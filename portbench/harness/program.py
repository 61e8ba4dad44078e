"""What the benchmark takes from the program under test (``repro_torch``):
the graph, the model and the session built from a configuration file, its
kernels built ahead, and its state's leaves. Everything the program
derives from these (W, the plan, the calibrated constants, the partition,
the packed wire row) is its own; the reference works it out again."""
from __future__ import annotations

import dataclasses


def topology(cfg: dict):
    """The program's topology object of a configuration's graph."""
    from repro_torch.core.topology import DOutGraph
    from repro_torch.net import ErdosRenyiGraph

    topo = cfg["topology"]
    if topo["kind"] == "dout":
        return DOutGraph(int(topo["nodes"]), int(topo["d"]))
    if topo["kind"] == "erdos_renyi":
        return ErdosRenyiGraph(int(topo["nodes"]), p=float(topo["p"]),
                               seed=int(topo["seed"]),
                               backbone=bool(topo["backbone"]))
    raise ValueError(f"unknown topology kind {topo['kind']!r}")


def model(cfg: dict):
    """The program's ``Transformer`` at the configuration's sizes: its own
    configuration of the architecture (``preset`` "model", or "smoke" for
    the CPU tests), cut to ``model.n_layers`` layers; every size the file
    states must equal the program's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer

    spec = get_config(cfg["arch"])
    mc = spec.smoke if cfg.get("preset") == "smoke" else spec.model
    m = cfg["model"]
    (group,) = mc.groups
    mc = dataclasses.replace(mc, groups=(dataclasses.replace(
        group, n_layers=int(m["n_layers"])),))
    for key in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                "vocab_size", "activation", "norm_eps", "rope_theta",
                "input_mode", "tie_embedding"):
        if getattr(mc, key) != m[key]:
            raise ValueError(f"{cfg['name']}: {key} is {m[key]!r} in the "
                             f"file and {getattr(mc, key)!r} in the program")
    return Transformer(mc)


def build_kernels(names) -> None:
    """The program's kernels this cell launches, built at once (one nvcc
    each, in parallel) where they are not yet built in this checkout."""
    from repro_torch.kernels import build

    build.build_all(tuple(names))
