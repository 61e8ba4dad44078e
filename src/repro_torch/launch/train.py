"""PartPSP training driver of the port (port of ``repro.launch.train``).

Trains any architecture of the zoo across N nodes on the synthetic Markov
token stream: the model of ``--arch`` (``--reduced``: its smoke config),
the arch's PartPSP partition rules, ``Session.build(..., model=...)`` and
``Session.train``. On the CUDA card by default; pass ``--device cpu`` for
the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --device cpu --nodes 4 --steps 5 --gamma-n 1e-6
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --device cpu --nodes 4 --steps 3 --gamma-n 1e-6 \\
        --checkpoint ckpt

Flags follow the reference's: ``--algorithm {partpsp,sgp,sgpdp,pedfl}``,
``--b``, ``--gamma-n``, ``--gamma-l``, ``--gamma-s``, ``--clip``,
``--topology`` (the families the port has) with ``--degree`` and the
random families' knobs, ``--sync-interval``, ``--schedule
{dense,circulant,sparse}``, ``--checkpoint DIR`` (the consensus view for
``launch.serve --checkpoint``), ``--driver {engine,loop}`` (``loop``: the
per-round driver over the pytree runtime), ``--ledger-out FILE`` (the
per-round privacy ledger as JSONL), ``--privacy-budget EPS`` with
``--strict-budget`` (abort once the budget is exceeded: no checkpoint is
written and the run exits through ``SystemExit``) and ``--metrics-out
FILE`` (the ``MetricsHook`` history as JSON). Flags of parts not ported
yet raise ``NotImplementedError`` naming their ROADMAP item. The batches
carry tokens only (embeddings for an embedding-input model), as the
reference's do: llama-3.2-vision-11b, which needs image embeddings, fails
with a ``ValueError`` naming ``image_embeds``, as the reference's
assertion does. The run always goes under a ``LedgerHook`` and a
``MetricsHook``, as the reference's does: every ``--log-every`` steps (and
the last) a line gives the loss, the sensitivity used and the mean
seconds a step so far, at each segment boundary, and the run ends with
``privacy: {ledger summary}``.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --driver loop --ledger-out /tmp/l.jsonl \\
        --privacy-budget 5 --strict-budget
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.api import (BudgetHook, LedgerHook, MetricsHook,
                             PrivacySpec, Session)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.topology import (DOutGraph, ExpGraph,
                                       FullyConnectedGraph, RingGraph)
from repro_torch.data import NodeShardedLoader, SyntheticLMStream
from repro_torch.data.pipeline import seeded_generator
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.net import (ErdosRenyiGraph, RandomMatchingGraph,
                             SmallWorldGraph, TorusGraph)

__all__ = ["TOPOLOGY_CHOICES", "make_topology", "build_session", "main"]

TOPOLOGY_CHOICES = ("dout", "exp", "ring", "full", "er", "matching",
                    "torus", "smallworld")

# flag -> the ROADMAP Queue 1 item that ports what it drives
_UNPORTED = {
    "drop_rate": "item 6 (faults)",
    "straggler_rate": "item 6 (faults)",
    "churn": "item 6 (faults)",
    "max_delay": "item 7 (async delays)",
    "timeout_rate": "item 7 (async delays)",
    "node_rates": "item 7 (async delays)",
    "wire": "item 8 (wire codecs)",
}


def make_topology(name: str, n_nodes: int, *, degree: int = 2,
                  p: float = 0.3, matchings: int = 1, beta: float = 0.1,
                  rows: int = 0, seed: int = 0):
    """The name -> Topology registry of the reference's ``repro.api.cli``,
    over the families the port has."""
    if name == "dout":
        return DOutGraph(n_nodes=n_nodes, d=degree)
    if name == "exp":
        return ExpGraph(n_nodes=n_nodes)
    if name == "ring":
        return RingGraph(n_nodes=n_nodes)
    if name == "full":
        return FullyConnectedGraph(n_nodes=n_nodes)
    if name == "er":
        return ErdosRenyiGraph(n_nodes=n_nodes, p=p, seed=seed)
    if name == "matching":
        return RandomMatchingGraph(n_nodes=n_nodes, k=matchings, seed=seed)
    if name == "smallworld":
        return SmallWorldGraph(n_nodes=n_nodes, beta=beta, seed=seed)
    if name == "torus":
        return TorusGraph(n_nodes=n_nodes, rows=rows)
    raise ValueError(f"unknown topology {name!r}; choose from "
                     f"{TOPOLOGY_CHOICES}")


def build_session(arch_name: str, *, reduced: bool, n_nodes: int,
                  algorithm: str, b: float, gamma_n: float, gamma_l: float,
                  gamma_s: float, clip: float, topology, degree: int = 2,
                  sync_interval: int = 5, schedule: str = "dense",
                  seed: int = 0, device=None):
    """Arch-specific assembly -> (model, model config, session), as the
    reference's ``build_session``: the model and the partition rules (full
    sharing for SGP/SGPDP, split points clamped to 1 on the 2-layer smoke
    stacks); every protocol decision is ``Session.build``'s. ``topology``
    is a :data:`TOPOLOGY_CHOICES` name or a Topology."""
    arch = get_config(arch_name)
    model_cfg = arch.smoke if reduced else arch.model
    model = Transformer(model_cfg)
    topo = (topology if not isinstance(topology, str)
            else make_topology(topology, n_nodes, degree=degree))
    rules = (((".*", "shared"),) if algorithm in ("sgp", "sgpdp")
             else tuple(arch.shared_rules))
    if reduced:
        rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple)
                       else act) for pat, act in rules)
    session = Session.build(
        topo, privacy=PrivacySpec(b=b, gamma_n=gamma_n), model=model,
        partition=rules, algorithm=algorithm, gamma_l=gamma_l,
        gamma_s=gamma_s, clip=clip, schedule=schedule,
        sync_interval=sync_interval, seed=seed, device=device)
    return model, model_cfg, session


def lm_batches(model_cfg, loader: NodeShardedLoader):
    """``batch_at(t)`` of the loader's token batches; an embedding-input
    model gets Gaussian embeddings (scale 0.1, from a generator seeded by
    (7, t)) with the tokens as its labels, as the reference's driver
    makes them."""
    if model_cfg.input_mode != "embeddings":
        return loader.batch_at
    dev = loader.generator.device

    def batch_at(t: int) -> dict:
        toks = loader.batch_at(t)["tokens"]
        embeds = torch.randn(tuple(toks.shape) + (model_cfg.d_model,),
                             generator=seeded_generator(dev, 7, t),
                             device=dev) * 0.1
        return {"embeds": embeds, "labels": toks}

    return batch_at


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU friendly)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--per-node-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--algorithm", choices=("partpsp", "sgp", "sgpdp", "pedfl"),
                    default="partpsp")
    ap.add_argument("--b", type=float, default=3.0)
    ap.add_argument("--gamma-n", type=float, default=0.003)
    ap.add_argument("--gamma-l", type=float, default=0.05)
    ap.add_argument("--gamma-s", type=float, default=0.05)
    ap.add_argument("--clip", type=float, default=100.0)
    ap.add_argument("--topology", choices=TOPOLOGY_CHOICES, default="dout")
    ap.add_argument("--degree", type=int, default=2,
                    help="dout: out-degree incl. the self loop")
    ap.add_argument("--er-p", type=float, default=0.3)
    ap.add_argument("--matchings", type=int, default=1)
    ap.add_argument("--sw-beta", type=float, default=0.1)
    ap.add_argument("--torus-rows", type=int, default=0)
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--sync-interval", type=int, default=5)
    ap.add_argument("--schedule", choices=("dense", "circulant", "sparse"),
                    default="dense")
    ap.add_argument("--seed", type=int, default=2024)   # the paper's seed
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--checkpoint", default=None,
                    help="write the consensus params (s-bar + node 0's "
                         "local ones) here for serving")
    ap.add_argument("--driver", choices=("engine", "loop"), default="engine",
                    help="loop: the per-round driver over the pytree runtime")
    ap.add_argument("--ledger-out", default=None,
                    help="stream the per-round privacy ledger to this JSONL")
    ap.add_argument("--metrics-out", default=None,
                    help="write the per-step metrics history here (JSON)")
    ap.add_argument("--privacy-budget", type=float, default=None,
                    help="total epsilon ceiling for the run")
    ap.add_argument("--strict-budget", action="store_true",
                    help="abort training once --privacy-budget is exceeded")
    for flag in _UNPORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported yet (ROADMAP Queue 1 "
                             f"{_UNPORTED[flag]})")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    for flag, item in _UNPORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: not ported yet (ROADMAP Queue 1 "
                f"{item})")
    dev = resolve_device(args.device)
    topo = make_topology(args.topology, args.nodes, degree=args.degree,
                         p=args.er_p, matchings=args.matchings,
                         beta=args.sw_beta, rows=args.torus_rows,
                         seed=args.graph_seed)
    model, model_cfg, session = build_session(
        args.arch, reduced=args.reduced, n_nodes=args.nodes,
        algorithm=args.algorithm, b=args.b, gamma_n=args.gamma_n,
        gamma_l=args.gamma_l, gamma_s=args.gamma_s, clip=args.clip,
        topology=topo, sync_interval=args.sync_interval,
        schedule=args.schedule, seed=args.seed, device=dev)
    part = session.partition
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'FULL'}) "
          f"algorithm={args.algorithm} nodes={args.nodes} "
          f"topo={args.topology}(d={args.degree}) "
          f"schedule={session.plan.schedule} device={dev} "
          f"kernels={session.plan.use_kernels} "
          f"d_s={part.d_shared():,} d_l={part.d_local():,}")

    stream = SyntheticLMStream(vocab_size=model_cfg.vocab_size,
                               seq_len=args.seq_len, n_nodes=args.nodes,
                               seed=args.seed, device=dev)
    loader = NodeShardedLoader(stream, per_node_batch=args.per_node_batch,
                               seed=args.seed)
    batch_at = lm_batches(model_cfg, loader)

    t0 = time.perf_counter()
    metrics = MetricsHook(
        fields={"loss": "loss_mean", "sensitivity": "sensitivity_used",
                "grad_l1_max": "grad_l1_max"},
        log_every=args.log_every, total=args.steps,
        formatter=lambda r: (f"step {r['step']:5d} loss={r['loss']:.4f} "
                             f"S={r['sensitivity']:.3f} "
                             f"({(time.perf_counter() - t0) / (r['step'] + 1):.2f}"
                             f"s/step)"))
    ledger = LedgerHook(path=args.ledger_out, budget=args.privacy_budget)
    hooks = [ledger, metrics]
    if args.privacy_budget is not None:
        note = (" (engine driver enforces at segment granularity)"
                if args.driver == "engine" else "")
        hooks.append(BudgetHook(args.privacy_budget,
                                strict=args.strict_budget, note=note))

    report = session.train(args.steps, batch_at, hooks=hooks,
                           driver=args.driver)

    print("privacy:", json.dumps(ledger.summary()))
    if args.ledger_out:
        print("privacy ledger written to", args.ledger_out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics.history, f, indent=1)
    if args.checkpoint and not report.aborted:
        # consensus shared params are identical across nodes; persist node
        # 0's view (s-bar + its personalised local params) for serving
        session.save_consensus(args.checkpoint, report.state,
                               step=report.rounds,
                               metadata={"arch": args.arch,
                                         "algorithm": args.algorithm})
        print("checkpoint written to", args.checkpoint)
    if report.aborted:
        if args.checkpoint:
            # strict mode never releases over-budget parameters, the
            # serving checkpoint included
            print("checkpoint NOT written (over budget):", args.checkpoint)
        raise SystemExit(
            "aborted: privacy budget exhausted (--strict-budget)")


if __name__ == "__main__":
    main()
