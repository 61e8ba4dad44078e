"""Every file the benchmark finds by name is there and loads, every cell
of ``BENCHMARK.json`` resolves, the file keeps to the benchmark's form,
and the configuration files state what the program builds."""
import json
import os
import re

import numpy as np
import pytest
import torch

from portbench.harness import runtime
from portbench.reference import graphs, model as ref_model
from portbench.reference import partpsp as ref_partpsp

BENCH = runtime.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = runtime.Cell(BENCH, cell)
    driver = c.driver()
    assert callable(driver.run) and callable(driver.control)
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
    for key in ("limits",):
        assert set(c.traffic[key]) <= {"start_gap", "sens_gap", "window_gap",
                                       "loss_gap", "clip_norm_gap",
                                       "grad_gap", "change_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_file_declares_its_entry(metric):
    entry = next(m for m in METRICS if m["name"] == metric)
    mod = runtime.load_module(runtime.PORTBENCH / "metrics" / f"{metric}.py",
                              "m_" + metric.replace(".", "_"))
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    assert mod.read({}) is None, "a reader that finds nothing returns None"


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits its allowance
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and group != "per_layer" \
                        or key in ("why", "layer") and key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_layers_are_named_alike():
    layers = {m["layer"] for m in METRICS}
    assert layers == {"front door", "model", "protocol", "kernels", "device"}


def test_musicgen_file_states_the_program_model():
    """The file's sizes build the program's Transformer, whose parameter
    tree is the reference's, and whose partition gives the file's d_s and
    shared leaves."""
    from portbench.harness import program
    from repro_torch.core.partition import Partition
    from repro_torch.core.tree_utils import tree_flatten_with_path, tree_map

    cfg = runtime.Cell(BENCH, "musicgen-large.train").config
    m, k = cfg["model"], cfg["partition"]["shared_layers"]
    params = program.model(cfg).init(torch.Generator(), device="meta")
    got = [(p, tuple(x.shape)) for p, x in tree_flatten_with_path(params)[0]]
    assert got == ref_model.param_shapes(m)
    stacked = tree_map(lambda x: x[None].expand((4,) + tuple(x.shape)),
                       params)
    part = Partition.from_rules(stacked, (("group_0/.*",
                                           ("split_layers", k)),),
                                default="local")
    segs, d_s = ref_partpsp.shared_segments(ref_model.param_shapes(m), k)
    assert part.d_shared() == d_s == cfg["d_s"]
    assert [[p, list(s)] for p, s, _, _ in segs] == cfg["shared_leaves"]


def test_xlstm_file_states_the_program_model_and_graph():
    from repro_torch.configs import get_config
    from repro_torch.core.topology import calibrate_constants
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.models.transformer import Transformer
    from portbench.harness import program

    cfg = runtime.Cell(BENCH, "xlstm-125m.consensus").config
    spec = get_config("xlstm-125m")
    params = Transformer(spec.model).init(torch.Generator(), device="meta")
    pat = re.compile(spec.shared_rules[0][0])
    shared = [[p, list(x.shape)] for p, x in
              tree_flatten_with_path(params)[0] if pat.search(p)]
    assert shared == cfg["shared_leaves"]
    assert sum(int(np.prod(s)) for _, s in shared) == cfg["d_s"]
    topo = program.topology(cfg)
    w_prog = topo.weight_matrix(0)
    w_ref = graphs.weights(cfg["topology"])
    np.testing.assert_array_equal(w_prog != 0, w_ref != 0)
    np.testing.assert_allclose(w_ref, w_prog, rtol=0, atol=1e-15)
    c, lam = calibrate_constants(topo)
    c2, lam2 = graphs.calibrate(w_ref)
    assert c2 == pytest.approx(c, rel=1e-12) and lam2 == pytest.approx(
        lam, rel=1e-12)


def test_dout_weights_and_constants_match_the_program():
    from portbench.harness import program
    from repro_torch.core.topology import calibrate_constants

    cfg = runtime.Cell(BENCH, "musicgen-large.train").config
    topo = program.topology(cfg)
    np.testing.assert_array_equal(graphs.weights(cfg["topology"]),
                                  topo.weight_matrix(0))
    c, lam = calibrate_constants(topo)
    c2, lam2 = graphs.calibrate(graphs.weights(cfg["topology"]))
    assert (c2, lam2) == pytest.approx((c, lam), rel=1e-12)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_reduced_keys_are_the_files(config):
    """``reduced`` in ``BENCHMARK.json`` names exactly the keys that the
    configuration's file says were changed from its source."""
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(runtime.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for key in entry["reduced"]:
        assert key in cfg["model"] and key in cfg["published"]


def test_allocator_option_comes_from_the_configuration(monkeypatch):
    """Only a cell whose configuration states an allocator option gets
    it; the harness sets none of its own."""
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    runtime.cache_environment()
    runtime.allocator_environment(runtime.Cell(BENCH, "xlstm-125m.consensus"))
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    cell = runtime.Cell(BENCH, "musicgen-large.train")
    runtime.allocator_environment(cell)
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
        cell.config["allocator"]["conf"]
