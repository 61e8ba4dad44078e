"""The port's shared CLI (``repro_torch.api.cli``) against the reference's
``repro.api.cli``.

Both parsers get the same flags (``add_topology_arguments``,
``add_fault_arguments``, ``add_delay_arguments``,
``add_protocol_arguments``, plus the launcher's ``--use-kernels`` and
``--driver``) and the same argv, then run the launcher's sequence
(``validate_protocol_args``, ``topology_from_args``, ``faults_from_args``,
``delays_from_args``, ``wire_from_args``). For every argv of the table the
two give the same weight matrices (exactly, three rounds of a resampled
family), the same ``FaultModel`` / ``DelayModel`` fields and codec names,
or the same ``ap.error`` message. The one stated difference: the
compress-first codec with ``--use-kernels`` is refused by the reference
and taken by the port, whose kernel route runs it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import warnings

import numpy as np
import pytest

from test_torch_reference import load_reference

from repro_torch import api as port_api
from repro_torch.api import cli
from repro_torch.engine import plan as plan_mod
from repro_torch.launch import train as train_cli

N = 8
FAULT_FIELDS = ("drop_rate", "straggler_rate", "churn", "seed")
DELAY_FIELDS = ("max_delay", "timeout_rate", "rates", "seed")


@pytest.fixture(scope="module")
def RC():
    load_reference()
    return importlib.import_module("repro.api.cli")


def _parser(mod) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="train")
    mod.add_topology_arguments(ap)
    mod.add_fault_arguments(ap)
    mod.add_delay_arguments(ap)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--driver", choices=("engine", "loop"), default="engine")
    mod.add_protocol_arguments(ap)
    return ap


def _parse(mod, argv):
    """The launcher's parse sequence -> (topology, faults, delays, codec
    name), or the parser's error text."""
    ap = _parser(mod)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err), warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            args = ap.parse_args(argv)
            mod.validate_protocol_args(ap, args)
            topo = mod.topology_from_args(ap, args, N)
            faults = mod.faults_from_args(ap, args, n_nodes=N)
            delays = mod.delays_from_args(ap, args, n_nodes=N)
            codec = mod.wire_from_args(ap, args)
    except SystemExit:
        return err.getvalue().strip().splitlines()[-1]
    return topo, faults, delays, None if codec is None else codec.name


def _fields(model, names):
    return None if model is None else {k: getattr(model, k) for k in names}


TABLE = [
    [],
    ["--topology", "dout", "--degree", "3"],
    ["--topology", "exp"],
    ["--topology", "ring"],
    ["--topology", "full"],
    ["--topology", "er", "--er-p", "0.5", "--graph-seed", "3"],
    ["--topology", "matching", "--matchings", "2", "--graph-seed", "1"],
    ["--topology", "torus", "--torus-rows", "2"],
    ["--topology", "torus"],
    ["--topology", "smallworld", "--sw-beta", "0.2", "--graph-seed", "4"],
    ["--topology", "er", "--resample-period", "3", "--graph-seed", "9"],
    ["--topology", "matching", "--resample-period", "2"],
    ["--drop-rate", "0.2", "--straggler-rate", "0.1", "--fault-seed", "5"],
    ["--churn", "1:0:2", "--churn", "3:1:4"],
    ["--max-delay", "2", "--timeout-rate", "0.1", "--delay-seed", "7"],
    ["--node-rates", "1,2,1,3,1,1,1,1"],
    ["--node-rates", "1,1,1,1,1,1,1,1"],
    ["--wire", "f32"], ["--wire", "bf16"], ["--wire", "int8"],
    ["--wire", "topk:4"], ["--wire", "topk:1/16"], ["--wire", "TopK:1/4"],
    ["--wire", "broken-compress-first"],
    ["--wire-dtype", "bf16"],
    ["--wire", "bf16", "--wire-dtype", "bf16"],
    ["--wire", "int8", "--max-delay", "2"],
    ["--wire", "topk:1/8", "--node-rates", "1,2,1,1,1,1,1,1"],
    ["--chunk", "7", "--no-packed"],
    # parser errors
    ["--chunk", "0"],
    ["--wire", "int4"],
    ["--wire", "topk:x"],
    ["--wire", "int8", "--wire-dtype", "bf16"],
    ["--wire", "int8", "--no-packed"],
    ["--wire", "bf16", "--driver", "loop"],
    ["--wire", "bf16", "--max-delay", "2"],
    ["--wire-dtype", "bf16", "--timeout-rate", "0.1"],
    ["--topology", "torus", "--torus-rows", "3"],
    ["--topology", "er", "--er-p", "1.5"],
    ["--topology", "smallworld", "--sw-beta", "-0.1"],
    ["--topology", "torus", "--resample-period", "2"],
    ["--topology", "dout", "--resample-period", "2"],
    ["--churn", "9:0:4"], ["--churn", "1:4"], ["--churn", "a:0:4"],
    ["--churn", "1:0:5", "--churn", "1:3:8"],
    ["--churn", "1:4:2"],
    ["--drop-rate", "1.5"], ["--straggler-rate", "-0.1"],
    ["--node-rates", "1,2"], ["--node-rates", "1,x,1,1,1,1,1,1"],
    ["--node-rates", "1,0,1,1,1,1,1,1"],
    ["--timeout-rate", "1.5"], ["--max-delay", "-1"],
]


@pytest.mark.parametrize("argv", TABLE,
                         ids=lambda a: " ".join(a) or "defaults")
def test_cli_matches_the_reference(RC, argv, monkeypatch):
    monkeypatch.setattr(plan_mod, "_WARNED", set())
    got, want = _parse(cli, argv), _parse(RC, argv)
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    (topo, faults, delays, codec), (r_topo, r_faults, r_delays, r_codec) = \
        got, want
    assert type(topo).__name__ == type(r_topo).__name__
    for t in range(3):
        np.testing.assert_array_equal(topo.weight_matrix(t),
                                      np.asarray(r_topo.weight_matrix(t)))
    assert _fields(faults, FAULT_FIELDS) == _fields(r_faults, FAULT_FIELDS)
    assert _fields(delays, DELAY_FIELDS) == _fields(r_delays, DELAY_FIELDS)
    assert codec == r_codec


@pytest.mark.parametrize("name", ["2-out", "4-out", "DOUT", "Exp", "ring",
                                  "mesh"])
def test_make_topology_spellings_match_the_reference(RC, name):
    """The older ``K-out`` spelling, case, and an unknown name's error."""
    try:
        r_topo = RC.make_topology(name, N)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cli.make_topology(name, N)
        assert str(got.value) == str(e)
        return
    topo = cli.make_topology(name, N)
    assert type(topo).__name__ == type(r_topo).__name__
    np.testing.assert_array_equal(topo.weight_matrix(0),
                                  np.asarray(r_topo.weight_matrix(0)))


def test_compress_first_with_kernels_is_the_one_difference(RC):
    """The reference refuses ``broken-compress-first`` with
    ``--use-kernels``; the port takes it (its kernel route runs the
    codec)."""
    argv = ["--wire", "broken-compress-first", "--use-kernels"]
    assert "rejected with --use-kernels" in _parse(RC, argv)
    assert _parse(cli, argv)[3] == "broken_compress_first"


def test_the_vocabulary_and_exports_match_the_reference(RC):
    assert cli.TOPOLOGY_CHOICES == RC.TOPOLOGY_CHOICES
    assert cli.__all__ == RC.__all__
    for name in RC.__all__:
        assert getattr(port_api, name) is getattr(cli, name)
    ap, r_ap = _parser(cli), _parser(RC)
    assert ({a.dest: a.default for a in ap._actions}
            == {a.dest: a.default for a in r_ap._actions})


def test_the_launcher_builds_its_parser_from_the_shared_cli(RC):
    """``launch.train`` keeps no copy of the registry or the parsers: the
    names it exports are the CLI's, and its parser takes every shared flag
    with the reference's defaults."""
    for name in ("make_topology", "faults_from_args", "delays_from_args",
                 "wire_from_args", "TOPOLOGY_CHOICES"):
        assert getattr(train_cli, name) is getattr(cli, name)
    assert not hasattr(train_cli, "validate_wire_args")
    assert not hasattr(train_cli, "_parse_churn")
    dests = {a.dest: a.default for a in train_cli._parser()._actions}
    for a in _parser(RC)._actions:
        assert dests[a.dest] == a.default, a.dest


def test_models_are_dataclasses_with_the_reference_fields(RC):
    """The fields the table compares are all the models carry, in both
    packages."""
    from repro_torch.net import DelayModel, FaultModel

    r_net = importlib.import_module("repro.net")
    for cls, ref_cls, names in ((FaultModel, r_net.FaultModel, FAULT_FIELDS),
                                (DelayModel, r_net.DelayModel, DELAY_FIELDS)):
        assert {f.name for f in dataclasses.fields(cls)} == set(names)
        assert {f.name for f in dataclasses.fields(ref_cls)} == set(names)
