"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``requires_cuda`` and skips where there is no
card. On a GPU machine (which needs no JAX for this file):

    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine
need not have.)

Tolerances: flash attention to rtol 1e-4 / atol 1e-5 on outputs of
magnitude about 1 (online softmax in another order, 3xTF32 products on the
tensor cores, expf against the CPU's exp); the fused perturb agrees elementwise to rtol 1e-6 / atol 1e-6
(the card's logf may differ from the CPU's log by an ulp); row sums to
rtol 1e-5 (per-block partials against PyTorch's reduction order); the mix
to rtol 1e-5 / atol 1e-6 (fma in j order against cuBLAS's order), also
on unaligned x, with the bits it gives on an aligned copy; its tiled
kernel (N > 32) bit for bit equal to the template kernel's chain (an
f64 check of the same terms bounds both) and to ``spmm``, under every
tile. The perturbation's s_noise is bit for bit the plain version's on
the card under every plan (the same logf), its norms within rtol 1e-5.
Every kernel gives the same bits on two launches. The
sparse mix to rtol 1e-6 / atol 1e-6 (fma against the plain version's
separate multiply and add), and bit for bit against the dense kernel on a
topology's own CSR; the clip scale exactly (one correctly rounded
division); the Laplace transform to rtol 1e-6 (logf against the CPU's
log, an ulp).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
import torch

import dataclasses

from repro_torch.api import PrivacySpec, Session
from repro_torch.configs import get_config
from repro_torch.core.topology import DOutGraph
from repro_torch.core.tree_utils import tree_leaves, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import open_cross_gates
from repro_torch.models.transformer import Transformer
from repro_torch.net import ErdosRenyiGraph

pytestmark = pytest.mark.requires_cuda

# N = 1 and 32 the ends of pushsum_mix.cu's range, 24 the sparse full
# width's; d_s 300,001: a ragged tail, and longer than one l1_norm.cu block
SHAPES = [(n, d_s) for n in (1, 4, 10, 24, 32)
          for d_s in (7840, 8192, 3, 300_001)]


@pytest.fixture
def dev():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows(gen, dev, n, d_s, pad=0.0):
    d_pad = -(-d_s // 128) * 128
    x = torch.randn((n, d_pad), generator=gen, device=dev)
    x[:, d_s:] = pad
    return x


@pytest.mark.parametrize("n,d_s", SHAPES)
def test_kernels_match_plain(dev, n, d_s):
    """1e4 in the pad lanes: the norms and the perturbation must leave them
    out."""
    gen = torch.Generator(device=dev).manual_seed(n * d_s)
    s, eps = _rows(gen, dev, n, d_s, 1e4), _rows(gen, dev, n, d_s, 1e4)
    scale = torch.tensor(0.7, device=dev)
    if d_s == 300_001:
        assert ops.l1_plan(n, d_s)["blocks_per_row"] > 1
    torch.testing.assert_close(ops.l1_norm_rows(s, d_s),
                               ref.l1_norm_rows(s, d_s), rtol=1e-5, atol=0)
    want = ref.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5, t=3)
    bits = ref.philox_bits(5, 3, n, 0, d_s, device=dev).to(torch.uint32)
    for kw in (dict(seed=5, t=3), dict(bits=bits)):
        got = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, **kw)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        assert bool((got[0][:, d_s:] == 0).all())
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(0, keepdim=True)
    torch.testing.assert_close(ops.pushsum_mix(w, s), ref.pushsum_mix(w, s),
                               rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1, 5, 10, 32])
@pytest.mark.parametrize("d,offset", [(7936, 1), (7939, 0), (7939, 3),
                                      (300_001, 0)])
def test_pushsum_mix_takes_unaligned_and_ragged_x(dev, n, d, offset):
    """x unaligned (a flat buffer offset by ``offset`` floats, then
    reshaped) or D % 4 != 0: within the tolerance of the plain version,
    and bit for bit what an aligned copy padded to D % 4 == 0 gives."""
    gen = torch.Generator(device=dev).manual_seed(n + d + offset)
    flat = torch.randn(n * d + offset, generator=gen, device=dev)
    x = flat[offset:].view(n, d)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0 or d % 4 != 0)
    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(0, keepdim=True)
    got = ops.pushsum_mix(w, x)
    torch.testing.assert_close(got, ref.pushsum_mix(w, x), rtol=1e-5,
                               atol=1e-6)
    wide = torch.zeros((n, -(-d // 4) * 4), device=dev)
    wide[:, :d] = x
    assert torch.equal(ops.pushsum_mix(w, wide)[:, :d], got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,d", [(33, 7936), (64, 4099), (64, 1 << 20),
                                 (4096, 8), (257, 1000), (33, 1)])
def test_pushsum_mix_past_the_template_matches_plain(dev, n, d):
    """The tiled kernel (N > 32; both rows-a-thread plans at these shapes)
    within the mix tolerance of the plain version, and bit for bit the
    same chain as the template kernel: a W whose rows past 32 and senders
    past 32 are zero gives, on the first 32 rows, the template kernel's
    bits for the 32 x 32 corner."""
    gen = torch.Generator(device=dev).manual_seed(n * 7 + d)
    x = torch.randn((n, d), generator=gen, device=dev)
    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(0, keepdim=True)
    plan = ops.mix_plan(n, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan["kernel"] == "tiles"
    torch.testing.assert_close(ops.pushsum_mix(w, x), ref.pushsum_mix(w, x),
                               rtol=1e-5, atol=1e-6)
    corner = torch.zeros_like(w)
    corner[:32, :32] = w[:32, :32]
    got = ops.pushsum_mix(corner, x)
    assert torch.equal(got[:32], ops.pushsum_mix(
        w[:32, :32].contiguous(), x[:32].contiguous()))
    assert not bool(got[32:].any())
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [65_536, 100_003])
def test_row_kernels_past_a_grid_of_rows(dev, n):
    """More rows than a grid holds (65,535): each of the three row kernels
    against its plain version, with 1e4 in the pad lanes, and the rows past
    65,535 equal to the same rows launched alone (the Philox counter holds
    the row, so the split changes no bits)."""
    d_s = 300
    gen = torch.Generator(device=dev).manual_seed(n)
    s, eps = _rows(gen, dev, n, d_s, 1e4), _rows(gen, dev, n, d_s, 1e4)
    norms = ops.l1_norm_rows(eps, d_s)
    torch.testing.assert_close(norms, ref.l1_norm_rows(eps, d_s), rtol=1e-5,
                               atol=0)
    scale = torch.tensor(0.7, device=dev)
    got = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5, t=3)
    want = ref.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5, t=3)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert bool((got[0][:, d_s:] == 0).all())
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    denom = torch.clamp_min(norms / norms.median(), 1.0)
    clipped = ops.clip_scale_rows(s, d_s, denom)
    assert torch.equal(clipped, ref.clip_scale_rows(s, d_s, denom))
    tail = slice(65_535, n)
    assert torch.equal(ops.l1_norm_rows(eps[tail].contiguous(), d_s),
                       norms[tail])
    assert torch.equal(ops.clip_scale_rows(s[tail].contiguous(), d_s,
                                           denom[tail].contiguous()),
                       clipped[tail])
    torch.cuda.synchronize()


def test_dpps_step_on_a_ring_of_70000_nodes(dev):
    """One DPPS round on the sparse schedule over a hand-built ring CSR
    (K = 3: left, self, right), N = 70,000: the card against the CPU's
    plain path from the same state and the same Philox bits."""
    from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
    from repro_torch.core.packing import PackedLayout

    n, d_s = 70_000, 300
    i = torch.arange(n)
    idx = torch.stack([(i - 1) % n, i, (i + 1) % n], dim=1)
    idx = torch.sort(idx, dim=1).values.to(torch.int32)
    vals = torch.full((n, 3), 1.0 / 3.0)
    x = torch.randn((n, d_s), generator=torch.Generator().manual_seed(0))
    eps = 0.01 * torch.randn((n, d_s),
                             generator=torch.Generator().manual_seed(1))
    out = {}
    for device, kernels in (("cuda", True), ("cpu", False)):
        cfg = DPPSConfig(b=1.0, gamma_n=1e-4, schedule="sparse",
                         use_kernels=kernels)
        layout = PackedLayout.from_tree({"x": x}, lane=128 if kernels else 1)
        state = dpps_init({"x": x.to(device)}, cfg)
        state = state._replace(push=state.push._replace(
            s=layout.pack(state.push.s)))
        ops.reset_launch_counts()
        new, diag = dpps_step(state, {"x": eps.to(device)}, cfg, layout,
                              sparse_idx=idx.to(device),
                              sparse_vals=vals.to(device), seed=3)
        if kernels:
            counts = ops.launch_counts()
            assert counts["l1_norm_rows"] == 2 and counts["spmm"] == 1
            assert counts["dpps_perturb_rows"] == 1
        out[device] = (layout.unpack(new.push.s)["x"].cpu(), new.push.a.cpu(),
                       diag["sensitivity_used"].cpu())
    want = out["cpu"][0]
    torch.testing.assert_close(out["cuda"][0], want, rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("plan", [(256, 2048), (512, 4096), (128, 1024)])
@pytest.mark.parametrize("n,d_s", [(1, 300_001), (10, 7840), (24, 1 << 20)])
def test_l1_norm_plans_match_plain_and_leave_the_tickets_at_zero(
        dev, monkeypatch, plan, n, d_s):
    """The table's plan of csrc/l1_norm.cu and two of the sweep's, within
    rtol 1e-5 of the plain version; each launch leaves its stream's ticket
    counters at zero, so the next launch gives the same bits; two streams
    at once each get their own counters."""
    monkeypatch.setattr(ops, "L1_THREADS", plan[0])
    monkeypatch.setattr(ops, "L1_QUADS_PER_BLOCK", plan[1])
    gen = torch.Generator(device=dev).manual_seed(n + d_s)
    buf = _rows(gen, dev, n, d_s, 1e4)
    other = _rows(gen, dev, n, d_s, 1e4)
    first = ops.l1_norm_rows(buf, d_s)
    torch.testing.assert_close(first, ref.l1_norm_rows(buf, d_s), rtol=1e-5,
                               atol=0)
    assert torch.equal(ops.l1_norm_rows(buf, d_s), first)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for st, x in zip(streams, (buf, other)):
        with torch.cuda.stream(st):
            outs.append(ops.l1_norm_rows(x, d_s))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], first)
    torch.testing.assert_close(outs[1], ref.l1_norm_rows(other, d_s),
                               rtol=1e-5, atol=0)
    for _, tickets in ops._ROW_SCRATCH.values():
        assert int(tickets.count_nonzero()) == 0


@pytest.mark.parametrize("n,d_s", [(10, 7840), (24, 300_001)])
def test_l1_norm_rows_in_a_cuda_graph(dev, n, d_s):
    """A launch captured into a CUDA graph takes counters of its own, not
    the eager set of its capture stream: every replay gives the eager
    launch's bits, with eager launches between replays, and the capture
    adds no scratch."""
    gen = torch.Generator(device=dev).manual_seed(n + d_s)
    buf = _rows(gen, dev, n, d_s, 1e4)
    want = ops.l1_norm_rows(buf, d_s)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        ops.l1_norm_rows(buf, d_s)
    torch.cuda.current_stream(dev).wait_stream(side)
    kept = {k: (p.data_ptr(), t.data_ptr())
            for k, (p, t) in ops._ROW_SCRATCH.items()}
    assert ("l1_norm", dev.index, side.cuda_stream) in kept
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = ops.l1_norm_rows(buf, d_s)
    assert {k: (p.data_ptr(), t.data_ptr())
            for k, (p, t) in ops._ROW_SCRATCH.items()} == kept
    for _ in range(3):
        graph.replay()
        assert torch.equal(ops.l1_norm_rows(buf, d_s), want)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    for _, tickets in ops._ROW_SCRATCH.values():
        assert int(tickets.count_nonzero()) == 0


# -- the tiled mix (N > 32) under every tile --------------------------------

def _each_tile(monkeypatch, dev, fn):
    """{tile: fn()} with ``ops.mix_plan`` held at each tile of MIX_TILES."""
    plan = ops.mix_plan
    out = {}
    for tile in ops.MIX_TILES:
        monkeypatch.setattr(ops, "mix_plan",
                            lambda n, d, sms, tile=tile, **kw: plan(
                                n, d, sms, tile, **kw))
        out[tile] = fn()
    monkeypatch.setattr(ops, "mix_plan", plan)
    return out


# D = 1, 7, 8, 128, 129 and 2^20 against N = 33, 64, 128, 256 and 4096;
# offset > 0: x unaligned (a flat buffer offset by that many floats)
@pytest.mark.parametrize("n,d,offset", [
    (33, 1, 0), (33, 129, 1), (33, 1 << 20, 0), (64, 7, 0), (64, 1 << 20, 3),
    (128, 8, 0), (128, 129, 0), (128, 7936, 1), (256, 128, 0),
    (256, 1 << 20, 0), (4096, 8, 0), (4096, 128, 0), (4096, 1, 0),
    (4096, 7, 2)])
def test_tiled_mix_is_one_chain_under_every_tile(dev, monkeypatch, n, d,
                                                 offset):
    """Every tile of the N > 32 kernel gives the same bits (and the same on
    a second launch), within rtol 1e-5 / atol 1e-6 of the plain version
    (fma in j order against cuBLAS's order); on a W whose rows and senders
    past 32 are zero, the first 32 rows are the template kernel's bits and
    the rest exact zeros; a row block of W (B < N) gives the same rows of
    the whole mix under every tile."""
    gen = torch.Generator(device=dev).manual_seed(n * 7 + d + offset)
    flat = torch.randn(n * d + offset, generator=gen, device=dev)
    x = flat[offset:].view(n, d)
    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(0, keepdim=True)
    corner = torch.zeros_like(w)
    corner[:32, :32] = w[:32, :32]
    template = ops.pushsum_mix(w[:32, :32].contiguous(), x[:32].contiguous())
    rows = slice(n // 3, n // 3 + n // 2)
    got = _each_tile(monkeypatch, dev, lambda: (
        ops.pushsum_mix(w, x), ops.pushsum_mix(w, x),
        ops.pushsum_mix(corner, x), ops.pushsum_mix(w[rows], x)))
    first = got[next(iter(got))][0]
    torch.testing.assert_close(first, ref.pushsum_mix(w, x), rtol=1e-5,
                               atol=1e-6)
    for tile, (a, b, c, block) in got.items():
        assert torch.equal(a, first), tile
        assert torch.equal(b, first), tile
        assert torch.equal(c[:32], template), tile
        assert not bool(c[32:].any()), tile
        assert torch.equal(block, first[rows]), tile
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,d", [(64, 128), (64, 1 << 20), (4096, 8),
                                 (4096, 128)])
def test_tiled_mix_equals_spmm_under_every_tile(dev, monkeypatch, n, d):
    """On ER(64) and bench_sparse.py's ER(4096, p = 8/4096, seed 2024) every
    tile gives ``spmm``'s bits on the graph's own CSR."""
    topo = ErdosRenyiGraph(n, p=8 / n, seed=2024 if n == 4096 else 0)
    idx, vals = (torch.as_tensor(a, device=dev)
                 for a in topo.sparse_weights(0))
    vals = vals.to(torch.float32)
    w = topo.weight_matrix_torch(0, device=dev)
    x = torch.randn((n, d), generator=torch.Generator(device=dev)
                    .manual_seed(n + d), device=dev)
    want = ops.spmm(idx, vals, x)
    for tile, got in _each_tile(monkeypatch, dev,
                                lambda: ops.pushsum_mix(w, x)).items():
        assert torch.equal(got, want), tile
    torch.cuda.synchronize()


# -- dpps_perturb.cu under every plan ---------------------------------------

# (name, tables patched into ops): the short-row and long-row plans, each
# with other blocks, lanes a row, and each regime forced at the other's rows
_PERTURB_PLANS = {
    "default": {},
    "long_512": dict(PERTURB_QUADS_PER_BLOCK=512, PERTURB_SHORT_QUADS=0),
    "long_4096_t128": dict(PERTURB_QUADS_PER_BLOCK=4096, PERTURB_THREADS=128,
                           PERTURB_SHORT_QUADS=0),
    "short_8_lanes": dict(PERTURB_ROW_LANES=8, PERTURB_SHORT_QUADS=1 << 20),
    "short_16_lanes_t64": dict(PERTURB_ROW_LANES=16, PERTURB_THREADS=64,
                               PERTURB_SHORT_QUADS=1 << 20),
}


@pytest.mark.parametrize("n,d_s", [(20_000, 300), (4096, 8), (3, 300_001),
                                   (10, 7840)])
def test_perturb_plans_give_the_same_bits(dev, monkeypatch, n, d_s):
    """Short rows (d_s 300 and 8) and long ones (300,001: many blocks a
    row; 7,840: one): every plan gives the plain version's s_noise bit for
    bit (Philox variant and bits-in), the same bits on a second launch,
    norms within rtol 1e-5, and leaves its ticket counters at zero."""
    gen = torch.Generator(device=dev).manual_seed(n + d_s)
    s, eps = _rows(gen, dev, n, d_s, 1e4), _rows(gen, dev, n, d_s, 1e4)
    scale = torch.tensor(0.7, device=dev)
    want = ref.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5, t=3)
    bits = ref.philox_bits(5, 3, n, 0, d_s, device=dev).to(torch.uint32)
    for name, tables in _PERTURB_PLANS.items():
        for k, v in tables.items():
            monkeypatch.setattr(ops, k, v)
        runs = [ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, **kw)
                for kw in (dict(seed=5, t=3), dict(seed=5, t=3),
                           dict(bits=bits))]
        for got in runs:
            assert torch.equal(got[0], want[0]), name
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        for a, b in zip(*runs[:2]):  # the same bits on a second launch
            assert torch.equal(a, b), name
        monkeypatch.undo()
    torch.cuda.synchronize()
    for _, tickets in ops._ROW_SCRATCH.values():
        assert int(tickets.count_nonzero()) == 0


@pytest.mark.parametrize("n,d_s", [(10, 7840), (3, 300_001), (4096, 8)])
def test_dpps_perturb_rows_in_a_cuda_graph(dev, n, d_s):
    """A launch captured into a CUDA graph (one block a row, many, and short
    rows) replays the eager launch's bits, with eager launches between
    replays, and adds nothing to the eager scratch."""
    gen = torch.Generator(device=dev).manual_seed(n + d_s)
    s, eps = _rows(gen, dev, n, d_s, 1e4), _rows(gen, dev, n, d_s, 1e4)
    scale = torch.tensor(0.7, device=dev)
    call = lambda: ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5,
                                         t=3)
    want = call()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        call()
    torch.cuda.current_stream(dev).wait_stream(side)
    kept = {k: (p.data_ptr(), t.data_ptr())
            for k, (p, t) in ops._ROW_SCRATCH.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = call()
    assert {k: (p.data_ptr(), t.data_ptr())
            for k, (p, t) in ops._ROW_SCRATCH.items()} == kept
    for _ in range(3):
        graph.replay()
        again = call()
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(a, w)
    for _, tickets in ops._ROW_SCRATCH.values():
        assert int(tickets.count_nonzero()) == 0


def _each_kernel(dev):
    """One call of each of the seven kernels on seeded inputs (the main
    paths' kinds of shape, small): name -> thunk."""
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d_s = 24, 100_003
    s, eps = _rows(gen, dev, n, d_s, 1e4), _rows(gen, dev, n, d_s, 1e4)
    topo = ErdosRenyiGraph(n, p=8 / n, seed=0)
    idx, vals = (torch.as_tensor(a, device=dev) for a in topo.sparse_weights(0))
    vals = vals.to(torch.float32)
    w = topo.weight_matrix_torch(0, device=dev)
    bits = torch.randint(0, 2 ** 32, (n * 1000,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.uint32)
    denom = torch.linspace(1.0, 3.0, n, device=dev)
    q, k, v = (torch.randn((2, 300, h, 128), generator=gen, device=dev)
               for h in (8, 4, 4))
    return {
        "l1_norm_rows": lambda: ops.l1_norm_rows(eps, d_s),
        "dpps_perturb_rows": lambda: ops.dpps_perturb_rows(
            s, eps, 0.7, 0.1, d_s, seed=3, t=2),
        "pushsum_mix": lambda: ops.pushsum_mix(w, s),
        "pushsum_mix_ragged": lambda: ops.pushsum_mix(w, s[:, :d_s].contiguous()),
        "spmm": lambda: ops.spmm(idx, vals, s),
        "clip_scale_rows": lambda: ops.clip_scale_rows(s, d_s, denom),
        "laplace_from_bits": lambda: ops.laplace_from_bits(bits, 0.7),
        "flash_attention": lambda: ops.flash_attention_bshd(q, k, v),
    }


@pytest.mark.parametrize("kernel", [
    "l1_norm_rows", "dpps_perturb_rows", "pushsum_mix", "pushsum_mix_ragged",
    "spmm", "clip_scale_rows", "laplace_from_bits", "flash_attention"])
def test_two_launches_give_the_same_bits(dev, kernel):
    """No kernel sums with float atomics or in an order that depends on
    timing."""
    fn = _each_kernel(dev)[kernel]
    a, b = fn(), fn()
    for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
        assert torch.equal(x, y)
    torch.cuda.synchronize()


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(dev):
    s = torch.zeros((3, 256), device=dev)
    ops.reset_launch_counts()
    ops.l1_norm_rows(s, 200)
    ops.dpps_perturb_rows(s, s, 1.0, 1.0, 200, seed=0, t=0)
    ops.noise_l1_rows(s, 200)
    ops.pushsum_mix(torch.eye(3, device=dev), s)
    idx = torch.tensor([[0, 1], [1, 2], [0, 2]], dtype=torch.int32, device=dev)
    ops.spmm(idx, torch.full((3, 2), 0.5, device=dev), s)
    ops.clip_scale_rows(s, 200, torch.ones(3, device=dev))
    ops.laplace_from_bits(torch.zeros(9, dtype=torch.uint32, device=dev), 1.0)
    q = torch.zeros((1, 5, 2, 64), device=dev)
    ops.flash_attention_bshd(q, q, q)
    assert ops.launch_counts() == {
        "l1_norm_rows": 1, "dpps_perturb_rows": 1, "noise_l1_rows": 1,
        "pushsum_mix": 1, "spmm": 1, "clip_scale_rows": 1,
        "laplace_from_bits": 1, "flash_attention": 1}
    with pytest.raises(TypeError):
        ops.l1_norm_rows(s.double(), 200)
    with pytest.raises(ValueError):
        ops.l1_norm_rows(s.t().contiguous().t(), 2)  # not contiguous
    with pytest.raises(ValueError):
        ops.dpps_perturb_rows(s, s, 1.0, 1.0, 300, seed=0, t=0)  # d_s > d_pad
    with pytest.raises(ValueError):  # W not (N, N)
        big = torch.zeros((33, 128), device=dev)
        ops.pushsum_mix(torch.eye(33, device=dev)[:, :32].contiguous(), big)
    with pytest.raises(ValueError):
        ops.pushsum_mix(torch.eye(3), s)  # W on the CPU, x on the card
    with pytest.raises(ValueError):
        ops.spmm(idx, torch.ones((3, 2), device=dev), s[:, :126])  # D % 4
    with pytest.raises(TypeError):
        ops.spmm(idx.long(), torch.ones((3, 2), device=dev), s)
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(q, q, q, window=0)
    with pytest.raises(TypeError):
        ops.flash_attention_bshd(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        ops.noise_l1_rows(s.double(), 200)
    assert sum(ops.launch_counts().values()) == 8


# Widths set from the card's SM count and the column tile at N, each on a
# stated side of ops.spmm_plan's threshold (D >= SMs * tile): (D, regime).
_SPMM_WIDTHS = {
    "tiles_min": lambda sms, tile: (sms * tile, "tiles"),
    "rows_max": lambda sms, tile: ((sms - 1) * tile, "rows"),
    # no multiple of the tile: the last tile is ragged
    "tiles_ragged": lambda sms, tile: (sms * tile + tile // 2 + 4, "tiles"),
}


@pytest.mark.parametrize("n,d", [
    (4, 7936), (24, 1024), (128, 7936), (4096, 8), (33, 12), (32, 7936),
    (24, "tiles_min"), (24, "rows_max"), (24, "tiles_ragged"),
    (32, "tiles_min"), (32, "rows_max"),
    (128, "tiles_min"), (128, "rows_max"), (128, "tiles_ragged"),
    (64, "tiles_min"), (1025, 4096)])
def test_spmm_matches_plain_and_the_dense_kernel(dev, n, d):
    """Both regimes of ``ops.spmm_plan`` (N = 1025 has no column tile: rows),
    each with the topology's own K and with 3 zero-weight pad slots more."""
    topo = ErdosRenyiGraph(n, p=min(1.0, 8 / n), seed=0)
    if isinstance(d, str):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        k = topo.max_in_degree(0)
        d, regime = _SPMM_WIDTHS[d](
            sms, ops.spmm_plan(n, k, 1 << 30, sms)["tile"])
        assert ops.spmm_plan(n, k, d, sms)["regime"] == regime
    w = topo.weight_matrix_torch(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, d), generator=gen, device=dev)
    for k in (None, topo.max_in_degree(0) + 3):
        idx, vals = topo.sparse_weights(0, k)
        idx = torch.as_tensor(idx, device=dev)
        vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        got = ops.spmm(idx, vals, x)
        torch.testing.assert_close(got, ref.spmm(idx, vals, x), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(got, ops.pushsum_mix(w, x))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,d_s", [(4, 7840), (3, 130), (24, 8192)])
def test_clip_scale_and_laplace_match_plain(dev, n, d_s):
    gen = torch.Generator(device=dev).manual_seed(d_s)
    buf = _rows(gen, dev, n, d_s)
    norms = ops.l1_norm_rows(buf, d_s)
    denom = torch.clamp_min(norms / norms.median(), 1.0)
    got = ops.clip_scale_rows(buf, d_s, denom)
    assert torch.equal(got, ref.clip_scale_rows(buf, d_s, denom))
    tree = {"a": buf[:, :d_s].reshape(n, -1, 2) if d_s % 2 == 0
            else buf[:, :d_s], "b": buf[:, :7].clone()}
    clipped, tree_norms = ops.l1_clip_tree(tree, 50.0)
    want, want_norms = ops.l1_clip_tree({k: v.cpu() for k, v in tree.items()},
                                        50.0)
    for k in tree:
        torch.testing.assert_close(clipped[k].cpu(), want[k], rtol=1e-6,
                                   atol=0)
    torch.testing.assert_close(tree_norms.cpu(), want_norms, rtol=1e-5,
                               atol=0)
    bits = torch.randint(0, 2 ** 32, (n * d_s + 3,), generator=gen,
                         device=dev, dtype=torch.int64)
    bits[:5] = 1 << 31  # the padding bits give exactly 0
    bits = bits.to(torch.uint32)
    scale = torch.tensor(0.7, device=dev)
    noise = ops.laplace_from_bits(bits, scale)
    torch.testing.assert_close(noise, ref.laplace_from_bits(bits, scale),
                               rtol=1e-6, atol=0)
    assert bool((noise[:5] == 0).all())
    torch.cuda.synchronize()


def test_session_on_the_card_matches_the_cpu(dev):
    """The same seeded consensus run with the kernels and with the plain
    versions: the Philox bits are the same, so the states agree to rounding
    (plus 1e-6 of the largest magnitude, for entries that are differences
    of much larger mixed terms)."""
    vals = torch.randn((6, 1000), generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cuda", "cpu"):
        session = Session.build(DOutGraph(6, 2), privacy=PrivacySpec(
            b=1.0, gamma_n=1e-5), schedule="dense", sync_interval=5,
            chunk=3, seed=1, device=device)
        out[device] = session.run(7, values={"x": vals})
    want = out["cpu"].state.push.s["x"]
    torch.testing.assert_close(out["cuda"].state.push.s["x"].cpu(), want,
                               rtol=1e-5, atol=1e-6 * want.abs().max().item())
    for k, v in out["cpu"].trajectory.items():
        torch.testing.assert_close(torch.as_tensor(out["cuda"].trajectory[k]),
                                   torch.as_tensor(v), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", ops.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("s,group,window", [
    (1, 1, None), (100, 4, None), (128, 1, 37), (300, 4, 1), (300, 1, 200),
    (257, 2, 64),
    # below one tile; one row past a multiple of BQ (64) and of BK (16, 32,
    # 64); windows of 1 and of exactly one key tile (BK: 32 at D = 64, 64
    # at D = 128, 16 at D = 256); groups 1, 4 and 8
    (17, 8, None), (65, 1, None), (65, 4, 64), (129, 8, 32), (97, 8, 1),
    (193, 1, 64), (161, 4, 32), (145, 8, 16),
    # a group of 5 (llama4's 40 query heads on 8 KV heads)
    (203, 5, None), (131, 5, 48)])
def test_flash_attention_matches_plain(dev, d, s, group, window):
    """Ragged S (no multiple of any tile), GQA groups, windows that cut
    inside a key tile and across several; both layouts, one launch each."""
    _flash_against_plain(dev, 2, s, 2, group, d, window)


@pytest.mark.parametrize("d,window", [(256, None), (64, None), (256, 512),
                                      (112, None)])
def test_flash_attention_matches_plain_over_many_key_tiles(dev, d, window):
    """B = 1, S = 4,096: the K/V ring's steady state over up to 256 key
    tiles a query tile, and a window of several tiles."""
    _flash_against_plain(dev, 1, 4096, 1, 4, d, window)


@pytest.mark.parametrize("kh,group,d", [(32, 1, 112), (8, 5, 128),
                                         (8, 4, 128)])
def test_flash_attention_at_the_4k_prefill_shapes(dev, kh, group, d):
    """The attention of zamba2-7b's shared block (H = K = 32, D = 112, a
    tile of its own), llama4-scout (H = 40, K = 8, D = 128) and
    llama-3.2-vision-11b's self layers (H = 32, K = 8) at a 4,096-token
    prompt: B = 1, causal."""
    _flash_against_plain(dev, 1, 4096, kh, group, d, None)


def _flash_against_plain(dev, b, s, kh, group, d, window):
    gen = torch.Generator(device=dev).manual_seed(s * d + group)
    q = torch.randn((b, s, kh * group, d), generator=gen, device=dev)
    k = torch.randn((b, s, kh, d), generator=gen, device=dev)
    v = torch.randn((b, s, kh, d), generator=gen, device=dev)
    ops.reset_launch_counts()
    got = ops.flash_attention_bshd(q, k, v, window=window)
    want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), group=group,
                               window=window).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    hsd = ops.flash_attention(q[0].transpose(0, 1).contiguous(),
                              k[0].transpose(0, 1).contiguous(),
                              v[0].transpose(0, 1).contiguous(), group=group,
                              window=window)
    torch.testing.assert_close(hsd, want[0].transpose(0, 1), rtol=1e-4,
                               atol=1e-5)
    assert ops.launch_counts()["flash_attention"] == 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("q0,h", [(3, 3), (5, 2), (7, 3), (4, 0)])
def test_flash_attention_at_a_head_offset(dev, q0, h):
    """A rank's run of llama4-scout's query heads (H = 40, K = 8, D = 128,
    a 1,000-token prompt): heads [3, 6) straddle GQA groups 0 and 1
    (``head0`` 3 into KV head 0's group), [5, 7) and [7, 10) sit in group
    1: one launch over exactly those heads and the KV heads they read,
    against the plain version at the same offset and against the whole
    model's attention cut to those heads; a rank of no heads launches
    nothing."""
    b, s, kh_all, group, d = 1, 1000, 8, 5, 128
    gen = torch.Generator(device=dev).manual_seed(q0 * 7 + h)
    q_all = torch.randn((b, s, kh_all * group, d), generator=gen, device=dev)
    k_all = torch.randn((b, s, kh_all, d), generator=gen, device=dev)
    v_all = torch.randn((b, s, kh_all, d), generator=gen, device=dev)
    k0 = q0 // group
    k1 = (q0 + h - 1) // group + 1 if h else k0
    q = q_all[:, :, q0:q0 + h].contiguous()
    k = k_all[:, :, k0:k1].contiguous()
    v = v_all[:, :, k0:k1].contiguous()
    ops.reset_launch_counts()
    got = ops.flash_attention_bshd(q, k, v, group=group,
                                   head0=q0 - k0 * group)
    assert ops.launch_counts()["flash_attention"] == (1 if h else 0)
    assert got.shape == q.shape
    if not h:
        return
    plain = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), group=group,
                                head0=q0 - k0 * group).transpose(1, 2)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
    whole = ref.flash_attention(q_all.transpose(1, 2), k_all.transpose(1, 2),
                                v_all.transpose(1, 2), group=group
                                ).transpose(1, 2)[:, :, q0:q0 + h]
    torch.testing.assert_close(got, whole, rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()


def test_flash_prefill_on_the_card_matches_the_cpu(dev):
    """A two-layer llama3.2-1b-shaped model (head_dim 64, the kernel's) with
    a local and a global layer: the card's flash prefill against the CPU's
    plain prefill, and the card's serve tokens against the CPU's under the
    same Gumbel noise."""
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").smoke, head_dim=64, flash_prefill=True,
        groups=(get_config("gemma3-1b").smoke.groups[0],))
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(1))
    noise = torch.randn((4, 2, cfg.vocab_size),
                        generator=torch.Generator().manual_seed(2))
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(device), params)
        session = Session.build(model=model, device=device)
        ops.reset_launch_counts()
        out[device] = session.serve(p, {"tokens": toks.to(device)}, gen=5,
                                    noise_at=lambda t: noise[t].to(device))
        if device == "cuda":
            assert ops.launch_counts()["flash_attention"] == 2
    torch.testing.assert_close(out["cuda"].logits.cpu(), out["cpu"].logits,
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"].tokens.cpu(), out["cpu"].tokens)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b", "xlstm-125m",
                                  "zamba2-7b", "llama-3.2-vision-11b"])
def test_other_group_kinds_serve_on_the_card_as_on_the_cpu(dev, arch):
    """The MoE, xLSTM, Zamba2 and VLM smoke models (plain prefill: their
    smoke head dims have no flash tile), the VLM's gates at 0.5: the card's
    prefill logits within rtol 1e-4 / atol 1e-4 of the CPU's, the same
    tokens under the same Gumbel noise."""
    cfg = get_config(arch).smoke
    model = Transformer(cfg)
    params = open_cross_gates(model.init(torch.Generator().manual_seed(0),
                                         device="cpu"))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)}
    enc = None
    if cfg.groups[0].kind == "cross_self":
        enc = torch.randn((2, cfg.groups[0].n_image_tokens, cfg.d_model),
                          generator=gen) * 0.1
        batch["image_embeds"] = enc
    noise = torch.randn((5, 2, cfg.vocab_size), generator=gen)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = Session.build(model=model, device=device).serve(
            tree_map(lambda x: x.to(device), params),
            {k: v.to(device) for k, v in batch.items()}, gen=6,
            noise_at=lambda t: noise[t].to(device),
            enc=None if enc is None else enc.to(device))
    torch.testing.assert_close(out["cuda"].logits.cpu(), out["cpu"].logits,
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"].tokens.cpu(), out["cpu"].tokens)


def test_transformer_training_on_the_card_matches_the_cpu(dev):
    """PartPSP of llama3.2-1b's smoke model (split point 1, N = 4, 3
    rounds, noise on from the same Philox stream): the card (kernels)
    against the CPU (plain versions). Trajectory within rtol 1e-4 plus 1e-6
    of each entry's largest magnitude; trained state within rtol 1e-4 plus
    1e-5 of each array's largest magnitude (an updated weight near zero
    carries the difference of its gradient's sums, which cuBLAS and the CPU
    add in other orders)."""
    cfg = get_config("llama3.2-1b").smoke
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 32),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cuda", "cpu"):
        session = Session.build(
            DOutGraph(4, 2), privacy=PrivacySpec(b=1.0, gamma_n=1e-7),
            model=model, params=tree_map(lambda x: x.to(device), params),
            partition=(("group_0/.*", ("split_layers", 1)),),
            schedule="dense", sync_interval=5, seed=3, device=device)
        ops.reset_launch_counts()
        rep = session.train(3, lambda t: {"tokens": toks.to(device)})
        if device == "cuda":
            counts = ops.launch_counts()
            assert counts["l1_norm_rows"] == 4 and counts["pushsum_mix"] == 3
            assert counts["dpps_perturb_rows"] == 3
            assert counts["flash_attention"] == 0
        state = rep.state
        out[device] = (rep.trajectory, [x.cpu() for x in
                                        tree_leaves(state.dpps.push.s)
                                        + list(state.local)])
    for k, want in out["cpu"][0].items():
        want = torch.as_tensor(want)
        torch.testing.assert_close(torch.as_tensor(out["cuda"][0][k]), want,
                                   rtol=1e-4,
                                   atol=1e-6 * want.abs().max().item())
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


# -- the pytree runtime's entry points ----------------------------------------

@pytest.mark.parametrize("col0", [0, 1, 2, 3, 7840, 7850, 7851])
@pytest.mark.parametrize("n,size", [(4, 10), (10, 7840), (3, 300_001),
                                    (4096, 7)])
def test_perturbation_at_col0_draws_the_packed_launchs_columns(dev, n, size,
                                                               col0):
    """A launch over one leaf that starts at wire column col0 against one
    launch over the packed row holding it there: s_noise bit for bit
    (col0 % 4 != 0 straddles two Philox counters a quad), and the plain
    version at col0 bit for bit too."""
    gen = torch.Generator(device=dev).manual_seed(n + size + col0)
    d_row = col0 + size
    d_pad = -(-d_row // 4) * 4
    s = torch.randn((n, d_pad), generator=gen, device=dev)
    eps = torch.randn((n, d_pad), generator=gen, device=dev)
    scale = torch.tensor(0.7, device=dev)
    whole = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_row, seed=5, t=3)
    leaf_pad = -(-size // 4) * 4
    ls = torch.zeros((n, leaf_pad), device=dev)
    le = torch.zeros((n, leaf_pad), device=dev)
    ls[:, :size], le[:, :size] = s[:, col0:d_row], eps[:, col0:d_row]
    got = ops.dpps_perturb_rows(ls, le, scale, 0.1, size, seed=5, t=3,
                                col0=col0)
    assert torch.equal(got[0][:, :size], whole[0][:, col0:d_row])
    assert torch.equal(got[0][:, size:], torch.zeros_like(got[0][:, size:]))
    plain = ref.dpps_perturb_rows(ls, le, scale, 0.1, size, seed=5, t=3,
                                  col0=col0)
    assert torch.equal(got[0], plain[0])
    for g, w in zip(got[1:], plain[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("lead,width,a,b,col0", [
    (64, 1024, 256, 512, 0),        # llama's runs: aligned, one counter
    (8, 4096, 1024, 3072, 4096),
    (6, 10, 3, 8, 5),               # run, off and col0 not multiples of 4
    (1000, 33, 11, 22, 1),          # runs of 11: quads across run ends
    (3, 100_003, 7, 100_000, 2),    # long rows: several blocks a row
])
def test_strided_perturbation_draws_the_whole_launchs_columns(dev, lead,
                                                              width, a, b,
                                                              col0):
    """A rank's block [a, b) of the last dim of a (lead, width) leaf at wire
    column col0, launched with its column map: s_noise bit for bit the
    whole leaf's launch at those columns and the plain version's; its
    noise norm bit for bit a bits-in launch fed the whole draw's bits at
    those columns, and within rtol 1e-5 of the plain version's."""
    n = 4
    size, part = lead * width, lead * (b - a)
    gen = torch.Generator(device=dev).manual_seed(size + a)
    s = torch.randn((n, -(-size // 4) * 4), generator=gen, device=dev)
    eps = torch.randn(s.shape, generator=gen, device=dev)
    scale = torch.tensor(0.7, device=dev)
    whole = ops.dpps_perturb_rows(s, eps, scale, 0.1, size, seed=5, t=3,
                                  col0=col0, node0=1)

    def cut(x):
        return x[:, :size].reshape(n, lead, width)[..., a:b].reshape(n, -1)

    ls, le = ops.leaf_rows(cut(s)), ops.leaf_rows(cut(eps))
    cmap = ref.ColumnMap(col0, b - a, width, a)
    got = ops.dpps_perturb_rows(ls, le, scale, 0.1, part, seed=5, t=3,
                                node0=1, col_map=cmap)
    assert torch.equal(got[0][:, :part], cut(whole[0]))
    plain = ref.dpps_perturb_rows(ls, le, scale, 0.1, part, seed=5, t=3,
                                  node0=1, col_map=cmap)
    assert torch.equal(got[0], plain[0])
    bits = ref.philox_map(5, 3, n, cmap, part, dev, node0=1)
    fed = ops.dpps_perturb_rows(ls, le, scale, 0.1, part,
                                bits=bits.to(torch.uint32).contiguous())
    for g, f in zip(got, fed):
        assert torch.equal(g, f)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-5, atol=0)


def test_perturbation_refuses_runs_under_a_quad(dev):
    s = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError, match="at least 4"):
        ops.dpps_perturb_rows(s, s, 1.0, 0.1, 6, seed=1, t=0,
                              col_map=ref.ColumnMap(0, 3, 7, 2))


def _leaves(dev, shapes, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((4,) + sh, generator=gen, device=dev) for sh in shapes]


TREE_SHAPES = [(784, 10), (10,), (10, 784), (7,), (3, 5), (2048, 8192)]


def test_tree_wrappers_match_their_plain_versions(dev):
    """One launch a leaf (aligned leaves as views, the others padded):
    l1_norm_tree to rtol 1e-5; dpps_perturb_tree's s_noise bit for bit and
    the packed launch's too, its norms to rtol 1e-5; laplace_noise_like to
    rtol 1e-6 (logf against the CPU's log)."""
    s, eps = _leaves(dev, TREE_SHAPES), _leaves(dev, TREE_SHAPES, 1)
    scale = torch.tensor(0.7, device=dev)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.l1_norm_tree(s), ref.l1_norm_tree(s),
                               rtol=1e-5, atol=0)
    got, g_eps, g_noise = ops.dpps_perturb_tree(s, eps, scale, 0.1, seed=5,
                                               t=3)
    want, w_eps, w_noise = ref.dpps_perturb_tree(s, eps, scale, 0.1, seed=5,
                                                t=3)
    counts = ops.launch_counts()
    assert counts["l1_norm_rows"] == counts["dpps_perturb_rows"] == len(s)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
    for g, w in ((g_eps, w_eps), (g_noise, w_noise)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    d_s = sum(x[0].numel() for x in s)
    packed = ops.dpps_perturb_rows(
        torch.cat([x.reshape(4, -1) for x in s], 1),
        torch.cat([x.reshape(4, -1) for x in eps], 1), scale, 0.1, d_s,
        seed=5, t=3)[0]
    assert torch.equal(torch.cat([x.reshape(4, -1) for x in got], 1), packed)
    for x, c0 in zip(s, ref.leaf_columns(s)):
        torch.testing.assert_close(
            ops.laplace_noise_like(x, scale, seed=5, t=3, col0=c0),
            ref.laplace_noise_like(x, scale, seed=5, t=3, col0=c0),
            rtol=1e-6, atol=1e-6)


def test_half_leaves_take_the_kernels_as_f32_rows(dev):
    """A bf16 leaf (the shared state of a bf16-parameter plan) goes to the
    row kernels as f32 rows, as the reference's kernels compute a bf16
    leaf: the norms and the perturbation equal those of the leaves cast to
    f32, bit for bit, one launch a leaf."""
    half = [x.to(torch.bfloat16) for x in _leaves(dev, TREE_SHAPES)]
    s32, eps = [x.float() for x in half], _leaves(dev, TREE_SHAPES, 1)
    scale = torch.tensor(0.7, device=dev)
    ops.reset_launch_counts()
    assert torch.equal(ops.l1_norm_tree(half), ops.l1_norm_tree(s32))
    assert torch.equal(ops.noise_l1_tree(half), ops.noise_l1_tree(s32))
    got = ops.dpps_perturb_tree(half, eps, scale, 0.1, seed=5, t=3)
    want = ops.dpps_perturb_tree(s32, eps, scale, 0.1, seed=5, t=3)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    counts = ops.launch_counts()
    assert counts["l1_norm_rows"] == counts["dpps_perturb_rows"] \
        == counts["noise_l1_rows"] == 2 * len(half)


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_tree_gossip_launches_a_mix_a_leaf(dev, schedule):
    """gossip_dense / gossip_sparse with use_kernels against the plain mix
    (rtol 1e-5 / atol 1e-6, the mix kernels' tolerance above)."""
    from repro_torch.core.pushsum import (PushSumState, gossip_dense,
                                          gossip_sparse)
    topo = ErdosRenyiGraph(4, p=0.9, seed=0)
    s = _leaves(dev, TREE_SHAPES[:5])
    a = torch.ones(4, device=dev)
    ops.reset_launch_counts()
    if schedule == "dense":
        w = topo.weight_matrix_torch(0, device=dev)
        got = gossip_dense(PushSumState(s, a), w, use_kernels=True)
        want = gossip_dense(PushSumState(s, a), w)
    else:
        idx, vals = (torch.as_tensor(x, device=dev)
                     for x in topo.sparse_weights(0))
        vals = vals.to(torch.float32)
        got = gossip_sparse(PushSumState(s, a), idx, vals, use_kernels=True)
        want = gossip_sparse(PushSumState(s, a), idx, vals)
    kernel = "pushsum_mix" if schedule == "dense" else "spmm"
    assert ops.launch_counts()[kernel] == len(s)
    for g, w in zip(got.s, want.s):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# -- faults and bounded delays on the card ------------------------------------

def _mlp_session(dev, schedule, packed, noise, **models):
    from repro_torch.models.mlp import PARTITIONS, init_mlp, mlp_loss

    return Session.build(
        ErdosRenyiGraph(16, p=0.4, seed=1), privacy=PrivacySpec(
            b=1.0, gamma_n=1e-5, noise=noise, c_prime=0.8, lam=0.6),
        model=mlp_loss, params=init_mlp(torch.Generator().manual_seed(0)),
        partition=PARTITIONS["partpsp-2"], schedule=schedule, packed=packed,
        sync_interval=0, seed=7, device=dev, **models)


def _batches(dev, n=16, steps=4):
    from repro_torch.models.mlp import D_IN, N_CLASSES

    gen = torch.Generator().manual_seed(1)
    return [(torch.randn((n, 8, D_IN), generator=gen).to(dev),
             torch.randint(0, N_CLASSES, (n, 8), generator=gen).to(dev))
            for _ in range(steps)]


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_realized_weights_mix_through_the_kernels(dev, schedule):
    """A faulted round's realized W through ``pushsum_mix`` bit for bit
    against its plain version (N <= 32: one fma chain a column in both);
    the realized edge-list values through ``spmm`` to rtol 1e-6 / atol
    1e-6 and bit for bit against ``pushsum_mix`` on the same weights; the
    realization twice the same bits (the deterministic segment sum)."""
    from repro_torch.core.topology import padded_csr
    from repro_torch.net import FaultModel

    fm = FaultModel(drop_rate=0.3, straggler_rate=0.1, churn=((2, 1, 3),))
    w_np = ErdosRenyiGraph(24, p=0.3, seed=2).weight_matrix(0).astype(
        "float32")
    x = torch.randn((24, 8192), generator=torch.Generator().manual_seed(3))
    x = x.to(dev)
    w, _ = fm.realize(torch.from_numpy(w_np).to(dev), 2, seed=5)
    assert torch.equal(ops.pushsum_mix(w, x), ref.pushsum_mix(w, x))
    if schedule == "sparse":
        idx, vals = padded_csr(w_np, int((w_np > 0).sum(1).max()))
        idx = torch.from_numpy(idx).to(dev, torch.int32)
        vals = torch.from_numpy(vals).to(dev, torch.float32)
        real, _ = fm.realize_sparse(idx, vals, 2, seed=5)
        again, _ = fm.realize_sparse(idx, vals, 2, seed=5)
        assert torch.equal(real, again)
        dense = torch.zeros((24, 24), device=dev).index_put_(
            (torch.arange(24, device=dev)[:, None].expand_as(idx),
             idx.long()), real, accumulate=True)
        got = ops.spmm(idx, real, x)
        torch.testing.assert_close(got, ref.spmm(idx, real, x), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(got, ops.pushsum_mix(dense, x))


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_async_packed_and_pytree_and_loop_bit_equal_on_the_card(dev,
                                                                schedule):
    """Delays with faults, noise off: the packed engine, the pytree engine
    and the loop give the same bits (each delay slot one kernel launch a
    buffer or a leaf, one fma chain an output in sender order); noise on:
    the masks, ``a`` and the async rows bit for bit, the state to rtol
    1e-4 (the norms sum a leaf at a time in the pytree runtime)."""
    from repro_torch.net import DelayModel, FaultModel

    models = dict(delays=DelayModel(max_delay=2, timeout_rate=0.1,
                                    rates=(1, 2) * 8),
                  faults=FaultModel(drop_rate=0.2))
    batches = _batches(dev)
    for noise in (False, True):
        reps = []
        for packed, driver in ((True, "engine"), (False, "engine"),
                               (True, "loop")):
            session = _mlp_session(dev, schedule, packed, noise, **models)
            reps.append(session.train(4, lambda t: batches[t],
                                      driver=driver))
        base = reps[0]
        for rep in reps[1:]:
            assert torch.equal(rep.state.dpps.push.a, base.state.dpps.push.a)
            for k, v in base.trajectory.items():
                if k.startswith(("net_", "async_")) or k in ("a_min",
                                                             "a_max"):
                    assert (rep.trajectory[k] == v).all(), k
            for x, y in zip(tree_leaves(rep.state), tree_leaves(base.state)):
                if not isinstance(x, torch.Tensor):
                    assert x == y
                elif noise:
                    torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)
                else:
                    assert torch.equal(x, y)


def _consensus_reps(devices, *, spec=None, mechanism=None, packed=True,
                    schedule="dense", rounds=6, n=8, d=300):
    """A seeded consensus run of each device: the same values, the same
    Philox streams (noise bits, int8 uniforms)."""
    from repro_torch.wire import parse_wire_spec

    vals = torch.randn((n, d), generator=torch.Generator().manual_seed(4))
    reps = {}
    for device in devices:
        session = Session.build(
            ErdosRenyiGraph(n, p=0.5, seed=1) if schedule == "sparse"
            else DOutGraph(n, 2), privacy=PrivacySpec(
                b=5.0, gamma_n=1e-3, mechanism=mechanism, c_prime=0.8,
                lam=0.6), schedule=schedule, sync_interval=4, chunk=3,
            seed=11, packed=packed, device=device,
            wire=parse_wire_spec(spec) if spec else None)
        reps[str(device)] = session.run(
            rounds, values={"x": vals[:, :d // 2].contiguous(),
                            "y": vals[:, d // 2:].contiguous()})
    return reps


@pytest.mark.parametrize("schedule", ["dense", "sparse", "circulant"])
@pytest.mark.parametrize("spec", ["int8", "topk:1/16", "bf16"])
def test_codec_rounds_on_the_card_match_the_cpu(dev, spec, schedule):
    """The codecs' rounds on the card (kernels; the int8 uniforms from the
    same Philox words) against the CPU: the state to rtol 1e-5 plus 1e-6
    of its largest magnitude, except where the card's logf (an ulp from
    the CPU's log) or the kernels' summation order moves a value across a
    rounding boundary: an int8 entry may then differ by one quantum,
    max|row| / 127, a bf16 one by one bf16 step, max|s| 2^-8. Such entries
    are counted and bounded: none for int8, 1 % of the entries for bf16 (a
    crossing's quantum reaches the receivers of the later rounds' mixes:
    8 of these 2,400 entries on the sparse schedule, on an H100)."""
    reps = _consensus_reps([dev, "cpu"], spec=spec, schedule=schedule)
    card, cpu = reps[str(dev)], reps["cpu"]
    off = entries = 0
    for k in ("x", "y"):
        got, want = card.state.push.s[k].cpu(), cpu.state.push.s[k]
        lim = 1e-6 * want.abs().max().item()
        quantum = {"int8": 1.0 / 127.0, "bf16": 2.0 ** -8}.get(spec, 0.0) * \
            float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=lim + quantum)
        off += int(((got - want).abs() > 1e-5 * want.abs() + lim).sum())
        entries += want.numel()
    assert off <= int({"bf16": 1e-2}.get(spec, 0.0) * entries), off
    torch.testing.assert_close(card.state.push.a.cpu(), cpu.state.push.a,
                               rtol=1e-6, atol=1e-6)
    if spec.startswith("topk"):
        assert card.state.resid.device.type == "cuda"


def test_noise_l1_rows_is_the_fused_perturbations_eps_norm(dev):
    """A norm-only launch of dpps_perturb.cu sums as the perturbation sums
    its eps: bit for bit, and the L1 norm to rtol 1e-5."""
    z = torch.randn((4, 1024), device=dev)
    zero = torch.zeros((), device=dev)
    want = ops.dpps_perturb_rows(z, z, zero, 0.0, 1000, seed=0, t=0)[1]
    got = ops.noise_l1_rows(z, 1000)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, z[:, :1000].abs().sum(dim=1), rtol=1e-5,
                               atol=0)


def test_compress_first_codec_runs_on_the_kernels(dev):
    """The compress-first codec on the kernel route: its down-scaled noise
    drawn through laplace_noise.cu with its norm apart, no fused
    perturbation, the mix kernel; the state against the CPU as the int8
    codec's (a quantum at most, on at most 0.1 % of the entries)."""
    ops.reset_launch_counts()
    reps = _consensus_reps([dev], spec="broken-compress-first")
    counts = ops.launch_counts()
    assert counts["laplace_from_bits"] == 6 and counts["noise_l1_rows"] == 6
    assert counts["dpps_perturb_rows"] == 0
    assert counts["pushsum_mix"] == 5  # round 3 is a sync round
    reps.update(_consensus_reps(["cpu"], spec="broken-compress-first"))
    card, cpu = reps[str(dev)], reps["cpu"]
    off = entries = 0
    for k in ("x", "y"):
        got, want = card.state.push.s[k].cpu(), cpu.state.push.s[k]
        lim = 1e-6 * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=lim + float(
            want.abs().max()) / 127.0)
        off += int(((got - want).abs() > 1e-5 * want.abs() + lim).sum())
        entries += want.numel()
    assert off <= int(1e-3 * entries), off


def test_bf16_rounds_launch_no_mix(dev):
    from repro_torch.wire import Bf16Codec

    session = Session.build(DOutGraph(8, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=1e-3), schedule="dense", seed=1, wire=Bf16Codec())
    ops.reset_launch_counts()
    session.run(3, values={"x": torch.randn((8, 4096), device=dev)})
    counts = ops.launch_counts()
    assert counts["pushsum_mix"] == 0 and counts["spmm"] == 0
    assert counts["dpps_perturb_rows"] == 3 and counts["l1_norm_rows"] == 4


@pytest.mark.parametrize("packed", [True, False])
def test_laplace_mechanism_is_bit_for_bit_no_mechanism_on_the_card(dev,
                                                                   packed):
    """The mechanism's draw goes through laplace_noise.cu, its noise norm
    in the fused perturbation's order: scale factor 1 keeps
    ``mechanism=None``'s state and rows bit for bit."""
    ops.reset_launch_counts()
    mech = _consensus_reps([dev], mechanism="laplace", packed=packed)
    counts = ops.launch_counts()
    assert counts["laplace_from_bits"] == 6  # one a round
    # the noise norm: one launch a round a buffer (packed) or leaf (x, y),
    # counted apart from the perturbations, of which there are none
    assert counts["noise_l1_rows"] == (6 if packed else 12)
    assert counts["dpps_perturb_rows"] == 0
    none = _consensus_reps([dev], packed=packed)
    a, b = mech[str(dev)], none[str(dev)]
    for k in ("x", "y"):
        assert torch.equal(a.state.push.s[k], b.state.push.s[k])
    for k, v in b.trajectory.items():
        assert (a.trajectory[k] == v).all(), k


@pytest.mark.parametrize("name", ["gaussian", "graph_homomorphic",
                                  "broken_laplace"])
def test_mechanisms_on_the_card_match_the_cpu(dev, name):
    reps = _consensus_reps([dev, "cpu"], mechanism=name)
    card, cpu = reps[str(dev)], reps["cpu"]
    for k in ("x", "y"):
        want = cpu.state.push.s[k]
        torch.testing.assert_close(card.state.push.s[k].cpu(), want,
                                   rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())


def test_audit_battery_on_the_card_holds_the_claims(dev):
    """The default Laplace through dpps_perturb.cu and the three other
    mechanisms at 400 trials: the fig5 claims."""
    from repro_torch.audit import (GLOBAL_OBSERVER, LOCAL_EAVESDROPPER,
                                   THREAT_MODELS, AuditConfig,
                                   distinguishing_attack, get_mechanism)

    audit = AuditConfig(trials=400, seed=0)
    flag = {(m, t.name): distinguishing_attack(
        t, mechanism=get_mechanism(m) if m != "default" else None,
        audit=audit).flagged
        for m in ("default", "graph_homomorphic", "broken_laplace")
        for t in THREAT_MODELS}
    assert not any(flag[("default", t.name)] for t in THREAT_MODELS)
    assert any(flag[("broken_laplace", t.name)] for t in THREAT_MODELS)
    assert not flag[("graph_homomorphic", LOCAL_EAVESDROPPER.name)]
    assert flag[("graph_homomorphic", GLOBAL_OBSERVER.name)]


# -- the observability layer on the card ---------------------------------------

# a device kernel's name (demangled by the profiler) -> the phase its launch
# must fall in (the reference's layout; PERF.md's kernel table)
KERNEL_PHASES = {"l1_norm_kernel": "dpps_perturb",
                 "perturb_kernel": "dpps_noise",
                 "mix_kernel": "dpps_gossip", "mix_tile_kernel": "dpps_gossip",
                 "spmm_rows_kernel": "dpps_gossip",
                 "spmm_tiles_kernel": "dpps_gossip"}


def _kernel_of(name: str) -> str | None:
    import re

    for k in KERNEL_PHASES:
        if re.search(rf"\b{k}\b", name):
            return k
    return None


def profile_phases_run(schedule: str) -> dict:
    """The runs of :func:`test_profile_attributes_each_kernel_launch_to_
    its_phase` in the calling process: ``Session.profile(3)`` from a state,
    then ``run(3)`` under ``torch.profiler``; returns what the test checks
    (JSON-ready)."""
    from repro_torch.obs.trace import attribute

    dev = torch.device("cuda", 0)
    topo = DOutGraph(5, 2) if schedule == "dense" else ErdosRenyiGraph(
        24, p=8 / 24, seed=0)
    session = Session.build(topo, privacy=PrivacySpec(b=5.0, gamma_n=1e-4),
                            schedule=schedule, sync_interval=0, seed=3)
    n = topo.n_nodes
    values = {"x": torch.randn((n, 300_001), device=dev)}
    state = session.consensus_state(values)
    before = state.push.s["x"].clone()
    report = session.profile(3, state=state)
    unchanged = torch.equal(state.push.s["x"], before)
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        session.run(3, values=values)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    kernels = [[_kernel_of(name), where]
               for name, where, _ in attribute(prof.events(), device="cuda")[0]
               if _kernel_of(name) is not None]
    return dict(note=report.note, backend=report.backend,
                unchanged=unchanged, phases=report.phases,
                device_total_s=report.device_total_s, kernels=kernels,
                counts=counts)


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_profile_attributes_each_kernel_launch_to_its_phase(dev, schedule):
    """The profile's breakdown and every kernel launch's phase. The runs
    go in a fresh process (:func:`profile_phases_run` under ``python
    -c``), as ``chip_smoke.py`` runs its phase 28: torch's profiler on the
    card drops device events in a process that has run for minutes, while
    the wrappers' launch counts show the kernels ran (PERF.md §7;
    ``chip_smoke.py`` phase 35's probe). The checks are unchanged."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_cuda as t; "
            "print(json.dumps(t.profile_phases_run(sys.argv[2])))")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(pathlib.Path(__file__).parent),
         schedule], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["note"] is None and r["backend"] == "torch-cuda"
    assert r["unchanged"]
    assert sum(r["phases"].values()) == pytest.approx(
        r["device_total_s"], rel=1e-9)
    for name in ("dpps_perturb", "dpps_noise", "dpps_gossip"):
        assert r["phases"].get(name, 0.0) > 0.0, (name, r["phases"])
    counts = r["counts"]
    found = {}
    for k, where in r["kernels"]:
        # round 0's norm of s^(0) is the sensitivity's init, as in the
        # reference's layout
        want = ("dpps_sensitivity" if k == "l1_norm_kernel"
                and found.get(k, 0) == 1 else KERNEL_PHASES[k])
        assert where == want, (k, where)
        found[k] = found.get(k, 0) + 1
    mix = "pushsum_mix" if schedule == "dense" else "spmm"
    assert found.get("l1_norm_kernel") == counts["l1_norm_rows"] == 4
    assert found.get("perturb_kernel") == counts["dpps_perturb_rows"] == 3
    assert sum(v for k, v in found.items() if "mix" in k or "spmm" in k) \
        == counts[mix] == 3


def test_strict_watchdog_aborts_on_a_nan_on_the_card(dev):
    from repro_torch.obs import MetricsBus, WatchdogHook

    session = Session.build(DOutGraph(5, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=1e-4), schedule="dense", chunk=2, seed=3)
    x = torch.randn((5, 4096), device=dev)
    x[2, 7] = float("nan")
    hook = WatchdogHook(strict=True, warn=lambda m: None, bus=MetricsBus())
    report = session.run(6, values={"x": x}, hooks=[hook])
    assert report.aborted and report.rounds == 2
    assert report.abort_reason.startswith("watchdog critical")
    first = hook.alerts[0]
    assert (first.check, first.round, first.severity) == (
        "nonfinite_wire", 0, "critical")


def test_phase_opens_no_record_function_outside_a_profiler(dev, monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    session = Session.build(DOutGraph(5, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=1e-4), schedule="dense", seed=3)
    values = {"x": torch.randn((5, 4096), device=dev)}
    session.run(3, values=values)
    torch.cuda.synchronize()
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        session.run(3, values=values)
    assert {"dpps_perturb", "dpps_noise", "dpps_gossip"} <= set(opened)


# -- row blocks: a rank's launches in the sharded engine -----------------------

def _blocks(n):
    """(B, first row) blocks of N rows: B in {1, 3, N - 1}, at the first,
    an inner and the last rows."""
    out = []
    for b in (1, 3, n - 1):
        out += [(b, 0), (b, (n - b) // 2), (b, n - b)]
    return out


@pytest.mark.parametrize("n", [24, 64])  # the template mix, and the tiles
@pytest.mark.parametrize("d", [1000, 32_768])
def test_mix_row_blocks_are_the_rows_of_the_full_launch(dev, n, d):
    """``pushsum_mix`` with W (B, N) and ``spmm`` with (B, K) slots give the
    same rows of the whole launch, bit for bit (one chain an output), under
    both spmm regimes (D = 1000 rows, 32,768 column tiles)."""
    from repro_torch.core.topology import padded_csr

    gen = torch.Generator(device=dev).manual_seed(n * d)
    w = torch.rand((n, n), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    full = ops.pushsum_mix(w, x)
    w_np = ErdosRenyiGraph(n, p=8 / n, seed=1).weight_matrix(0)
    idx, vals = padded_csr(w_np, int((w_np > 0).sum(1).max()))
    idx = torch.as_tensor(idx, device=dev)
    vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    sparse = ops.spmm(idx, vals, x)
    for b, r0 in _blocks(n):
        rows = slice(r0, r0 + b)
        assert torch.equal(ops.pushsum_mix(w[rows], x), full[rows]), (b, r0)
        assert torch.equal(ops.spmm(idx[rows], vals[rows], x),
                           sparse[rows]), (b, r0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ops.spmm_plan(n, idx.shape[1], d, sms)["regime"] == (
        "rows" if d == 1000 else "tiles")
    assert ops.mix_plan(n, d, sms)["kernel"] == (
        "template" if n <= ops.MIX_TEMPLATE_NODES else "tiles")


@pytest.mark.parametrize("n,d_s", [(24, 7840), (64, 300_001)])
def test_perturbation_row_blocks_draw_the_rows_of_the_full_launch(dev, n,
                                                                  d_s):
    """The Philox draw keyed at ``node0`` gives the same rows of the whole
    launch, bit for bit, at short rows and long (several blocks a row)."""
    gen = torch.Generator(device=dev).manual_seed(n + d_s)
    s, eps = _rows(gen, dev, n, d_s), _rows(gen, dev, n, d_s)
    scale = torch.tensor(0.7, device=dev)
    full = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=5, t=3)
    for b, r0 in _blocks(n):
        rows = slice(r0, r0 + b)
        part = ops.dpps_perturb_rows(s[rows], eps[rows], scale, 0.1, d_s,
                                     seed=5, t=3, node0=r0)
        for whole, got in zip(full, part):
            assert torch.equal(got, whole[rows]), (b, r0)
