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
to rtol 1e-5 / atol 1e-6 (fma in j order against cuBLAS's order). The
sparse mix to rtol 1e-6 / atol 1e-6 (fma against the plain version's
separate multiply and add), and bit for bit against the dense kernel on a
topology's own CSR; the clip scale exactly (one correctly rounded
division); the Laplace transform to rtol 1e-6 (logf against the CPU's
log, an ulp).
"""
from __future__ import annotations

import pytest
import torch

import dataclasses

from repro_torch.api import PrivacySpec, Session
from repro_torch.configs import get_config
from repro_torch.core.topology import DOutGraph
from repro_torch.core.tree_utils import tree_map
from repro_torch.kernels import ops, ref
from repro_torch.models.transformer import Transformer
from repro_torch.net import ErdosRenyiGraph

pytestmark = pytest.mark.requires_cuda

SHAPES = [(n, d_s) for n in (4, 10) for d_s in (7840, 8192, 3)]


@pytest.fixture
def dev():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows(gen, dev, n, d_s):
    d_pad = -(-d_s // 128) * 128
    x = torch.randn((n, d_pad), generator=gen, device=dev)
    x[:, d_s:] = 0
    return x


@pytest.mark.parametrize("n,d_s", SHAPES)
def test_kernels_match_plain(dev, n, d_s):
    gen = torch.Generator(device=dev).manual_seed(n * d_s)
    s, eps = _rows(gen, dev, n, d_s), _rows(gen, dev, n, d_s)
    scale = torch.tensor(0.7, device=dev)
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


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(dev):
    s = torch.zeros((3, 256), device=dev)
    ops.reset_launch_counts()
    ops.l1_norm_rows(s, 200)
    ops.dpps_perturb_rows(s, s, 1.0, 1.0, 200, seed=0, t=0)
    ops.pushsum_mix(torch.eye(3, device=dev), s)
    idx = torch.tensor([[0, 1], [1, 2], [0, 2]], dtype=torch.int32, device=dev)
    ops.spmm(idx, torch.full((3, 2), 0.5, device=dev), s)
    ops.clip_scale_rows(s, 200, torch.ones(3, device=dev))
    ops.laplace_from_bits(torch.zeros(9, dtype=torch.uint32, device=dev), 1.0)
    q = torch.zeros((1, 5, 2, 64), device=dev)
    ops.flash_attention_bshd(q, q, q)
    assert ops.launch_counts() == {
        "l1_norm_rows": 1, "dpps_perturb_rows": 1, "pushsum_mix": 1,
        "spmm": 1, "clip_scale_rows": 1, "laplace_from_bits": 1,
        "flash_attention": 1}
    with pytest.raises(TypeError):
        ops.l1_norm_rows(s.double(), 200)
    with pytest.raises(ValueError):
        ops.l1_norm_rows(s.t().contiguous().t(), 2)  # not contiguous
    with pytest.raises(ValueError):
        ops.dpps_perturb_rows(s, s, 1.0, 1.0, 300, seed=0, t=0)  # d_s > d_pad
    with pytest.raises(ValueError):
        big = torch.zeros((33, 128), device=dev)
        ops.pushsum_mix(torch.eye(33, device=dev), big)
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
    assert sum(ops.launch_counts().values()) == 7


# Widths set from the card's SM count and the column tile at N, each on a
# stated side of ops.spmm_plan's threshold (D >= SMs * tile): (D, regime).
_SPMM_WIDTHS = {
    "tiles_min": lambda sms, tile: (sms * tile, "tiles"),
    "rows_max": lambda sms, tile: ((sms - 1) * tile, "rows"),
    # no multiple of the tile: the last tile is ragged
    "tiles_ragged": lambda sms, tile: (sms * tile + tile // 2 + 4, "tiles"),
}


@pytest.mark.parametrize("n,d", [
    (4, 7936), (24, 1024), (128, 7936), (4096, 8), (33, 12),
    (24, "tiles_min"), (24, "rows_max"), (24, "tiles_ragged"),
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
        if n <= ops.MAX_MIX_NODES:
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
    (193, 1, 64), (161, 4, 32), (145, 8, 16)])
def test_flash_attention_matches_plain(dev, d, s, group, window):
    """Ragged S (no multiple of any tile), GQA groups, windows that cut
    inside a key tile and across several; both layouts, one launch each."""
    _flash_against_plain(dev, 2, s, 2, group, d, window)


@pytest.mark.parametrize("d,window", [(256, None), (64, None), (256, 512)])
def test_flash_attention_matches_plain_over_many_key_tiles(dev, d, window):
    """B = 1, S = 4,096: the K/V ring's steady state over up to 256 key
    tiles a query tile, and a window of several tiles."""
    _flash_against_plain(dev, 1, 4096, 1, 4, d, window)


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
