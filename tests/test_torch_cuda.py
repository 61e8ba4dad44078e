"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``requires_cuda`` and skips where there is no
card. On a GPU machine (which needs no JAX for this file):

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: the fused perturb agrees elementwise to rtol 1e-6 / atol 1e-6
(the card's logf may differ from the CPU's log by an ulp); row sums to
rtol 1e-5 (per-block partials against PyTorch's reduction order); the mix
to rtol 1e-5 / atol 1e-6 (fma in j order against cuBLAS's order).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.api import PrivacySpec, Session
from repro_torch.core.topology import DOutGraph
from repro_torch.kernels import ops, ref

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
    assert ops.launch_counts() == {"l1_norm_rows": 1, "dpps_perturb_rows": 1,
                                   "pushsum_mix": 1}
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
    assert sum(ops.launch_counts().values()) == 3


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
