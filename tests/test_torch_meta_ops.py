"""The kernel wrappers' meta paths (``repro_torch.kernels.ops``), on the CPU.

On meta tensors each wrapper checks its inputs as it does on the card,
returns empty outputs of its kernel's shapes and dtypes, and charges the
active cost count (``repro_torch.launch.op_analysis``) one launch (its
``launches``; ``ops.launch_counts`` keeps counting what a card ran) with its
kernel's FLOPs and bytes (``ops.kernel_cost``: the reckoning of each
kernel's bound in ``PERF.md`` §6). The tree entry points reach them one
launch a leaf. The device routing takes meta as the card's.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.device import resolve_use_kernels
from repro_torch.kernels import ops
from repro_torch.launch.op_analysis import analyze_step

N, D_S, D_PAD = 5, 100, 128


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _scale():
    return _meta(())


# name -> (call, expected outputs (shape, dtype), kernel_cost dims)
CASES = {
    "l1_norm_rows": (lambda: ops.l1_norm_rows(_meta((N, D_PAD)), D_S),
                     [((N,), torch.float32)], dict(n=N, d_s=D_S)),
    "dpps_perturb_rows": (
        lambda: ops.dpps_perturb_rows(_meta((N, D_PAD)), _meta((N, D_PAD)),
                                      _scale(), 0.1, D_S, seed=3, t=2),
        [((N, D_PAD), torch.float32), ((N,), torch.float32),
         ((N,), torch.float32)], dict(n=N, d_s=D_S, d_pad=D_PAD)),
    "dpps_perturb_rows_bits": (
        lambda: ops.dpps_perturb_rows(_meta((N, D_PAD)), _meta((N, D_PAD)),
                                      _scale(), 0.1, D_S,
                                      bits=_meta((N, D_S), torch.uint32)),
        [((N, D_PAD), torch.float32), ((N,), torch.float32),
         ((N,), torch.float32)], dict(n=N, d_s=D_S, d_pad=D_PAD, bits=True)),
    "noise_l1_rows": (lambda: ops.noise_l1_rows(_meta((N, D_PAD)), D_S),
                      [((N,), torch.float32)],
                      dict(n=N, d_s=D_S, d_pad=D_PAD)),
    "pushsum_mix": (lambda: ops.pushsum_mix(_meta((N, N)), _meta((N, 300))),
                    [((N, 300), torch.float32)], dict(n=N, d=300)),
    "spmm": (lambda: ops.spmm(_meta((N, 3), torch.int32), _meta((N, 3)),
                              _meta((N, D_PAD))),
             [((N, D_PAD), torch.float32)], dict(n=N, d=D_PAD, k=3)),
    "clip_scale_rows": (
        lambda: ops.clip_scale_rows(_meta((N, D_PAD)), D_S, _meta((N,))),
        [((N, D_PAD), torch.float32)], dict(n=N, d_s=D_S, d_pad=D_PAD)),
    "laplace_from_bits": (
        lambda: ops.laplace_from_bits(_meta((1000,), torch.uint32), _scale()),
        [((1000,), torch.float32)], dict(m=1000)),
    "flash_attention": (
        lambda: ops.flash_attention(_meta((8, 300, 64)), _meta((2, 300, 64)),
                                    _meta((2, 300, 64)), group=4, window=100),
        [((8, 300, 64), torch.float32)],
        dict(b=1, s=300, h=8, kh=2, d=64, window=100)),
    "flash_attention_bshd": (
        lambda: ops.flash_attention_bshd(_meta((2, 300, 8, 128)),
                                         _meta((2, 300, 2, 128)),
                                         _meta((2, 300, 2, 128))),
        [((2, 300, 8, 128), torch.float32)],
        dict(b=2, s=300, h=8, kh=2, d=128, window=-1)),
}


def _counted(fn):
    """The launches charged while ``fn()`` runs under a cost count."""
    return analyze_step(fn, arch="a", shape="s", nodes=1,
                        model_flops=0.0).launches


def _kernel(case: str) -> str:
    return {"dpps_perturb_rows_bits": "dpps_perturb_rows",
            "flash_attention_bshd": "flash_attention"}.get(case, case)


@pytest.mark.parametrize("case", CASES)
def test_meta_path_shapes_and_launch(case):
    call, want, _ = CASES[case]
    ops.reset_launch_counts()
    out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == want
    assert all(o.device.type == "meta" for o in outs)
    assert _counted(call) == {_kernel(case): 1}
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("case", CASES)
def test_meta_path_charges_its_bound_reckoning(case):
    call, _, dims = CASES[case]
    flops, nbytes = ops.kernel_cost(_kernel(case), **dims)
    terms = analyze_step(lambda: call(), arch="a", shape="s", nodes=1,
                         model_flops=0.0)
    assert terms.launches == {_kernel(case): 1}
    assert (terms.kernel_flops, terms.kernel_bytes) == (flops, nbytes)
    assert flops > 0 and nbytes > 0


def test_kernel_cost_is_the_bound_reckoning():
    """The reckonings beside each bound in ``chip_smoke.py`` / ``PERF.md``
    §6, at the dense full width (5, 505,956,352) and llama's 32k prefill."""
    n, d = 5, 505_956_352
    assert ops.kernel_cost("l1_norm_rows", n=n, d_s=d) == \
        (2.0 * n * d, 4.0 * n * d + 4 * n)
    assert ops.kernel_cost("dpps_perturb_rows", n=n, d_s=d, d_pad=d) == \
        (17.0 * n * d, 8.0 * n * d + 4.0 * n * d + 8 * n + 4)
    assert ops.kernel_cost("pushsum_mix", n=n, d=d) == \
        (2.0 * n * n * d, 8.0 * n * d + 4.0 * n * n)
    s = 32_768
    flops, nbytes = ops.kernel_cost("flash_attention", b=1, s=s, h=32, kh=8,
                                    d=64, window=-1)
    assert flops == 4.0 * 64 * (s * (s + 1) // 2) * 32
    assert nbytes == 4.0 * (2 * s * 32 * 64 + 2 * s * 8 * 64)
    assert ops.visible_pairs(10, 4) == 4 * 5 // 2 + 6 * 4


def test_tree_entry_points_reach_the_meta_paths():
    """One launch a leaf; a bf16 leaf goes to the kernels as f32 rows."""
    leaves = [_meta((N, 7, 3)), _meta((N, 64), torch.bfloat16)]

    def trees():
        assert tuple(ops.l1_norm_tree(leaves).shape) == (N,)
        out, e1, n1 = ops.dpps_perturb_tree(leaves, leaves, _scale(), 0.1,
                                            seed=1, t=0)
        assert [(tuple(x.shape), x.dtype) for x in out] == \
            [((N, 7, 3), torch.float32), ((N, 64), torch.float32)]
        assert tuple(ops.noise_l1_tree(leaves).shape) == (N,)
        noise = ops.laplace_noise_tree(
            [_meta((N, 7, 3), torch.uint32), _meta((N, 64), torch.uint32)],
            _scale())
        assert [tuple(x.shape) for x in noise] == [(N, 7, 3), (N, 64)]
        clipped, norms = ops.l1_clip_tree({"a": leaves[0], "b": leaves[0]},
                                          10.0)
        assert tuple(clipped["a"].shape) == (N, 7, 3)
        assert tuple(norms.shape) == (N,)

    assert _counted(trees) == {
        "l1_norm_rows": 3, "dpps_perturb_rows": 2, "noise_l1_rows": 2,
        "clip_scale_rows": 1, "laplace_from_bits": 2}


def test_meta_path_checks_as_the_card_does():
    def refused():
        with pytest.raises(TypeError):
            ops.l1_norm_rows(_meta((N, D_PAD), torch.float64), D_S)
        with pytest.raises(ValueError):
            ops.pushsum_mix(_meta((N, N + 1)), _meta((N, 8)))
        with pytest.raises(ValueError):
            ops.flash_attention(_meta((8, 30, 48)), _meta((2, 30, 48)),
                                _meta((2, 30, 48)), group=4)

    assert _counted(refused) == {}


def test_meta_routes_as_the_card():
    meta, cpu = torch.device("meta"), torch.device("cpu")
    assert resolve_use_kernels(None, meta) is True
    assert resolve_use_kernels(True, meta) is True
    assert resolve_use_kernels(None, cpu) is False
    with pytest.raises(ValueError, match="use_kernels=True"):
        resolve_use_kernels(True, cpu)
