"""Wrappers of the hand-written CUDA kernels.

For a tensor on the CPU each wrapper returns its plain version from
:mod:`repro_torch.kernels.ref`; for a CUDA tensor it launches the kernel
(built on first use by :mod:`repro_torch.kernels.build`) or raises. It never
falls back. A wrapper checks device, dtype, shape and contiguity, allocates
its outputs and scratch with ``torch.empty``, launches on the current
stream, raises if the C function reports a CUDA error, and adds one to its
``launches`` count (read with :func:`launch_counts`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

__all__ = ["l1_norm_rows", "dpps_perturb_rows", "pushsum_mix",
           "launch_counts", "reset_launch_counts", "CHUNK", "MAX_MIX_NODES"]

CHUNK = 8192        # columns per pass-one block (csrc/common.cuh kChunk)
MAX_MIX_NODES = 32  # csrc/pushsum_mix.cu template range


def _is_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           align: bool = False) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def l1_norm_rows(buf: torch.Tensor, d_s: int) -> torch.Tensor:
    """Per-row L1 norm of ``buf[:, :d_s]`` -> (N,) f32."""
    if _is_cpu(buf):
        return ref.l1_norm_rows(buf, d_s)
    _check(buf, "buf", torch.float32, 2, align=True)
    n, d_pad = buf.shape
    if not (0 < d_s <= d_pad) or d_pad % 4:
        raise ValueError(f"need 0 < d_s <= d_pad and d_pad % 4 == 0, got "
                         f"d_s={d_s}, d_pad={d_pad}")
    n_chunks = -(-d_s // CHUNK)
    partials = torch.empty((n, n_chunks), dtype=torch.float32, device=buf.device)
    out = torch.empty((n,), dtype=torch.float32, device=buf.device)
    lib = build.load("l1_norm")
    _raise_on(lib.l1_norm_rows(buf.data_ptr(), n, d_pad, d_s,
                               partials.data_ptr(), n_chunks, out.data_ptr(),
                               _stream(buf)), "l1_norm_rows")
    l1_norm_rows.launches += 1
    return out


def dpps_perturb_rows(s: torch.Tensor, eps: torch.Tensor, scale,
                      gamma_n: float, d_s: int, *,
                      bits: torch.Tensor | None = None,
                      seed: int | None = None, t: int | None = None):
    """Fused ``s + eps + gamma_n Lap(scale)`` over (N, d_pad) rows.

    Returns ``(s_noise (N, d_pad), eps_l1 (N,), noise_l1 (N,))``. ``bits``
    (N, d_s) uint32 selects the bits-in variant; otherwise the Philox
    variant draws the bits of ``(seed, t)`` in the kernel. On CUDA ``scale``
    is a 0-d f32 device tensor, read by the kernel through its pointer.
    """
    if bits is None and (seed is None or t is None):
        raise ValueError("pass bits= or both seed= and t=")
    if _is_cpu(s, eps, *([bits] if bits is not None else [])):
        return ref.dpps_perturb_rows(s, eps, scale, gamma_n, d_s, bits=bits,
                                     seed=seed, t=t)
    _check(s, "s", torch.float32, 2, align=True)
    _check(eps, "eps", torch.float32, 2, align=True)
    n, d_pad = s.shape
    if eps.shape != s.shape:
        raise ValueError(f"eps {tuple(eps.shape)} != s {tuple(s.shape)}")
    if not (0 < d_s <= d_pad) or d_pad % 4:
        raise ValueError(f"need 0 < d_s <= d_pad and d_pad % 4 == 0, got "
                         f"d_s={d_s}, d_pad={d_pad}")
    if bits is not None:
        _check(bits, "bits", torch.uint32, 2)
        if tuple(bits.shape) != (n, d_s):
            raise ValueError(f"bits {tuple(bits.shape)} != {(n, d_s)}")
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32, device=s.device)
    if scale.numel() != 1 or scale.dtype != torch.float32 \
            or scale.device != s.device:
        raise ValueError("scale must be one f32 value on the same device")
    if not (0 <= int(t if t is not None else 0) < 2 ** 32):
        raise ValueError(f"round t={t} out of the uint32 counter range")
    n_chunks = -(-d_pad // CHUNK)
    dev = s.device
    out = torch.empty_like(s)
    eps_part = torch.empty((n, n_chunks), dtype=torch.float32, device=dev)
    noise_part = torch.empty((n, n_chunks), dtype=torch.float32, device=dev)
    eps_l1 = torch.empty((n,), dtype=torch.float32, device=dev)
    noise_l1 = torch.empty((n,), dtype=torch.float32, device=dev)
    scale = scale.contiguous()
    lib = build.load("dpps_perturb")
    _raise_on(lib.dpps_perturb_rows(
        s.data_ptr(), eps.data_ptr(),
        bits.data_ptr() if bits is not None else None,
        scale.data_ptr(), float(gamma_n), n, d_pad, d_s,
        int(seed or 0) & 0xFFFFFFFFFFFFFFFF, int(t or 0), out.data_ptr(),
        eps_part.data_ptr(), noise_part.data_ptr(), n_chunks,
        eps_l1.data_ptr(), noise_l1.data_ptr(), _stream(s)),
        "dpps_perturb_rows")
    dpps_perturb_rows.launches += 1
    return out, eps_l1, noise_l1


def pushsum_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` for W (N, N) and x (N, D), f32 accumulation -> (N, D)."""
    if _is_cpu(w, x):
        return ref.pushsum_mix(w, x)
    _check(w, "w", torch.float32, 2)
    _check(x, "x", torch.float32, 2)
    n, d = x.shape
    if tuple(w.shape) != (n, n) or not (1 <= n <= MAX_MIX_NODES):
        raise ValueError(f"need w (N, N) with 1 <= N <= {MAX_MIX_NODES}, got "
                         f"w {tuple(w.shape)}, x {tuple(x.shape)}")
    out = torch.empty_like(x)
    lib = build.load("pushsum_mix")
    _raise_on(lib.pushsum_mix(w.data_ptr(), x.data_ptr(), out.data_ptr(), n,
                              d, _stream(x)), "pushsum_mix")
    pushsum_mix.launches += 1
    return out


_KERNELS = (l1_norm_rows, dpps_perturb_rows, pushsum_mix)
for _fn in _KERNELS:
    _fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _KERNELS}


def reset_launch_counts() -> None:
    for fn in _KERNELS:
        fn.launches = 0
