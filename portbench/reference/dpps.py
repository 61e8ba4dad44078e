"""One DPPS round (paper Alg. 1) over a flat (N, d_s) state, written out.

Per round t, for the wire row s (N, d_s), the push-sum weights a (N,) and
the per-node sensitivity recursion (Remark 1, Eq. 22):

  1. s_half = s + eps                                         (Eq. 7)
  2. S_i = 2 C' (||s_i||_1 + ||eps_i||_1)                     (t = 0)
     S_i = lambda S_i + 2 C' (||eps_i||_1 + lambda gamma_n ||n_i||_1)
     S = max_i S_i                                            (Eq. 22)
  3. s_noise = s_half + gamma_n Lap(0, S / b), Lap from Philox (Eq. 8)
  4. s = W s_noise, a = W a                                   (Eq. 9)
     or, every ``sync_interval``-th round, the exact average of s_noise,
     a = 1 and the recursion restarted from the average's norm.

The columns are independent but for the norms, so the round runs in
blocks of columns: the norms first, then the noise and the mix of each
block in place. ``dtype`` is the arithmetic's precision (float32; the
control runs it in bfloat16).
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference import philox

BLOCK_ELEMENTS = 1 << 26   # noise words drawn at once (N x columns)


@dataclasses.dataclass
class Consts:
    c_prime: float
    lam: float
    gamma_n: float
    b: float
    seed: int
    sync_interval: int = 0


@dataclasses.dataclass
class Sens:
    s_local: torch.Tensor      # (N,) S_i
    prev_noise_l1: torch.Tensor  # (N,) ||n_i||_1 of the last round


def is_sync(t: int, sync_interval: int) -> bool:
    return sync_interval > 0 and (t + 1) % sync_interval == 0


def l1_rows(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().sum(dim=1)


def _mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (w.to(x.dtype) @ x)


def dpps_round(s: torch.Tensor, a: torch.Tensor, sens: Sens | None, t: int,
               k: Consts, w: torch.Tensor, eps: torch.Tensor | None = None,
               dtype=torch.float32) -> tuple[torch.Tensor, Sens, dict]:
    """Round ``t`` over ``s`` (N, d_s), which it overwrites with the new
    state; ``eps`` is the perturbation row (None: zero) and ``sens`` the
    recursion's state (None at round 0). Returns (a, sens, diag)."""
    n, d = s.shape
    f32 = dict(dtype=torch.float32, device=s.device)
    eps_l1 = (torch.zeros((n,), **f32) if eps is None else l1_rows(eps))
    lam = torch.tensor(k.lam, **f32)
    cp = torch.tensor(k.c_prime, **f32)
    if sens is None:
        s_local = 2.0 * cp * (l1_rows(s) + eps_l1)
    else:
        s_local = lam * sens.s_local + 2.0 * cp * (
            eps_l1 + lam * k.gamma_n * sens.prev_noise_l1)
    s_used = s_local.max()
    scale = s_used / k.b
    noise_l1 = torch.zeros((n,), **f32)
    sync = is_sync(t, k.sync_interval)
    step = max(4, (BLOCK_ELEMENTS // n) // 4 * 4)
    w = w.to(device=s.device)
    for c0 in range(0, d, step):
        c1 = min(d, c0 + step)
        lap = philox.laplace(philox.bits_block(k.seed, t, n, c0, c1, s.device),
                             scale, torch.float32)
        noise_l1 += lap.abs().sum(dim=1)
        block = s[:, c0:c1].to(dtype)
        if eps is not None:
            block = block + eps[:, c0:c1].to(dtype)
        block = block + (k.gamma_n * lap).to(dtype)
        if sync:
            s[:, c0:c1] = block.float().mean(dim=0, keepdim=True).to(s.dtype)
        else:
            s[:, c0:c1] = _mix(w, block).to(s.dtype)
    if sync:
        a = torch.ones_like(a)
        s_local = (2.0 * cp * l1_rows(s[:1])).expand(n).clone()
        prev = torch.zeros_like(noise_l1)
    else:
        a = (w.to(torch.float32) @ a.float()).to(a.dtype)
        prev = noise_l1
    diag = dict(sensitivity_used=s_used, sensitivity_local=s_local,
                eps_l1=eps_l1, noise_l1=noise_l1)
    return a, Sens(s_local, prev), diag


def replay_columns(s_cols: torch.Tensor, cols: torch.Tensor, scales,
                   t0: int, k: Consts, w: torch.Tensor,
                   dtype=torch.float32, rounds_at_once: int = 16
                   ) -> torch.Tensor:
    """Pure-consensus rounds ``t0, t0 + 1, ...`` (one a scale in
    ``scales``, the noise scale S / b of each round) over the columns
    ``cols`` of the state, ``s_cols`` (N, C) -> the columns after them.
    A sync round averages them. The columns are independent given the
    scales, so this follows the full state's rounds exactly there."""
    n = s_cols.shape[0]
    nodes = torch.arange(n, dtype=torch.int64, device=s_cols.device)
    x = s_cols.to(dtype)
    w = w.to(device=s_cols.device, dtype=dtype)
    scales = [float(v) for v in scales]
    for r0 in range(0, len(scales), rounds_at_once):
        chunk = scales[r0:r0 + rounds_at_once]
        lap = [philox.laplace(philox.bits_at(k.seed, t0 + r0 + j, nodes,
                                             cols),
                              torch.tensor(sc, dtype=torch.float32),
                              torch.float32)
               for j, sc in enumerate(chunk)]
        for j, z in enumerate(lap):
            x = x + (k.gamma_n * z).to(dtype)
            if is_sync(t0 + r0 + j, k.sync_interval):
                x = x.float().mean(dim=0, keepdim=True).expand(
                    n, -1).to(dtype)
            else:
                x = w @ x
    return x.float()
