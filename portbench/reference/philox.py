"""The noise draw of a DPPS round, written out plainly.

Element ``e`` of node ``n``'s wire row in round ``t`` takes word ``e % 4``
of Philox4x32-10 (Salmon et al., SC'11) with key ``(seed lo, seed hi)`` and
counter ``(e // 4 lo, e // 4 hi, n, t)``; its Laplace(0, scale) value is
the inverse CDF of ``u = (bits >> 8) 2^-24``:
``-scale sign(u - 1/2) log(max(1 - 2 |u - 1/2|, 1e-30))``.

Words are held in int64 tensors (no unsigned 32-bit shifts are needed).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of ``a * b``, from 16-bit halves of ``a``."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, seed: int):
    """Ten Philox4x32 rounds over four counter words."""
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK32
        k1 = (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def bits_at(seed: int, t: int, nodes: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """The uint32 noise words (as int64) of round ``t`` at ``nodes`` (R,)
    and wire columns ``cols`` (C,) -> (R, C)."""
    q = (cols // 4)[None, :]
    shape = (nodes.shape[0], cols.shape[0])
    words = philox(q.expand(shape) & MASK32, (q >> 32).expand(shape),
                   nodes[:, None].expand(shape),
                   torch.full(shape, int(t) & MASK32, dtype=torch.int64,
                              device=cols.device), seed)
    return torch.stack(words, dim=-1).gather(
        -1, (cols % 4)[None, :, None].expand(shape + (1,)))[..., 0]


def bits_block(seed: int, t: int, n_nodes: int, c0: int, c1: int,
               device) -> torch.Tensor:
    """Round ``t``'s words of every node at the contiguous columns
    ``[c0, c1)`` -> (n_nodes, c1 - c0); one counter gives four columns."""
    q0, q1 = c0 // 4, -(-c1 // 4)
    q = torch.arange(q0, q1, dtype=torch.int64, device=device)[None, :]
    nodes = torch.arange(n_nodes, dtype=torch.int64, device=device)[:, None]
    shape = (n_nodes, q1 - q0)
    words = philox(q.expand(shape) & MASK32, (q >> 32).expand(shape),
                   nodes.expand(shape),
                   torch.full(shape, int(t) & MASK32, dtype=torch.int64,
                              device=device), seed)
    flat = torch.stack(words, dim=-1).reshape(n_nodes, 4 * (q1 - q0))
    return flat[:, c0 - 4 * q0:c0 - 4 * q0 + (c1 - c0)]


def laplace(bits: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    """Laplace(0, scale) of uint32 words by the inverse CDF, in ``dtype``."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    c = u - 0.5
    mag = torch.clamp_min(1.0 - 2.0 * c.abs(), 1e-30)
    return (-(torch.sign(c) * torch.log(mag)) * scale).to(dtype)
