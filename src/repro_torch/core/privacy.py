"""Differential-privacy primitives: Laplace noise through a bits seam,
L1 clipping and accounting (port of ``repro.core.privacy``).

* Lemma 1 / Eq. 8: noise is ``kernels.ref.laplace_from_bits(bits, S / b)``,
  computed inside the DPPS round's fused perturb (``core/dpps.py``). The
  bits come from Philox in production (a pure function of (seed, round,
  node, element); ``kernels.ref.philox_bits``) or, in the conformance
  tests, are the exact uint32 values the reference's kernel path consumed.
  The reference's eager threefry ``jax.random.laplace`` cannot be
  reproduced in PyTorch and is not ported.
* :func:`noise_wire`: the plain tree draw of the pytree runtime, one
  flat (N, d_s) draw over the wire row split per leaf in wire order, as
  ``repro.core.privacy.noise_wire`` draws it, so the pytree and packed
  runtimes take the same noise.
* Eq. 24: L1 gradient clip ``g / max(1, ||g||_1 / C)``; the L2 clip of
  the PEDFL baseline.
* Accounting: pure-DP linear composition, ``rounds * b / gamma_n``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree_utils import (PyTree, l1_norm_per_node,
                                         tree_flatten, tree_map,
                                         tree_unflatten)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["noise_wire", "laplace_row", "normal_row", "split_row",
           "GAUSS_SALT", "l1_clip_per_node", "l2_clip_per_node",
           "PrivacyAccountant"]

# The Gaussian mechanism's normals come from a Philox stream of their own:
# the noise key with this salt xored into its high word.
GAUSS_SALT = 0x47415553  # "GAUS"


def noise_wire(tree: PyTree, scale, *, bits: torch.Tensor | None = None,
               seed: int | None = None, t: int | None = None,
               node0: int = 0, col_maps=None) -> PyTree:
    """Laplace(0, scale) noise shaped like the node-stacked ``tree``: one
    flat (N, d_s) draw over the wire row, sliced back into the leaves in
    wire order. The bits are ``bits`` (N, d_s) uint32, or the Philox row of
    ``(seed, t)`` (``kernels.ref.philox_bits``) of global nodes ``node0``,
    ``node0 + 1``, ..., the bits the packed runtime draws for the same
    columns; with ``col_maps`` (a rank's shards of a model-sharded tree,
    one ``kernels.ref.ColumnMap`` a leaf) each leaf's bits at its
    columns of the whole wire row."""
    leaves, treedef = tree_flatten(tree)
    n = leaves[0].shape[0]
    sizes = [x[0].numel() for x in leaves]
    if bits is None and col_maps is not None:
        dev = leaves[0].device
        bits = torch.cat([kref.philox_map(seed, t, n, cmap, size, dev,
                                          node0=node0)
                          for cmap, size in zip(col_maps, sizes)], dim=1)
    elif bits is None:
        bits = kref.philox_bits(seed, t, n, 0, sum(sizes),
                                device=leaves[0].device, node0=node0)
    flat = kref.laplace_from_bits(bits, scale)
    out, off = [], 0
    for x, size in zip(leaves, sizes):
        out.append(flat[:, off:off + size].reshape(x.shape).to(x.dtype))
        off += size
    return tree_unflatten(treedef, out)


def split_row(row: torch.Tensor, tree: PyTree) -> PyTree:
    """An (N, d_s) wire row sliced back into the leaf shapes and dtypes of
    the node-stacked ``tree``, in wire order."""
    leaves, treedef = tree_flatten(tree)
    out, off = [], 0
    for x in leaves:
        size = x[0].numel()
        out.append(row[:, off:off + size].reshape(x.shape).to(x.dtype))
        off += size
    return tree_unflatten(treedef, out)


def laplace_row(n: int, d_s: int, scale, *, seed: int, t: int, device=None,
                bits: torch.Tensor | None = None,
                draws: torch.Tensor | None = None,
                use_kernels: bool = False) -> torch.Tensor:
    """Laplace(0, scale) as the (N, d_s) wire row of round ``t``: the
    transform of ``bits`` (N, d_s) or of the round's Philox noise bits
    (``kernels.ref.philox_bits``), the bits the fused perturbation draws,
    through ``ops.laplace_from_bits`` (``csrc/laplace_noise.cu``) with
    ``use_kernels``; or, tests only, ``draws`` (unit-scale Laplace samples,
    the reference's ``jax.random.laplace`` draws) times ``scale``, as the
    reference's ``noise_like`` scales them."""
    if draws is not None:
        return draws.to(device=device, dtype=torch.float32) * scale
    if bits is None:
        bits = kref.philox_bits(seed, t, n, 0, d_s, device=device)
    if not use_kernels:
        return kref.laplace_from_bits(bits, scale)
    flat = bits.to(torch.uint32).contiguous().reshape(-1)
    return kops.laplace_from_bits(flat, scale).reshape(n, d_s)


def normal_row(n: int, d_s: int, scale, *, seed: int, t: int, device=None,
               draws: torch.Tensor | None = None) -> torch.Tensor:
    """Normal(0, scale^2) as the (N, d_s) wire row of round ``t``.

    Element ``e`` is Box-Muller over words ``2e`` and ``2e + 1`` of the
    :data:`GAUSS_SALT` stream (``philox_bits(..., salt=GAUSS_SALT)``):
    ``u1 = ((w1 >> 9) + 1) 2^-23`` in (0, 1], ``u2 = (w2 >> 9) 2^-23``,
    ``sqrt(-2 log u1) cos(2 pi u2)``, in f32 on the tensors' device (the
    same words on the card and on the CPU; the transcendentals may differ
    by an ulp). ``draws`` (tests only) are unit normals, the reference's
    ``jax.random.normal`` draws, times ``scale``."""
    if draws is None:
        words = kref.philox_bits(seed, t, n, 0, 2 * d_s, device=device,
                                 salt=GAUSS_SALT)
        u1 = ((words[:, 0::2] >> 9) + 1).to(torch.float32) * (1.0 / (1 << 23))
        u2 = (words[:, 1::2] >> 9).to(torch.float32) * (1.0 / (1 << 23))
        del words
        draws = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            (2.0 * torch.pi) * u2)
    return draws.to(device=device, dtype=torch.float32) * scale


def l1_clip_per_node(tree: PyTree, clip: float, *, counted=None,
                     col_sum=None) -> tuple[PyTree, torch.Tensor]:
    """Paper Eq. 24: per-node L1 clip. Returns (clipped tree, pre-clip norms).
    Over a model axis (a rank's shards of the tree) ``counted`` and
    ``col_sum`` make the norm the whole vector's
    (:class:`repro_torch.core.dpps.ColumnOps`): each rank divides by it."""
    norms = l1_norm_per_node(tree, counted)
    if col_sum is not None:
        norms = col_sum(norms)
    denom = torch.clamp_min(norms / clip, 1.0)
    return tree_map(
        lambda x: x / denom.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype),
        tree), norms


def l2_clip_per_node(tree: PyTree, clip: float) -> tuple[PyTree, torch.Tensor]:
    """DP-SGD style per-node L2 clip (the PEDFL baseline). Returns (clipped
    tree, pre-clip norms); the squares are summed leaf by leaf, as the
    reference's ``tree_l2_norm_sq_per_node`` sums them."""
    sq = [x.square().reshape(x.shape[0], -1).sum(dim=1)
          for x in tree_flatten(tree)[0]]
    norms = torch.sqrt(sum(sq[1:], start=sq[0]))
    denom = torch.clamp_min(norms / clip, 1.0)
    return tree_map(
        lambda x: x / denom.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype),
        tree), norms


@dataclasses.dataclass
class PrivacyAccountant:
    """Pure-epsilon accountant under linear composition (Theorem 1: each
    protected round is (b / gamma_n)-DP; sync rounds are not private)."""

    b: float
    gamma_n: float
    rounds: int = 0
    unprotected_rounds: int = 0
    budget: float | None = None

    @property
    def epsilon_per_round(self) -> float:
        return float("inf") if self.gamma_n <= 0 else self.b / self.gamma_n

    @property
    def epsilon_total(self) -> float:
        return 0.0 if self.rounds == 0 else self.rounds * self.epsilon_per_round

    def step(self, *, protected: bool = True) -> "PrivacyAccountant":
        return dataclasses.replace(
            self, rounds=self.rounds + (1 if protected else 0),
            unprotected_rounds=self.unprotected_rounds + (0 if protected else 1))

    def remaining(self) -> float:
        if self.budget is None:
            return float("inf")
        return max(self.budget - self.epsilon_total, 0.0)

    @property
    def exhausted(self) -> bool:
        return self.budget is not None and self.epsilon_total > self.budget

    def summary(self) -> dict[str, Any]:
        return {"epsilon_per_round": self.epsilon_per_round,
                "epsilon_total": self.epsilon_total, "rounds": self.rounds,
                "unprotected_rounds": self.unprotected_rounds,
                "budget": self.budget, "remaining": self.remaining(),
                "exhausted": self.exhausted}
