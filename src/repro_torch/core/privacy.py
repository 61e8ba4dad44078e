"""Differential-privacy primitives: Laplace noise through a bits seam,
L1 clipping and accounting (port of ``repro.core.privacy``).

* Lemma 1 / Eq. 8: noise is ``kernels.ref.laplace_from_bits(bits, S / b)``,
  computed inside the DPPS round's fused perturb (``core/dpps.py``). The
  bits come from Philox in production (a pure function of (seed, round,
  node, element); ``kernels.ref.philox_bits``) or, in the conformance
  tests, are the exact uint32 values the reference's kernel path consumed.
  The reference's eager threefry ``jax.random.laplace`` cannot be
  reproduced in PyTorch: where it takes a key, the draws here take
  ``(seed, t)`` (Philox), ``bits=`` or, tests only, its unit ``draws=``.
* :func:`flat_wire_draw`: the one (N, d_s) draw of a round, Laplace or
  normal (``sampler``); :func:`noise_wire` slices it into the leaves in
  wire order, as ``repro.core.privacy.noise_wire`` does, so the pytree and
  packed runtimes take the same noise. :func:`noise_like` /
  :func:`noise_tree` draw a leaf, or each leaf, at its wire columns.
* Eq. 24: L1 gradient clip ``g / max(1, ||g||_1 / C)``; the L2 clip of
  the PEDFL baseline.
* Accounting: pure-DP linear composition, ``rounds * b / gamma_n``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree_utils import (PyTree, l1_norm_per_node,
                                         tree_flatten, tree_l2_norm_sq_per_node,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["noise_like", "noise_tree", "laplace_noise_like",
           "laplace_noise_tree", "noise_wire", "flat_wire_draw", "laplace_row",
           "normal_row", "split_row", "SAMPLERS", "GAUSS_SALT",
           "l1_clip_per_node", "l2_clip_per_node", "PrivacyAccountant"]

# The Gaussian mechanism's normals come from a Philox stream of their own:
# the noise key with this salt xored into its high word.
GAUSS_SALT = 0x47415553  # "GAUS"


SAMPLERS = ("laplace", "normal")


def _per_node(scale, n: int):
    """A per-node (N,) scale as an (N, 1) column (it scales node i's row);
    any other scale as it is."""
    if isinstance(scale, torch.Tensor) and scale.dim() == 1 \
            and scale.shape[0] == n:
        return scale.to(torch.float32)[:, None]
    return scale


def laplace_row(n: int, d_s: int, scale, *, seed: int | None = None,
                t: int | None = None, device=None,
                bits: torch.Tensor | None = None,
                draws: torch.Tensor | None = None,
                use_kernels: bool = False, col0: int = 0,
                node0: int = 0) -> torch.Tensor:
    """Laplace(0, scale) as the (N, d_s) wire row of round ``t``: the
    transform of ``bits`` (N, d_s) or of the round's Philox noise bits at
    wire columns ``[col0, col0 + d_s)`` of global nodes ``node0`` ...
    (``kernels.ref.philox_bits``), the bits the fused perturbation draws,
    through ``ops.laplace_from_bits`` (``csrc/laplace_noise.cu``) with
    ``use_kernels``; or, tests only, ``draws`` (unit-scale Laplace samples,
    the reference's ``jax.random.laplace`` draws) times ``scale``, as the
    reference's ``noise_like`` scales them. A per-node (N,) ``scale``
    scales each node's row (the plain route; the kernel reads one scale
    and refuses another)."""
    scale = _per_node(scale, n)
    if draws is not None:
        return draws.to(device=device, dtype=torch.float32) * scale
    if bits is None:
        bits = kref.philox_bits(seed, t, n, col0, col0 + d_s, device=device,
                                node0=node0)
    if not use_kernels:
        return kref.laplace_from_bits(bits, scale)
    flat = bits.to(torch.uint32).contiguous().reshape(-1)
    return kops.laplace_from_bits(flat, scale).reshape(n, d_s)


def normal_row(n: int, d_s: int, scale, *, seed: int | None = None,
               t: int | None = None, device=None,
               draws: torch.Tensor | None = None, col0: int = 0,
               node0: int = 0) -> torch.Tensor:
    """Normal(0, scale^2) as the (N, d_s) wire row of round ``t``.

    Element ``e`` is Box-Muller over words ``2e`` and ``2e + 1`` of the
    :data:`GAUSS_SALT` stream (``philox_bits(..., salt=GAUSS_SALT)``):
    ``u1 = ((w1 >> 9) + 1) 2^-23`` in (0, 1], ``u2 = (w2 >> 9) 2^-23``,
    ``sqrt(-2 log u1) cos(2 pi u2)``, in f32 on the tensors' device (the
    same words on the card and on the CPU; the transcendentals may differ
    by an ulp), for ``e`` in ``[col0, col0 + d_s)``. ``draws`` (tests only)
    are unit normals, the reference's ``jax.random.normal`` draws, times
    ``scale``; a per-node (N,) ``scale`` scales each node's row."""
    if draws is None:
        words = kref.philox_bits(seed, t, n, 2 * col0, 2 * (col0 + d_s),
                                 device=device, salt=GAUSS_SALT, node0=node0)
        u1 = ((words[:, 0::2] >> 9) + 1).to(torch.float32) * (1.0 / (1 << 23))
        u2 = (words[:, 1::2] >> 9).to(torch.float32) * (1.0 / (1 << 23))
        del words
        draws = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            (2.0 * torch.pi) * u2)
    return draws.to(device=device, dtype=torch.float32) * _per_node(scale, n)


def flat_wire_draw(n_nodes: int, d_s: int, scale, *, seed: int | None = None,
                   t: int | None = None, bits: torch.Tensor | None = None,
                   draws: torch.Tensor | None = None,
                   sampler: str = "laplace", device=None, col0: int = 0,
                   node0: int = 0) -> torch.Tensor:
    """The one (N, d_s) draw behind :func:`noise_wire`, which slices it
    into leaves, and :meth:`~repro_torch.core.packing.PackedLayout.
    laplace_noise_flat`, which takes the row as it is: the same call, so
    the two are bit-equal by construction. ``sampler`` is ``"laplace"``
    (:func:`laplace_row`: ``bits`` or the round's Philox noise bits) or
    ``"normal"`` (:func:`normal_row`, its own salted stream; ``bits`` do
    not apply); ``draws`` (tests only) are unit samples. Where the
    reference takes a key, the port takes ``(seed, t)`` or ``bits``."""
    if sampler == "laplace":
        return laplace_row(n_nodes, d_s, scale, seed=seed, t=t,
                           device=device, bits=bits, draws=draws, col0=col0,
                           node0=node0)
    if sampler == "normal":
        if bits is not None:
            raise ValueError("the normal sampler draws its own salted "
                             "Philox words; bits= applies to laplace only")
        return normal_row(n_nodes, d_s, scale, seed=seed, t=t, device=device,
                          draws=draws, col0=col0, node0=node0)
    raise ValueError(f"unknown sampler {sampler!r}; have {list(SAMPLERS)}")


def _rows(x, n: int, size: int):
    return None if x is None else torch.as_tensor(x).reshape(n, size)


def noise_like(x: torch.Tensor, scale, *, seed: int | None = None,
               t: int | None = None, bits: torch.Tensor | None = None,
               draws: torch.Tensor | None = None, sampler: str = "laplace",
               col0: int = 0) -> torch.Tensor:
    """i.i.d. ``sampler`` noise times ``scale`` with the shape and dtype of
    the node-stacked ``x``: node i's part is wire columns ``[col0, col0 +
    size)`` of its row (:func:`flat_wire_draw`), from ``bits`` or
    ``draws`` of x's shape where given. ``scale`` is a scalar or a per-node
    (N,) vector, as in the reference."""
    n = x.shape[0] if x.dim() else 1
    size = x.numel() // n if n else 0
    row = flat_wire_draw(n, size, scale, seed=seed, t=t,
                         bits=_rows(bits, n, size),
                         draws=_rows(draws, n, size), sampler=sampler,
                         device=x.device, col0=col0)
    return row.reshape(x.shape).to(x.dtype)


def noise_tree(tree: PyTree, scale, *, seed: int | None = None,
               t: int | None = None, bits=None, draws=None,
               sampler: str = "laplace") -> PyTree:
    """Independent ``sampler`` noise for every leaf of the node-stacked
    ``tree``: each leaf takes its own wire columns (its ``col0``, in leaf
    order), where the reference splits its key a leaf. ``bits`` / ``draws``
    (one tensor a leaf, in leaf order) replace the Philox stream."""
    leaves, treedef = tree_flatten(tree)
    out, col0 = [], 0
    for i, x in enumerate(leaves):
        out.append(noise_like(
            x, scale, seed=seed, t=t,
            bits=None if bits is None else bits[i],
            draws=None if draws is None else draws[i], sampler=sampler,
            col0=col0))
        col0 += x[0].numel() if x.dim() else 1
    return tree_unflatten(treedef, out)


def laplace_noise_like(x: torch.Tensor, scale, **kwargs) -> torch.Tensor:
    """i.i.d. Laplace(0, scale) with the shape and dtype of ``x`` (Lemma 1);
    :func:`noise_like`'s keywords."""
    return noise_like(x, scale, sampler="laplace", **kwargs)


def laplace_noise_tree(tree: PyTree, scale, **kwargs) -> PyTree:
    """Independent Laplace noise for every leaf (:func:`noise_tree`)."""
    return noise_tree(tree, scale, sampler="laplace", **kwargs)


def noise_wire(tree: PyTree, scale, *, bits: torch.Tensor | None = None,
               seed: int | None = None, t: int | None = None,
               node0: int = 0, col_maps=None) -> PyTree:
    """Laplace(0, scale) noise shaped like the node-stacked ``tree``: one
    flat (N, d_s) draw over the wire row (:func:`flat_wire_draw`), sliced
    back into the leaves in wire order. The bits are ``bits`` (N, d_s)
    uint32, or the Philox row of ``(seed, t)`` (``kernels.ref.philox_bits``)
    of global nodes ``node0``, ``node0 + 1``, ..., the bits the packed
    runtime draws for the same columns; with ``col_maps`` (a rank's shards
    of a model-sharded tree, one ``kernels.ref.ColumnMap`` a leaf) each
    leaf's bits at its columns of the whole wire row."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    sizes = [x[0].numel() for x in leaves]
    if bits is None and col_maps is not None:
        dev = leaves[0].device
        bits = torch.cat([kref.philox_map(seed, t, n, cmap, size, dev,
                                          node0=node0)
                          for cmap, size in zip(col_maps, sizes)], dim=1)
    flat = flat_wire_draw(n, sum(sizes), scale, seed=seed, t=t, bits=bits,
                          device=leaves[0].device, node0=node0)
    return split_row(flat, tree)


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
    tree, pre-clip norms)."""
    norms = torch.sqrt(tree_l2_norm_sq_per_node(tree))
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
