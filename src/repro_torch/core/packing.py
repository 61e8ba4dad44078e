"""PackedLayout: one contiguous (N, d_pad) float32 wire buffer for the
shared tree (port of ``repro.core.packing``).

The shared tree is flattened once into a single buffer whose columns are
the leaves' flat rows in tree-flatten order, padded from ``d_s`` up to a
``lane`` multiple. The round's passes (perturb, norms, noise, mix) then run
once over the buffer. The lane is 128 on the kernel path and 1 on the plain
path (``repro.engine.rounds.wire_layout``); ``d_s``, ``d_pad`` and the
segment offsets equal the reference's.

Padding lanes hold zeros in the state, the perturbation and the noise, so
they are inert through every pass; :meth:`wire_slice` strips them. Buffers
are never updated in place, so views returned by :meth:`unpack` and the
single-leaf fast path of :meth:`pack` may alias their source safely. The
one exception is :meth:`encode_wire` with ``inplace``, which the round
uses only on its freshly noised buffer, which nothing else holds.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.tree_utils import PyTree, TreeDef, tree_flatten, tree_unflatten
from repro_torch.kernels.ref import leaf_columns

__all__ = ["Segment", "PackedLayout", "LANE"]

# Column alignment of the kernel path's buffers (the reference's TPU lane).
LANE = 128


class Segment(NamedTuple):
    """One leaf's slot in the packed buffer."""

    shape: tuple[int, ...]  # per-node shape (leaf shape without the N axis)
    dtype: torch.dtype      # original leaf dtype (restored by unpack)
    offset: int             # start column in the packed buffer
    size: int               # prod(shape) columns


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Shapes, dtypes and offsets of the shared tree's flat wire row."""

    treedef: TreeDef
    segments: tuple[Segment, ...]
    d_s: int     # true wire dimension (sum of segment sizes)
    d_pad: int   # d_s rounded up to a lane multiple (buffer columns)

    @classmethod
    def from_tree(cls, tree: PyTree, *, lane: int = LANE) -> "PackedLayout":
        """Layout of a node-stacked shared tree (leaves (N, ...))."""
        leaves, treedef = tree_flatten(tree)
        if not leaves:
            raise ValueError("cannot pack an empty shared tree")
        segments = tuple(
            Segment(tuple(leaf.shape[1:]), leaf.dtype, offset,
                    leaf[0].numel())
            for leaf, offset in zip(leaves, leaf_columns(leaves)))
        d_s = segments[-1].offset + segments[-1].size
        d_pad = -(-d_s // lane) * lane
        return cls(treedef=treedef, segments=segments, d_s=d_s, d_pad=d_pad)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def pad(self) -> int:
        return self.d_pad - self.d_s

    def wire_bytes_per_node(self, wire_dtype: str = "f32",
                            codec=None) -> int:
        """Bytes one node puts on the wire a round (d_s, not d_pad: the pad
        lanes never leave the node). An active codec owns the figure: int8
        ``d_s + 4``, top-k ``6 k``."""
        if codec is not None and getattr(codec, "active", False):
            return int(codec.payload_bytes(self.d_s))
        return self.d_s * {"f32": 4, "bf16": 2}[wire_dtype]

    def encode_wire(self, codec, buf: torch.Tensor, resid, *, seed: int,
                    t: int, draws: torch.Tensor | None = None,
                    inplace: bool = False) -> tuple[torch.Tensor, object]:
        """A codec over the buffer's un-padded (N, d_s) slice -> (the buffer
        with the encoded wire row and ``buf``'s pad lanes, the codec's new
        residual). ``inplace`` writes the encoding into ``buf`` itself (a
        buffer nothing reads afterwards); the pad lanes never reach the
        codec."""
        wire = self.wire_slice(buf)
        if inplace:
            _, new_resid = codec.encode(wire, resid, seed=seed, t=t,
                                        draws=draws, out=wire)
            return buf, new_resid
        enc, new_resid = codec.encode(wire, resid, seed=seed, t=t,
                                      draws=draws)
        return self.append_pad(enc, buf), new_resid

    def _leaves(self, tree: PyTree) -> list:
        leaves = tree_flatten(tree)[0]
        if len(leaves) != len(self.segments):
            raise ValueError(f"tree has {len(leaves)} leaves but layout packs "
                             f"{len(self.segments)} segments")
        return leaves

    def _rows(self, leaves: list, lead: tuple) -> list[torch.Tensor]:
        return [x.to(torch.float32).reshape(lead + (seg.size,))
                for x, seg in zip(leaves, self.segments)]

    def _lead(self, leaf: torch.Tensor) -> tuple:
        nrest = len(self.segments[0].shape)
        return tuple(leaf.shape[:leaf.dim() - nrest])

    def pack(self, tree: PyTree) -> torch.Tensor:
        """Tree with leaves (lead..., *seg.shape) -> (lead..., d_pad) f32.

        A single contiguous f32 leaf that needs no padding is returned as
        is (no copy): nothing updates buffers in place.
        """
        leaves = self._leaves(tree)
        lead = self._lead(leaves[0])
        rows = self._rows(leaves, lead)
        if len(rows) == 1 and not self.pad and rows[0].is_contiguous():
            return rows[0]
        if self.pad:
            rows.append(rows[0].new_zeros(lead + (self.pad,)))
        return torch.cat(rows, dim=-1)

    def view_tree(self, buf: torch.Tensor) -> PyTree:
        """The buffer sliced back into leaf-shaped f32 views."""
        lead = tuple(buf.shape[:-1])
        return tree_unflatten(self.treedef, [
            buf[..., seg.offset:seg.offset + seg.size].reshape(lead + seg.shape)
            for seg in self.segments])

    def unpack(self, buf: torch.Tensor) -> PyTree:
        """(lead..., d_pad) buffer -> tree with the leaf dtypes restored."""
        lead = tuple(buf.shape[:-1])
        return tree_unflatten(self.treedef, [
            buf[..., seg.offset:seg.offset + seg.size].reshape(
                lead + seg.shape).to(seg.dtype)
            for seg in self.segments])

    def wire_slice(self, buf: torch.Tensor) -> torch.Tensor:
        """Drop padding lanes: (..., d_pad) -> (..., d_s)."""
        return buf if not self.pad else buf[..., :self.d_s]

    def l1_norm_per_node(self, buf: torch.Tensor) -> torch.Tensor:
        """Per-node L1 norm of the wire lanes -> (...,)."""
        return self.wire_slice(buf).abs().sum(dim=-1)

    def laplace_noise_flat(self, n_nodes: int, scale, **draw) -> torch.Tensor:
        """The round's Laplace noise as the flat (N, d_s) row: the same
        :func:`repro_torch.core.privacy.flat_wire_draw` call that
        ``noise_wire`` slices into leaves, so the two are bit-equal by
        construction; ``draw`` are its keywords (``seed``, ``t``, ``bits``,
        ``draws``, ``device``, ``node0``)."""
        from repro_torch.core.privacy import flat_wire_draw

        return flat_wire_draw(n_nodes, self.d_s, scale, **draw)

    def flat_row(self, tree: PyTree) -> torch.Tensor:
        """Tree with leaves (N, *seg.shape) -> the un-padded (N, d_s) row."""
        leaves = self._leaves(tree)
        rows = self._rows(leaves, self._lead(leaves[0]))
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)

    def append_pad(self, wire_row: torch.Tensor,
                   src_buf: torch.Tensor) -> torch.Tensor:
        """(N, d_s) row -> (N, d_pad) buffer with ``src_buf``'s pad lanes."""
        if not self.pad:
            return wire_row
        return torch.cat([wire_row, src_buf[..., self.d_s:]], dim=-1)

    def add_wire(self, buf: torch.Tensor, tree: PyTree) -> torch.Tensor:
        """``buf + pack(tree)``: the packed perturb add (Eq. 7)."""
        return self.append_pad(self.wire_slice(buf) + self.flat_row(tree), buf)
