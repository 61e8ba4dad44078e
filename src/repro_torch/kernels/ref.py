"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
over the same (N, d_pad) row layout (flash attention over (..., H, S, D)). The wrappers in
:mod:`repro_torch.kernels.ops` take these for tensors on the CPU; the tests
hold them against ``repro.kernels.ref`` and the interpret-mode Pallas
kernels, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.

torch on the CPU has no ``>>`` for ``uint32``, so bits are widened to
``int64`` before any shift.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.tree_utils import counted_part

__all__ = [
    "philox4x32_10",
    "philox_bits",
    "ColumnMap",
    "philox_columns",
    "philox_map",
    "laplace_from_bits",
    "l1_norm_rows",
    "clip_scale_rows",
    "dpps_perturb_rows",
    "leaf_columns",
    "tree_column_maps",
    "l1_norm_tree",
    "dpps_perturb_tree",
    "laplace_noise_like",
    "pushsum_mix",
    "spmm",
    "flash_attention",
]

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * b`` for a < 2^32 and int64 b < 2^32,
    from 16-bit halves of ``a`` so no product leaves int64."""
    p_lo = b * (a & 0xFFFF)            # < 2^48
    p_hi = b * (a >> 16)               # < 2^48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr: tuple[torch.Tensor, ...], key: tuple[int, int]):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    words. ``ctr`` is four broadcastable tensors; ``key`` two ints.

    Plain version of ``philox4x32_10`` in ``csrc/dpps_perturb.cu``. It has
    no Pallas counterpart: the reference draws its bits outside the kernel
    with ``jax.random.bits`` (``repro/kernels/ops.py::dpps_perturb_flat``),
    whose threefry stream the port does not reproduce; the tests feed those
    bits in through the bits-in variant instead."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, t: int, n_nodes: int, start: int, stop: int,
                device=None, *, salt: int = 0, node0: int = 0) -> torch.Tensor:
    """The production noise bits of round ``t``: (n_nodes, stop - start)
    int64 holding uint32 values for elements [start, stop) of the rows of
    global nodes ``node0`` ... ``node0 + n_nodes - 1`` (a rank's row block
    of the sharded engine; 0 for the whole network).

    Element ``e`` of node ``n`` is word ``e % 4`` of Philox4x32-10 with key
    ``(seed lo, seed hi)`` and counter ``(e // 4 lo, e // 4 hi, n, t)`` —
    a pure function of (seed, t, node, e), as the Philox variant of
    ``csrc/dpps_perturb.cu`` computes it. It stands where the reference's
    ``fold_in(key, t)`` / ``split(key, N)`` / ``jax.random.bits`` chain
    stands (``repro/engine/rounds.py``, ``repro/kernels/ops.py``). A
    nonzero ``salt`` is xored into the key's high word: a stream of its
    own (the wire codecs' uniforms, the Gaussian mechanism's normals) that
    shares no word with the noise bits.
    """
    q0, q1 = start // 4, -(-stop // 4)
    q = torch.arange(q0, q1, dtype=torch.int64, device=device)[None, :]
    nodes = torch.arange(node0, node0 + n_nodes, dtype=torch.int64,
                         device=device)[:, None]
    shape = (n_nodes, q1 - q0)
    ctr = (q.expand(shape) & _MASK32, (q >> 32).expand(shape),
           nodes.expand(shape),
           torch.full(shape, int(t) & _MASK32, dtype=torch.int64,
                      device=device))
    words = philox4x32_10(ctr, (seed & _MASK32,
                                ((seed >> 32) ^ salt) & _MASK32))
    flat = torch.stack(words, dim=-1).reshape(n_nodes, 4 * (q1 - q0))
    lo = start - 4 * q0
    return flat[:, lo:lo + (stop - start)]


class ColumnMap(NamedTuple):
    """The wire columns of a leaf's flat per-node elements where the rank
    holds a block of the leaf (a model-axis shard): element j is wire
    column ``col0 + (j // run) * stride + off + j % run``. ``col0`` is the
    whole leaf's first column in the wire row, ``stride`` the elements of
    the whole leaf from one index of the dims before the split dim to the
    next (the split dim's width times its trailing dims' sizes), ``run``
    the rank's share of them (its block's width times the same) and
    ``off`` where its block starts (the block's first index times the
    same). ``run == stride`` is the contiguous case: column ``col0 + off +
    j`` (a split on the leaf's leading dim, or no split)."""

    col0: int
    run: int
    stride: int
    off: int = 0

    @property
    def contiguous(self) -> bool:
        return self.run == self.stride

    def columns(self, start: int, stop: int, device=None) -> torch.Tensor:
        """The wire columns of elements [start, stop), int64."""
        j = torch.arange(start, stop, dtype=torch.int64, device=device)
        return self.col0 + (j // self.run) * self.stride + self.off + \
            j % self.run


def philox_columns(seed: int, t: int, n_nodes: int, cols: torch.Tensor, *,
                   node0: int = 0) -> torch.Tensor:
    """The noise bits of round ``t`` at the wire columns ``cols`` (int64,
    any order) of global nodes ``node0`` ... ``node0 + n_nodes - 1``:
    (n_nodes, len(cols)) int64 holding uint32 values, column e being word
    ``e % 4`` of the Philox counter ``e // 4`` as in :func:`philox_bits`.
    The plain version of ``csrc/dpps_perturb.cu``'s column map (a rank's
    shard of a leaf draws the whole leaf's bits at its columns); each
    element evaluates its own counter."""
    q = (cols // 4)[None, :]
    nodes = torch.arange(node0, node0 + n_nodes, dtype=torch.int64,
                         device=cols.device)[:, None]
    shape = (n_nodes, cols.shape[0])
    ctr = (q.expand(shape) & _MASK32, (q >> 32).expand(shape),
           nodes.expand(shape),
           torch.full(shape, int(t) & _MASK32, dtype=torch.int64,
                      device=cols.device))
    words = torch.stack(philox4x32_10(ctr, (seed & _MASK32,
                                            (seed >> 32) & _MASK32)), dim=-1)
    return words.gather(-1, (cols % 4)[None, :, None].expand(
        shape + (1,)))[..., 0]


def philox_map(seed: int, t: int, n_nodes: int, col_map: ColumnMap,
               size: int, device=None, *, node0: int = 0) -> torch.Tensor:
    """The noise bits of a leaf's first ``size`` elements at the columns of
    ``col_map``: :func:`philox_bits` where they are contiguous, else
    :func:`philox_columns`."""
    if col_map.contiguous:
        c0 = col_map.col0 + col_map.off
        return philox_bits(seed, t, n_nodes, c0, c0 + size, device=device,
                           node0=node0)
    return philox_columns(seed, t, n_nodes,
                          col_map.columns(0, size, device), node0=node0)


def laplace_from_bits(bits: torch.Tensor, scale) -> torch.Tensor:
    """Laplace(0, scale) from uint32 bits by the inverse CDF.

    Mirrors ``repro.kernels.ref.laplace_from_bits`` (the transform of the
    Pallas kernel ``repro/kernels/laplace_noise.py::_laplace_transform``):
    ``u = (bits >> 8) 2^-24``, ``c = u - 1/2``,
    ``-scale sign(c) log(max(1 - 2|c|, 1e-30))``. Bits ``1 << 31`` give
    exactly zero noise. Plain version of ``csrc/laplace_noise.cu`` (the
    Pallas ``repro/kernels/laplace_noise.py::laplace_from_bits``) and of
    the transform inside ``csrc/dpps_perturb.cu``.
    """
    u = (bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    c = u - 0.5
    mag = torch.clamp_min(1.0 - 2.0 * c.abs(), 1e-30)
    if isinstance(scale, torch.Tensor):
        scale = scale.to(torch.float32)
    return -scale * torch.sign(c) * torch.log(mag)


def l1_norm_rows(buf: torch.Tensor, d_s: int) -> torch.Tensor:
    """Per-row L1 norm of the first ``d_s`` columns -> (N,).

    Plain version of ``csrc/l1_norm.cu``; mirrors the Pallas
    ``repro/kernels/l1_clip.py::l1_norm`` as ``repro.kernels.ops.
    l1_norm_packed`` applies it per node (oracle: ``repro.kernels.ref.
    l1_norm``).
    """
    return buf[:, :d_s].to(torch.float32).abs().sum(dim=1)


def clip_scale_rows(buf: torch.Tensor, d_s: int,
                    denom: torch.Tensor) -> torch.Tensor:
    """Row i of ``buf[:, :d_s]`` divided by ``denom[i]``; pad columns 0.

    A division, as the Pallas kernel divides, not a product with the
    reciprocal. Plain version of ``csrc/clip_scale.cu``; mirrors the
    Pallas ``repro/kernels/l1_clip.py::clip_scale`` as ``repro.kernels.ops.
    l1_clip_tree`` applies it per node (oracle: ``repro.kernels.ref.
    clip_scale``).
    """
    n, d_pad = buf.shape
    row = buf[:, :d_s].to(torch.float32) / denom.to(torch.float32)[:, None]
    if d_pad != d_s:
        row = torch.cat([row, row.new_zeros((n, d_pad - d_s))], dim=1)
    return row


def dpps_perturb_rows(s: torch.Tensor, eps: torch.Tensor, scale,
                      gamma_n: float, d_s: int, *,
                      bits: torch.Tensor | None = None,
                      seed: int | None = None, t: int | None = None,
                      col0: int = 0, node0: int = 0,
                      col_map: ColumnMap | None = None):
    """Fused Eq. 7 + Eq. 8 over the packed rows.

    ``s_noise = s + eps + gamma_n Lap(bits; scale)`` on the first ``d_s``
    columns, exact zeros in the pad columns, plus per-row ``||eps||_1`` and
    ``||noise||_1``. ``bits`` (N, d_s) uint32 feeds explicit bits (the
    bits-in variant); otherwise :func:`philox_bits` of ``(seed, t)`` at wire
    columns ``[col0, col0 + d_s)`` (a leaf whose first column in the wire
    row is ``col0``) of global nodes ``[node0, node0 + N)``, or, with
    ``col_map`` (which then replaces ``col0``), at its columns
    (:func:`philox_columns`).

    Plain version of ``csrc/dpps_perturb.cu``; mirrors the Pallas
    ``repro/kernels/dpps_perturb.py::dpps_perturb`` as ``repro.kernels.ops.
    dpps_perturb_packed`` applies it (oracle: ``repro.kernels.ref.
    dpps_perturb``).
    """
    n, d_pad = s.shape
    if bits is None:
        bits = philox_map(seed, t, n, col_map or ColumnMap(col0, 1, 1), d_s,
                          s.device, node0=node0)
    noise = laplace_from_bits(bits, scale)
    eps_w = eps[:, :d_s].to(torch.float32)
    row = s[:, :d_s].to(torch.float32) + eps_w + gamma_n * noise
    if d_pad != d_s:
        row = torch.cat([row, row.new_zeros((n, d_pad - d_s))], dim=1)
    return (row.to(s.dtype), eps_w.abs().sum(dim=1),
            noise.abs().sum(dim=1))


def leaf_columns(leaves) -> list[int]:
    """The first wire column of each node-stacked leaf: the running sum of
    the per-node sizes in leaf order. ``PackedLayout`` takes its segment
    offsets from here, so the tree routes and the packed row agree."""
    cols, off = [], 0
    for x in leaves:
        cols.append(off)
        off += x[0].numel()
    return cols


def _leaf_bits(bits, i: int, x: torch.Tensor):
    """Leaf i's (N, size) bits of ``bits`` (None, or one tensor a leaf)."""
    return None if bits is None else bits[i].reshape(x.shape[0], -1)


def l1_norm_tree(leaves, counted=None) -> torch.Tensor:
    """Per-node L1 norms of node-stacked leaves: each leaf's norm over its
    flat (N, size) rows, summed in leaf order -> (N,); ``counted`` as
    :func:`dpps_perturb_tree` takes it. Plain version of
    ``ops.l1_norm_tree``; mirrors ``repro.kernels.ops.l1_norm_tree``."""
    total = None
    for i, x in enumerate(leaves):
        part = counted_part(x, None if counted is None else counted[i])
        norm = x.new_zeros((x.shape[0],), dtype=torch.float32) \
            if part is None else l1_norm_rows(part.reshape(x.shape[0], -1),
                                              part[0].numel())
        total = norm if total is None else total + norm
    return total


def counted_map(col_map: ColumnMap, keep: slice) -> ColumnMap:
    """``col_map`` (a block split on the leaf's last dim) cut to the
    ``keep`` slice of that dim."""
    if col_map.contiguous:
        raise ValueError("a part of a leaf is counted only on its last "
                         f"dim, got the map {tuple(col_map)}")
    return ColumnMap(col_map.col0, keep.stop - keep.start, col_map.stride,
                     col_map.off + keep.start)


def tree_column_maps(leaves, col_maps=None) -> list:
    """Each leaf's :class:`ColumnMap`: ``col_maps`` where given (a rank's
    shards of a model-sharded tree), else the contiguous columns from
    :func:`leaf_columns`."""
    if col_maps is not None:
        if len(col_maps) != len(leaves):
            raise ValueError(f"{len(col_maps)} column maps for "
                             f"{len(leaves)} leaves")
        return list(col_maps)
    return [ColumnMap(c0, 1, 1) for c0 in leaf_columns(leaves)]


def dpps_perturb_tree(s_leaves, eps_leaves, scale, gamma_n: float, *,
                      bits=None, seed: int | None = None,
                      t: int | None = None, node0: int = 0, col_maps=None,
                      counted=None):
    """:func:`dpps_perturb_rows` leaf by leaf -> (s_noise leaves, eps_l1
    (N,), noise_l1 (N,)), the norms summed in leaf order. ``bits`` is one
    uint32 tensor a leaf; otherwise leaf i draws the Philox bits of its wire
    columns (``col0`` = :func:`leaf_columns`, the packed row's bits, or its
    ``col_maps[i]``). ``counted`` (one entry a leaf, ``core.tree_utils.
    counted_part``'s;
    default all) leaves out of the norms the columns another rank counts:
    a leaf counted in part gives the norms of a second pass over the
    counted part alone. An empty leaf (a rank without heads) draws
    nothing. Plain version of ``ops.dpps_perturb_tree``; mirrors
    ``repro.kernels.ops.dpps_perturb_tree``."""
    out, eps_l1, noise_l1 = [], None, None
    maps = tree_column_maps(s_leaves, col_maps)
    for i, (x, e, cmap) in enumerate(zip(s_leaves, eps_leaves, maps)):
        n, size = x.shape[0], x[0].numel()
        keep = None if counted is None else counted[i]
        zero = x.new_zeros((n,), dtype=torch.float32)
        if size == 0:
            out.append(x.clone())
            e1 = n1 = zero
        else:
            lb = _leaf_bits(bits, i, x)
            sn, e1, n1 = dpps_perturb_rows(
                x.reshape(n, size), e.reshape(n, size), scale, gamma_n,
                size, bits=lb, seed=seed, t=t, node0=node0, col_map=cmap)
            out.append(sn.reshape(x.shape))
            if keep is False:
                e1 = n1 = zero
            elif isinstance(keep, slice):
                xs, es = x[..., keep], e[..., keep]
                sub = xs[0].numel()
                _, e1, n1 = dpps_perturb_rows(
                    xs.reshape(n, sub), es.reshape(n, sub), scale, gamma_n,
                    sub, bits=None if lb is None else
                    bits[i][..., keep].reshape(n, sub), seed=seed, t=t,
                    node0=node0, col_map=counted_map(cmap, keep))
        eps_l1 = e1 if eps_l1 is None else eps_l1 + e1
        noise_l1 = n1 if noise_l1 is None else noise_l1 + n1
    return out, eps_l1, noise_l1


def laplace_noise_like(x: torch.Tensor, scale, *,
                       bits: torch.Tensor | None = None,
                       seed: int | None = None, t: int | None = None,
                       col0: int = 0) -> torch.Tensor:
    """Laplace(0, scale) shaped like the node-stacked leaf ``x``: from
    ``bits`` (x's shape, uint32) or from the Philox bits of wire columns
    ``[col0, col0 + size)`` of each node's row in round ``t``. Plain version
    of ``ops.laplace_noise_like``."""
    if bits is None:
        n, size = x.shape[0], x[0].numel()
        bits = philox_bits(seed, t, n, col0, col0 + size, device=x.device)
    return laplace_from_bits(bits, scale).reshape(x.shape).to(x.dtype)


def pushsum_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` with f32 accumulation, result in x's dtype.

    Plain version of ``csrc/pushsum_mix.cu``; mirrors the Pallas
    ``repro/kernels/pushsum_mix.py::pushsum_mix`` (oracle:
    ``repro.kernels.ref.pushsum_mix``).
    """
    return (w.to(torch.float32) @ x.to(torch.float32)).to(x.dtype)


def spmm(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Padded-CSR mix ``out[i] = sum_k vals[i, k] x[idx[i, k]]`` in f32.

    ``idx`` (B, K) integer sender indices into the rows of ``x`` (N, D),
    ``vals`` (B, K) their weights; the result has B rows. The slots are
    added in storage order, one gather-and-add a slot, so no (B, K, D)
    temporary is made. Plain version of ``csrc/spmm.cu``; mirrors the
    Pallas ``repro/kernels/spmm.py::spmm`` as ``repro.kernels.ops.
    pushsum_mix_sparse`` applies it (oracle: ``repro.kernels.ref.spmm``).
    """
    idx = idx.to(torch.int64)
    w = vals.to(torch.float32)
    xf = x.to(torch.float32)
    out = torch.zeros((idx.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(idx.shape[1]):
        out += w[:, k, None] * xf[idx[:, k]]
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, window: int | None = None,
                    q_start: int = 0, head0: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention, softmax in f32.

    q (..., H, Sq, D); k, v (..., K, Sk, D); query head h reads KV head
    (``head0`` + h) // group: H = K group with ``head0`` 0, or a rank's
    run of heads that starts ``head0`` heads into its first KV head's
    group (a model axis's :class:`~repro_torch.models.parallel.HeadShare`;
    computed here over the KV heads' whole groups, the run cut out after).
    Query row i sits at position ``q_start + i``, key j at
    position j; key j is seen by row i when ``j <= q_start + i`` and, with
    ``window`` >= 0, ``q_start + i - j < window`` (``None`` or < 0: global).
    ``q_start`` lets a caller take the rows of a long sequence in windows
    against the keys up to the window's end. Scores are scaled by
    1/sqrt(D) and masked with -1e30, as the Pallas kernel does. Plain
    version of ``csrc/flash_attention.cu``; mirrors the Pallas
    ``repro/kernels/flash_attention.py::flash_attention`` (oracle:
    ``repro.kernels.ref.flash_attention``).
    """
    *lead, h, sq, d = q.shape
    kh, sk = k.shape[-3], k.shape[-2]
    if head0 != 0 or h != kh * group:
        if head0 < 0 or head0 + h > kh * group or (h and head0 >= group):
            raise ValueError(f"{h} query heads from head {head0} of the "
                             f"groups of {kh} KV heads x {group}")
        qp = F.pad(q, (0, 0, 0, 0, head0, kh * group - head0 - h))
        return flash_attention(qp, k, v, group=group, window=window,
                               q_start=q_start)[..., head0:head0 + h, :, :]
    qg = q.float().reshape(*lead, kh, group, sq, d)
    scores = torch.einsum("...kgqd,...ktd->...kgqt", qg, k.float()) / \
        torch.sqrt(torch.tensor(float(d)))
    qpos = torch.arange(q_start, q_start + sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window is not None and window >= 0:
        mask = mask & ((qpos - kpos) < window)
    probs = torch.softmax(scores.masked_fill_(~mask, -1e30), dim=-1)
    out = torch.einsum("...kgqt,...ktd->...kgqd", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)
