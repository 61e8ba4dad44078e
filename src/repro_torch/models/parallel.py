"""The model axis: tensor and expert parallelism of a model over the M
ranks of a mesh's "model" dim, for serving and for training (the port's
stand-in for what GSPMD derives from the reference's pspecs,
``repro/launch/steps.py:95-218``).

Rank r of M holds the reference's pspecs applied by rank
(:func:`leaf_sharding`), by whole heads: query heads ``[floor(r H / M),
floor((r + 1) H / M))`` (:func:`span`: runs whose lengths differ by at
most one, empty where M > H) of ``wq`` and the rows of ``wo`` that read
them, the KV heads those query heads read of ``wk`` / ``wv`` (a KV head
that several ranks' query heads read is whole on each of them; a GQA
group may straddle two ranks: :class:`HeadShare`), column blocks of
``w_up`` / ``w_gate`` and row blocks of ``w_down`` (the dense MLP and the
shared expert), experts ``[r E/M, (r+1) E/M)``, vocabulary rows of
``embed`` and columns of ``lm_head``; norms and the router whole. M need
divide only the leaf dims the reference's pspecs put on "model"
(:meth:`ModelAxis.check`), not the head counts. Its KV cache follows its
KV heads, and with the reference's ``shard_seq`` (a decode of global
batch 1) its slots split over "data". The recurrent and cross-attention
groups split by head too: an mLSTM's ``w_q`` / ``w_k`` / ``w_v`` /
``w_o`` column runs and ``w_down`` row run are its heads' (``n_heads`` of
the config; ``w_up`` in M even blocks, its ``u`` gathered whole), a
Mamba2 layer's ``w_in`` the ``x`` and the gate ``z`` columns of its heads
of nh (:class:`Halves`) and ``w_out`` their rows, a cross layer's ``wq``
/ ``wk`` / ``wv`` / ``wo`` as self-attention's; an mLSTM cache its heads'
``C`` / ``n`` / ``m``, a Mamba2 cache its heads' ``h``.
The sLSTM, the gates' and the SSM's small leaves (``w_if``, ``b_if``,
``w_b``, ``w_c``, ``w_dt``, ``b_dt``, ``a_log``, ``d_skip``) and a cross
layer's ``gate`` stay whole. A data dim of the mesh splits the batch into
row blocks.

Every collective goes through one :class:`ModelAxis`:

* :meth:`ModelAxis.reduce`, a SUM all-reduce over "model": after ``wo``,
  after ``w_down`` or after the MoE combine (the shared expert's partial
  folded in), and after the masked vocabulary-row lookup
  (:meth:`ModelAxis.embed`);
* :meth:`ModelAxis.gather_vocab`, the logits' vocabulary gather, written
  as an all-reduce into a zero-filled (..., V) buffer: exact (every other
  rank adds zeros), and an op gloo runs on CUDA tensors (gloo has only
  all-reduce and broadcast there). A ring all-reduce moves 2 (M - 1) / M
  of the buffer a rank against an all-gather's (M - 1) / M: twice the
  wire bytes, on one (B, V) row a step;
* :meth:`ModelAxis.gather`, the mLSTM's up-projection ``u`` gathered
  over "model" the same way (its ``w_up`` is column-split, while its
  ``w_q`` / ``w_k`` / ``w_v`` / ``w_if`` read the whole of ``u``);
* :meth:`ModelAxis.gather_rows`, the MoE groups' routed tokens gathered
  over "data" the same way, so routing, capacity and drops are the
  whole batch's, as the reference's GSPMD program computes them (only
  where the data dim is above 1 and splits the batch);
* :meth:`ModelAxis.seq_max` and :meth:`ModelAxis.seq_sum`, the MAX and
  the SUM over "data" that merge the data ranks' partials of a decode's
  attention where the KV slots are split (:attr:`ModelAxis.seq_split`).

Training (grad enabled) runs the same sums as collectives autograd sees,
in the Megatron pattern: :meth:`ModelAxis.reduce` is then
*reduce-from-model* (forward a SUM all-reduce, backward the identity) and
:meth:`ModelAxis.copy` *copy-to-model* (forward the identity, backward a
SUM all-reduce), where the replicated stream enters a column-split block:
the normed input of ``wq`` / ``wk`` / ``wv``, of ``w_up`` / ``w_gate``,
of the head, and the MoE block's dispatched tokens and gate
probabilities (the router itself runs replicated on every rank, so its
gradient, the load-balance loss's among it, is whole on every rank), and
each whole leaf that a head-split block reads only in part (the mLSTM's
``w_if`` / ``b_if``; Mamba2's ``w_b``, ``w_c``, ``w_dt``, ``b_dt``,
``a_log``, ``d_skip``): each rank's gradient of it is its heads' share,
summed over "model" so that it is whole on every rank and counted once.
:meth:`ModelAxis.gather` is then *gather-to-model* (backward the SUM of
the ranks' partial gradients of the whole ``u``, then the rank's block).
A KV head that several ranks hold sums its ``wk`` / ``wv`` gradient
over them (:meth:`ModelAxis.shared_kv`), and the loss is vocabulary-parallel
(:meth:`ModelAxis.cross_entropy`): no (..., V) logits cross the wire.
Without grad (serving) the ops are the in-place all-reduces they were.
A training axis has a data dim of 1: there "data" splits the nodes of
the protocol (:mod:`repro_torch.engine.shard`), and each node routes its
own batch's tokens.

The default axis (:data:`NO_AXIS`: M = 1, no group) is off: every method
returns its input and the model runs today's ops, op for op. An axis with
a group issues its c10d calls whatever M (M = 1: identities). An axis of
M > 1 without a group is the dry run's (:mod:`repro_torch.launch.
dryrun`): on meta tensors it issues no call and charges the collective's
operand bytes to the active cost count
(:func:`repro_torch.core.loops.charge_collective`), in the backward too;
on real tensors it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import loops

__all__ = ["ModelAxis", "NO_AXIS", "SHARDED_KINDS", "MAMBA2_HEAD_DIM",
           "Halves", "HeadShare", "leaf_sharding", "take", "mamba2_heads",
           "span", "owned_runs"]

# the group kinds the model axis splits: all of them
SHARDED_KINDS = ("attn", "moe", "xlstm", "mamba", "zamba", "cross_self")
_KV_LEAVES = ("wk", "wv")
# Mamba2's head dim (the reference's, fixed at 64 whatever the config)
MAMBA2_HEAD_DIM = 64


def mamba2_heads(cfg, group) -> int:
    """The Mamba2 heads ``nh = expand d_model / 64`` of a mamba or zamba
    group of ``cfg``."""
    return group.expand * cfg.d_model // MAMBA2_HEAD_DIM


@dataclasses.dataclass(frozen=True)
class Halves:
    """A rank's share of a dim cut into two equal halves (Mamba2's ``w_in``:
    the ``x`` columns, then the gate ``z`` columns): indices ``[start,
    stop)`` of each half, the rank's heads' in both."""

    start: int
    stop: int


def span(n: int, size: int, rank: int) -> slice:
    """Rank ``rank``'s items of ``n`` over ``size`` ranks: ``[floor(rank n /
    size), floor((rank + 1) n / size))``, whole items in runs whose lengths
    differ by at most one, empty runs where ``size > n``."""
    return slice(rank * n // size, (rank + 1) * n // size)


def _kv_of(q: slice, group: int) -> slice:
    """The KV heads query heads ``q`` read (head h reads KV head h //
    ``group``); an empty run for no query heads."""
    if q.stop == q.start:
        return slice(q.start // group, q.start // group)
    return slice(q.start // group, (q.stop - 1) // group + 1)


def owned_runs(runs: list) -> list:
    """Each rank's part of its run (a slice of one dim, in rank order, the
    runs' starts never decreasing) that no earlier rank holds: where
    neighbours share items (a KV head two ranks read), the first of them
    owns it."""
    out, top = [], 0
    for sl in runs:
        start = min(max(sl.start, top), sl.stop)
        out.append(slice(start, sl.stop))
        top = max(top, sl.stop)
    return out


@dataclasses.dataclass(frozen=True)
class HeadShare:
    """A rank's query heads ``[q0, q0 + h)`` and the KV heads ``[k0, k0 +
    kv)`` they read, query head q reading KV head q // ``group`` (H / K of
    the whole model)."""

    q0: int
    h: int
    k0: int
    kv: int
    group: int

    @property
    def off(self) -> int:
        """Where the rank's first query head sits in its KV heads' groups:
        local head i reads local KV head (off + i) // group."""
        return self.q0 - self.k0 * self.group

    def grid(self, q: torch.Tensor):
        """q (B, S, h, D) of the rank's heads -> (qg (B, S, kv, g, D), a
        function taking an output on that grid back to (B, S, h, D)): a
        reshape where the heads fill whole groups or read one KV head;
        else the KV heads' whole groups, zero heads padded in before and
        after the rank's (a GQA group straddling two ranks) and cut off
        again."""
        b, s, h, d = q.shape
        kv, g = (self.kv, self.h) if self.kv <= 1 else (self.kv, self.group)
        if kv * g == h:
            return q.reshape(b, s, kv, g, d), lambda o: o.reshape(b, s, h, d)
        lo = self.off
        qp = F.pad(q, (0, 0, lo, kv * g - lo - h))
        return qp.reshape(b, s, kv, g, d), \
            lambda o: o.reshape(b, s, kv * g, d)[:, :, lo:lo + h]


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """Rank ``rank`` of ``size`` along "model" (``group`` its c10d group,
    None without a process group) and of ``data_size`` along "data"."""

    size: int = 1
    rank: int = 0
    group: Any = None
    data_size: int = 1
    data_rank: int = 0
    data_group: Any = None
    shard_seq: bool = False

    @property
    def off(self) -> bool:
        """No axis: one rank, no group; every method is the identity."""
        return (self.group is None and self.size == 1
                and self.data_group is None and self.data_size == 1)

    # -- the rank's share ----------------------------------------------------
    @property
    def seq_split(self) -> bool:
        """The KV caches' slots split over "data" (the sequence-sharded
        decode of a global batch of one, the reference's ``shard_seq``):
        the batch whole on every data rank, its recurrent states too."""
        return self.shard_seq and self.data_size > 1

    def block(self, n: int, name: str = "dim") -> slice:
        """This rank's contiguous block of ``n`` along "model"."""
        if n % self.size:
            raise ValueError(f"{name} = {n} does not divide over the "
                             f"{self.size} ranks of the model axis")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def span(self, n: int) -> slice:
        """This rank's whole items of ``n`` (heads) along "model": :func:`span`
        of its rank."""
        return span(n, self.size, self.rank)

    def data_block(self, n: int, name: str) -> slice:
        """This rank's block of ``n`` along "data" (the batch rows, or the
        KV slots of a sequence-sharded cache)."""
        if n % self.data_size:
            raise ValueError(f"{name} {n} does not divide over the "
                             f"{self.data_size} ranks of the data axis")
        b = n // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` along "data" (all of them
        where the sequence is split instead)."""
        if self.seq_split:
            return slice(0, n)
        return self.data_block(n, "batch")

    def kv_heads(self, n_heads: int, n_kv_heads: int) -> slice:
        """The KV heads this rank's query heads (:meth:`span` of
        ``n_heads``) read: query head q reads KV head q // (H / K); a run
        of them, shared with a neighbour where a GQA group straddles two
        ranks; empty for a rank without heads."""
        return _kv_of(self.span(n_heads), n_heads // n_kv_heads)

    def attn_heads(self, n_heads: int, n_kv_heads: int) -> "HeadShare":
        """This rank's :class:`HeadShare` of an attention of ``n_heads``
        query and ``n_kv_heads`` KV heads."""
        q, g = self.span(n_heads), n_heads // n_kv_heads
        kv = _kv_of(q, g)
        return HeadShare(q.start, q.stop - q.start, kv.start,
                         kv.stop - kv.start, g)

    def kv_overlap(self, cfg) -> bool:
        """Whether some KV head of ``cfg`` is held by more than one rank
        (a property of H, K and M, the same on every rank)."""
        runs = [_kv_of(span(cfg.n_heads, self.size, r),
                       cfg.n_heads // cfg.n_kv_heads)
                for r in range(self.size)]
        return bool(owned_runs(runs) != runs)

    def check(self, cfg) -> None:
        """Refuse a model this axis cannot split: a leaf dim that the
        reference's pspecs put on "model" and M does not divide (H D, K D,
        ``d_ff``, V, E, Mamba2's 2 d_inner, an mLSTM's column leaves): a
        ``ValueError`` naming every such leaf and the config dims it is
        made of. The head counts need not divide M (:meth:`span`)."""
        if self.size == 1:
            return
        from repro_torch.models.transformer import Transformer

        bad = [f"{path} dim {dim} = {n} ({_dim_name(path)})"
               for path, dim, n in Transformer(cfg).model_dims()
               if n % self.size]
        if bad:
            raise ValueError(f"{'; '.join(bad)}: does not divide over the "
                             f"{self.size} ranks of the model axis")

    def heads(self, n: int) -> slice | None:
        """This rank's heads of ``n``: :meth:`span`, None where the rank
        holds all of them (M = 1)."""
        return None if self.size == 1 else self.span(n)

    # -- collectives ---------------------------------------------------------
    @staticmethod
    def _sum(x: torch.Tensor, group, size: int,
             op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``op`` (SUM) all-reduce of ``x`` in place over ``group``; on meta
        without a group, charged to the cost count."""
        if group is not None:
            x = x.contiguous()
            dist.all_reduce(x, op=op, group=group)
        elif size > 1:
            if not x.is_meta:
                raise RuntimeError("a model axis of more than one rank needs "
                                   "a process group (launch.mesh.model_axis)")
            loops.charge_collective("all-reduce", x.numel() * x.element_size())
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial ``x`` over "model": in place
        without grad; with grad, reduce-from-model (a new tensor; backward
        the identity)."""
        if self.off:
            return x
        if torch.is_grad_enabled():
            return _ReduceFromModel.apply(x, self)
        return self._sum(x, self.group, self.size)

    def sum_columns(self, x: torch.Tensor) -> torch.Tensor:
        """The SUM over "model" of this rank's partial per-node norms
        (outside autograd): the column-sum seam of a model-sharded protocol
        state (:class:`repro_torch.core.dpps.ColumnOps`)."""
        if self.off:
            return x
        return self._sum(x.detach().clone(), self.group, self.size)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated over "model") where it enters a column-split
        block: with grad, copy-to-model (the identity; backward the SUM of
        every rank's partial gradient); without grad, ``x``."""
        if self.off or not torch.is_grad_enabled():
            return x
        return _CopyToModel.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n/M) block of this rank -> (..., n), every rank's block in
        rank order: an all-reduce into a zero-filled buffer (exact; gloo
        runs it on CUDA tensors). With grad, gather-to-model: backward the
        SUM all-reduce of the whole gradient (each rank's paths give only a
        partial one), then the rank's block."""
        if self.off:
            return x
        if torch.is_grad_enabled():
            return _GatherFromModel.apply(x, self)
        return self._gather(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        full = x.new_zeros(tuple(x.shape[:-1]) + (n * self.size,))
        full[..., self.rank * n:(self.rank + 1) * n] = x
        return self._sum(full, self.group, self.size)

    def shared_kv(self, cfg):
        """Where some KV head is held by more than one rank (K < M, or a GQA
        group straddling two ranks) and grad is enabled: a function of this
        rank's ``wk`` / ``wv`` (its KV heads' D columns each, last) whose
        backward sums the gradient over the ranks holding the same heads
        (an all-reduce over "model" of the (..., K D) gradient with the
        rank's heads in their columns, zeros elsewhere: exact for any set
        of holders). Else None."""
        if self.off or not torch.is_grad_enabled() \
                or not self.kv_overlap(cfg):
            return None
        kv = self.kv_heads(cfg.n_heads, cfg.n_kv_heads)
        d = cfg.head_dim
        cols, total = slice(kv.start * d, kv.stop * d), cfg.n_kv_heads * d
        return lambda w: _SharedHead.apply(w, self, cols, total)

    def cross_entropy(self, logits: torch.Tensor, targets: torch.Tensor,
                      vocab: int) -> torch.Tensor:
        """``sum(logsumexp(z) - z[target])`` over the positions, ``z`` the
        whole vocabulary's logits, from this rank's block (..., V/M) of
        them (f32): its max, a MAX all-reduce (no gradient), its sum of
        exponentials, a SUM all-reduce; the target's logit a masked pick
        and a SUM all-reduce."""
        rows = self.block(vocab, "vocab_size")
        with torch.no_grad():
            top = self._sum(logits.amax(dim=-1), self.group, self.size,
                            op=dist.ReduceOp.MAX)
        lse = torch.log(self.reduce(
            torch.exp(logits - top[..., None]).sum(dim=-1))) + top
        local = targets - rows.start
        mine = (local >= 0) & (local < logits.shape[-1])
        picked = logits.gather(
            -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        return (lse - self.reduce(torch.where(mine, picked, 0.0))).sum()

    def gather_vocab(self, x: torch.Tensor, vocab: int) -> torch.Tensor:
        """(..., V/M) logits of this rank's vocabulary block -> (..., V): an
        all-reduce into a zero-filled buffer."""
        if self.off:
            return x
        full = x.new_zeros(tuple(x.shape[:-1]) + (vocab,))
        full[..., self.block(vocab, "vocab_size")] = x
        return self.reduce(full)

    def embed(self, tokens: torch.Tensor, table: torch.Tensor,
              vocab: int) -> torch.Tensor:
        """Rows of the embedding for ``tokens``, this rank holding rows
        [r V/M, (r+1) V/M) of ``table``: a masked lookup, then the sum."""
        if self.off:
            return F.embedding(tokens, table)
        rows = self.block(vocab, "vocab_size")
        local = tokens - rows.start
        mine = (local >= 0) & (local < table.shape[0])
        x = F.embedding(local.clamp(0, table.shape[0] - 1), table)
        return self.reduce(torch.where(mine[..., None], x, 0.0))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(T, ...) rows of this rank's batch -> (data T, ...) of every
        data rank, in rank order (the rank's own rows where the batch is
        whole on every data rank)."""
        if self.data_size == 1 or self.seq_split:
            return x
        t = x.shape[0]
        full = x.new_zeros((self.data_size * t,) + tuple(x.shape[1:]))
        full[self.data_rank * t:(self.data_rank + 1) * t] = x
        return self._sum(full, self.data_group, self.data_size)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a :meth:`gather_rows` result."""
        if self.data_size == 1 or self.seq_split:
            return x
        t = x.shape[0] // self.data_size
        return x[self.data_rank * t:(self.data_rank + 1) * t]

    def seq_max(self, x: torch.Tensor) -> torch.Tensor:
        """The MAX over "data" of the data ranks' partial maxima (a
        sequence-sharded decode's scores), in place."""
        return self._sum(x, self.data_group, self.data_size,
                         op=dist.ReduceOp.MAX)

    def seq_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The SUM over "data" of the data ranks' partial sums, in place."""
        return self._sum(x, self.data_group, self.data_size)


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the SUM all-reduce of a copy of ``x``; backward: the
    identity (every rank already holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._sum(x.clone(memory_format=torch.contiguous_format),
                         axis.group, axis.size)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: every rank's block of the last dim, gathered; backward: the
    SUM all-reduce of the gradient (a copy), then the rank's block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        return axis._gather(x)

    @staticmethod
    def backward(ctx, grad):
        axis, n = ctx.axis, ctx.n
        full = axis._sum(grad.clone(memory_format=torch.contiguous_format),
                         axis.group, axis.size)
        return full[..., axis.rank * n:(axis.rank + 1) * n].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity; backward: the SUM all-reduce of the rank's
    partial gradient (a copy: autograd's own buffer is left alone)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        return axis._sum(grad.clone(memory_format=torch.contiguous_format),
                         axis.group, axis.size), None


class _SharedHead(torch.autograd.Function):
    """Forward: the identity on a shared KV head's ``wk`` / ``wv``;
    backward: the sum of the gradient over the ranks holding that head."""

    @staticmethod
    def forward(ctx, w, axis, cols, total):
        ctx.axis, ctx.cols, ctx.total = axis, cols, total
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        axis, cols = ctx.axis, ctx.cols
        full = grad.new_zeros(tuple(grad.shape[:-1]) + (ctx.total,))
        full[..., cols] = grad
        full = axis._sum(full, axis.group, axis.size)
        return full[..., cols].contiguous(), None, None, None


NO_AXIS = ModelAxis()


def _dim_name(path: str) -> str:
    """The config dims a "model" leaf dim at ``path`` is made of (for a
    refusal's message)."""
    key = path.rsplit("/", 1)[-1]
    if key in ("embed", "lm_head"):
        return "vocab_size"
    if "/mlstm/" in path:
        return "the mLSTM's d_inner: n_heads x its head dim"
    if key == "w_in":
        return "2 d_inner of nh (the Mamba2 heads) x 64"
    if key == "w_out":
        return "d_inner of nh (the Mamba2 heads) x 64"
    if key in ("wq", "wo"):
        return "n_heads x head_dim"
    if key in _KV_LEAVES:
        return "n_kv_heads x head_dim"
    if "/moe/" in path and "/shared/" not in path:
        return "n_experts"
    return "d_ff"


def _head_leaf(path: str, n: int, cfg) -> tuple[int, int] | None:
    """(heads, columns a head) of a "model" leaf dim of width ``n`` that a
    rank holds by whole heads (:meth:`ModelAxis.span`): the attention's
    ``wq`` columns and ``wo`` rows (H heads of ``head_dim``), an mLSTM's
    ``w_q`` / ``w_k`` / ``w_v`` / ``w_o`` columns and ``w_down`` rows
    (``n_heads`` of d_inner / H), Mamba2's ``w_out`` rows (nh of 64); None
    for a leaf cut into even blocks (its ``w_up``: the whole ``u`` is
    gathered) or by KV heads."""
    key = path.rsplit("/", 1)[-1]
    if "/mlstm/" in path:
        if key in ("w_q", "w_k", "w_v", "w_o", "w_down"):
            return cfg.n_heads, n // cfg.n_heads
        return None
    if key == "w_out":
        return n // MAMBA2_HEAD_DIM, MAMBA2_HEAD_DIM
    if key in ("wq", "wo"):
        return cfg.n_heads, cfg.head_dim
    return None


def leaf_sharding(axis: ModelAxis, path: str, spec: tuple, shape: tuple,
                  cfg, *, kv_dim: int | None = None,
                  heads_dim: int | None = None):
    """What rank ``axis`` holds of a leaf at ``path`` with the reference's
    pspec ``spec`` (a tuple of axis names): a tuple of (dim, slice) pairs
    (a :class:`Halves` in place of the slice for Mamba2's ``w_in``), or
    None for a leaf it holds whole. Its "model" dim is cut by whole heads
    where it is made of heads (:func:`_head_leaf`; ``wk`` / ``wv`` the KV
    heads its query heads read, ``w_in`` its heads' ``x`` and ``z``
    columns, where the reference's pspec gives rank r the r-th of M even
    blocks), else into M even blocks; a cache's ``kv_dim`` (its KV-head
    dim) gives its KV heads and its ``heads_dim`` (an mLSTM state's head
    dim) its heads of ``n_heads``, whatever the spec says, and its "data"
    dim its batch rows, or its KV slots where the sequence is split."""
    key = path.rsplit("/", 1)[-1]
    out = []
    if "data" in spec and axis.data_size > 1:
        dim = spec.index("data")
        out.append((dim, axis.data_block(
            shape[dim], "KV slots" if axis.seq_split else "batch")))
    if axis.size > 1:
        if kv_dim is not None:
            out.append((kv_dim, axis.kv_heads(cfg.n_heads, cfg.n_kv_heads)))
        elif heads_dim is not None:
            out.append((heads_dim, axis.span(cfg.n_heads)))
        elif "model" in spec:
            dim = spec.index("model")
            heads = _head_leaf(path, shape[dim], cfg)
            if key in _KV_LEAVES:
                kv = axis.kv_heads(cfg.n_heads, cfg.n_kv_heads)
                d = cfg.head_dim
                out.append((dim, slice(kv.start * d, kv.stop * d)))
            elif key == "w_in":
                h = axis.span(shape[dim] // 2 // MAMBA2_HEAD_DIM)
                out.append((dim, Halves(h.start * MAMBA2_HEAD_DIM,
                                        h.stop * MAMBA2_HEAD_DIM)))
            elif heads is not None:
                h, unit = axis.span(heads[0]), heads[1]
                out.append((dim, slice(h.start * unit, h.stop * unit)))
            else:
                out.append((dim, axis.block(shape[dim], path)))
    return tuple(out) or None


def take(x: torch.Tensor, shard) -> torch.Tensor:
    """The part ``shard`` (see :func:`leaf_sharding`) of ``x``, as a tensor
    of its own (no view that would keep the whole alive); ``x`` itself for
    a whole leaf."""
    if shard is None:
        return x
    for dim, sl in shard:
        if isinstance(sl, Halves):
            x = x.unflatten(dim, (2, -1)).narrow(
                dim + 1, sl.start, sl.stop - sl.start).flatten(dim, dim + 1)
        else:
            x = x.narrow(dim, sl.start, sl.stop - sl.start)
    return x.clone(memory_format=torch.contiguous_format)
