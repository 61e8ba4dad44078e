"""Config-driven decoder transformer: every group kind of the model zoo
(port of ``repro.models.transformer``).

Parameters are plain dicts with the reference's paths (``embed``,
``final_ln/scale``, ``lm_head`` when untied, ``group_<i>/{ln1,attn,ln2,mlp}
/...``); the leaves of a group are stacked over its layers (a leading
``n_layers`` axis), as the reference stacks them for ``lax.scan``. The
reference scans the layers; the port runs them as a Python loop over the
stacked leaves.

Modes:
  forward_train(params, batch)           -> (final hidden (B, S, d), aux)
  loss_fn(params, batch)                 -> mean next-token cross entropy
  prefill(params, batch, capacity=None)  -> (last-token logits, cache)
  decode_step(params, cache, token, pos) -> (logits, cache)

Training runs every layer under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` over its scan body) when grad is enabled,
and takes the loss over sequence chunks of ``LOSS_CHUNK`` positions, each
chunk's head and logsumexp checkpointed too, so no (B, S, V) logits are
kept. Training attention is the plain einsum, as in the reference (its
flash route is forward-only, for the prefill). A layer-stacked leaf may
come as a :class:`repro_torch.core.partition.LayerParts` (PartPSP's
shared and local layers, uncopied); layers are read through
:func:`repro_torch.core.partition.layer_list`.

Prefill attention goes through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention_bshd`) when
``cfg.flash_prefill`` is set, else through the plain einsum with
materialised scores, as in the reference.

Caches are ``{"group_<i>": {"k", "v"}}`` of shape (n_layers, B, T, K, D).
Decode writes the new token's K/V into its slot of the stacked cache in
place and reads the layer's slice: the layout the reference's
``decode_cache_in_carry`` path uses. The port takes it whatever that flag
says (the reference's other path streams the whole stack through its scan);
the results are the same either way. A group whose layers all share one
window keeps a ring buffer of that many slots.

Every group kind of the reference trains and serves: ``attn``, ``moe``
(all-MoE, or ``moe_every`` - 1 dense layers before each MoE one),
``xlstm`` (units of mLSTM layers and an sLSTM), ``mamba``, ``zamba``
(units of Mamba2 layers, each followed by one shared attention block with
a KV cache of its own for each application, then trailing Mamba2 layers)
and ``cross_self`` (units of one tanh-gated cross-attention over
``batch["image_embeds"]`` and self-attention layers). A recurrent group's
cache is its state (f32), written by the prefill and in place by each
decode step; training runs without a cache and writes nothing in place.

A group's ``train`` returns (x, aux): the MoE groups' Switch load-balance
loss summed over their MoE blocks, a zero for the other kinds, as the
reference's groups return it. ``loss_fn`` adds the groups' sum to the
cross entropy; the prefill drops it, as the reference's does. Training
checkpoints at the reference's granularity: each ``attn`` layer, each MoE
unit (its dense layers checkpointed inside it too), each mLSTM layer (the
sLSTM is not), each Mamba2 layer, each zamba unit (its Mamba2 layers
inside it too) and each cross/self unit (its self layers inside it too).

``param_pspecs`` / ``cache_pspecs`` give the reference's PartitionSpec
trees as tuples of mesh axis names. ``Transformer(cfg, axis=)`` is one
rank of the model split over a mesh's "model" dim
(:mod:`repro_torch.models.parallel`): the attention and MoE groups run
on the rank's heads, FFN blocks and experts, the embedding and head on
its vocabulary block, each partial summed through the axis's
all-reduces; its ``param_shards`` / ``cache_shards`` say what it holds.
It serves and trains: in training the sums are collectives autograd
sees, a block's replicated input passes through the axis's
copy-to-model, a shared KV head sums its gradient over its ranks, and
the loss is vocabulary-parallel (no logits cross the wire). Every group
kind splits: the mLSTM and Mamba2 layers run on the rank's heads (the
mLSTM's ``u`` gathered whole, the whole gate leaves' gradients summed),
the sLSTM whole on every rank, zamba's shared block and the VLM's self
and cross layers on the rank's heads as attention does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.partition import LayerParts, layer_list
from repro_torch.core.tree_utils import (tree_flatten, tree_flatten_with_path,
                                         tree_map, tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import ssm
from repro_torch.models.attention import (cross_attention, init_attention,
                                          init_cross_attention)
from repro_torch.models.config import (AttnGroup, CrossSelfGroup, MambaGroup,
                                       ModelConfig, MoEGroup, XLSTMGroup,
                                       ZambaGroup)
from repro_torch.models.layers import (dense_init, init_rms_norm, mlp_apply,
                                       mlp_init, rms_norm, rope, softcap)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.parallel import (MAMBA2_HEAD_DIM, NO_AXIS, HeadShare,
                                         ModelAxis, leaf_sharding,
                                         mamba2_heads, take)

__all__ = ["Transformer"]

_NEG_INF = -1e30
# Slots a chunk of the decode P V contraction (see _probs_v).
_PV_CHUNK = 512


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _attn_qkv(params, x, d: int):
    """q (B, S, h, D), k, v (B, S, kv, D) of the rank's heads (all without
    an axis), D = ``d``."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, params["wq"].shape[-1] // d, d)
    k = (x @ params["wk"]).reshape(b, s, params["wk"].shape[-1] // d, d)
    v = (x @ params["wv"]).reshape(b, s, params["wv"].shape[-1] // d, d)
    return q, k, v


def _probs_v(probs, v):
    """probs (B, K, g, S, T) @ v (B, T, K, D) -> (B, S, K, g, D).

    For one query row against a long cache (decode) the contraction over
    T is split into chunks of ``_PV_CHUNK`` slots, one batched product
    over the chunks, summed after, plus the tail: for a single product of
    g x T by T x D with T in the tens of thousands, cuBLAS picks a
    small-N kernel that took most of a decode step's device time on an
    H100 (``chip_smoke.py`` profiles the decode step by kernel).
    """
    b, kh, g, s, t = probs.shape
    if s > 1 or t < 2 * _PV_CHUNK:
        return torch.einsum("bkgst,btkd->bskgd", probs, v)
    c, d = t // _PV_CHUNK, v.shape[-1]
    t1 = c * _PV_CHUNK
    pp = probs[:, :, :, 0, :t1].reshape(b, kh, g, c, _PV_CHUNK).transpose(2, 3)
    vv = v[:, :t1].reshape(b, c, _PV_CHUNK, kh, d).permute(0, 3, 1, 2, 4)
    out = torch.matmul(pp, vv).sum(dim=2)  # (B, K, g, D)
    if t1 < t:
        out += torch.einsum("bkgt,btkd->bkgd", probs[:, :, :, 0, t1:],
                            v[:, t1:])
    return out[:, None]


def _softmax_attend(q, k, v, mask, share: HeadShare, dtype,
                    axis: ModelAxis = NO_AXIS):
    """Plain GQA attention of q (B, S, h, D) over k, v (B, T, kv, D) under
    ``mask`` (broadcast to (B, kv, g, S, T)) -> (B, S, h D). Where the
    cache's slots are split over "data" (``axis.seq_split``, one query
    row) each data rank takes the exponentials of its slots against the
    MAX over "data" of every rank's maximum, then one SUM over "data" of
    their sums and their products with v, and divides. A rank without
    heads runs the same ops on empty tensors (its collectives, and what a
    checkpoint's recomputation saves, stay the other ranks')."""
    b, s, h, d = q.shape
    qg, back = share.grid(q)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / \
        math.sqrt(d)
    scores = scores.masked_fill_(~mask, _NEG_INF)
    if not axis.seq_split:
        out = _probs_v(torch.softmax(scores, dim=-1), v.float())
    else:
        top = axis.seq_max(scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - top)                     # (B, kv, g, 1, T)
        part = torch.cat([_probs_v(p, v.float())[:, 0],  # (B, kv, g, D)
                          p.sum(dim=-1)], dim=-1)       # (B, kv, g, D + 1)
        part = axis.seq_sum(part)
        out = (part[..., :d] / part[..., d:])[:, None]
    return back(out).reshape(b, s, h * d).to(dtype)


def _attn_train(params, x, positions, head_dim: int, theta: float,
                window: int, share: HeadShare, use_flash: bool = False):
    """Full-sequence causal GQA of the rank's heads ``share``; ``window`` < 0
    is global. Returns (out, k, v): k, v (rope applied) feed the prefill
    cache. ``use_flash`` routes the softmax through the flash-attention
    kernel, at the rank's head offset."""
    q, k, v = _attn_qkv(params, x, head_dim)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    b, s = x.shape[:2]
    if use_flash:
        out = kops.flash_attention_bshd(q, k, v, window=window,
                                        group=share.group, head0=share.off)
        out = out.reshape(b, s, -1).to(x.dtype)
        return out @ params["wo"], k, v
    qpos = positions[:, None, None, :, None]
    kpos = positions[:, None, None, None, :]
    mask = qpos >= kpos
    if window >= 0:
        mask = mask & ((qpos - kpos) < window)
    return _softmax_attend(q, k, v, mask, share, x.dtype) @ params["wo"], \
        k, v


def _attn_decode(params, x, pos: int, k_cache, v_cache, head_dim: int,
                 theta: float, window: int, ring: bool, share: HeadShare,
                 axis: ModelAxis = NO_AXIS):
    """One-token GQA against one layer's cache k, v (B, T, K, D), whose
    token slot it writes in place (slot ``pos % T`` for a ring buffer of
    T = window slots). Where the slots are split over "data"
    (``axis.seq_split``) the cache holds the rank's T / D of them, the
    rank owning slot ``pos`` writes it, and the attention merges the data
    ranks' partials (:func:`_softmax_attend`)."""
    b = x.shape[0]
    t = k_cache.shape[1]
    first, whole = 0, t
    if axis.seq_split:
        first, whole = axis.data_rank * t, t * axis.data_size
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _attn_qkv(params, x, head_dim)
    q = rope(q, posv, theta)
    k_new = rope(k_new, posv, theta)
    slot = (pos % whole if ring else pos) - first
    if 0 <= slot < t:
        k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
    slots = torch.arange(first, first + t, device=x.device)
    if ring:
        # slot s holds position pos - ((pos - s) mod T): every slot is in the
        # window once pos >= T, before that only the slots <= pos are filled
        mask = slots <= pos if pos < whole else \
            torch.ones_like(slots, dtype=torch.bool)
    else:
        mask = slots <= pos
        if window >= 0:
            mask = mask & ((pos - slots) < window)
    out = _softmax_attend(q, k_cache, v_cache, mask, share, x.dtype, axis)
    return out @ params["wo"]


def _init_attn_block(gen, cfg: ModelConfig, dtype, device):
    return {
        "ln1": init_rms_norm(cfg.d_model, dtype, device),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dtype, device),
        "ln2": init_rms_norm(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                        device),
    }


def _stack_init(n: int, init_one) -> dict:
    """``n`` draws of ``init_one()`` stacked leaf by leaf on a leading axis,
    filled layer by layer (one layer's temporaries at a time)."""
    first = init_one()
    leaves, treedef = tree_flatten(first)
    stacked = [torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device) for x in leaves]
    for i in range(n):
        layer = leaves if i == 0 else tree_flatten(init_one())[0]
        for dst, src in zip(stacked, layer):
            dst[i] = src
    return tree_unflatten(treedef, stacked)


def _layers(tree) -> list:
    """The layers of a layer-stacked tree, as trees of views (one
    :func:`layer_list` a leaf)."""
    leaves, treedef = tree_flatten(tree)
    return [tree_unflatten(treedef, list(layer))
            for layer in zip(*(layer_list(x) for x in leaves))]


def _remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when grad is enabled:
    its activations are recomputed in the backward instead of kept (the
    reference's ``jax.checkpoint``). No layer draws random numbers, so the
    RNG state is not saved."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _count(sl: slice) -> int:
    return sl.stop - sl.start


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """The aux loss of a group that makes none: a zero f32 scalar."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _per_layer(cache, n: int) -> list:
    """The layers of a layer-stacked cache, or ``n`` Nones without one."""
    return [None] * n if cache is None else _layers(cache)


def _write_prompt(cache: torch.Tensor, kv: torch.Tensor) -> None:
    """Positions [0, S) of ``kv`` (B, S, K, D) into one layer's cache
    (B, T, K, D): slots [0, S) when T >= S, else (a ring buffer) the last T
    positions at their slots ``p % T``."""
    s, t = kv.shape[1], cache.shape[1]
    if t >= s:
        cache[:, :s] = kv.to(cache.dtype)
    else:
        slots = torch.arange(s - t, s, device=kv.device) % t
        cache[:, slots] = kv[:, s - t:].to(cache.dtype)


def _mlp_residual(lp, x, cfg: ModelConfig, axis: ModelAxis = NO_AXIS):
    return x + axis.reduce(mlp_apply(
        lp["mlp"], axis.copy(rms_norm(lp["ln2"], x, cfg.norm_eps)),
        cfg.activation))


# ---------------------------------------------------------------------------
# Partition specs (the reference's, as tuples of mesh axis names)
# ---------------------------------------------------------------------------

def _prepend(tree):
    """Each spec of a (nested dict) spec tree with one more leading
    unsharded dim."""
    if isinstance(tree, dict):
        return {k: _prepend(v) for k, v in tree.items()}
    return (None,) + tree


def _spec_paths(tree, prefix: str = "") -> dict:
    """{"group_0/attn/wq": spec, ...} of a spec tree, the paths
    :func:`repro_torch.core.tree_utils.tree_flatten_with_path` gives."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_spec_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _attn_block_pspec(cfg: ModelConfig, prefix=()) -> dict:
    mlp = {"w_up": (*prefix, None, "model"), "w_down": (*prefix, "model", None)}
    if cfg.activation in ("silu", "geglu"):
        mlp["w_gate"] = (*prefix, None, "model")
    return {
        "ln1": {"scale": (*prefix, None)},
        "attn": {"wq": (*prefix, None, "model"), "wk": (*prefix, None, "model"),
                 "wv": (*prefix, None, "model"), "wo": (*prefix, "model", None)},
        "ln2": {"scale": (*prefix, None)},
        "mlp": mlp,
    }


def _kv_pspec(cfg: ModelConfig, batch_axis, seq_axis) -> dict:
    """The reference's KV cache spec: the KV heads over "model" only where
    16 divides their count (``repro/models/transformer.py:253-256``); the
    port's cache follows the rank's KV heads instead
    (:meth:`Transformer.cache_shards`)."""
    kv = (None, batch_axis, seq_axis,
          "model" if cfg.n_kv_heads % 16 == 0 else None, None)
    return {"k": kv, "v": kv}


# ---------------------------------------------------------------------------
# Group implementation
# ---------------------------------------------------------------------------

class _AttnGroupImpl:
    """n GQA decoder blocks (pre-norm attention and MLP)."""

    def __init__(self, spec: AttnGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self.share = axis.attn_heads(cfg.n_heads, cfg.n_kv_heads)
        ws = spec.layer_windows()
        self.windows = [w if w is not None else -1 for w in ws]
        self.thetas = [float(t) for t in spec.layer_thetas(cfg.rope_theta)]
        finite = [w for w in ws if w is not None]
        self.uniform_window = finite[0] if (len(finite) == len(ws) and all(
            w == finite[0] for w in finite)) else None

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        return _stack_init(self.spec.n_layers, lambda: _init_attn_block(
            gen, self.cfg, dtype, device))

    def pspec(self) -> dict:
        return _attn_block_pspec(self.cfg, prefix=(None,))

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        return _kv_pspec(self.cfg, batch_axis, seq_axis)

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        """Forward over the layers -> (x, zero aux); with ``cache`` (this
        group's :meth:`init_cache`) each layer's K/V is written into it.
        Each layer runs under :func:`_remat` (checkpointed when grad is
        enabled)."""
        leaves, treedef = tree_flatten(params)
        layers = [layer_list(leaf) for leaf in leaves]
        for i in range(self.spec.n_layers):

            def block(h, *weights, i=i):
                lp = tree_unflatten(treedef, weights)
                return self._block(lp, h, positions, i, cache, use_flash)

            x = _remat(block, x, *(ls[i] for ls in layers))
        return x, _no_aux(x)

    def _block(self, lp, x, positions, i: int, cache, use_flash: bool):
        """Layer i: pre-norm attention and MLP, each added to the residual."""
        return _mlp_residual(lp, self.attend(lp, x, positions, i, cache,
                                             use_flash), self.cfg, self.axis)

    def attend(self, lp, x, positions, i: int, cache, use_flash: bool):
        """x + layer i's pre-norm attention over the whole sequence; with
        ``cache``, its K/V into the cache's layer ``i``."""
        cfg = self.cfg
        a, k, v = _attn_train(lp["attn"], self.axis.copy(
                                  rms_norm(lp["ln1"], x, cfg.norm_eps)),
                              positions, cfg.head_dim, self.thetas[i],
                              self.windows[i], self.share, use_flash=use_flash)
        if cache is not None:
            _write_prompt(cache["k"][i], k)
            _write_prompt(cache["v"][i], v)
        return x + self.axis.reduce(a)

    def attend_step(self, lp, x, pos: int, i: int, cache):
        """One token of :meth:`attend`, writing its K/V slot in place."""
        cfg = self.cfg
        return x + self.axis.reduce(_attn_decode(
            lp["attn"], rms_norm(lp["ln1"], x, cfg.norm_eps), pos,
            cache["k"][i], cache["v"][i], cfg.head_dim, self.thetas[i],
            self.windows[i], self.uniform_window is not None, self.share,
            self.axis))

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        """The layers' K/V of the rank's KV heads: ``capacity`` slots (the
        window's, for a ring buffer), or the rank's block of them where the
        slots are split over "data"."""
        t = (capacity if self.uniform_window is None
             else min(capacity, self.uniform_window))
        if self.axis.seq_split:
            t = _count(self.axis.data_block(t, "KV slots"))
        shape = (self.spec.n_layers, batch, t, self.share.kv,
                 self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, params, x, pos: int, cache, enc=None):
        """One token through the layers, each writing its K/V slot of
        ``cache`` in place."""
        for i, lp in enumerate(_layers(params)):
            x = _mlp_residual(lp, self.attend_step(lp, x, pos, i, cache),
                              self.cfg, self.axis)
        return x


def _stacked(n: int, tree: dict) -> dict:
    """Each leaf of ``tree`` repeated on a new leading axis of ``n`` (a
    cache for ``n`` units)."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)).clone(), tree)


def _residual_mixer(fn, lp, x, state, eps: float, axis=None, **kw):
    """x + ``fn(cell, norm(x), state=state)`` for a pre-norm recurrent
    layer ``lp`` = {"ln", "cell"}; the new state is copied into ``state``
    (a view of the cache) in place. Without a state (training) the layer
    starts from the zero state and its final state is dropped. ``axis``
    (a head-split mixer's): the normed input enters through its
    copy-to-model and ``fn`` runs on the rank's heads, whose partial
    output is summed over "model"; None (the sLSTM): whole."""
    h = rms_norm(lp["ln"], x, eps)
    if axis is None:
        y, new = fn(lp["cell"], h, state=state, **kw)
    else:
        y, new = fn(lp["cell"], axis.copy(h), state=state, axis=axis, **kw)
        y = axis.reduce(y)
    if state is not None:
        for key, value in new.items():
            state[key].copy_(value)
    return x + y


def _plain(fn, *args):
    return fn(*args)


class _MoEGroupImpl:
    """All-MoE units (``moe_every`` = 1, llama4-scout) or units of
    ``moe_every`` - 1 dense blocks and one MoE block (llama4-maverick's
    alternation). An MoE block is global attention and the routed experts;
    ``train`` sums the blocks' aux losses (the dense blocks add none).
    Each unit runs under :func:`_remat`, as the reference checkpoints its
    scan body."""

    def __init__(self, spec: MoEGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self._dense_unit = (_AttnGroupImpl(AttnGroup(n_layers=spec.moe_every - 1),
                                           cfg, axis)
                            if spec.moe_every > 1 else None)
        # the MoE blocks' attention halves: one global layer a unit
        self._attn = _AttnGroupImpl(AttnGroup(n_layers=spec.n_units), cfg, axis)

    def _init_block(self, gen, dtype, device) -> dict:
        cfg, spec = self.cfg, self.spec
        return {
            "ln1": init_rms_norm(cfg.d_model, dtype, device),
            "attn": init_attention(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, dtype, device),
            "ln2": init_rms_norm(cfg.d_model, dtype, device),
            "moe": init_moe(gen, cfg.d_model, cfg.d_ff, spec.n_experts,
                            shared_expert=spec.shared_expert, dtype=dtype,
                            device=device),
        }

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        if self._dense_unit is None:
            return _stack_init(self.spec.n_units,
                               lambda: self._init_block(gen, dtype, device))
        return _stack_init(self.spec.n_units, lambda: {
            "dense": self._dense_unit.init(gen, dtype, device),
            "moe": self._init_block(gen, dtype, device)})

    def pspec(self) -> dict:
        moe = {"router": (None, None, None),
               "w_gate": (None, "model", None, None),
               "w_up": (None, "model", None, None),
               "w_down": (None, "model", None, None)}
        if self.spec.shared_expert:
            moe["shared"] = {"w_gate": (None, None, "model"),
                             "w_up": (None, None, "model"),
                             "w_down": (None, "model", None)}
        base = _attn_block_pspec(self.cfg, prefix=(None,))
        base.pop("mlp")
        base["moe"] = moe
        if self._dense_unit is None:
            return base
        return {"dense": _prepend(self._dense_unit.pspec()), "moe": base}

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        kv = _kv_pspec(self.cfg, batch_axis, seq_axis)
        if self._dense_unit is None:
            return kv
        return {"dense": _prepend(self._dense_unit.cache_pspec(
            batch_axis=batch_axis, seq_axis=seq_axis)), "moe": kv}

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        kv = self._attn.init_cache(batch, capacity, dtype, device)
        if self._dense_unit is None:
            return kv
        return {"dense": _stacked(self.spec.n_units, self._dense_unit.init_cache(
            batch, capacity, dtype, device)), "moe": kv}

    def _moe(self, lp, x):
        """x + the block's routed experts -> (x, the block's aux loss)."""
        spec = self.spec
        out, aux = moe_apply(lp["moe"], rms_norm(lp["ln2"], x, self.cfg.norm_eps),
                             n_experts=spec.n_experts,
                             capacity_factor=spec.capacity_factor,
                             router_aux_weight=spec.router_aux_weight,
                             axis=self.axis)
        return x + self.axis.reduce(out), aux

    def _units(self, params, cache):
        """(unit params, its dense blocks' cache) of each unit, and the MoE
        blocks' KV cache (Nones without a cache)."""
        n = self.spec.n_units
        if self._dense_unit is None:
            return zip(_layers(params), [None] * n), cache
        if cache is None:
            return zip(_layers(params), [None] * n), None
        return zip(_layers(params), _layers(cache["dense"])), cache["moe"]

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        units, kv = self._units(params, cache)
        aux = _no_aux(x)
        for i, (up, dense_cache) in enumerate(units):

            def unit(h, up=up, dense_cache=dense_cache, i=i):
                if self._dense_unit is not None:
                    h, _ = self._dense_unit.train(up["dense"], h, positions,
                                                  cache=dense_cache,
                                                  use_flash=use_flash)
                    up = up["moe"]
                return self._moe(up, self._attn.attend(up, h, positions, i,
                                                       kv, use_flash))

            x, unit_aux = _remat(unit, x)
            aux = aux + unit_aux
        return x, aux

    def decode(self, params, x, pos: int, cache, enc=None):
        units, kv = self._units(params, cache)
        for i, (lp, dense_cache) in enumerate(units):
            if self._dense_unit is not None:
                x = self._dense_unit.decode(lp["dense"], x, pos, dense_cache)
                lp = lp["moe"]
            x, _ = self._moe(lp, self._attn.attend_step(lp, x, pos, i, kv))
        return x


class _XLSTMGroupImpl:
    """Units of ``mlstm_per_unit`` mLSTM layers and one sLSTM layer, each
    pre-norm and added to the residual; attention-free. The cache is the
    states: mLSTM ``C``, ``n``, ``m`` (units, mlstm_per_unit, B, heads,
    ...) and sLSTM ``c``, ``n``, ``m``, ``h`` (units, B, d). Over a model
    axis the mLSTM runs on the rank's heads (a :meth:`ModelAxis.span` of
    the config's ``n_heads``), its cache their states; the sLSTM runs
    whole on every rank."""

    def __init__(self, spec: XLSTMGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self.n_heads = cfg.n_heads
        self.head_dim = int(cfg.d_model * spec.proj_factor) // self.n_heads

    def _init_unit(self, gen, dtype, device) -> dict:
        cfg, spec = self.cfg, self.spec
        return {
            "mlstm": _stack_init(spec.mlstm_per_unit, lambda: {
                "ln": init_rms_norm(cfg.d_model, dtype, device),
                "cell": ssm.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                       spec.proj_factor, dtype, device)}),
            "slstm": {"ln": init_rms_norm(cfg.d_model, dtype, device),
                      "cell": ssm.init_slstm(gen, cfg.d_model, dtype, device)},
        }

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        return _stack_init(self.spec.n_units,
                           lambda: self._init_unit(gen, dtype, device))

    def pspec(self) -> dict:
        m = {"w_up": (None, None, None, "model"),
             "w_q": (None, None, None, "model"),
             "w_k": (None, None, None, "model"),
             "w_v": (None, None, None, "model"),
             "w_if": (None, None, None, None), "b_if": (None, None, None),
             "w_o": (None, None, None, "model"),
             "w_down": (None, None, "model", None)}
        s = {"w": (None, None, None), "r": (None, None, None), "b": (None, None)}
        return {"mlstm": {"ln": {"scale": (None, None, None)}, "cell": m},
                "slstm": {"ln": {"scale": (None, None)}, "cell": s}}

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        bax = batch_axis  # the recurrent state has no sequence dim
        m = {"C": (None, None, bax, None, None, None),
             "n": (None, None, bax, None, None), "m": (None, None, bax, None)}
        return {"mlstm": m,
                "slstm": {k: (None, bax, None) for k in ("c", "n", "m", "h")}}

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        cfg, spec = self.cfg, self.spec
        m = ssm.mlstm_state(batch, cfg.d_model, self.n_heads,
                            spec.proj_factor, device,
                            local_heads=_count(self.axis.span(self.n_heads)))
        s = ssm.slstm_state(batch, cfg.d_model, device)
        return {"mlstm": _stacked(spec.n_units,
                                  _stacked(spec.mlstm_per_unit, m)),
                "slstm": _stacked(spec.n_units, s)}

    def _run(self, params, x, cache, m_fn, s_fn, wrap):
        """Each unit's mLSTM layers (each through ``wrap``), then its
        sLSTM."""
        cfg, spec = self.cfg, self.spec
        for up, st in zip(_layers(params), _per_layer(cache, spec.n_units)):
            m_states = _per_layer(None if st is None else st["mlstm"],
                                  spec.mlstm_per_unit)
            for lp, m_st in zip(_layers(up["mlstm"]), m_states):
                x = wrap(lambda h, lp=lp, m_st=m_st: _residual_mixer(
                    m_fn, lp, h, m_st, cfg.norm_eps, axis=self.axis,
                    n_heads=self.n_heads, head_dim=self.head_dim), x)
            x = _residual_mixer(s_fn, up["slstm"], x,
                                None if st is None else st["slstm"],
                                cfg.norm_eps)
        return x

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        return self._run(params, x, cache, ssm.mlstm_seq, ssm.slstm_seq,
                         _remat), _no_aux(x)

    def decode(self, params, x, pos: int, cache, enc=None):
        return self._run(params, x, cache, ssm.mlstm_step, ssm.slstm_step,
                         _plain)


class _MambaGroupImpl:
    """n pre-norm Mamba2 layers; attention-free. Mamba2's head dim is its
    own (64, as in the reference), not ``cfg.head_dim``. The cache is each
    layer's state ``h`` (n, B, heads, d_state, 64). Over a model axis each
    layer runs on the rank's heads of nh (a :meth:`ModelAxis.span`), its
    cache their states."""

    HEAD_DIM = MAMBA2_HEAD_DIM

    def __init__(self, spec: MambaGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self.n_heads = mamba2_heads(cfg, spec)  # nh, the whole layer's

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        cfg, spec = self.cfg, self.spec
        return _stack_init(self.spec.n_layers, lambda: {
            "ln": init_rms_norm(cfg.d_model, dtype, device),
            "cell": ssm.init_mamba2(gen, cfg.d_model, spec.d_state,
                                    spec.expand, self.HEAD_DIM, dtype, device)})

    def pspec(self) -> dict:
        cell = {"w_in": (None, None, "model"), "w_b": (None, None, None),
                "w_c": (None, None, None), "w_dt": (None, None, None),
                "b_dt": (None, None), "a_log": (None, None),
                "d_skip": (None, None), "w_out": (None, "model", None)}
        return {"ln": {"scale": (None, None)}, "cell": cell}

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        return {"h": (None, batch_axis, "model", None, None)}

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        return _stacked(self.spec.n_layers, ssm.mamba2_state(
            batch, self.cfg.d_model, self.spec.d_state, self.spec.expand,
            self.HEAD_DIM, device,
            local_heads=_count(self.axis.span(self.n_heads))))

    def _run(self, params, x, cache, fn, wrap):
        """The layers, each through ``wrap``."""
        for lp, st in zip(_layers(params),
                          _per_layer(cache, self.spec.n_layers)):
            x = wrap(lambda h, lp=lp, st=st: _residual_mixer(
                fn, lp, h, st, self.cfg.norm_eps, axis=self.axis,
                head_dim=self.HEAD_DIM, n_heads=self.n_heads), x)
        return x

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        return self._run(params, x, cache, ssm.mamba2_seq, _remat), _no_aux(x)

    def decode(self, params, x, pos: int, cache, enc=None):
        return self._run(params, x, cache, ssm.mamba2_step, _plain)


class _ZambaGroupImpl:
    """Units of ``mamba_per_unit`` Mamba2 layers and one application of a
    shared attention block (one set of weights for every unit: Zamba2's
    parameter sharing), then the trailing Mamba2 layers. Each application
    keeps a KV cache of its own (``attn``: (units, B, T, K, D)). Over a
    model axis the Mamba2 layers and the shared block run on the rank's
    heads."""

    def __init__(self, spec: ZambaGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self._mamba_unit = _MambaGroupImpl(
            MambaGroup(n_layers=spec.mamba_per_unit, d_state=spec.d_state,
                       expand=spec.expand), cfg, axis)
        self._trailing = (_MambaGroupImpl(
            MambaGroup(n_layers=spec.trailing_mamba, d_state=spec.d_state,
                       expand=spec.expand), cfg, axis)
            if spec.trailing_mamba else None)
        # the shared block's applications: one global layer a unit, each
        # with its own cache
        self._shared = _AttnGroupImpl(AttnGroup(n_layers=spec.n_units), cfg,
                                      axis)

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        params = {
            "units_mamba": _stack_init(
                self.spec.n_units,
                lambda: self._mamba_unit.init(gen, dtype, device)),
            "shared_attn": _init_attn_block(gen, self.cfg, dtype, device),
        }
        if self._trailing is not None:
            params["trailing"] = self._trailing.init(gen, dtype, device)
        return params

    def pspec(self) -> dict:
        out = {"units_mamba": _prepend(self._mamba_unit.pspec()),
               "shared_attn": _attn_block_pspec(self.cfg)}
        if self._trailing is not None:
            out["trailing"] = self._trailing.pspec()
        return out

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        out = {"mamba": _prepend(self._mamba_unit.cache_pspec(
                   batch_axis=batch_axis)),
               "attn": _kv_pspec(self.cfg, batch_axis, seq_axis)}
        if self._trailing is not None:
            out["trailing"] = self._trailing.cache_pspec(batch_axis=batch_axis)
        return out

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        n = self.spec.n_units
        cache = {"mamba": _stacked(n, self._mamba_unit.init_cache(
                     batch, capacity, dtype, device)),
                 "attn": self._shared.init_cache(batch, capacity, dtype,
                                                 device)}
        if self._trailing is not None:
            cache["trailing"] = self._trailing.init_cache(batch, capacity,
                                                          dtype, device)
        return cache

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        """Each unit (its Mamba2 layers and the shared block's application)
        under :func:`_remat`, then the trailing layers."""
        shared = params["shared_attn"]
        n = self.spec.n_units
        kv = None if cache is None else cache["attn"]
        units = zip(_layers(params["units_mamba"]),
                    _per_layer(None if cache is None else cache["mamba"], n))
        for u, (up, m_cache) in enumerate(units):

            def unit(h, up=up, m_cache=m_cache, u=u):
                h, _ = self._mamba_unit.train(up, h, positions, cache=m_cache)
                return _mlp_residual(shared, self._shared.attend(
                    shared, h, positions, u, kv, use_flash), self.cfg,
                    self.axis)

            x = _remat(unit, x)
        if self._trailing is not None:
            x, _ = self._trailing.train(
                params["trailing"], x, positions,
                cache=None if cache is None else cache["trailing"])
        return x, _no_aux(x)

    def decode(self, params, x, pos: int, cache, enc=None):
        shared = params["shared_attn"]
        for u, (up, m_cache) in enumerate(zip(_layers(params["units_mamba"]),
                                              _layers(cache["mamba"]))):
            x = self._mamba_unit.decode(up, x, pos, m_cache)
            x = _mlp_residual(shared, self._shared.attend_step(
                shared, x, pos, u, cache["attn"]), self.cfg, self.axis)
        if self._trailing is not None:
            x = self._trailing.decode(params["trailing"], x, pos,
                                      cache["trailing"])
        return x


class _CrossSelfGroupImpl:
    """Units of one tanh-gated cross-attention over the image embeddings
    ``enc`` (B, M, d_model) and ``self_per_unit`` self-attention blocks
    (Llama-3.2-Vision). The cache is the self blocks' K/V, (units,
    self_per_unit, B, T, K, D); the cross layers recompute theirs from
    ``enc`` at every step, as the reference does. Over a model axis the
    cross and self layers run on the rank's heads."""

    def __init__(self, spec: CrossSelfGroup, cfg: ModelConfig,
                 axis: ModelAxis = NO_AXIS):
        self.spec, self.cfg, self.axis = spec, cfg, axis
        self._self_unit = _AttnGroupImpl(AttnGroup(n_layers=spec.self_per_unit),
                                         cfg, axis)

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        cfg = self.cfg
        return _stack_init(self.spec.n_units, lambda: {
            "cross_ln": init_rms_norm(cfg.d_model, dtype, device),
            "cross": init_cross_attention(gen, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.head_dim, dtype,
                                          device),
            "self": self._self_unit.init(gen, dtype, device)})

    def pspec(self) -> dict:
        return {"cross_ln": {"scale": (None, None)},
                "cross": {"wq": (None, None, "model"),
                          "wk": (None, None, "model"),
                          "wv": (None, None, "model"),
                          "wo": (None, "model", None), "gate": (None, None)},
                "self": _prepend(self._self_unit.pspec())}

    def cache_pspec(self, *, batch_axis=None, seq_axis=None) -> dict:
        return _prepend(self._self_unit.cache_pspec(batch_axis=batch_axis,
                                                    seq_axis=seq_axis))

    def init_cache(self, batch: int, capacity: int, dtype, device) -> dict:
        return _stacked(self.spec.n_units, self._self_unit.init_cache(
            batch, capacity, dtype, device))

    @staticmethod
    def _need_enc(enc) -> None:
        if enc is None:
            raise ValueError("a cross_self group needs the image embeddings: "
                             "batch['image_embeds'] in training and prefill, "
                             "enc= in decode")

    def _cross(self, up, x, enc):
        self._need_enc(enc)
        cfg = self.cfg
        return x + cross_attention(up["cross"],
                                   rms_norm(up["cross_ln"], x, cfg.norm_eps),
                                   enc, n_heads=cfg.n_heads,
                                   n_kv_heads=cfg.n_kv_heads,
                                   head_dim=cfg.head_dim, axis=self.axis)

    def train(self, params, x, positions, cache=None, use_flash=False,
              enc=None):
        """Each unit (cross layer and self layers) under :func:`_remat`."""
        self._need_enc(enc)
        for up, c in zip(_layers(params),
                         _per_layer(cache, self.spec.n_units)):

            def unit(h, up=up, c=c):
                h, _ = self._self_unit.train(up["self"],
                                             self._cross(up, h, enc),
                                             positions, cache=c,
                                             use_flash=use_flash)
                return h

            x = _remat(unit, x)
        return x, _no_aux(x)

    def decode(self, params, x, pos: int, cache, enc=None):
        for up, c in zip(_layers(params), _layers(cache)):
            x = self._self_unit.decode(up["self"], self._cross(up, x, enc),
                                       pos, c)
        return x


_GROUP_IMPLS = {
    "attn": _AttnGroupImpl,
    "moe": _MoEGroupImpl,
    "xlstm": _XLSTMGroupImpl,
    "mamba": _MambaGroupImpl,
    "zamba": _ZambaGroupImpl,
    "cross_self": _CrossSelfGroupImpl,
}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class Transformer:
    """The assembled model: embed -> groups -> final norm -> (tied) LM head.

    ``axis`` (a :class:`repro_torch.models.parallel.ModelAxis`; default
    none) makes it one rank of a model split over the mesh's "model" dim:
    its groups run on the rank's heads, FFN blocks and experts, its
    embedding and head on the rank's vocabulary block, each partial summed
    over the ranks where the reference's GSPMD program would, in serving
    and in training (a training axis has a data dim of 1). Every group
    kind splits, whatever its head count. An axis with ``shard_seq`` and a
    data dim above 1 decodes with each KV cache's slots split over
    "data" (and does no prefill)."""

    LOSS_CHUNK = 512  # sequence positions a chunk of the cross entropy

    def __init__(self, cfg: ModelConfig, axis: ModelAxis | None = None):
        self.cfg = cfg
        self.axis = NO_AXIS if axis is None else axis
        self.axis.check(cfg)
        self.groups = [_GROUP_IMPLS[g.kind](g, cfg, self.axis)
                       for g in cfg.groups]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.param_dtype)

    # -- parameters -----------------------------------------------------------
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Fresh parameters from ``gen`` (a generator on ``device``; the
        card by default). Over a model axis of M > 1: the rank's shard of
        the whole model's draw (every rank draws the whole model and keeps
        its part, so one seed's shards make up the unsharded model's
        parameters)."""
        if self.axis.size > 1:
            return self.shard_params(Transformer(self.cfg).init(gen, device))
        cfg = self.cfg
        dev = resolve_device(device)
        params: dict[str, Any] = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), self.dtype,
                                dev),
            "final_ln": init_rms_norm(cfg.d_model, self.dtype, dev),
        }
        if not cfg.tie_embedding:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                           self.dtype, dev)
        for i, g in enumerate(self.groups):
            params[f"group_{i}"] = g.init(gen, self.dtype, dev)
        return params

    def _whole_groups(self) -> list:
        """The groups of the whole model (a rank's hold its local heads)."""
        return self.groups if self.axis.size == 1 else \
            Transformer(self.cfg).groups

    def param_pspecs(self) -> dict:
        """The reference's PartitionSpec tree of the parameters, each spec a
        tuple of mesh axis names (``None``: unsharded dim)."""
        specs: dict[str, Any] = {"embed": ("model", None),
                                 "final_ln": {"scale": (None,)}}
        if not self.cfg.tie_embedding:
            specs["lm_head"] = (None, "model")
        for i, g in enumerate(self._whole_groups()):
            specs[f"group_{i}"] = g.pspec()
        return specs

    def cache_pspecs(self, *, batch_axis="data", seq_axis=None) -> dict:
        """The reference's PartitionSpec tree of the cache, as tuples."""
        return {f"group_{i}": g.cache_pspec(batch_axis=batch_axis,
                                            seq_axis=seq_axis)
                for i, g in enumerate(self._whole_groups())}

    def _whole_shapes(self, make) -> list:
        """(path, shape) of each leaf of ``make(the whole model)`` on meta."""
        return [(p, tuple(x.shape)) for p, x in
                tree_flatten_with_path(make(Transformer(self.cfg)))[0]]

    def param_shards(self) -> dict:
        """What this rank holds of each parameter, by path (the paths of
        :func:`repro_torch.core.tree_utils.tree_flatten_with_path`): a
        tuple of (dim, slice) pairs
        (:func:`repro_torch.models.parallel.leaf_sharding`), ``None`` for a
        leaf it holds whole."""
        specs = _spec_paths(self.param_pspecs())
        return {p: leaf_sharding(self.axis, p, specs[p], shape, self.cfg)
                for p, shape in self._whole_shapes(lambda m: m.init(
                    torch.Generator(device="cpu"), device="meta"))}

    def model_dims(self) -> list[tuple[str, int, int]]:
        """(path, dim, width) of every parameter dim that the reference's
        pspecs put on "model", of the whole model (on meta)."""
        specs = _spec_paths(self.param_pspecs())
        return [(p, specs[p].index("model"), shape[specs[p].index("model")])
                for p, shape in self._whole_shapes(lambda m: m.init(
                    torch.Generator(device="cpu"), device="meta"))
                if "model" in specs[p]]

    def cache_shards(self, batch: int, capacity: int, *,
                     shard_seq: bool | None = None) -> dict:
        """:meth:`param_shards` of a (batch, capacity) cache of the whole
        model: the rank's rows of the batch over "data", of a KV leaf its
        KV heads (the reference's spec replicates KV unless 16 divides K),
        of an mLSTM state its heads (the reference's spec replicates it),
        of a Mamba2 state its heads (the reference's spec). ``shard_seq``
        (the reference's sequence-sharded long-context decode; default the
        axis's own): each KV leaf's block of its slots over "data" in place
        of batch rows (a ``ValueError`` where they do not divide), the
        recurrent states whole over "data"."""
        if shard_seq is None:
            shard_seq = self.axis.shard_seq
        axis = dataclasses.replace(self.axis, shard_seq=shard_seq)
        specs = _spec_paths(self.cache_pspecs(
            batch_axis=None if shard_seq else "data",
            seq_axis="data" if shard_seq else None))
        def dims(p: str, shape: tuple) -> dict:
            if p.rsplit("/", 1)[-1] in ("k", "v"):
                return {"kv_dim": len(shape) - 2}
            # (units, mlstm_per_unit, B, heads, ...)
            return {"heads_dim": 3} if "/mlstm/" in p else {}

        return {
            p: leaf_sharding(axis, p, specs[p], shape, self.cfg,
                             **dims(p, shape))
            for p, shape in self._whole_shapes(lambda m: m.init_cache(
                batch, capacity, device="meta"))}

    def shard_params(self, params: dict) -> dict:
        """This rank's part of the whole model's ``params`` (a new tree; a
        leaf held whole is the same tensor)."""
        if self.axis.size == 1:
            return params
        shards = self.param_shards()
        pairs, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, [take(x, shards[p]) for p, x in pairs])

    # -- forward --------------------------------------------------------------
    def _scale_embed(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.embed_scale:  # sqrt(d_model) rounded to f32, as a scalar
            x = x * float(torch.tensor(math.sqrt(self.cfg.d_model),
                                       dtype=torch.float32))
        return x

    def _embed_inputs(self, params, batch):
        if self.cfg.input_mode == "embeddings":
            x = batch["embeds"].to(self.dtype)
        else:
            x = self.axis.embed(batch["tokens"], params["embed"],
                                self.cfg.vocab_size)
        return self._scale_embed(x)

    def _backbone(self, params, x, positions, caches=None, use_flash=False,
                  enc=None):
        """-> (final-normed hidden states, the groups' aux losses summed)."""
        aux = _no_aux(x)
        for i, g in enumerate(self.groups):
            x, group_aux = g.train(
                params[f"group_{i}"], x, positions,
                cache=None if caches is None else caches[f"group_{i}"],
                use_flash=use_flash, enc=enc)
            aux = aux + group_aux
        return rms_norm(params["final_ln"], x, self.cfg.norm_eps), aux

    def _logits(self, params, x):
        """The (f32, soft-capped) logits of this rank's vocabulary block."""
        if self.cfg.tie_embedding:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        return softcap(logits.float(), self.cfg.logit_softcap)

    def _head(self, params, x):
        return self.axis.gather_vocab(self._logits(params, x),
                                      self.cfg.vocab_size)

    def _train_params(self, params):
        """``params`` with each shared KV head's ``wk`` / ``wv`` (a layer
        stack, or a :class:`LayerParts` of two) through the axis's
        :meth:`ModelAxis.shared_kv`: one gradient sum a leaf a backward."""
        share = self.axis.shared_kv(self.cfg)
        if share is None:
            return params

        def wrap(path: str, x):
            if not path.endswith(("attn/wk", "attn/wv", "cross/wk",
                                  "cross/wv")):
                return x
            if isinstance(x, LayerParts):
                return LayerParts([share(p) for p in x.parts], x.layer_axis)
            return share(x)

        pairs, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, [wrap(p, x) for p, x in pairs])

    # -- training ---------------------------------------------------------------
    def _labels(self, batch):
        return batch["labels"] if "labels" in batch else batch["tokens"]

    def forward_train(self, params, batch):
        """-> (final hidden states (B, S, d), aux loss). The logits are made
        chunk by chunk inside :meth:`loss_fn`. ``aux`` is the MoE groups'
        load-balance loss (zero for the other kinds). A cross-attention
        model reads the image embeddings ``batch["image_embeds"]`` (B, M,
        d_model). Over a model axis: this rank's shard of ``params``, a
        data dim of 1 (each node routes its own batch's tokens)."""
        if self.axis.data_size > 1:
            raise NotImplementedError(
                "training over the model axis takes a data dim of 1: there "
                "\"data\" splits the protocol's nodes "
                "(launch.steps.build_train_plan)")
        params = self._train_params(params)
        x = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return self._backbone(params, x, positions,
                              enc=batch.get("image_embeds"))

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy over B (S - 1) positions (+ aux),
        over sequence chunks of :attr:`LOSS_CHUNK` and the remainder, each
        chunk's head and logsumexp under :func:`_remat`. One node's params
        and batch: ``tokens`` (B, S), or ``embeds`` (B, S, d_model) and
        ``labels`` (B, S) for embedding-input models. The reference's
        ``key`` argument is not taken: no layer draws random numbers. Over
        a model axis of M > 1 each chunk's cross entropy is
        vocabulary-parallel (:meth:`ModelAxis.cross_entropy`)."""
        h, aux = self.forward_train(params, batch)
        targets = self._labels(batch)[:, 1:].long()  # token t+1 from hidden t
        h = h[:, :-1]
        b, sm1 = h.shape[:2]
        chunk = min(self.LOSS_CHUNK, sm1)
        axis, vocab = self.axis, self.cfg.vocab_size

        def chunk_loss(h_c, t_c):
            logits = self._logits(params, axis.copy(h_c))  # (B, c, V/M) f32
            if axis.size > 1:
                return axis.cross_entropy(logits, t_c, vocab)
            picked = logits.gather(-1, t_c[..., None])[..., 0]
            return (torch.logsumexp(logits, dim=-1) - picked).sum()

        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, sm1, chunk):  # the last chunk is the remainder
            total = total + _remat(chunk_loss, h[:, c0:c0 + chunk],
                                   targets[:, c0:c0 + chunk])
        return total / (b * sm1) + aux

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, dtype=None,
                   device=None) -> dict:
        dev = resolve_device(device)
        dtype = dtype or self.dtype
        return {f"group_{i}": g.init_cache(batch, capacity, dtype, dev)
                for i, g in enumerate(self.groups)}

    def prefill(self, params, batch, capacity: int | None = None):
        """Forward over the prompt -> (last-token logits (B, V) f32, cache).

        The cache holds ``capacity`` slots (default: the prompt length, as
        the reference's prefill returns), the prompt's K/V written into
        them; a caller that goes on decoding passes prompt + gen and so
        needs no second, larger cache. A recurrent group's cache is its
        state after the prompt. A cross-attention model reads the image
        embeddings ``batch["image_embeds"]`` (B, M, d_model)."""
        if self.axis.seq_split:
            raise ValueError(
                "a model whose KV slots are split over \"data\" decodes "
                "only: prefill on a plan without shard_seq, then cut its "
                "cache (launch.sharding.shard_cache)")
        x = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        caches = self.init_cache(b, s if capacity is None else capacity,
                                 device=x.device)
        h, _ = self._backbone(params, x, positions, caches=caches,
                              use_flash=self.cfg.flash_prefill,
                              enc=batch.get("image_embeds"))
        return self._head(params, h[:, -1:])[:, 0], caches

    def decode_step(self, params, cache, token, pos: int, enc=None):
        """One token for the whole batch. ``token``: (B,) int (or (B, d)
        embeddings for embedding-input models); ``pos``: its position;
        ``enc``: the image embeddings of a cross-attention model. The cache
        is updated in place and returned."""
        if self.cfg.input_mode == "embeddings":
            x = token[:, None, :].to(self.dtype)
        else:
            x = self.axis.embed(token, params["embed"],
                                self.cfg.vocab_size)[:, None, :]
        x = self._scale_embed(x)
        for i, g in enumerate(self.groups):
            x = g.decode(params[f"group_{i}"], x, int(pos), cache[f"group_{i}"],
                         enc=enc)
        x = rms_norm(params["final_ln"], x, self.cfg.norm_eps)
        return self._head(params, x)[:, 0], cache
