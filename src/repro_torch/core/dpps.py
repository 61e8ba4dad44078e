"""DPPS — Differentially Private Perturbed Push-Sum (paper Algorithm 1),
port of ``repro.core.dpps``.

Callers supply the round's perturbation ``eps`` (PartPSP: ``-gamma_s *
clipped shared gradient``; consensus: zero) and one round does

  1. perturb              s^(t+1/2) = s^(t) + eps^(t)                 (Eq. 7)
  2. sensitivity estimate S_i recursion, S = max_i S_i (1 scalar)     (Eq. 22)
  3. noise                s_noise = s^(t+1/2) + gamma_n Lap(0, S/b)   (Eq. 8)
  4. gossip               s <- W s_noise ; a <- W a                   (Eq. 9)
  5. correct              y = s / a                                   (Eq. 10)

over the packed (N, d_pad) buffer of :class:`repro_torch.core.packing.
PackedLayout`, or, with ``layout=None``, over the tree of node-stacked
leaves (the pytree runtime, the reference's oracle and its per-round loop
driver's path). With ``cfg.use_kernels`` the per-round passes are CUDA
kernels (``l1_norm_rows``, ``dpps_perturb_rows``, and ``pushsum_mix`` on
the dense schedule or ``spmm`` on the sparse one), once over the buffer
or once a leaf; otherwise their plain versions, which compute the same
thing. The noise of both runtimes, on both routes, is the same Philox row:
the pytree runtime's plain draw is one flat draw over the wire row
(:func:`repro_torch.core.privacy.noise_wire`), its kernel route draws each
leaf's wire columns (``ops.dpps_perturb_tree``).

Node-axis reductions (the sensitivity max of Alg. 1 line 4, the sync
average, the scalar diagnostics) go through :class:`NodeOps`: over the
rows this process holds by default, over every rank's rows under the
sharded engine (:mod:`repro_torch.engine.shard`), which also passes the
global index of its first row as ``node0`` to key the noise.

Column-axis reductions go through :class:`ColumnOps`: where a rank of a
model axis holds a shard of each shared leaf (``launch.steps.
build_train_plan`` on a mesh), each per-node L1 norm of a shared vector
(the perturbation's, round 0's s^(0), the noise's, the sync average's,
PartPSP's clip norm) is the rank's partial over the leaves it counts
(each column once: a leaf several ranks hold whole, or a shared KV head,
is counted by the first of them), then a SUM all-reduce over "model";
and the noise is drawn at the whole leaf's wire columns
(``kernels.ref.ColumnMap``), so a rank draws exactly the unsharded
draw's columns. The mix and ``a`` need no model collective.

The round counter ``DPPSState.t`` is a host integer, so the ``t == 0``
sensitivity init and the sync schedule are decided on the host with no
device sync; the noise scale ``S / b`` stays a 0-d device tensor that the
kernel reads through its pointer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.packing import PackedLayout
from repro_torch.core.privacy import laplace_row, noise_wire, split_row
from repro_torch.core.pushsum import (
    PushSumState,
    consensus_error,
    correct,
    gossip_circulant,
    gossip_dense,
    gossip_packed,
    gossip_sparse,
    init_push_sum,
)
from repro_torch.core.sensitivity import (
    SensitivityState,
    init_sensitivity,
    real_sensitivity,
)
from repro_torch.core.tree_utils import (
    PyTree,
    l1_norm_per_node,
    node_mean,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.trace import (
    PHASE_DPPS_GOSSIP,
    PHASE_DPPS_NOISE,
    PHASE_DPPS_PERTURB,
    PHASE_DPPS_SENSITIVITY,
    PHASE_DPPS_SYNC,
    PHASE_DPPS_WIRE_STATS,
    phase,
)
from repro_torch.wire import Bf16Codec

__all__ = ["DPPSConfig", "DPPSState", "NodeOps", "LOCAL_NODE_OPS",
           "ColumnOps", "LOCAL_COLUMN_OPS", "dpps_init", "dpps_step",
           "dpps_consensus", "is_sync_round"]


def is_sync_round(t: int, sync_interval: int) -> bool:
    """Whether round ``t`` ends with a full synchronization (paper SIII.C)."""
    return sync_interval > 0 and (t + 1) % sync_interval == 0


class NodeOps(NamedTuple):
    """Node-axis reductions the protocol needs, swappable per execution
    mode (``repro.core.dpps.NodeOps``).

    The defaults (:data:`LOCAL_NODE_OPS`) reduce over the node-stacked
    leading axis of one process's tensors. :mod:`repro_torch.engine.shard`
    substitutes collective versions (``all_reduce`` over the gossip group)
    when each rank holds a block of the node rows."""

    vmax: Callable[[torch.Tensor], torch.Tensor]       # (N,) -> () max
    vmin: Callable[[torch.Tensor], torch.Tensor]       # (N,) -> () min
    vmean: Callable[[torch.Tensor], torch.Tensor]      # (N,) -> () mean
    leaf_mean: Callable[[torch.Tensor], torch.Tensor]  # (N, ...) -> (1, ...)


LOCAL_NODE_OPS = NodeOps(
    vmax=torch.max,
    vmin=torch.min,
    vmean=torch.mean,
    leaf_mean=lambda x: x.mean(dim=0, keepdim=True),
)


class ColumnOps(NamedTuple):
    """Column-axis reductions of the per-node norms of a shared vector whose
    leaves the ranks of a model axis split (the shared leaves' order).

    ``col_sum`` finishes a rank's partial norm (N,) (a SUM all-reduce over
    "model"; the identity by default); ``counted`` says, for each shared
    leaf, whether this rank counts its columns (None: all); ``col_maps``
    gives each leaf's wire columns (``kernels.ref.ColumnMap``; None: the
    rank's leaves are the whole wire row)."""

    col_sum: Callable[[torch.Tensor], torch.Tensor]
    counted: Sequence[bool] | None = None
    col_maps: Sequence[Any] | None = None

    @property
    def local(self) -> bool:
        return self.counted is None and self.col_maps is None


LOCAL_COLUMN_OPS = ColumnOps(col_sum=lambda x: x)


def _tree_norm(leaves, use_kernels: bool, columns: ColumnOps):
    """Per-node L1 norm of the shared vector from this rank's ``leaves``."""
    norm = kops.l1_norm_tree if use_kernels else l1_norm_per_node
    return columns.col_sum(norm(leaves, columns.counted))


@dataclasses.dataclass(frozen=True)
class DPPSConfig:
    """Protocol hyperparameters (paper Alg. 1 inputs + deployment switches)."""

    b: float = 5.0            # privacy budget hyperparameter
    gamma_n: float = 1.0      # noise rate (round is b/gamma_n - DP)
    c_prime: float = 0.78     # C' in Eq. (11)
    lam: float = 0.55         # lambda in Eq. (11)
    noise: bool = True        # False => plain Perturbed Push-Sum (SGP)
    sync_interval: int = 0    # full sync every k rounds; 0 = never
    schedule: str = "dense"   # "dense" | "circulant" | "sparse"
    use_kernels: bool = False # the CUDA kernels instead of plain versions
    wire_dtype: str = "f32"   # wire format; "bf16" needs the packed path
    # The wire codec (a repro_torch.wire.WireCodec; None or inactive = the
    # raw f32 wire), stamped from ProtocolPlan.wire by plan.resolve_dpps.
    wire: Any = None
    # "estimated" (Remark 1), "real" (exact, O(N^2 d)), "fixed" (constant)
    sensitivity_mode: str = "estimated"
    fixed_sensitivity: float = 0.0

    def __post_init__(self):
        if self.schedule not in ("dense", "circulant", "sparse"):
            raise ValueError(f"unknown or unported schedule {self.schedule!r}")
        if self.wire_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        # As the plan does: an inactive codec is the raw wire and is
        # dropped; an active codec's dtype stamps wire_dtype, and a
        # contradicting pair is refused.
        if self.wire is not None and not getattr(self.wire, "active", False):
            object.__setattr__(self, "wire", None)
        if self.wire is not None:
            codec_dtype = getattr(self.wire, "wire_dtype", "f32")
            if self.wire_dtype == "f32" and codec_dtype != "f32":
                object.__setattr__(self, "wire_dtype", codec_dtype)
            elif self.wire_dtype != codec_dtype:
                raise ValueError(
                    f"wire codec {self.wire.name!r} implies wire_dtype="
                    f"{codec_dtype!r} but cfg.wire_dtype={self.wire_dtype!r}")
        if self.sensitivity_mode not in ("estimated", "real", "fixed"):
            raise ValueError(f"unknown sensitivity_mode {self.sensitivity_mode!r}")
        if self.noise and self.b <= 0:
            raise ValueError("privacy budget b must be > 0")
        if self.gamma_n < 0:
            raise ValueError("gamma_n must be >= 0")

    @property
    def epsilon_per_round(self) -> float:
        if not self.noise or self.gamma_n == 0:
            return float("inf")
        return self.b / self.gamma_n


class DPPSState(NamedTuple):
    push: PushSumState
    sens: SensitivityState
    t: int  # host-side round counter
    # The message mass in flight under bounded delays (a repro_torch.net.
    # Mailbox, attached when the plan carries an active DelayModel). The
    # empty default adds no tree leaves, so synchronous states and their
    # checkpoints are unchanged.
    mail: Any = ()
    # The per-node (N, d_s) error-feedback residual of a stateful wire codec
    # (repro_torch.wire.TopKCodec), attached by the drivers; empty (no
    # leaves) otherwise, as mail.
    resid: Any = ()


def dpps_init(s0: PyTree, cfg: DPPSConfig) -> DPPSState:
    """Fresh state over node-stacked values ``s0`` (round 0)."""
    leaf = tree_leaves(s0)[0]
    n = leaf.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=leaf.device)
    return DPPSState(push=init_push_sum(s0, n, leaf.device),
                     sens=init_sensitivity(s0, zeros, c_prime=cfg.c_prime,
                                           lam=cfg.lam),
                     t=0)


def _bits_row(bits, leaves) -> torch.Tensor | None:
    """One uint32 tensor a leaf as the (N, d_s) wire row."""
    if bits is None:
        return None
    return torch.cat([b.reshape(x.shape[0], -1)
                      for b, x in zip(bits, leaves)], dim=1)


def _check_codec(cfg: DPPSConfig, state: DPPSState, packed: bool):
    """The round's value codec (None for the raw or bf16 wire), after the
    reference's checks (``repro/core/dpps.py:303-330``)."""
    if cfg.wire_dtype != "f32" and not packed:
        raise ValueError("wire_dtype='bf16' requires the packed runtime "
                         "(ProtocolPlan.packed=True / layout=)")
    codec = cfg.wire  # __post_init__ dropped inactive codecs
    if codec is not None and not packed:
        raise ValueError(
            f"wire codec {codec.name!r} requires the packed runtime "
            "(ProtocolPlan.packed=True / layout=) — the pytree oracle "
            "carries the raw f32 wire")
    if codec is None or not codec.transforms_values:
        return None
    if codec.stateful and not isinstance(state.resid, torch.Tensor):
        raise ValueError(
            f"wire codec {codec.name!r} carries an error-feedback "
            "residual; attach DPPSState.resid as an (N, d_s) f32 buffer "
            "(repro_torch.engine.run_dpps does this automatically)")
    return codec


def _nonfinite(x: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """The count of non-finite entries of ``x``, over its (N, -1) rows in
    ``chunk``-column blocks: a bool tensor's sum casts it to int64 first,
    which at the full width would be a second buffer twice the state's
    size."""
    rows = x.reshape(x.shape[0], -1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, rows.shape[1], chunk):
        total += (~torch.isfinite(rows[:, c0:c0 + chunk])).sum()
    return total


def _noise_l1(noise: PyTree, use_kernels: bool, layout) -> torch.Tensor:
    """Per-node ||noise||_1 of a drawn noise row (packed) or tree. On the
    kernel route it is summed in the fused perturbation's order
    (``ops.noise_l1_rows``), so a mechanism whose noise equals the fused
    draw's (Laplace at scale factor 1) keeps ``mechanism=None``'s norms,
    and with them its state, bit for bit."""
    if not use_kernels:
        return (noise.abs().sum(dim=-1) if isinstance(noise, torch.Tensor)
                else l1_norm_per_node(noise))
    if isinstance(noise, torch.Tensor):
        buf = torch.nn.functional.pad(noise, (0, layout.pad))  # the lanes
        return kops.noise_l1_rows(buf, noise.shape[1])
    return kops.noise_l1_tree(tree_leaves(noise))


def dpps_step(
    state: DPPSState,
    eps: torch.Tensor | PyTree,
    cfg: DPPSConfig,
    layout: PackedLayout | None = None,
    *,
    w: torch.Tensor | None = None,
    offsets: Sequence[int] | None = None,
    mix_weights: torch.Tensor | None = None,
    sparse_idx: torch.Tensor | None = None,
    sparse_vals: torch.Tensor | None = None,
    seed: int = 0,
    bits: torch.Tensor | Sequence[torch.Tensor] | None = None,
    return_s_half: bool = False,
    return_wire_stats: bool = False,
    gossip_fn: Callable[[PushSumState], PushSumState] | None = None,
    node_ops: NodeOps = LOCAL_NODE_OPS,
    node0: int = 0,
    mechanism: Any = None,
    tap: Any = None,
    wire_draws: torch.Tensor | None = None,
    noise_draws: torch.Tensor | None = None,
    columns: ColumnOps = LOCAL_COLUMN_OPS,
) -> tuple[DPPSState, dict[str, Any]]:
    """One DPPS round. Returns (new state, diag).

    With ``layout`` (the packed runtime) ``state.push.s`` is the (N, d_pad)
    buffer and ``eps`` an (N, d_pad) buffer or the shared leaf tree (packed
    here). With ``layout=None`` (the pytree runtime) both are trees of
    node-stacked leaves. The noise bits of round ``t`` are Philox of
    ``(seed, t)`` unless ``bits`` is given: the (N, d_s) uint32 wire row
    (packed runtime) or one uint32 tensor a leaf (pytree runtime). ``w``
    (dense), ``offsets`` (+ ``mix_weights``, circulant) or ``sparse_idx``
    + ``sparse_vals`` (sparse, (N, K) padded CSR) must match
    ``cfg.schedule``, unless ``gossip_fn`` is given: it then replaces the
    built-in mix of a round that is not a sync round, taking the noised
    ``PushSumState`` (the async mailbox, ``repro_torch.net.DelayModel.
    open_round``, is one). ``node_ops`` swaps the node-axis reductions
    (:class:`NodeOps`), and ``node0`` is the global node of the state's
    first row: the Philox draw keys row i by node ``node0 + i``, so a
    rank of the sharded engine draws the same rows of the whole network's
    noise (explicit ``bits`` are the rows' own; a mechanism's or a codec's
    draw is refused beside a nonzero ``node0``). ``columns``
    (:class:`ColumnOps`, the pytree runtime only) finishes the per-node
    norms over a model axis and keys the noise by global wire column.

    ``cfg.wire`` (packed runtime only) encodes the noised wire row after
    the noise (``repro_torch.wire``), in place in the noised buffer; a
    stateful codec reads and returns ``state.resid``; the broken
    compress-first codec encodes ``s^(t+1/2)`` before a down-scaled noise
    instead. Gossip, the sync average, the tap and the ``wd_*`` rows all
    read the one encoded buffer. ``cfg.wire_dtype="bf16"`` rounds the
    noised buffer to bf16 values on every round that gossips
    (``Bf16Codec.encode``) and mixes it with the plain f32 mix.
    ``wire_draws`` (tests only) feeds the int8 codecs' (N, d_s) uniforms.

    ``mechanism`` (a :class:`repro_torch.audit.mechanisms.NoiseMechanism`)
    replaces the built-in Laplace draw of Eq. 8 and takes precedence over
    ``use_kernels`` for the draw: it returns the (N, d_s) noise row of the
    round's scale ``S / b``, drawn from the round's noise bits.
    ``noise_draws`` (tests only) feeds the unit draws of a row drawn
    outside the fused perturbation (a mechanism's, or the compress-first
    codec's Laplace), which are then scaled. ``tap`` (a
    :class:`repro_torch.audit.transcript.TranscriptTap`) adds the round's
    wire-visible quantities under ``tap_*`` keys; packed rounds record the
    (N, d_s) wire slice in the wire dtype.

    ``return_s_half`` adds the perturbed pre-noise state ``s^(t+1/2)``
    under ``s_half`` (the buffer, or the tree); ``return_wire_stats`` the
    watchdog's ``wd_nonfinite`` (non-finite wire entries), ``wd_mass_drift``
    (``|mean(a) - 1|``), ``wd_consensus_residual`` (the corrected
    iterates' consensus error) and, under a stateful codec,
    ``wd_wire_resid`` (the mean per-node L1 of the carried residual).
    """
    packed = layout is not None
    codec = _check_codec(cfg, state, packed)
    if node0 and (mechanism is not None or cfg.wire is not None):
        raise ValueError("node0 keys the Laplace draw only; a mechanism's "
                         "or a wire codec's draw takes the rows as nodes 0, "
                         "1, ...")
    if not columns.local and (packed or mechanism is not None
                              or cfg.sensitivity_mode == "real"):
        raise ValueError("a model axis's column shards take the pytree "
                         "runtime (layout=None), the Laplace draw and the "
                         "estimated or fixed sensitivity")
    broken = codec is not None and codec.compress_before_noise
    s = state.push.s
    n = state.push.a.shape[0]
    t = state.t
    sens = state.sens
    noised = cfg.noise and cfg.gamma_n > 0
    # the noise row is drawn explicitly for a mechanism and for the broken
    # codec (which noises an encoded s_half); otherwise the fused perturb
    explicit = noised and (mechanism is not None or broken)
    need_s_half = (return_s_half or cfg.sensitivity_mode == "real"
                   or not noised or explicit)

    # -- 1. perturb (Eq. 7): the fused kernel below forms s + eps; the eps
    # norm is needed first, since the noise scale depends on it.
    with phase(PHASE_DPPS_PERTURB):
        if packed:
            k = kops if cfg.use_kernels else kref
            d_s = layout.d_s
            eps_buf = (eps if isinstance(eps, torch.Tensor)
                       else layout.pack(eps))
            eps_l1 = k.l1_norm_rows(eps_buf, d_s)
            s_half = s + eps_buf if need_s_half else None
            s_norm = lambda: k.l1_norm_rows(s, d_s)
        else:
            s_leaves, treedef = tree_flatten(s)
            eps_leaves = tree_leaves(eps)
            d_s = sum(x[0].numel() for x in s_leaves)
            eps_l1 = _tree_norm(eps_leaves, cfg.use_kernels, columns)
            s_half = (tree_unflatten(treedef, [x + e for x, e in
                                               zip(s_leaves, eps_leaves)])
                      if need_s_half or not cfg.use_kernels else None)
            s_norm = lambda: _tree_norm(s_leaves, cfg.use_kernels, columns)

    # -- 2. sensitivity estimate (Eq. 22 / Remark 1) -------------------------
    with phase(PHASE_DPPS_SENSITIVITY):
        if t == 0:
            s_local = 2.0 * sens.c_prime * (s_norm() + eps_l1)
        else:
            s_local = sens.lam * sens.s_local + 2.0 * sens.c_prime * (
                eps_l1 + sens.lam * cfg.gamma_n * sens.prev_noise_l1)
        s_net = node_ops.vmax(s_local)
        if cfg.sensitivity_mode == "real":
            s_used = real_sensitivity(layout.wire_slice(s_half) if packed
                                      else s_half)
        elif cfg.sensitivity_mode == "fixed":
            s_used = torch.tensor(cfg.fixed_sensitivity, dtype=torch.float32,
                                  device=state.push.a.device)
        else:
            s_used = s_net

    new_resid = state.resid
    if broken:
        # The wrong ordering on purpose (audit bait, repro_torch.wire): the
        # clean s_half is quantized first, and the noise below is scaled
        # down by the codec's factor. Honest codecs never come here.
        s_half, new_resid = layout.encode_wire(
            codec, s_half, new_resid, seed=seed, t=t, draws=wire_draws,
            inplace=True)

    # -- 3. Laplace noise (Eq. 8, Lemma 1), fused with the perturb add -------
    with phase(PHASE_DPPS_NOISE):
        noise_scale = s_used / cfg.b
        if broken and codec.noise_scale_factor != 1.0:
            noise_scale = noise_scale * codec.noise_scale_factor
        if not noised:
            s_noise = s_half
            noise_l1 = torch.zeros((n,), dtype=torch.float32,
                                   device=state.push.a.device)
        elif explicit:
            bits_row = bits if packed else _bits_row(bits, s_leaves)
            draw = dict(seed=seed, t=t, device=state.push.a.device,
                        use_kernels=cfg.use_kernels, bits=bits_row)
            sample = mechanism.sample if mechanism is not None else laplace_row
            row = sample(n, d_s, noise_scale, draws=noise_draws, **draw)
            if packed:
                noise_l1 = _noise_l1(row, cfg.use_kernels, layout)
                s_noise = layout.append_pad(
                    layout.wire_slice(s_half) + cfg.gamma_n * row, s_half)
            else:
                noise = split_row(row, s_half)
                noise_l1 = _noise_l1(noise, cfg.use_kernels, None)
                s_noise = tree_map(
                    lambda h, z: h + cfg.gamma_n * z.to(h.dtype),
                    s_half, noise)
            del row
        elif packed:
            s_noise, _, noise_l1 = k.dpps_perturb_rows(
                s, eps_buf, noise_scale, cfg.gamma_n, d_s, bits=bits,
                seed=seed, t=t, node0=node0)
        elif cfg.use_kernels:
            out, _, noise_l1 = kops.dpps_perturb_tree(
                s_leaves, eps_leaves, noise_scale, cfg.gamma_n,
                bits=bits, seed=seed, t=t, node0=node0,
                col_maps=columns.col_maps, counted=columns.counted)
            noise_l1 = columns.col_sum(noise_l1)
            s_noise = tree_unflatten(treedef, out)
        else:
            noise = noise_wire(s_half, noise_scale,
                               bits=_bits_row(bits, s_leaves), seed=seed, t=t,
                               node0=node0, col_maps=columns.col_maps)
            noise_l1 = columns.col_sum(l1_norm_per_node(noise,
                                                        columns.counted))
            s_noise = tree_map(lambda h, z: h + cfg.gamma_n * z.to(h.dtype),
                               s_half, noise)
        if codec is not None and not broken:
            # Noise, then compress: the codec sees only the noised wire, so the
            # encoding is DP post-processing. It is written into the noised
            # buffer, which is fresh whenever the noise is on.
            s_noise, new_resid = layout.encode_wire(
                codec, s_noise, new_resid, seed=seed, t=t, draws=wire_draws,
                inplace=s_noise is not s_half)
    s_local_round = s_local
    sync = is_sync_round(t, cfg.sync_interval)
    bf16 = cfg.wire_dtype == "bf16"
    mix_kernels = cfg.use_kernels and not bf16

    # -- 4. gossip (Eq. 9), or the full synchronization (paper SIII.C) --------
    with phase(PHASE_DPPS_SYNC if sync else PHASE_DPPS_GOSSIP):
        if bf16 and not sync:
            # The bf16 wire: the messages are rounded once, as the reference's
            # gossip casts them, and the f32 mix below accumulates them (never
            # in a mix kernel, as in the reference). A sync round averages the
            # f32 noised buffer, as the reference's does.
            s_noise, _ = layout.encode_wire(Bf16Codec(), s_noise, (),
                                            seed=seed, t=t,
                                            inplace=s_noise is not s_half)
        if sync:
            # Exact averaging of the noised parameters, per leaf view, and a
            # restart of the recursion. The mix of this round would be thrown
            # away, so it is not run.
            means = tree_map(node_ops.leaf_mean,
                             layout.view_tree(s_noise) if packed else s_noise)
            mean_l1 = columns.col_sum(l1_norm_per_node(
                means, columns.counted))                             # (1,)
            bcast = tree_map(lambda m: m.expand((n,) + tuple(m.shape[1:])),
                             means)
            # the packed buffer copies the broadcast views once; a tree state
            # holds each leaf as its own tensor, as the kernels take them
            push_new = PushSumState(
                s=(layout.append_pad(layout.flat_row(bcast), s_noise) if packed
                   else tree_map(torch.Tensor.contiguous, bcast)),
                a=torch.ones_like(state.push.a))
            s_local = (2.0 * sens.c_prime * mean_l1).expand(n).clone()
            prev_l1 = torch.zeros_like(noise_l1)
        else:
            push_half = PushSumState(s=s_noise, a=state.push.a)
            if gossip_fn is not None:
                if packed and bf16:
                    raise NotImplementedError(
                        "bf16 wire + custom gossip_fn (sharded engine) is "
                        "not implemented; use wire_dtype='f32' on the mesh")
                push_new = gossip_fn(push_half)
            elif cfg.schedule == "circulant":
                if offsets is None:
                    raise ValueError("circulant schedule requires offsets=")
                if packed:
                    push_new = gossip_packed(push_half, offsets=offsets,
                                             weights=mix_weights)
                else:
                    if mix_weights is None:
                        mix_weights = torch.full(
                            (len(offsets),), 1.0 / len(offsets),
                            dtype=torch.float32, device=state.push.a.device)
                    push_new = gossip_circulant(push_half, offsets,
                                                mix_weights)
            elif cfg.schedule == "sparse":
                if sparse_idx is None or sparse_vals is None:
                    raise ValueError(
                        "sparse schedule requires sparse_idx=/sparse_vals=")
                push_new = (gossip_packed(push_half, sparse_idx=sparse_idx,
                                          sparse_vals=sparse_vals,
                                          use_kernels=mix_kernels)
                            if packed else
                            gossip_sparse(push_half, sparse_idx, sparse_vals,
                                          use_kernels=cfg.use_kernels))
            else:
                if w is None:
                    raise ValueError("dense schedule requires w=")
                push_new = (gossip_packed(push_half, w=w,
                                          use_kernels=mix_kernels)
                            if packed else
                            gossip_dense(push_half, w,
                                         use_kernels=cfg.use_kernels))
            prev_l1 = noise_l1

    new_state = state._replace(
        push=push_new,
        sens=sens._replace(s_local=s_local, prev_noise_l1=prev_l1),
        t=t + 1, resid=new_resid)
    diag = {
        "sensitivity_used": s_used,
        "sensitivity_estimate": s_net,
        "sensitivity_local": s_local,
        "eps_l1_max": node_ops.vmax(eps_l1),
        "noise_l1_mean": node_ops.vmean(noise_l1),
        "a_min": node_ops.vmin(push_new.a),
        "a_max": node_ops.vmax(push_new.a),
    }
    if return_wire_stats:
        with phase(PHASE_DPPS_WIRE_STATS):
            # The watchdog's inputs (repro.obs.watchdog in the reference):
            # judged on the host at segment boundaries.
            diag["wd_nonfinite"] = sum(_nonfinite(x).to(torch.int32)
                                       for x in tree_leaves(s_noise))
            diag["wd_mass_drift"] = (push_new.a.mean() - 1.0).abs()
            # in 2^24-column blocks: a full-width buffer's temporaries
            # stay at (N, 2^24); one block (the same sum) below that
            diag["wd_consensus_residual"] = consensus_error(
                push_new.s, a=push_new.a, chunk=1 << 24)
            if codec is not None and codec.stateful:
                # error-feedback health: top-k is a contraction, so this stays
                # bounded
                diag["wd_wire_resid"] = node_ops.vmean(
                    new_resid.abs().sum(dim=-1))
    if tap is not None:
        # What the network sees this round (repro_torch.audit.transcript):
        # the noised (encoded) messages with the weights a they carry, and
        # the local sensitivities broadcast for the max with the network
        # scalar they give.
        if packed:
            wire = layout.wire_slice(s_noise)
            if bf16:
                wire = wire.to(torch.bfloat16)
            msgs = [wire]
        else:
            msgs = s_noise
        diag.update(tap.capture(s_noise=msgs, a_out=state.push.a,
                                sens_local=s_local_round,
                                sens_scalar=s_used))
    if return_s_half:
        diag["s_half"] = s_half
    return new_state, diag


def dpps_consensus(state: DPPSState) -> PyTree:
    """The protocol output s-bar (Alg. 1 Output): node mean of corrected y."""
    return node_mean(correct(state.push.s, state.push.a))
