"""Wire-compression codecs for the packed (N, d_s) gossip buffer (port of
``repro.wire.codecs``).

A :class:`WireCodec` is a frozen, hashable stage riding on
:class:`repro_torch.engine.ProtocolPlan` (``wire=``) as the fault and delay
models do: an inactive codec is dropped at plan build, so the default
round is the raw f32 one; an active codec is applied by
:func:`repro_torch.core.dpps.dpps_step`.

Noise, then compress. Every honest codec encodes the already-noised wire
row (``s_noise``, after the Eq. 8 Laplace draw). Post-processing of a DP
release cannot raise its epsilon, so the sensitivity recursion, the noise
calibration and the ledger are untouched. :class:`BrokenCompressFirstCodec`
implements the converse fallacy (quantize the clean ``s_half``, then add a
quarter of the noise) so that the attack battery (``repro_torch.audit``)
can flag it.

Contract: ``encode(wire, resid, *, seed, t, draws=None, out=None) -> (enc,
new_resid)``. ``wire`` is the un-padded (N, d_s) f32 slice and ``enc`` the
dequantized f32 view of what travels: a receiver of an int8 message
dequantizes and accumulates in f32, which is what the f32 mix computes on
``enc``, so one encode on the sender's side models the whole round trip
for every gossip entry point (dense, sparse, circulant, the async
mailbox). ``payload_bytes(d_s)`` is the bytes-on-the-wire figure that the
ledger, ``RunReport.network`` and ``estimate_wire_bytes`` share. ``out``
(an (N, d_s) f32 tensor, which may be ``wire`` itself) receives ``enc``:
the round writes the encoding into the noised buffer, which nothing reads
afterwards, so a full-width encode adds no (N, d_s) buffer.

Stochastic rounding. The reference draws its uniforms with
``jax.random.uniform`` under ``fold_in(round key, WIRE_SALT)``; threefry is
not reproduced here. The port draws them from a Philox stream keyed by
``(seed lo, seed hi ^ WIRE_SALT)`` with counter ``(e // 4 lo, e // 4 hi,
node, t)`` (word ``e % 4`` for element ``e``), ``u = (word >> 9) 2^-23`` in
[0, 1) as ``jax.random.uniform`` forms it: a pure function of (session
seed, round, node, element), independent of the noise bits (whose key is
``(seed lo, seed hi)``) and the same on the card and on the CPU. The draw
runs in column windows of :data:`DRAW_COLUMNS`, so its int64 temporaries
stay bounded at full width. ``draws=`` (tests only) feeds the reference's
own uniforms instead.

Stateful codecs (top-k with error feedback) carry a per-node (N, d_s)
residual as ``DPPSState.resid``, attached by the drivers when the plan's
codec is ``stateful``; the empty default adds no state leaves.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import philox_bits

__all__ = [
    "WireCodec",
    "IdentityCodec",
    "Bf16Codec",
    "Int8StochasticCodec",
    "TopKCodec",
    "BrokenCompressFirstCodec",
    "parse_wire_spec",
    "wire_uniforms",
    "WIRE_SALT",
    "DRAW_COLUMNS",
]

# Stream separation: the stochastic-rounding draw's key is the session
# seed's with this salt xored into its high word (the reference folds the
# same salt into its round key).
WIRE_SALT = 0x57495245  # "WIRE"

# Top-k coordinate indices ship as uint16 on the wire (the 6-bytes-a-
# coordinate accounting), so the packed wire width must index in 16 bits.
_UINT16_DIMS = 2 ** 16

# Columns of one window of the stochastic-rounding draw and encode: the
# Philox draw holds about a dozen int64 (N, DRAW_COLUMNS / 4) temporaries.
DRAW_COLUMNS = 1 << 24


def wire_uniforms(seed: int, t: int, n_nodes: int, start: int, stop: int,
                  device=None) -> torch.Tensor:
    """The stochastic-rounding uniforms of round ``t``: (n_nodes, stop -
    start) f32 in [0, 1) for wire columns [start, stop) of every node (see
    the module docstring for the stream)."""
    words = philox_bits(seed, t, n_nodes, start, stop, device=device,
                        salt=WIRE_SALT)
    return (words >> 9).to(torch.float32) * (1.0 / (1 << 23))


def _sr_quantize_int8(wire: torch.Tensor, *, seed: int, t: int,
                      draws: torch.Tensor | None, out: torch.Tensor | None
                      ) -> torch.Tensor:
    """Stochastic-rounding int8 quantization, returned dequantized (f32).

    Per-node symmetric scale ``max|row| / 127`` (1 for an all-zero row);
    ``q = clip(floor(x / scale + u), -127, 127)``, the result ``q scale``.
    Unbiased: ``E[q scale] = x``. Every step is one IEEE operation, so the
    result equals the reference's bit for bit on the same uniforms. Runs
    in column windows (the draw's and the arithmetic's temporaries are a
    window's), writing into ``out``.
    """
    n, d = wire.shape
    step = DRAW_COLUMNS
    amax = None
    for c0 in range(0, d, step):
        m = wire[:, c0:c0 + step].abs().amax(dim=1, keepdim=True)
        amax = m if amax is None else torch.maximum(amax, m)
    scale = amax / 127.0
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    if out is None:
        out = torch.empty_like(wire)
    for c0 in range(0, d, step):
        c1 = min(c0 + step, d)
        u = (draws[:, c0:c1].to(device=wire.device, dtype=torch.float32)
             if draws is not None else
             wire_uniforms(seed, t, n, c0, c1, device=wire.device))
        q = wire[:, c0:c1] / scale
        q += u
        del u
        q = torch.floor_(q).clamp_(-127.0, 127.0)
        out[:, c0:c1] = q.mul_(scale)
    return out


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Base codec: the identity (nothing rides the plan).

    Contract attributes, overridden by the subclasses:

    * ``active``            inactive codecs are dropped at plan build;
    * ``wire_dtype``        the dtype the messages are rounded to ("bf16":
      once a round that gossips, before the f32 mix);
    * ``transforms_values`` whether ``encode`` changes values (dtype-only
      codecs leave the buffer alone and let the mix boundary cast);
    * ``stateful``          whether an (N, d_s) residual is carried
      (``DPPSState.resid``);
    * ``compress_before_noise`` / ``noise_scale_factor`` the broken
      ordering's knobs; every honest codec keeps the defaults.
    """

    name = "f32"
    wire_dtype = "f32"
    transforms_values = False
    stateful = False
    compress_before_noise = False
    noise_scale_factor = 1.0

    @property
    def active(self) -> bool:
        return False

    def payload_bytes(self, d_s: int) -> int:
        """A message's payload bytes (one edge, one round) at width d_s."""
        return 4 * d_s

    def encode(self, wire: torch.Tensor, resid, *, seed: int = 0, t: int = 0,
               draws: torch.Tensor | None = None,
               out: torch.Tensor | None = None):
        return wire, resid


class IdentityCodec(WireCodec):
    """The no-compression default spelled out (``--wire f32``)."""


def _round_bf16(wire: torch.Tensor, out: torch.Tensor | None
                ) -> torch.Tensor:
    """``wire`` rounded to bf16 values, kept in f32, in column windows of
    :data:`DRAW_COLUMNS` (the cast's temporary is a window's), into
    ``out``."""
    if out is None:
        out = torch.empty_like(wire)
    for c0 in range(0, wire.shape[1], DRAW_COLUMNS):
        out[:, c0:c0 + DRAW_COLUMNS] = wire[:, c0:c0 + DRAW_COLUMNS].to(
            torch.bfloat16)
    return out


@dataclasses.dataclass(frozen=True)
class Bf16Codec(WireCodec):
    """The bf16 wire as a codec. Dtype-only, as the reference's: the plan
    stamps ``wire_dtype="bf16"``, and every round that gossips rounds the
    noised messages once to bf16 (``encode``: the f32 view of the bf16
    values), which the f32 mix then accumulates, as the reference's bf16
    gossip does (bf16 messages, f32 accumulation, f32 result)."""

    name = "bf16"
    wire_dtype = "bf16"

    @property
    def active(self) -> bool:
        return True

    def payload_bytes(self, d_s: int) -> int:
        return 2 * d_s

    def encode(self, wire, resid, *, seed=0, t=0, draws=None, out=None):
        return _round_bf16(wire, out), resid


@dataclasses.dataclass(frozen=True)
class Int8StochasticCodec(WireCodec):
    """int8 stochastic-rounding quantization: d_s int8 coordinates and one
    f32 scale a message (about 4x fewer bytes). Unbiased, applied to the
    noised buffer (post-processing: epsilon untouched)."""

    name = "int8"
    transforms_values = True

    @property
    def active(self) -> bool:
        return True

    def payload_bytes(self, d_s: int) -> int:
        return d_s + 4  # int8 coordinates + one f32 scale

    def encode(self, wire, resid, *, seed=0, t=0, draws=None, out=None):
        return _sr_quantize_int8(wire, seed=seed, t=t, draws=draws,
                                 out=out), resid


@dataclasses.dataclass(frozen=True)
class TopKCodec(WireCodec):
    """Top-k magnitude sparsification with per-node error feedback.

    Exactly one of ``k`` (absolute) and ``frac`` (``k = d_s // frac``) is
    positive. The dropped mass is carried in the residual and added back
    the next round. Ties at the k-th magnitude are all kept: the threshold
    is the k-th largest ``|x|`` (``torch.topk`` values) and the encoding
    ``where(|x| >= kth, x, 0)``, as the reference's ``lax.top_k`` threshold
    makes it. Payload 6 bytes a kept coordinate (f32 value + uint16 index),
    which needs ``d_s < 65536``.
    """

    k: int = 0
    frac: int = 0

    name_prefix = "topk"
    transforms_values = True
    stateful = True

    def __post_init__(self):
        if (self.k > 0) == (self.frac > 0):
            raise ValueError(
                "TopKCodec needs exactly one of k= (absolute) or frac= "
                f"(k = d_s // frac); got k={self.k} frac={self.frac}")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"topk:{self.k}" if self.k > 0 else f"topk:1/{self.frac}"

    @property
    def active(self) -> bool:
        return True

    def effective_k(self, d_s: int) -> int:
        k = self.k if self.k > 0 else max(1, d_s // self.frac)
        return min(k, d_s)

    def payload_bytes(self, d_s: int) -> int:
        if d_s >= _UINT16_DIMS:
            raise ValueError(
                f"top-k wire indices are uint16; packed width d_s={d_s} "
                f"needs >= 17 index bits (max {_UINT16_DIMS - 1})")
        return 6 * self.effective_k(d_s)

    def encode(self, wire, resid, *, seed=0, t=0, draws=None, out=None):
        x = wire + resid
        k = self.effective_k(x.shape[-1])
        mag = x.abs()
        kth = torch.topk(mag, k, dim=-1).values[..., -1:]
        enc = torch.where(mag >= kth, x, torch.zeros_like(x))
        new_resid = x - enc
        if out is not None:
            out.copy_(enc)
            enc = out
        return enc, new_resid


@dataclasses.dataclass(frozen=True)
class BrokenCompressFirstCodec(WireCodec):
    """The wrong ordering on purpose, audit bait only: quantize the clean
    ``s_half`` to int8, then add a quarter of the noise
    (``noise_scale_factor``) because the wire "carries fewer bits". The
    attack battery must flag it. Never select it outside the audit lab."""

    noise_scale_factor: float = 0.25

    name = "broken_compress_first"
    transforms_values = True
    compress_before_noise = True

    @property
    def active(self) -> bool:
        return True

    def payload_bytes(self, d_s: int) -> int:
        return d_s + 4

    def encode(self, wire, resid, *, seed=0, t=0, draws=None, out=None):
        return _sr_quantize_int8(wire, seed=seed, t=t, draws=draws,
                                 out=out), resid


def parse_wire_spec(spec: str | None) -> WireCodec:
    """A ``--wire`` spec as a codec: ``f32`` / ``identity`` (none),
    ``bf16``, ``int8``, ``topk:K``, ``topk:1/M`` (k = d_s // M) and the
    audit-only ``broken-compress-first``. Anything else raises a
    ``ValueError`` naming the choices."""
    s = (spec or "f32").strip().lower()
    if s in ("f32", "identity", ""):
        return IdentityCodec()
    if s == "bf16":
        return Bf16Codec()
    if s == "int8":
        return Int8StochasticCodec()
    if s.startswith("topk:"):
        arg = s[len("topk:"):]
        try:
            if arg.startswith("1/") or arg.startswith("d/"):
                return TopKCodec(frac=int(arg[2:]))
            return TopKCodec(k=int(arg))
        except ValueError as e:
            raise ValueError(f"bad top-k spec {spec!r}: {e}") from None
    if s in ("broken-compress-first", "broken_compress_first"):
        return BrokenCompressFirstCodec()
    raise ValueError(
        f"unknown wire spec {spec!r}; choose f32 | bf16 | int8 | topk:K | "
        "topk:1/M | broken-compress-first")
