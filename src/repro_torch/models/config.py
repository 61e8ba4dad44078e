"""Model configuration: a composable block-group description (port of
``repro.models.config``; pure data, copied whole).

A model is an embedding, an ordered tuple of *block groups*, a final norm,
and an LM head. Parameters of a group are stacked over its layers (a
leading ``n_layers`` axis), as in the reference, so parameter paths and
shapes agree between the two packages.

* ``AttnGroup``     — n identical GQA decoder blocks; per-layer sliding
                      windows / rope thetas (gemma3's 5-local:1-global).
* ``MoEGroup``, ``XLSTMGroup``, ``MambaGroup``, ``ZambaGroup``,
  ``CrossSelfGroup`` — the other families. The port's
  :class:`repro_torch.models.transformer.Transformer` trains and serves
  every kind.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "AttnGroup",
    "MoEGroup",
    "XLSTMGroup",
    "MambaGroup",
    "ZambaGroup",
    "CrossSelfGroup",
    "ModelConfig",
]


@dataclasses.dataclass(frozen=True)
class AttnGroup:
    n_layers: int
    # Per-layer sliding window; None = full/global attention. A single value
    # broadcasts. gemma3: (w, w, w, w, w, None) * k.
    windows: Optional[Tuple[Optional[int], ...]] = None
    # Per-layer rope theta override (gemma3 uses 10k local / 1M global).
    thetas: Optional[Tuple[float, ...]] = None

    kind: str = dataclasses.field(default="attn", init=False)

    def layer_windows(self) -> Tuple[Optional[int], ...]:
        if self.windows is None:
            return (None,) * self.n_layers
        if len(self.windows) == self.n_layers:
            return self.windows
        # repeat pattern
        reps = -(-self.n_layers // len(self.windows))
        return (self.windows * reps)[: self.n_layers]

    def layer_thetas(self, default: float) -> Tuple[float, ...]:
        if self.thetas is None:
            return (default,) * self.n_layers
        if len(self.thetas) == self.n_layers:
            return self.thetas
        reps = -(-self.n_layers // len(self.thetas))
        return (self.thetas * reps)[: self.n_layers]

    @property
    def total_layers(self) -> int:
        return self.n_layers

    @property
    def min_window(self) -> Optional[int]:
        ws = [w for w in self.layer_windows()]
        return None if any(w is None for w in ws) else max(ws)


@dataclasses.dataclass(frozen=True)
class MoEGroup:
    n_layers: int
    n_experts: int
    top_k: int = 1                 # paper-assigned archs use top-1
    capacity_factor: float = 1.25
    shared_expert: bool = True     # llama4-style always-on shared expert
    router_aux_weight: float = 0.01
    # Interleave: every moe_every-th layer is MoE, the rest are dense MLP
    # (llama4-maverick alternates dense/MoE; scout is all-MoE).
    moe_every: int = 1

    kind: str = dataclasses.field(default="moe", init=False)

    def __post_init__(self):
        if self.moe_every < 1 or self.n_layers % self.moe_every:
            raise ValueError("n_layers must be divisible by moe_every >= 1")

    @property
    def n_units(self) -> int:
        return self.n_layers // self.moe_every

    @property
    def total_layers(self) -> int:
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class XLSTMGroup:
    n_units: int                   # each unit = mlstm_per_unit mLSTM + 1 sLSTM
    mlstm_per_unit: int = 3
    proj_factor: float = 2.0       # mLSTM up-projection factor
    conv_kernel: int = 0           # 0 disables the causal conv (kept simple)

    kind: str = dataclasses.field(default="xlstm", init=False)

    @property
    def total_layers(self) -> int:
        return self.n_units * (self.mlstm_per_unit + 1)


@dataclasses.dataclass(frozen=True)
class MambaGroup:
    n_layers: int
    d_state: int = 64
    expand: int = 2

    kind: str = dataclasses.field(default="mamba", init=False)

    @property
    def total_layers(self) -> int:
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class ZambaGroup:
    n_units: int                   # each unit = mamba_per_unit Mamba2 + shared attn
    mamba_per_unit: int = 6
    trailing_mamba: int = 0
    d_state: int = 64
    expand: int = 2

    kind: str = dataclasses.field(default="zamba", init=False)

    @property
    def total_layers(self) -> int:
        return self.n_units * (self.mamba_per_unit + 1) + self.trailing_mamba


@dataclasses.dataclass(frozen=True)
class CrossSelfGroup:
    n_units: int                   # each unit = 1 cross-attn + self_per_unit self-attn
    self_per_unit: int = 4
    n_image_tokens: int = 1600

    kind: str = dataclasses.field(default="cross_self", init=False)

    @property
    def total_layers(self) -> int:
        return self.n_units * (self.self_per_unit + 1)


GroupSpec = object  # union of the dataclasses above


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    groups: Tuple[GroupSpec, ...]
    norm_eps: float = 1e-6
    activation: str = "silu"       # silu | geglu | gelu
    rope_theta: float = 10_000.0
    tie_embedding: bool = True
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    logit_softcap: float = 0.0     # 0 disables
    input_mode: str = "tokens"     # tokens | embeddings (modality stub)
    param_dtype: str = "float32"
    # Eligible for the long_500k decode shape (SSM/hybrid state, or a mostly
    # sliding-window dense stack). Pure full-attention archs keep False and
    # skip long_500k per DESIGN.md.
    long_context_ok: bool = False
    # The reference's choice between two decode layouts of the
    # layer-stacked KV cache. The port always writes the token slot of the
    # stacked cache in place; the flag is kept and changes no result.
    decode_cache_in_carry: bool = False
    # Route prefill self-attention through the flash-attention kernel
    # (O(S*D) device memory traffic instead of materialised (S, S) scores).
    # Forward-only: applies to prefill, not training.
    flash_prefill: bool = False
    # citation for the assigned-architecture table
    source: str = ""

    def __post_init__(self):
        if self.activation not in ("silu", "geglu", "gelu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.input_mode not in ("tokens", "embeddings"):
            raise ValueError(f"unknown input_mode {self.input_mode!r}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def total_layers(self) -> int:
        return sum(g.total_layers for g in self.groups)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders
