"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared-weight attention blocks.
[arXiv:2411.15242]

Structure here: 11 units of [6 Mamba2 + 1 shared-weight attention
application] + 4 trailing Mamba2 = 81 layer applications; the attention
block's weights are shared across all 11 applications (Zamba2's trick)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, ZambaGroup

MODEL = ModelConfig(
    name="zamba2-7b",
    d_model=3584,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    activation="silu",
    tie_embedding=True,
    groups=(ZambaGroup(n_units=11, mamba_per_unit=6, trailing_mamba=4,
                       d_state=64, expand=2),),
    long_context_ok=True,   # Mamba2 state is O(1); bounded attention caches
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    activation="silu",
    tie_embedding=True,
    groups=(ZambaGroup(n_units=1, mamba_per_unit=1, trailing_mamba=0,
                       d_state=16, expand=2),),
    long_context_ok=True,
)

SPEC = ArchSpec(
    name="zamba2-7b",
    family="hybrid",
    model=MODEL,
    smoke=SMOKE,
    # The single shared attention block is the globally-coupled component —
    # share it; the Mamba2 backbone stays local (cheap d_s, paper SIII.C).
    shared_rules=(("group_0/shared_attn/.*", "shared"),),
    notes="SPerf hillclimb pair #3 (long_500k decode memory)",
)
