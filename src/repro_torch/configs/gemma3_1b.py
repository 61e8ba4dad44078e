"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import AttnGroup, ModelConfig

_PATTERN_W = (512, 512, 512, 512, 512, None)         # 5 local : 1 global
_PATTERN_T = (10_000.0,) * 5 + (1_000_000.0,)

MODEL = ModelConfig(
    name="gemma3-1b",
    d_model=1152,
    vocab_size=262_144,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    activation="geglu",
    embed_scale=True,
    tie_embedding=True,
    logit_softcap=30.0,
    groups=(AttnGroup(n_layers=26, windows=_PATTERN_W, thetas=_PATTERN_T),),
    long_context_ok=True,   # mostly sliding-window; global KV stays linear
    source="hf:google/gemma-3-1b-pt",
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    activation="geglu",
    embed_scale=True,
    tie_embedding=True,
    logit_softcap=30.0,
    groups=(AttnGroup(n_layers=2, windows=(8, None), thetas=(10_000.0, 1_000_000.0)),),
    long_context_ok=True,
)

SPEC = ArchSpec(
    name="gemma3-1b",
    family="dense",
    model=MODEL,
    smoke=SMOKE,
    # PartPSP: share the first quarter of the block stack (PartPSP-1 style).
    shared_rules=(("group_0/.*", ("split_layers", 6)),),
    notes="5:1 local:global; long_500k eligible via sliding window",
)
