"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16, i.e. MHA) d_ff=24576
vocab=256000 — GeGLU, head_dim=256. [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import AttnGroup, ModelConfig

MODEL = ModelConfig(
    name="gemma-7b",
    d_model=3072,
    vocab_size=256_000,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    activation="geglu",
    embed_scale=True,
    tie_embedding=True,
    groups=(AttnGroup(n_layers=28),),
    source="arXiv:2403.08295",
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=512,
    activation="geglu",
    embed_scale=True,
    tie_embedding=True,
    groups=(AttnGroup(n_layers=2),),
)

SPEC = ArchSpec(
    name="gemma-7b",
    family="dense",
    model=MODEL,
    smoke=SMOKE,
    shared_rules=(("group_0/.*", ("split_layers", 7)),),
)
