"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron. [arXiv:2407.14679]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import AttnGroup, ModelConfig

MODEL = ModelConfig(
    name="minitron-4b",
    d_model=3072,
    vocab_size=256_000,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    activation="silu",
    rope_theta=10_000.0,
    tie_embedding=False,
    groups=(AttnGroup(n_layers=32),),
    source="arXiv:2407.14679",
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke",
    d_model=192,
    vocab_size=512,
    n_heads=6,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    activation="silu",
    tie_embedding=False,
    groups=(AttnGroup(n_layers=2),),
)

SPEC = ArchSpec(
    name="minitron-4b",
    family="dense",
    model=MODEL,
    smoke=SMOKE,
    shared_rules=(("group_0/.*", ("split_layers", 8)),),
)
