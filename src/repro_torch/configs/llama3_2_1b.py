"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import AttnGroup, ModelConfig

MODEL = ModelConfig(
    name="llama3.2-1b",
    d_model=2048,
    vocab_size=128_256,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    activation="silu",
    rope_theta=500_000.0,
    tie_embedding=True,
    groups=(AttnGroup(n_layers=16),),
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    activation="silu",
    rope_theta=500_000.0,
    tie_embedding=True,
    groups=(AttnGroup(n_layers=2),),
)

SPEC = ArchSpec(
    name="llama3.2-1b",
    family="dense",
    model=MODEL,
    smoke=SMOKE,
    shared_rules=(("group_0/.*", ("split_layers", 4)),),
    notes="SPerf hillclimb pair #1 (gossip-collective-bound)",
)
