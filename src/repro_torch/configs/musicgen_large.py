"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048
— decoder-only over EnCodec tokens. [arXiv:2306.05284]

Modality carve-out (DESIGN.md): the EnCodec conv codec is a stub —
``input_specs`` supplies precomputed frame embeddings (B, S, d_model); this
model is the language-model decoder that consumes them, with a 2048-way
codebook head."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import AttnGroup, ModelConfig

MODEL = ModelConfig(
    name="musicgen-large",
    d_model=2048,
    vocab_size=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    activation="gelu",
    tie_embedding=False,
    input_mode="embeddings",
    groups=(AttnGroup(n_layers=48),),
    source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    d_model=128,
    vocab_size=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    activation="gelu",
    tie_embedding=False,
    input_mode="embeddings",
    groups=(AttnGroup(n_layers=2),),
)

SPEC = ArchSpec(
    name="musicgen-large",
    family="audio",
    model=MODEL,
    smoke=SMOKE,
    shared_rules=(("group_0/.*", ("split_layers", 12)),),
    notes="frame-embedding stub input; codebook head kept local",
)
