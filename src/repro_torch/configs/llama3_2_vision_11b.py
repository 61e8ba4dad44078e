"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision]

Modality carve-out (DESIGN.md): the ViT vision encoder + projector is a
stub — ``input_specs`` supplies projected patch embeddings
(B, 1600, d_model) consumed by the gated cross-attention layers. Structure:
8 units of [1 cross-attn + 4 self-attn] = 40 layers."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import CrossSelfGroup, ModelConfig

MODEL = ModelConfig(
    name="llama-3.2-vision-11b",
    d_model=4096,
    vocab_size=128_256,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    activation="silu",
    rope_theta=500_000.0,
    tie_embedding=True,
    groups=(CrossSelfGroup(n_units=8, self_per_unit=4, n_image_tokens=1600),),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    activation="silu",
    tie_embedding=True,
    groups=(CrossSelfGroup(n_units=1, self_per_unit=1, n_image_tokens=16),),
)

SPEC = ArchSpec(
    name="llama-3.2-vision-11b",
    family="vlm",
    model=MODEL,
    smoke=SMOKE,
    # Self-attn stack shared; cross-attn (modality adapters) stay local —
    # the natural PartPSP split for multimodal personalization.
    shared_rules=(("group_0/self/.*", "shared"),),
    notes="patch-embedding stub; cross-attn local / self-attn shared",
)
