"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, MoEGroup

MODEL = ModelConfig(
    name="llama4-scout-17b-a16e",
    d_model=5120,
    vocab_size=202_048,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    activation="silu",
    rope_theta=500_000.0,
    tie_embedding=False,
    groups=(MoEGroup(n_layers=48, n_experts=16, top_k=1, shared_expert=True),),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    activation="silu",
    tie_embedding=False,
    groups=(MoEGroup(n_layers=2, n_experts=4, top_k=1, shared_expert=True),),
)

SPEC = ArchSpec(
    name="llama4-scout-17b-a16e",
    family="moe",
    model=MODEL,
    smoke=SMOKE,
    # Attention + router shared; the expert banks stay local. Keeping the
    # (huge) experts out of the DPPS shared set is exactly the paper's
    # d_s-reduction insight applied at MoE scale.
    shared_rules=(
        ("group_0/(ln1|ln2|attn)/.*", "shared"),
        ("group_0/moe/router", "shared"),
    ),
)
