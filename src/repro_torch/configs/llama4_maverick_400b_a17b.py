"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E (family card)]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, MoEGroup

MODEL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    d_model=5120,
    vocab_size=202_048,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    activation="silu",
    rope_theta=500_000.0,
    tie_embedding=False,
    # Maverick alternates dense / MoE layers (24 x 128-expert MoE + 24 dense
    # = ~400B total with ~17B active).
    groups=(MoEGroup(n_layers=48, n_experts=128, top_k=1, shared_expert=True,
                     moe_every=2),),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    activation="silu",
    tie_embedding=False,
    groups=(MoEGroup(n_layers=2, n_experts=4, top_k=1, shared_expert=True,
                     moe_every=2),),
)

SPEC = ArchSpec(
    name="llama4-maverick-400b-a17b",
    family="moe",
    model=MODEL,
    smoke=SMOKE,
    # Interleaved param paths: group_0/dense/* (attn+mlp unit) and
    # group_0/moe/* (attn + expert bank). Share attention everywhere +
    # the router; experts and dense MLPs stay local.
    shared_rules=(
        ("group_0/(dense|moe)/(ln1|ln2|attn)/.*", "shared"),
        ("group_0/moe/moe/router", "shared"),
    ),
    notes="SPerf hillclimb pair #2 (worst roofline; 128-expert bank)",
)
