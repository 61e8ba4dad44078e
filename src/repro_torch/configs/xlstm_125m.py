"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (3 units of [3 mLSTM + 1 sLSTM]). [arXiv:2405.04517]

DPPS applicability: the protocol is model-agnostic (it wraps the parameter
pytree), so the attention-free stack changes nothing protocol-side; the
PartPSP partition keeps the recurrent sLSTM cells local and shares the
mLSTM blocks."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, XLSTMGroup

MODEL = ModelConfig(
    name="xlstm-125m",
    d_model=768,
    vocab_size=50_304,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    tie_embedding=True,
    groups=(XLSTMGroup(n_units=3, mlstm_per_unit=3, proj_factor=2.0),),
    long_context_ok=True,   # O(1) recurrent state
    source="arXiv:2405.04517",
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke",
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=0,
    tie_embedding=True,
    groups=(XLSTMGroup(n_units=1, mlstm_per_unit=1, proj_factor=2.0),),
    long_context_ok=True,
)

SPEC = ArchSpec(
    name="xlstm-125m",
    family="ssm",
    model=MODEL,
    smoke=SMOKE,
    shared_rules=(("group_0/mlstm/.*", "shared"),),
    notes="attention-free; mLSTM shared / sLSTM local",
)
