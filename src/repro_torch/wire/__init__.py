"""Value-wise wire compression on the packed gossip buffer (port of
``repro.wire``): frozen codecs riding on
:class:`repro_torch.engine.ProtocolPlan` (``wire=``), applied after the
noise (see :mod:`repro_torch.wire.codecs`)."""
from repro_torch.wire.codecs import (
    DRAW_COLUMNS,
    WIRE_SALT,
    Bf16Codec,
    BrokenCompressFirstCodec,
    IdentityCodec,
    Int8StochasticCodec,
    TopKCodec,
    WireCodec,
    parse_wire_spec,
    wire_uniforms,
)

__all__ = [
    "WireCodec",
    "IdentityCodec",
    "Bf16Codec",
    "Int8StochasticCodec",
    "TopKCodec",
    "BrokenCompressFirstCodec",
    "parse_wire_spec",
    "wire_uniforms",
    "WIRE_SALT",
    "DRAW_COLUMNS",
]
