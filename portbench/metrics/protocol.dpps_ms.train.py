"""Device milliseconds a step in the DPPS round and the clip (the
program's ``dpps_*`` and ``partpsp_clip`` phases)."""
from portbench.harness.readers import phase_ms

UNIT, LAYER, MOVES = "ms", "protocol", "train_tokens_per_s"


def read(rec):
    return phase_ms(rec, lambda k: k.startswith("dpps_")
                    or k == "partpsp_clip", rec.get("steps"))
