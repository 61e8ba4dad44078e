"""Device milliseconds a step in the two gradient passes (the program's
``partpsp_local_grads`` and ``partpsp_shared_grads`` phases)."""
from portbench.harness.readers import phase_ms

UNIT, LAYER, MOVES = "ms", "model", "train_tokens_per_s"


def read(rec):
    return phase_ms(rec, lambda k: k in ("partpsp_local_grads",
                                         "partpsp_shared_grads"),
                    rec.get("steps"))
