"""The whole training step's share of the card's peak: the model FLOPs of
the window's steps (3 x the forward's matrix products and causal
attention's lower triangle; nothing recomputed) over the window's
seconds, over 495 TFLOP/s, dense TF32, the fastest rate at which the
card multiplies float32-stored operands."""
from portbench.harness.yardstick import TF32_OPS_PER_S

UNIT, LAYER, MOVES = "%", "front door", "train_tokens_per_s"


def read(rec):
    if not rec.get("window_s") or not rec.get("model_flops"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / TF32_OPS_PER_S
