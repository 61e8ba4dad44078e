"""The share of the traced window in which no operation ran on the card."""
from portbench.harness.readers import idle_pct

UNIT, LAYER, MOVES = "%", "device", "train_tokens_per_s"


def read(rec):
    return idle_pct(rec)
