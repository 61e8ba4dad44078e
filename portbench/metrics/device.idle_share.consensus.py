"""The share of the traced window in which no operation ran on the card."""
from portbench.harness.readers import idle_pct

UNIT, LAYER, MOVES = "%", "device", "consensus_round_ms"


def read(rec):
    return idle_pct(rec)
