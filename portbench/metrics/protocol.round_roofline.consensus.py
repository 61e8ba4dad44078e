"""A DPPS round's share of its floor: the least time any implementation
could take (``yardstick.round_floor_s``: the (N, d_s) state read and
written once, W's entries read once) over the traced window's time a
round."""
from portbench.harness.yardstick import round_floor_s

UNIT, LAYER, MOVES = "%", "protocol", "consensus_round_ms"


def read(rec):
    if not rec.get("window_s") or not rec.get("rounds"):
        return None
    per_round = rec["window_s"] / rec["rounds"]
    return 100.0 * round_floor_s(rec["n"], rec["d_s"],
                                 rec["w_entries"]) / per_round
