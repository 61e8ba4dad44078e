"""``dpps_perturb``'s share of its roofline: its least time a launch
(``yardstick.perturb_bound_s``: the bytes it must move, over the
card's memory rate) over its measured device time a launch."""
from portbench.harness.readers import roofline_pct
from portbench.harness.yardstick import perturb_bound_s

UNIT, LAYER, MOVES = "%", "kernels", "consensus_round_ms"


def read(rec):
    return roofline_pct(rec, ["perturb_kernel"],
                        lambda: perturb_bound_s(rec["n"], rec["d_s"]))
