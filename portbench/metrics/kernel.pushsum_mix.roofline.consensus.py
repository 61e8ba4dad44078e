"""``pushsum_mix``'s (the dense mix, W @ x) share of its roofline
(``yardstick.mix_bound_s``)."""
from portbench.harness.readers import roofline_pct
from portbench.harness.yardstick import mix_bound_s

UNIT, LAYER, MOVES = "%", "kernels", "consensus_round_ms"


def read(rec):
    if rec.get("schedule") != "dense":
        return None
    return roofline_pct(rec, ["mix_kernel", "mix_tile_kernel"],
                        lambda: mix_bound_s(rec["n"], rec["d_s"]))
