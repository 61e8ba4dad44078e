"""``spmm``'s (the padded-CSR mix) share of its roofline
(``yardstick.spmm_bound_s``)."""
from portbench.harness.readers import roofline_pct
from portbench.harness.yardstick import spmm_bound_s

UNIT, LAYER, MOVES = "%", "kernels", "consensus_round_ms"


def read(rec):
    if not rec.get("spmm_k"):
        return None
    return roofline_pct(rec, ["spmm_rows_kernel", "spmm_tiles_kernel"],
                        lambda: spmm_bound_s(rec["n"], rec["spmm_k"], rec["nnz"],
                                     rec["d_s"]))
