"""``buffer_agg``'s share of its roofline, in %: the least time of the
window's Eq. 20 applies (one at (L, d) per aggregation and lane, bound by
HBM bytes) over the kernel's summed device time."""
from fedbench import arith
from fedbench.trace import kernel_seconds


def read(rec):
    tr, mix = rec["trace"], rec["mix"]
    if tr is None or mix["policy"] != "fedpsa":
        return None
    secs = kernel_seconds(tr, "buffer_agg")
    if secs <= 0.0:
        return None
    applies = sum(s["lanes"] * s["versions"] for s in rec["sims"])
    per = arith.bound_s(arith.buffer_agg_cost(mix["psa"]["buffer_size"],
                                              rec["cfg"]["d"]))
    return 100.0 * applies * per / secs
