"""``grouped_matmul``'s share of its roofline, in %: the least time of the
window's calls (each call's bound by its cost) over the kernel's summed
device time, both passes (``grouped_matmul_kernel`` and the split-K
reduction ``splitk_reduce``). The calls and their costs are the program's
tally of its launches while a profiler records
(``repro_torch.common.trace.kernel_tally``, from
``repro_torch.kernels.grouped_matmul.cost``, which the tests hold to
``cost`` below); a program without the tally reads nothing."""
from fedbench import arith
from fedbench.trace import kernel_seconds

# the device operations of one call
KERNELS = ("grouped_matmul", "splitk_reduce")


def cost(G: int, M: int, K: int, N: int) -> dict:
    """One call ``(G, M, K) @ (G, K, N)``: ``2 G M N K`` flops, the float32
    operands read and the output written once."""
    return {"flops": 2.0 * G * M * N * K,
            "nbytes": 4.0 * G * (M * K + K * N + M * N)}


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = sum(kernel_seconds(tr, k) for k in KERNELS)
    if secs <= 0.0:
        return None
    try:
        from repro_torch.common.trace import kernel_tally
    except ImportError:
        return None
    bound = sum(n * arith.bound_s({"flops": f, "nbytes": b})
                for (name, f, b, _, _), n in kernel_tally().items()
                if name == "grouped_matmul")
    if bound <= 0.0:
        return None
    return 100.0 * bound / secs
