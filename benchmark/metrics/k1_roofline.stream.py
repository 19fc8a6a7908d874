"""K1's share of its roofline, in %: its least time a launch
(``counts.k1_bound``, from the judged batches' crops) over its mean device
time a launch in the profiled slice (kernel ``warp_align_kernel``)."""

from benchmark.trace import kernel_time


def read(data):
    tr, bound = data.get("trace"), data.get("k1_bound_s")
    if tr is None or not bound:
        return None
    secs, n = kernel_time(tr, "warp_align_kernel")
    if not n or secs <= 0:
        return None
    return 100.0 * bound * n / secs
