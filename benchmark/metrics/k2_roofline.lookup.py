"""K2's share of its roofline, in %: its least time for one (Q, G)
scoring (``counts.k2_bound``) over its mean device time a launch in the
profiled slice (kernel ``pq_adc_kernel``)."""

from benchmark.trace import kernel_time


def read(data):
    tr, bound = data.get("trace"), data.get("k2_bound_s")
    if tr is None or not bound:
        return None
    secs, n = kernel_time(tr, "pq_adc_kernel")
    if not n or secs <= 0:
        return None
    return 100.0 * bound * n / secs
