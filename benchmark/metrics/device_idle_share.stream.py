"""The device's idle share of the profiled slice, in %: 100 x (1 - the
union of its kernels', copies' and sets' intervals over the slice)."""


def read(data):
    tr = data.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
