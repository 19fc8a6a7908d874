"""The whole lookup's share of the card's peak, in %: a lookup's least
time (``counts.lookup_bound``: the tables and the adds at the float32
rate, or the codes read once, whichever is longer) times the lookups of
the traced run's window, over the window's seconds."""


def read(data):
    if not data.get("lookup_bound_s") or not data.get("lookups"):
        return None
    return 100.0 * data["lookup_bound_s"] * data["lookups"] / data["window_s"]
