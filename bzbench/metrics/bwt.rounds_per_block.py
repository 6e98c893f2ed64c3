"""bwt.rounds_per_block: doubling rounds a BWT call, as the card counted
them (``suffix_sort.ROUNDS_RUN`` over ``LAUNCHES``, over the window)."""


def read(run):
    c = run.counters
    if not c.get("launches"):
        return None
    return c["rounds"] / c["launches"]
