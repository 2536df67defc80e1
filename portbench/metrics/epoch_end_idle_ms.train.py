"""Device idle ms per epoch boundary: the time inside the program's
``epoch_end`` ranges (train/loop.py ``fit``: the epoch's losses stacked
and fetched, which waits for the epoch's work, the epoch hook, the
checkpoint and the preemption poll) in which no operation ran on the
device, over the number of those ranges."""

from portbench.common.spans import idle_within_s


def read(r):
    n = r.trace.range_count("epoch_end")
    return 1e3 * idle_within_s(r.trace, "epoch_end") / n if n else None
