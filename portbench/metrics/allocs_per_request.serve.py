"""Median count of the caching allocator's allocations a request makes
while the forward and the decode are issued (`timings["counts"]
["allocs"]`; none off the card), over the untraced part of a traced
run."""
from portbench.spans import median_count


def read(rec):
    return median_count(rec, "allocs")
