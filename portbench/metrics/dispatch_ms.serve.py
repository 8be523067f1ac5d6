"""Median host time of `entry.infer`'s forward and decode issued
(`timings["dispatch"]`), in ms, over the untraced part of a traced run."""
from portbench import stats


def read(rec):
    t = [x["dispatch"] for x in rec.get("timings", []) if "dispatch" in x]
    return stats.median(t) * 1e3 if t else None
