"""Median host time of `entry.infer`'s copy of the decoded boxes to the
host (`timings["wait"]`, the `ocrfdet.wait` span: it waits for the
device), in ms, over the untraced part of a traced run."""
from portbench import stats


def read(rec):
    t = [x["wait"] for x in rec.get("timings", []) if "wait" in x]
    return stats.median(t) * 1e3 if t else None
