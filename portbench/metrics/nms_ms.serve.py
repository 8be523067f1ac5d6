"""Median host NMS time of `entry.infer` (`timings["nms"]`), in ms, over
the untraced part of a traced run."""
from portbench import stats


def read(rec):
    t = [x["nms"] for x in rec.get("timings", []) if "nms" in x]
    return stats.median(t) * 1e3 if t else None
