"""The share of the tasks' NMS calls that scanned suppression rows built
on the card, in %: 100 x the median per request of the counters
`nms_rows_tasks` / `nms_tasks` (`timings["counts"]`; no `nms_rows_tasks`
counted reads 0), over the untraced part of a traced run. A program
without the counters gives nothing to read."""
from portbench import stats


def read(rec):
    per = [100.0 * t["counts"].get("nms_rows_tasks", 0)
           / t["counts"]["nms_tasks"]
           for t in rec.get("timings", [])
           if t.get("counts", {}).get("nms_tasks")]
    return float(stats.median(per)) if per else None
