"""The share of the view transformer's calls that replayed a captured
CUDA graph, in %: 100 x the median per request of the counters
`vt_replays` / `vt_calls` (`timings["counts"]`; no `vt_replays` counted
reads 0), over the untraced part of a traced run. A program without
the counters gives nothing to read."""
from portbench import stats


def read(rec):
    per = [100.0 * t["counts"].get("vt_replays", 0) / t["counts"]["vt_calls"]
           for t in rec.get("timings", [])
           if t.get("counts", {}).get("vt_calls")]
    return float(stats.median(per)) if per else None
