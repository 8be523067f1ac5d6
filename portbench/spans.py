"""What the per-layer readers take from the program's own spans and
counters: `entry.infer`'s `timings` (its `spans`, each [name, parent,
start_s, end_s], and its `counts`) over the untraced part of a traced
run. A program without them gives nothing to read: None."""
from portbench import stats


def median_ms(rec, *names):
    """Median per request of the summed length of the spans called any
    of `names`, in ms."""
    per = [sum(e - s for n, _, s, e in t["spans"] if n in names)
           for t in rec.get("timings", []) if "spans" in t]
    return stats.median(per) * 1e3 if per else None


def median_count(rec, name):
    """Median per request of the counter `name`."""
    per = [t["counts"][name] for t in rec.get("timings", [])
           if name in t.get("counts", {})]
    return float(stats.median(per)) if per else None
