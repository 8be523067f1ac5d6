"""Share of the traced window in which no kernel ran on the device (the
union of the trace's kernel intervals), in %."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
