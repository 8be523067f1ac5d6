"""K1 (the stereo cost volume, `ocrfdet::cost_volume`): the least time an
H100 needs for the traced calls (the frozen formula on each call's
inputs, worked out on the reference's identical calls) over their device
time (the device time of the kernels inside the op's range; CUDA events
around the kernel's launches where the profiler lost events), in %."""


def read(rec):
    b, t = rec.get("k1_bound_s"), rec.get("k1_device_s")
    if not b or not t:
        return None
    return 100.0 * b / t
