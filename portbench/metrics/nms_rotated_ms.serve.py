"""Median host time a request spends in rotated NMS (the summed
`ocrfdet.nms.rotated` spans: the C++ rotated-IoU NMS of the other
tasks), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.nms.rotated")
