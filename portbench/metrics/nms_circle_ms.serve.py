"""Median host time a request spends in circle NMS (the summed
`ocrfdet.nms.circle` spans: the Python centre-distance NMS of the tasks
that use it), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.nms.circle")
