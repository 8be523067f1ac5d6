"""Median host time a request spends issuing the BEV encoder (the summed
`ocrfdet.bev` spans: each frame's pre-process, then the backbone and
neck), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.bev")
