"""Median host time a request spends issuing the image encoder (the
summed `ocrfdet.encoder` spans: ResNet and FPN of each frame, the stem
of the oldest), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.encoder")
