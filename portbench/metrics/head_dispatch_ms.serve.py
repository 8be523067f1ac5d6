"""Median host time a request spends issuing the CenterHead (the
`ocrfdet.head` span), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.head")
