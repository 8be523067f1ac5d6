"""Median host time a request spends issuing the box decode (the
`ocrfdet.decode` span), in ms, over the untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.decode")
