"""Median host time a request spends issuing the view transformer and
its stereo input (the summed `ocrfdet.stereo` and `ocrfdet.vt` spans:
K1, the depth net, the splat, the HT pool, the voxel lift, the NeRF
alphas, the voxel sampling, HOA and the fusion), in ms, over the
untraced part of a traced run."""
from portbench.spans import median_ms


def read(rec):
    return median_ms(rec, "ocrfdet.stereo", "ocrfdet.vt")
