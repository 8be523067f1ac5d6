"""The reference's FLOPs a sample (FlopCounterMode on its products and
convolutions plus the kernels' frozen formulas) times the samples
answered in the untraced part of a traced run, over its wall time, as a
share of one H100's 989 TFLOP/s (bf16 dense), in %."""
from portbench import work


def read(rec):
    f, n, s = (rec.get(k) for k in ("ref_flops_per_sample",
                                   "samples_untraced", "wall_untraced"))
    if not f or not n or not s:
        return None
    return 100.0 * f * n / s / work.H100_BF16_FLOP_PER_S
