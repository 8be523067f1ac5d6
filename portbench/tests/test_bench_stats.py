"""The benchmark's arithmetic on known numbers."""
import pytest
import torch

from portbench import stats


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == 5
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.gaps([], 0, 1) == [(0, 1)]
    assert stats.union_length([]) == 0


def test_rate_and_spread():
    assert stats.rate(330, 30.0) == 11.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    # quartiles of 1..8 by Python's exclusive method: 2.25 and 6.75
    assert stats.spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx(4.5 / 4.5)
    assert stats.spread([10.0] * 6) == 0.0


def test_a_map_all_but_zero_sets_no_scale_of_its_own():
    from portbench import check
    ref = [{"a": torch.full((1, 2, 2, 1), 2.0),
            "b": torch.full((1, 2, 2, 1), 4.0),
            "vel": torch.full((1, 2, 2, 1), 1e-3)}]
    prog = [{"a": ref[0]["a"] + 0.02, "b": ref[0]["b"].clone(),
             "vel": ref[0]["vel"] + 1e-3}]
    # vel's gap 1e-3 over the median map's 2.0, not over its own 1e-3
    assert check.heads_gap(prog, ref) == pytest.approx(0.01)
