"""Multi-process helpers (counterpart of ocrfdet_tpu/parallel/multihost.py).

Each process loads only its slice of every global batch
(`Loader(process_index=, process_count=)`), and the eval results of
every process are gathered with `gather_objects` (the analog of mmdet's
collect_results_cpu) and merged by `merge_eval_results`. Outside a
process group everything is a no-op at one process, so the same code
path runs on one card.
"""
from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def gather_objects(obj: Any, group=None) -> List[Any]:
    """All-gather one picklable object per process of `group` (default:
    every process); the list ordered by rank, the same on every
    process."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def merge_eval_results(evaluator, results_json: dict, group=None):
    """Gather every process's evaluator and result JSON dict and merge
    them into process 0's view (returned on every process)."""
    parts = gather_objects((evaluator, results_json), group)
    merged_eval, merged_json = parts[0]
    for ev, rj in parts[1:]:
        merged_eval.merge(ev)
        merged_json.update(rj)
    return merged_eval, merged_json
