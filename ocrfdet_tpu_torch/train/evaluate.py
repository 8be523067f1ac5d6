"""Evaluation runner: eval forward + decode (device) -> Scale-NMS
(host) -> native metrics + devkit-compatible JSON (counterpart of
ocrfdet_tpu/train/evaluate.py on one device), and the eval model of a
run's EMA weights (counterpart of `train/optim.py::resolve_ema`).

Mirrors tools/test.py + CenterHead.get_bboxes + NuScenesDataset
.evaluate in the reference, with evaluation running from the EMA
weights (the reference evaluates epoch_N_ema.pth)."""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .. import entry
from ..config import OcRFDetConfig
from ..core.coder import decode_all_tasks
from ..core.eval_metrics import DetectionEvaluator
from ..core.nusc_format import boxes_to_nusc_sample, write_results_json
from ..models.detector import OcRFDet
from ..ops.nms import multi_task_nms
from .step import TrainState
from .trainer import device_batch


def ema_detector(cfg: OcRFDetConfig, source: Union[TrainState, Mapping],
                 device=None) -> OcRFDet:
    """An eval-mode `OcRFDet(cfg)` (no render heads) on `device` whose
    parameters and BatchNorm statistics are the EMA of `source`, a
    `TrainState` or a checkpoint (`TrainState.state_dict()`). The EMA
    holds the training model's keys, render heads included; a key of the
    eval model that it lacks raises. For GeoEnhDet the eval model is the
    student alone: eval never runs the teacher or the aligner, and the
    EMA holds no copy of the frozen teacher. (`num_batches_tracked`,
    which eval mode does not read, stays 0.)"""
    device = entry.resolve_device(device)
    if isinstance(source, TrainState):
        source = source.state_dict()
    ema = dict(source["ema_params"])
    ema.update(source["ema_stats"])
    model = OcRFDet(cfg)     # without GeoEnhDet's teacher and aligner
    sd = model.state_dict()
    missing = [k for k in sd
               if k not in ema and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the EMA lacks {len(missing)} keys of the eval "
                       f"model: {missing[:8]}")
    model.load_state_dict({k: ema.get(k, v) for k, v in sd.items()},
                          strict=True)
    return model.eval().to(device)


def raw_detector(cfg: OcRFDetConfig, state: TrainState) -> OcRFDet:
    """An eval-mode `OcRFDet(cfg)` (no render heads; for GeoEnhDet, no
    teacher or aligner) on the training model's device holding its raw
    parameters and BatchNorm statistics (a short run's EMA has barely
    moved)."""
    model = OcRFDet(cfg)
    trained = state.model.state_dict()
    model.load_state_dict({k: trained[k] for k in model.state_dict()},
                          strict=True)
    return model.eval().to(next(state.model.parameters()).device)


@torch.inference_mode()
def eval_forward(cfg: OcRFDetConfig, model: OcRFDet,
                 batch: Dict) -> List[Dict[str, np.ndarray]]:
    """The forward and decode of one batch on the model's device; the
    decoded boxes of each task as numpy arrays on the host."""
    preds, _ = model(batch)
    decoded = decode_all_tasks(preds, cfg.head, cfg.grid)
    return [{k: v.cpu().numpy() for k, v in d._asdict().items()}
            for d in decoded]


def run_eval(cfg: OcRFDetConfig, model: OcRFDet, loader,
             out_json: Optional[str] = None,
             max_batches: Optional[int] = None,
             token_to_pose: Optional[dict] = None,
             with_prev: float = 1.0, mesh=None) -> Dict[str, float]:
    """Evaluate `model` (eval mode, on its device) over `loader.epoch(0)`.

    token_to_pose maps sample_token -> the key CAM_FRONT info dict
    (ego2global_* fields) for global-frame JSON output; identity pose
    is used when absent (native metrics are pose-independent).

    With `mesh` (`parallel/mesh.py`, the multi-GPU-test analog), every
    rank runs this and `loader` yields the rows of each batch of the
    rank's data index (`Loader(process_index=d, process_count=data)`);
    the model runs on the mesh's space axis, the data ranks' evaluators
    and result JSON are gathered and merged (`parallel/multihost.py`),
    every rank returns the metrics of all the samples, and rank 0
    writes the JSON."""
    device = next(model.parameters()).device
    if mesh is not None:
        model.set_space(mesh.space_axis)
    evaluator = DetectionEvaluator(cfg.class_names)
    results_json = {}
    batches = loader.epoch(0)
    try:
        for bi, batch in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            decoded = eval_forward(cfg, model, device_batch(
                batch, with_prev, 0.0, device))
            B = batch["imgs"].shape[0]
            for b in range(B):
                task_results = [
                    {k: v[b] for k, v in d.items()} for d in decoded]
                det = multi_task_nms(task_results, cfg.head)
                gt_boxes = batch["gt_boxes"][b]
                gt_labels = batch["gt_labels"][b]
                # evaluator compares gravity-centred z; det boxes are
                # bottom-centred after multi_task_nms
                det_g = det["boxes"].copy()
                if len(det_g):
                    det_g[:, 2] += det_g[:, 5] * 0.5
                evaluator.add_sample(det_g, det["scores"], det["labels"],
                                     gt_boxes, gt_labels,
                                     token=str(batch["sample_token"][b]))
                if out_json is not None:
                    tok = batch["sample_token"][b]
                    pose = (token_to_pose or {}).get(tok, dict(
                        ego2global_rotation=[1, 0, 0, 0],
                        ego2global_translation=[0, 0, 0]))
                    results_json[tok] = [
                        dict(r, sample_token=tok) for r in
                        boxes_to_nusc_sample(
                            det["boxes"], det["scores"], det["labels"],
                            cfg.class_names, pose)]
    finally:
        batches.close()
    if mesh is not None:        # every space rank merges its data group
        from ..parallel.multihost import merge_eval_results
        evaluator, results_json = merge_eval_results(evaluator, results_json,
                                                     mesh.group)
    metrics = evaluator.evaluate()
    if out_json is not None and (mesh is None or mesh.rank == 0):
        write_results_json(results_json, out_json)
    return metrics
