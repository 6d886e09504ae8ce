"""Evaluation: the detection step on the device and the per-class results
on the host, from which utils/voc_eval.py computes VOC mAP.

Port of aod_meh_hua_tpu/engine/eval.py (`make_eval_step` :28-69,
`detections_to_per_class` :72-97), which mirrors the reference's
apis/test.py:138-195 (single_gpu_test, rescale=True) -> get_bboxes with
NMS -> bbox2result (mmdet/core/bbox/transforms.py:99). The step runs
forward -> score transform -> top-k -> decode -> rescale -> fixed-shape
NMS under torch.no_grad(); only the [B, max_per_img] detections go to
the host.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..ops.nms import batched_multiclass_nms
from ..utils.config import RetinaNetConfig
from ..utils.device import resolve_device
from .batch import EvalBatch, as_tensor, prepare_images
from .postprocess import make_candidate_selector


class EvalStep(torch.nn.Module):
    """make_eval_step's body as a module: forward(batch: EvalBatch of
    tensors on the model's device) -> NMSResult ([B, max_per_img] fields,
    boxes in original-image coordinates); (NMSResult, unc [B, K]) with
    `with_uncertainty`, unc the Shannon entropy of each survivor anchor's
    foreground scores (the reference's per-detection uncertainty,
    L_anchor_head.py:473-481), 0 in empty slots. The anchor table is a
    buffer.

    torch.export traces it at a fixed batch (tools/deployment/
    export_model.py): on float32 canvases normalised on the host, as the
    JAX package's artifacts take them, and with `device_loop`, which
    runs the NMS fixpoint as a device-side while_loop (ops/nms.py) where
    the eager step checks for convergence on the host. Both give the same
    detections. The caller runs it under torch.no_grad().
    """

    def __init__(self, model, cfg: RetinaNetConfig, with_uncertainty: bool = False,
                 device_loop: bool = False):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.with_uncertainty = with_uncertainty
        self.device_loop = device_loop
        self.select, anchors_host = make_candidate_selector(cfg)
        device = next(model.parameters()).device
        self.register_buffer("anchors", torch.from_numpy(anchors_host).to(device))

    def candidates(self, batch: EvalBatch):
        """The batch's pre-NMS candidates (postprocess.Candidates), boxes
        in the canvas frame: the forward, the score transform, top-k and
        decode. The TTA step (engine/tta.py) maps these back itself."""
        images = prepare_images(batch.images, batch.img_shapes, self.cfg)
        cls_scores, bbox_preds, _ = self.model(images, with_meh=False)
        return self.select(self.anchors, cls_scores, bbox_preds, None, batch.img_shapes)

    def forward(self, batch: EvalBatch):
        cfg, t = self.cfg, self.cfg.test
        cand = self.candidates(batch)
        # rescale to original image coordinates before NMS (Lambda_L2.py:307-308)
        boxes = cand.boxes / batch.scale_factors[:, None, :]
        fg_scores = cand.scores[..., :cfg.num_fg_classes]
        dets = batched_multiclass_nms(boxes, fg_scores, t.score_thr, t.nms_iou_thr,
                                      t.max_per_img, t.pre_nms_cands, self.device_loop)
        if not self.with_uncertainty:
            return dets
        h = -(fg_scores * torch.log(fg_scores.clamp(min=1e-38))).sum(dim=-1)  # [B, A]
        det_unc = torch.gather(h, 1, dets.anchor_idx)
        return dets, torch.where(dets.valid, det_unc, torch.zeros_like(det_unc))


def batch_on(batch: EvalBatch, device) -> EvalBatch:
    """An EvalBatch of numpy arrays or tensors as tensors on `device`
    (scale factors float32)."""
    return EvalBatch(as_tensor(batch.images, device), as_tensor(batch.img_shapes, device),
                     as_tensor(batch.scale_factors, device, torch.float32),
                     as_tensor(batch.valid, device))


def make_eval_step(model, cfg: RetinaNetConfig, with_uncertainty: bool = False,
                   device="cuda") -> Callable:
    """Returns step(batch: EvalBatch) -> NMSResult ([B, max_per_img]
    fields, boxes in original-image coordinates) on `device`, where
    `model` lives: EvalStep under torch.no_grad(), on a batch of numpy
    arrays or tensors. with_uncertainty: step returns (NMSResult, unc
    [B, K]) (EvalStep)."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    module = EvalStep(model, cfg, with_uncertainty)

    @torch.no_grad()
    def step(batch: EvalBatch):
        return module(batch_on(batch, dev))

    return step


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def detections_to_per_class(dets, num_classes: int, batch_valid=None,
                            unc=None) -> List[List[np.ndarray]]:
    """NMSResult -> the reference's bbox2result format: per image, per
    class float32 arrays [k, 5] (x1, y1, x2, y2, score); [k, 6] with the
    per-detection uncertainty appended when `unc` [B, K] is given (the
    bbox2tupleresult format). Rows where `batch_valid` is False are
    dropped."""
    boxes, scores, labels, valid = (_host(a) for a in (dets.boxes, dets.scores,
                                                       dets.labels, dets.valid))
    unc = None if unc is None else _host(unc)
    out = []
    for i in range(boxes.shape[0]):
        if batch_valid is not None and not batch_valid[i]:
            continue
        per_cls = []
        for c in range(num_classes):
            m = valid[i] & (labels[i] == c)
            cols = [boxes[i][m], scores[i][m][:, None]]
            if unc is not None:
                cols.append(unc[i][m][:, None])
            per_cls.append(np.concatenate(cols, axis=1).astype(np.float32))
        out.append(per_cls)
    return out
