"""PASCAL VOC mAP evaluation (host-side numpy).

A copy of aod_meh_hua_tpu/utils/voc_eval.py, which is numpy only; the
port keeps its own because it imports nothing of the JAX package.
tests/test_torch_eval.py holds the two copies to the same mAP, bit for
bit. It mirrors the reference's mmdet/core/evaluation/mean_ap.py:268
(eval_map), :154 (tpfp_default), :12 (average_precision, 'area' and
'11points'), mmdet/core/evaluation/bbox_overlaps.py (numpy IoU, no +1)
and mmdet/datasets/voc.py:27-94 (voc07 -> 11-point AP).

Fork quirks reproduced deliberately (they change the number):
* recalls / precisions are ceiled to 2 decimals before AP
  (mean_ap.py:364-365), and the 11-point mode ceils each sampled
  precision again (mean_ap.py:50).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def np_bbox_overlaps(b1: np.ndarray, b2: np.ndarray, mode: str = "iou", eps: float = 1e-6) -> np.ndarray:
    """IoU/IoF between b1 [N, 4] and b2 [M, 4] -> [N, M]."""
    b1 = b1.astype(np.float32)
    b2 = b2.astype(np.float32)
    if b1.shape[0] * b2.shape[0] == 0:
        return np.zeros((b1.shape[0], b2.shape[0]), dtype=np.float32)
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter if mode == "iou" else a1[:, None] + 0 * a2[None, :]
    return inter / np.maximum(union, eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray, mode: str = "area") -> float:
    if mode == "area":
        mrec = np.concatenate(([0.0], recalls, [1.0]))
        mpre = np.concatenate(([0.0], precisions, [0.0]))
        for i in range(mpre.size - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        ind = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[ind + 1] - mrec[ind]) * mpre[ind + 1]))
    if mode == "11points":
        ap = 0.0
        for thr in np.arange(0, 1 + 1e-3, 0.1):
            precs = precisions[recalls >= thr]
            prec = precs.max() if precs.size > 0 else 0.0
            ap += math.ceil(prec * 100) / 100  # fork quirk
        return ap / 11
    raise ValueError(mode)


def tpfp_default(
    det_bboxes: np.ndarray,
    gt_bboxes: np.ndarray,
    gt_bboxes_ignore: Optional[np.ndarray] = None,
    iou_thr: float = 0.5,
):
    """Greedy TP/FP marking per image (mean_ap.py:154). dets are [m, 5]."""
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.empty((0, 4), dtype=np.float32)
    gt_ignore = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], dtype=bool), np.ones(gt_bboxes_ignore.shape[0], dtype=bool))
    )
    all_gt = np.vstack((gt_bboxes, gt_bboxes_ignore))
    num_dets = det_bboxes.shape[0]
    tp = np.zeros(num_dets, dtype=np.float32)
    fp = np.zeros(num_dets, dtype=np.float32)
    if all_gt.shape[0] == 0:
        fp[...] = 1
        return tp, fp
    ious = np_bbox_overlaps(det_bboxes[:, :4], all_gt)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    gt_covered = np.zeros(all_gt.shape[0], dtype=bool)
    for i in sort_inds:
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if not gt_ignore[matched]:
                if not gt_covered[matched]:
                    gt_covered[matched] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
            # matched an ignored gt: neither tp nor fp
        else:
            fp[i] = 1
    return tp, fp


def eval_map(
    det_results: List[List[np.ndarray]],
    annotations: List[Dict[str, np.ndarray]],
    iou_thr: float = 0.5,
    mode: str = "11points",
) -> Dict:
    """VOC mAP. det_results: per image, per class [m, 5] arrays.

    annotations: per image dicts with 'bboxes' [n,4], 'labels' [n],
    optional 'bboxes_ignore'/'labels_ignore'. mode='11points' corresponds
    to the reference's dataset='voc07'.
    """
    assert len(det_results) == len(annotations)
    num_classes = len(det_results[0])
    per_class = []
    for c in range(num_classes):
        cls_dets = [img[c] for img in det_results]
        cls_gts, cls_gts_ig = [], []
        for ann in annotations:
            mask = ann["labels"] == c
            cls_gts.append(ann["bboxes"][mask])
            if ann.get("labels_ignore") is not None:
                mi = ann["labels_ignore"] == c
                cls_gts_ig.append(ann["bboxes_ignore"][mi])
            else:
                cls_gts_ig.append(np.empty((0, 4), dtype=np.float32))

        tpfp = [tpfp_default(d, g, gi, iou_thr) for d, g, gi in zip(cls_dets, cls_gts, cls_gts_ig)]
        tp = np.hstack([t for t, _ in tpfp])
        fp = np.hstack([f for _, f in tpfp])
        num_gts = int(sum(g.shape[0] for g in cls_gts))
        all_dets = np.vstack(cls_dets) if cls_dets else np.empty((0, 5), np.float32)
        sort_inds = np.argsort(-all_dets[:, -1]) if all_dets.size else np.array([], dtype=int)
        tp = np.cumsum(tp[sort_inds])
        fp = np.cumsum(fp[sort_inds])
        eps = np.finfo(np.float32).eps
        # fork quirk: 2-decimal ceil on recall/precision
        recalls = np.ceil(tp / max(num_gts, eps) * 100) / 100
        precisions = np.ceil(tp / np.maximum(tp + fp, eps) * 100) / 100
        ap = average_precision(recalls, precisions, mode)
        per_class.append({"num_gts": num_gts, "num_dets": int(all_dets.shape[0]), "ap": ap})

    aps = [r["ap"] for r in per_class if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    return {"mAP": mean_ap, "per_class": per_class}
