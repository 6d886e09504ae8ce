"""SSD train-time augmentations (host numpy).

A copy of aod_meh_hua_tpu/data/ssd_augment.py (`photo_metric_distortion`
:29-61, `expand` :64-88, `min_iou_random_crop` :91-137,
`ssd_train_augment` :140-149), which mirrors the reference's
mmdet/datasets/pipelines/transforms.py:900 (PhotoMetricDistortion), :1006
(Expand) and :1098 (MinIoURandomCrop). Every draw comes from the
RandomState in the JAX package's order; none depends on pixel values, so
the two streams stay in lockstep.

The JAX package converts BGR <-> HSV with cv2.cvtColor on float32; the
machine with the card has no OpenCV, so `bgr_to_hsv` and `hsv_to_bgr`
follow OpenCV's float vector path (color_hsv: H in degrees in [0, 360),
S in [0, 1], V on the input's scale, FLT_EPSILON in the divisions, its
fused multiply-adds). The randomly initialised SSD is sensitive to the
last bit of its input (L2Norm lifts a near-zero conv4_3 vector to norm
20), so the conversions aim at bit-equality; tests/test_torch_ssd_data.py
holds them to cv2.

All operate on float32 BGR images + 0-based boxes, before Resize.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# HSV2RGB's sector -> the (b, g, r) entries of tab = (v, v(1-s), v(1-sh), v(1-s(1-h)))
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c with one rounding (a fused multiply-add): the
    product of two float32 is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# OpenCV's color conversions run 8 float lanes at a time along a row; the
# last (width % 8) pixels of each row take its scalar path
_LANES = 8


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2HSV) for float32 BGR [..., W, 3],
    as OpenCV computes it. Vector lanes: h = fma(delta, 60 / (diff +
    eps), offset), the offset 360 where r is the max and g < b, 120 where
    g is, 240 where b is. A row's scalar tail: h = delta * k, plus 120 or
    240 fused, then + 360 where negative."""
    img = img.astype(np.float32, copy=False)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = np.float32(60) / (diff + _FLT_EPSILON)
    r_max, g_max = r == v, g == v
    delta = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    offset = np.where(r_max, np.float32(0), np.where(g_max, np.float32(120), np.float32(240)))
    h = fma32(delta, k, np.where(r_max & (g < b), np.float32(360), offset))
    w = img.shape[-2]
    tail = w - w % _LANES
    if tail < w:
        ht = np.where(r_max, delta * k, fma32(delta, k, offset))[..., tail:]
        h[..., tail:] = np.where(ht < 0, ht + np.float32(360), ht)
    return np.stack([h, s, v], axis=-1)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR) for float32 HSV (H in
    degrees), as OpenCV's vector path computes it: sector = trunc(h / 60)
    mod 6, and the 1 - s*h terms fused."""
    hsv = hsv.astype(np.float32, copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    one = np.float32(1)
    h = h * np.float32(6.0 / 360.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * np.float32(1.0 / 6.0)) * np.float32(6)).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * fma32(-s, h, one), v * fma32(-s, one - h, one)],
                   axis=-1)
    return np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)


def photo_metric_distortion(
    img: np.ndarray,
    rng: np.random.RandomState,
    brightness_delta: float = 32,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18,
) -> np.ndarray:
    """img: float32 BGR."""
    img = img.astype(np.float32)
    if rng.randint(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        img = img * rng.uniform(*contrast_range)
    hsv = bgr_to_hsv(img)
    if rng.randint(2):
        hsv[..., 1] = hsv[..., 1] * rng.uniform(*saturation_range)
    if rng.randint(2):
        hsv[..., 0] = hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = hsv_to_bgr(hsv)
    if mode == 0 and rng.randint(2):
        img = img * rng.uniform(*contrast_range)
    if rng.randint(2):
        img = img[..., rng.permutation(3)]
    return img


def expand(
    img: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.RandomState,
    mean: Tuple[float, ...] = (123.675, 116.28, 103.53),
    to_rgb: bool = True,
    ratio_range: Tuple[float, float] = (1, 4),
) -> Tuple[np.ndarray, np.ndarray]:
    """Place the BGR image on a mean-filled larger canvas (1/2 prob)."""
    if rng.randint(2):
        return img, boxes
    h, w = img.shape[:2]
    ratio = rng.uniform(*ratio_range)
    fill = np.asarray(mean, np.float32)
    if to_rgb:  # mean given in RGB order, canvas is BGR
        fill = fill[::-1]
    canvas = np.empty((int(h * ratio), int(w * ratio), 3), img.dtype)
    canvas[...] = fill
    left = int(rng.uniform(0, w * ratio - w))
    top = int(rng.uniform(0, h * ratio - h))
    canvas[top:top + h, left:left + w] = img
    out_boxes = boxes + np.array([left, top, left, top], boxes.dtype) if len(boxes) else boxes
    return canvas, out_boxes


def min_iou_random_crop(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    rng: np.random.RandomState,
    min_ious: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7, 0.9),
    min_crop_size: float = 0.3,
):
    """Returns (img, boxes, labels); may be unchanged (mode 1)."""
    h, w = img.shape[:2]
    sample_modes = (1, *min_ious, 0)
    while True:
        mode = sample_modes[rng.randint(len(sample_modes))]
        if mode == 1:
            return img, boxes, labels
        min_iou = mode
        for _ in range(50):
            new_w = rng.uniform(min_crop_size * w, w)
            new_h = rng.uniform(min_crop_size * h, h)
            if new_h / new_w < 0.5 or new_h / new_w > 2:
                continue
            left = rng.uniform(w - new_w)
            top = rng.uniform(h - new_h)
            patch = np.array([int(left), int(top), int(left + new_w), int(top + new_h)])
            if patch[2] == patch[0] or patch[3] == patch[1]:
                continue
            if len(boxes):
                # IoU between the patch and every box must clear min_iou
                lt = np.maximum(patch[:2], boxes[:, :2])
                rb = np.minimum(patch[2:], boxes[:, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                a_p = (patch[2] - patch[0]) * (patch[3] - patch[1])
                a_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                iou = inter / np.maximum(a_p + a_b - inter, 1e-6)
                if iou.min() < min_iou:
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                mask = (
                    (centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                    & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3])
                )
                if not mask.any():
                    continue
                new_boxes = boxes[mask].copy()
                new_boxes[:, :2] = np.maximum(new_boxes[:, :2], patch[:2])
                new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], patch[2:])
                new_boxes -= np.tile(patch[:2], 2)
                new_labels = labels[mask]
            else:
                new_boxes, new_labels = boxes, labels
            cropped = img[patch[1]:patch[3], patch[0]:patch[2]]
            return cropped, new_boxes, new_labels


def ssd_train_augment(img, ann, rng, mean=(123.675, 116.28, 103.53), to_rgb=True):
    """The full SSD train augmentation chain before Resize
    (Config_SSD.py:88-106). img: uint8/float BGR; ann: bboxes/labels."""
    img = img.astype(np.float32)
    boxes = ann["bboxes"].astype(np.float32)
    labels = ann["labels"]
    img = photo_metric_distortion(img, rng)
    img, boxes = expand(img, boxes, rng, mean=mean, to_rgb=to_rgb)
    img, boxes, labels = min_iou_random_crop(img, boxes, labels, rng)
    return img, {"bboxes": boxes, "labels": labels}
