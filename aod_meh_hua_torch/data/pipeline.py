"""Deterministic preprocessing into the static canvas.

A copy of aod_meh_hua_tpu/data/pipeline.py (`PipelineConfig` :29-57,
`load_image` :59-66, `rescale_size` :69-73, `prepare_sample` :76-140),
which mirrors the reference's Load -> Resize(keep_ratio) -> RandomFlip ->
Normalize -> Pad(/32) pipeline (Config_RetinaNet.py:101-125). The JAX
package decodes and resizes with OpenCV; the machine with the card has no
OpenCV, so here `load_image` calls data/jpeg.py and the resize is
`resize_linear_u8`, both bit-equal to the OpenCV calls they replace
(tests/test_torch_data.py). The SSD augment chain hands over float32
images, which `resize_linear_f32` resizes by OpenCV's float path
(tests/test_torch_ssd_data.py holds it to cv2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .jpeg import imread
from .ssd_augment import fma32


@dataclass(frozen=True)
class PipelineConfig:
    """canvas is the LANDSCAPE canvas (H, W); portrait images (original
    w/h <= 1) land on the transposed canvas, so batches are
    orientation-homogeneous and each step sees one static shape."""

    img_scale: Tuple[int, int] = (1000, 600)  # (long, short) edge bound
    canvas: Tuple[int, int] = (608, 1024)     # landscape (H, W)
    mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    to_rgb: bool = True
    flip_ratio: float = 0.5
    size_divisor: int = 32
    # keep_ratio=False (SSD): warp every image exactly to canvas
    keep_ratio: bool = True
    # ship uint8 canvases and normalize on the device
    # (engine/batch.py prepare_images)
    device_normalize: bool = False

    def canvas_for(self, orientation: str) -> Tuple[int, int]:
        h, w = self.canvas
        if not self.keep_ratio:
            return (h, w)
        return (h, w) if orientation == "landscape" else (w, h)


def load_image(path: str) -> np.ndarray:
    """Load a JPEG as uint8 BGR HWC (cv2.imread IMREAD_COLOR's result)."""
    return imread(path)


def rescale_size(w: int, h: int, img_scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.imrescale sizing: returns (new_w, new_h, scale_factor)."""
    long_edge, short_edge = max(img_scale), min(img_scale)
    sf = min(long_edge / max(h, w), short_edge / min(h, w))
    return int(w * sf + 0.5), int(h * sf + 0.5), sf


def _linear_coeffs(dst: int, src: int, clamp: bool):
    """Source index and 11-bit fixed-point weights per destination index,
    as OpenCV's resize computes them: fx = float((d + 0.5) * scale - 0.5)
    with scale = 1 / (dst / src), each weight rounded on its own."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low = s < 0
        s, f = np.where(low, 0, s), np.where(low, np.float32(0), f)
        high = s >= src - 1
        s, f = np.where(high, src - 1, s), np.where(high, np.float32(0), f)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, w0, w1


def resize_linear_u8(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """cv2.resize(img, (dst_w, dst_h), interpolation=cv2.INTER_LINEAR) for
    a uint8 HWC image, bit for bit: a horizontal pass in int32 with 11-bit
    weights (columns past the last source column weigh (2048, 0)), then
    OpenCV's vectorised vertical rounding, ((((R0 >> 4) * b0) >> 16) +
    (((R1 >> 4) * b1) >> 16) + 2) >> 2, saturated; the vertical weights
    are not clamped at the borders, only the source rows are."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8 images, got {img.dtype}")
    src_h, src_w = img.shape[:2]
    sx, a0, a1 = _linear_coeffs(dst_w, src_w, clamp=True)
    edge = sx + 1 >= src_w
    a0, a1 = np.where(edge, 2048, a0), np.where(edge, 0, a1)
    sx1 = np.minimum(sx + 1, src_w - 1)
    sy, b0, b1 = _linear_coeffs(dst_h, src_h, clamp=False)
    r0, r1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)
    s = img.astype(np.int32)
    tail = (None,) * (img.ndim - 2)
    horiz = s[:, sx] * a0[(None, slice(None)) + tail] + s[:, sx1] * a1[(None, slice(None)) + tail]
    b0, b1 = b0[(slice(None), None) + tail], b1[(slice(None), None) + tail]
    out = ((((horiz[r0] >> 4) * b0) >> 16) + (((horiz[r1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear_f32(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """cv2.resize(img, (dst_w, dst_h), interpolation=cv2.INTER_LINEAR) for
    a float32 HWC image, as OpenCV's float path computes it: per axis the
    source index floor(x) and the weight f = x - floor(x) of x = (d + 0.5)
    * scale - 0.5 in double, rounded to float; a horizontal pass
    fma(S1 - S0, f, S0) in which a column before the first or past the
    last source column takes that column alone; then the same vertical
    pass, whose weights are not clamped at the borders (only the source
    rows are)."""
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear_f32 takes float32 images, got {img.dtype}")
    src_h, src_w = img.shape[:2]
    sx_scale, sy_scale = 1.0 / (dst_w / src_w), 1.0 / (dst_h / src_h)

    def coeffs(dst, scale):
        x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
        s = np.floor(x)
        return s.astype(np.int64), (x - s).astype(np.float32)

    sx, fx = coeffs(dst_w, sx_scale)
    fx = np.where((sx < 0) | (sx >= src_w - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, src_w - 1)
    sx1 = np.minimum(sx + 1, src_w - 1)
    sy, fy = coeffs(dst_h, sy_scale)
    r0, r1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)
    tail = (None,) * (img.ndim - 2)
    s0 = img[:, sx]
    horiz = fma32(img[:, sx1] - s0, fx[(None, slice(None)) + tail], s0)
    return fma32(horiz[r1] - horiz[r0], fy[(slice(None), None) + tail], horiz[r0])


def prepare_sample(
    img: np.ndarray,
    ann: Optional[dict],
    cfg: PipelineConfig,
    rng: Optional[np.random.RandomState] = None,
    flip: Optional[bool] = None,
) -> dict:
    """One sample -> canvas image + transformed GT + shape metadata.

    `img` is uint8 BGR (the decoder's) or float32 BGR (the SSD augment
    chain's). Returns dict with: image [H, W, 3] float32 (canvas; uint8
    with device_normalize and a uint8 image), img_shape (h, w) resized, pad_shape (h, w)
    /32-padded, scale_factor [4], flipped bool, and (when ann given)
    gt_bboxes [n, 4] / gt_labels [n] in resized coords.
    """
    h0, w0 = img.shape[:2]
    orientation = "landscape" if w0 / h0 > 1 else "portrait"
    if cfg.keep_ratio:
        new_w, new_h, _ = rescale_size(w0, h0, cfg.img_scale)
    else:
        new_h, new_w = cfg.canvas  # exact warp
    resized = (resize_linear_u8 if img.dtype == np.uint8 else resize_linear_f32)(
        img, new_w, new_h)
    w_scale, h_scale = new_w / w0, new_h / h0
    scale_factor = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)

    if flip is None:
        flip = bool(rng is not None and cfg.flip_ratio > 0 and rng.rand() < cfg.flip_ratio)
    if flip:
        resized = resized[:, ::-1]

    ch, cw = cfg.canvas_for(orientation)
    if cfg.device_normalize and resized.dtype == np.uint8:
        # raw BGR uint8 canvas; to_rgb/normalize/pad-zeroing happen on
        # the device (cfg.img_mean/img_std/img_to_rgb must match). The
        # SSD augment chain's float images are normalised here.
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:new_h, :new_w] = resized
    else:
        img_f = resized.astype(np.float32)
        if cfg.to_rgb:
            img_f = img_f[..., ::-1]
        img_f = (img_f - np.asarray(cfg.mean, np.float32)) / np.asarray(cfg.std, np.float32)
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:new_h, :new_w] = img_f

    d = cfg.size_divisor
    pad_shape = (int(np.ceil(new_h / d)) * d, int(np.ceil(new_w / d)) * d)

    out = dict(
        image=canvas,
        img_shape=np.array([new_h, new_w], np.int32),
        pad_shape=np.array(pad_shape, np.int32),
        scale_factor=scale_factor,
        flipped=flip,
        orientation=orientation,
    )
    if ann is not None:
        boxes = ann["bboxes"] * scale_factor
        # clip to resized image extent (Resize bbox_clip_border=True)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, new_w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, new_h)
        if flip:
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = new_w - boxes[:, 2]
            boxes[:, 2] = new_w - x1
        out["gt_bboxes"] = boxes.astype(np.float32)
        out["gt_labels"] = ann["labels"].astype(np.int32)
    return out
