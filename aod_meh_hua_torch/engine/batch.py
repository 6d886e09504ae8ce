"""Inference batch container, on-device image normalisation and the
per-device anchor table.

Port of aod_meh_hua_tpu/engine/batch.py (`prepare_images` :16-37,
`ConstArg` :40-83, `Batch` :86-95, `EvalBatch` :98-104).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import _register_namedtuple


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (in `dtype`)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def prepare_images(images: torch.Tensor, img_shapes: torch.Tensor, cfg) -> torch.Tensor:
    """On-device normalisation of uint8 canvases.

    float32 batches pass through. uint8 batches [B, H, W, 3] are flipped
    BGR -> RGB, normalised with cfg.img_mean/img_std, and zeroed beyond
    each image's resized (h, w) — the host's Normalize -> Pad(0)
    (reference Config_RetinaNet.py:99-110).
    """
    if images.dtype != torch.uint8:
        return images
    x = images.float()
    if cfg.img_to_rgb:
        x = x.flip(-1)
    mean = torch.tensor(cfg.img_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.img_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    h, w = images.shape[1], images.shape[2]
    shapes = img_shapes.to(x.device)
    row_ok = torch.arange(h, device=x.device)[None, :, None, None] < shapes[:, 0, None, None, None]
    col_ok = torch.arange(w, device=x.device)[None, None, :, None] < shapes[:, 1, None, None, None]
    return x * (row_ok & col_ok)


class AnchorTable:
    """A host anchor table, uploaded once per device."""

    def __init__(self, host: np.ndarray):
        self.host = host
        self._cache: Dict[torch.device, torch.Tensor] = {}

    def get(self, device: torch.device) -> torch.Tensor:
        t = self._cache.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._cache[device] = t
        return t


class Batch(NamedTuple):
    """Training batch; numpy arrays or tensors."""

    images: object        # [B, H, W, 3] uint8, or normalised float32
    gt_boxes: object      # [B, G, 4] float32 in resized-image coordinates
    gt_labels: object     # [B, G] int
    gt_valid: object      # [B, G] bool (GTs padded to max_gt)
    anchor_valid: object  # [B, A] bool (pad-region mask, ops/anchors.anchor_valid_flags)
    img_shapes: object    # [B, 2] int32 (h, w) resized shape


class EvalBatch(NamedTuple):
    """Inference batch (eval mAP or pool scoring); numpy arrays or tensors."""

    images: object         # [B, H, W, 3] uint8 (or normalised float32)
    img_shapes: object     # [B, 2] resized (h, w)
    scale_factors: object  # [B, 4] (w_s, h_s, w_s, h_s) resize scales
    valid: object          # [B] bool — padding rows in the last pool batch


# a name under which torch.export serialises the type in a program's
# input and output specs (JAX's register_namedtuple_serialization)
_register_namedtuple(EvalBatch, serialized_type_name="aod_meh_hua_torch.EvalBatch")
