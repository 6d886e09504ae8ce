"""Flip-consistency self-supervision (the SelfSSL_* detector family).

Port of aod_meh_hua_tpu/engine/self_ssl.py:32-83, which mirrors the
reference's SelfSSL_single_stage.py:55-69 (a second forward on the
horizontally flipped image) and old_codes/SelfSSL_EDL_RetinaSoft.py:
197-214 (per level, the flipped image's score map flipped back along W;
loss_Self_cls = sum((softmax(cls) - softmax(clsFlip))^2); the reference
discards its reg-consistency term and zeroes loss_bbox). As in the JAX
package it is a loss term, not a detector subclass.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def flip_level_maps_w(flat: torch.Tensor, featmap_sizes: Sequence[Tuple[int, int]],
                      num_anchors: int) -> torch.Tensor:
    """Flip a flattened [B, A, C] multi-level head output along each
    level's W axis (torch.flip(score_map, [3]) on the reference's
    [B, C, H, W] maps), keeping the (H, W, anchor)-major order in which
    models/detector.py flatten_levels emits the anchors."""
    b, _, c = flat.shape
    out, off = [], 0
    for (h, w) in featmap_sizes:
        n = h * w * num_anchors
        lvl = flat[:, off:off + n].reshape(b, h, w, num_anchors, c)
        out.append(lvl.flip(2).reshape(b, n, c))
        off += n
    return torch.cat(out, dim=1)


def self_ssl_consistency_loss(cls_scores: torch.Tensor, cls_scores_flip: torch.Tensor,
                              featmap_sizes: Sequence[Tuple[int, int]],
                              num_anchors: int) -> torch.Tensor:
    """loss_Self_cls: the sum over every (anchor, class) of the squared
    difference between the softmax of the image's scores and that of the
    flipped image's scores mirrored back (SelfSSL_EDL_RetinaSoft.py:
    203-206; the maxconf weighting of :205 is commented out there)."""
    back = flip_level_maps_w(cls_scores_flip, featmap_sizes, num_anchors)
    p = torch.softmax(cls_scores, dim=-1)
    q = torch.softmax(back, dim=-1)
    return torch.square(p - q).sum()


def make_self_ssl_loss_fn(model: torch.nn.Module, cfg) -> Callable:
    """loss_fn(images) -> the scalar flip-consistency loss of `model`, the
    SelfSSL routing loss_cls := loss_Self_cls, loss_bbox := 0
    (SelfSSL_EDL_RetinaSoft.py:212-214). `images` are normalised
    [B, H, W, 3] canvases, the layout the model takes; the flipped branch
    flips W, their dim 2 (dim 3 of the NCHW tensor the model runs), as
    the JAX loss flips axis 2 of its NHWC images. The JAX loss_fn takes
    (variables, images); the module carries its weights here."""
    feats = cfg.featmap_sizes()
    num_anchors = cfg.anchor.num_anchors

    def loss_fn(images: torch.Tensor) -> torch.Tensor:
        cls = model(images, with_meh=False)[0]
        cls_f = model(images.flip(2), with_meh=False)[0]
        return self_ssl_consistency_loss(cls, cls_f, feats, num_anchors)

    return loss_fn
