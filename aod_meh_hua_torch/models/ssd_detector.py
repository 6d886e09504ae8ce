"""MEH-SSD detector assembly (torch).

Port of aod_meh_hua_tpu/models/ssd_detector.py:24-69, which mirrors the
reference's mmdet/models/detectors/SSD_L_single_stage.py:11 (the
Config_SSD.py:24 assembly: SSDVGG -> SSDNeck -> MyLSSDHead); the lambda
branch reads detached features, as in the Retina family.

Module names are mmdet's (backbone.features.N, neck.l2_norm,
neck.extra_layers, bbox_head.*), so the reference's SSD .pth loads with
no renaming (models/reference_convert.py convert_reference_ssd).
Public layouts are the JAX package's: images [B, S, S, 3] in, flattened
f32 outputs [B, A, C+1], [B, A, 4] and [B, A] out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.config import SSDConfig
from ..utils.device import resolve_device
from .detector import SkipDefaultInit, flatten_levels
from .ssd_head import SSDMEHHead
from .ssd_neck import SSDNeck
from .vgg import SSDVGG

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class MEHSSD(nn.Module):
    def __init__(self, cfg: SSDConfig):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port's SSD runs float32 "
                "(ROADMAP Queue 1 item 16)")
        self.cfg = cfg
        self.backbone = SSDVGG(cfg.width_mult)
        self.neck = SSDNeck(self.backbone.out_channels, cfg.neck_out_channels,
                            cfg.level_strides, cfg.level_paddings, cfg.l2_norm_scale,
                            cfg.width_mult)
        gen = cfg.build_anchor_generator()
        self.bbox_head = SSDMEHHead(cfg.num_classes, self.neck.out_channels,
                                    gen.num_base_anchors)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init on the CPU, flax's defaults as in the JAX package:
        LeCun-normal backbone and neck convs (a normal truncated at two
        standard deviations, rescaled to variance 1 / fan_in) with zero
        biases, L2Norm at its scale, Xavier-uniform head."""
        gen = torch.Generator().manual_seed(seed)
        for m in list(self.backbone.modules()) + list(self.neck.modules()):
            if isinstance(m, nn.Conv2d):
                std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                m.bias.zero_()
        self.bbox_head.init_weights(gen)

    def forward(self, images: torch.Tensor, with_meh: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """images [B, S, S, 3] -> (cls [B, A, C+1], reg [B, A, 4],
        lambdas [B, A] or None), float32."""
        feats = self.neck(self.backbone(images.permute(0, 3, 1, 2).contiguous()))
        cls_maps, reg_maps = self.bbox_head(feats)
        cls_scores = flatten_levels(cls_maps, self.cfg.cls_out_channels).float()
        bbox_preds = flatten_levels(reg_maps, 4).float()
        lambdas = None
        if with_meh and self.cfg.use_meh:
            lam_maps = self.bbox_head.forward_L(tuple(f.detach() for f in feats))
            lambdas = flatten_levels(lam_maps, 1)[..., 0].float()
        return cls_scores, bbox_preds, lambdas


def build_ssd(cfg: SSDConfig, device="cuda", seed: int = 0) -> MEHSSD:
    """A seeded MEH-SSD in eval mode on `device`. Raises when device is
    CUDA and there is no card."""
    dev = resolve_device(device)
    with SkipDefaultInit():
        model = MEHSSD(cfg)
    model.init_weights(seed)
    return model.to(dev).eval()
