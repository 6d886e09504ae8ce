"""MEH-RetinaNet detector assembly (torch) + flattening helper.

Port of aod_meh_hua_tpu/models/detector.py:29-96, which mirrors the
reference's SSL_L_single_stage.py:11 (backbone -> neck -> head; the MEH
branch consumes detached FPN features, :43).

Public layouts are the JAX package's: images [B, H, W, 3] in, flattened
f32 outputs [B, A, C], [B, A, 4] and [B, A] out. Inside, the model runs
NCHW tensors in channels_last memory. With cfg.mc_dropout > 0 (the
MC-dropout baseline) every forward is stochastic and takes a
torch.Generator on the model's device for its dropout masks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from ..utils.config import RetinaNetConfig
from ..utils.device import resolve_device
from .fpn import FPN
from .resnet import ResNet, check_backbone_options
from .retina_head import RetinaMEHHead


def flatten_levels(level_maps: Sequence[torch.Tensor], channels: int) -> torch.Tensor:
    """Per-level NCHW maps [B, A*channels, H, W] -> [B, sum(H*W*A), channels].

    The permute to NHWC comes before the reshape, so anchors are ordered
    row-major by cell with the anchor index minor, as in ops/anchors.py.
    """
    flat = [m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, channels) for m in level_maps]
    return torch.cat(flat, dim=1)


class SkipDefaultInit(TorchFunctionMode):
    """Build modules without torch's default init of their conv and
    linear layers (kaiming_uniform_ and uniform_ leave the tensor as it
    is): the builders' init_weights draw every one of them from the seed
    (tests/test_torch_model.py holds the state dicts equal), and the
    default draws were most of a full-width model's build time on the
    card's host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is nn.init.kaiming_uniform_ or func is nn.init.uniform_:
            return args[0] if args else kwargs["tensor"]
        return func(*args, **(kwargs or {}))


class MEHRetinaNet(nn.Module):
    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        check_backbone_options(cfg)
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port's model runs float32 "
                "(ROADMAP Queue 1 item 16)")
        self.cfg = cfg
        self.backbone = ResNet(cfg.block_counts, cfg.stem_width, cfg.fused_blocks,
                               cfg.fused_stages, cfg.conv1x1_matmul, cfg.mc_dropout)
        self.neck = FPN(cfg.backbone_channels, cfg.fpn_channels, start_level=1,
                        num_outs=len(cfg.anchor.strides))
        self.head = RetinaMEHHead(cfg.num_classes, cfg.fpn_channels,
                                  num_anchors=cfg.anchor.num_anchors,
                                  feat_channels=cfg.feat_channels,
                                  stacked_convs=cfg.stacked_convs,
                                  with_lambda=cfg.use_meh, mc_dropout=cfg.mc_dropout)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init on the CPU: LeCun-normal backbone and neck convs,
        zero neck biases, the head's own init; BN at identity statistics."""
        gen = torch.Generator().manual_seed(seed)
        for m in list(self.backbone.modules()) + list(self.neck.modules()):
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        self.head.init_weights(gen)

    def forward(self, images: torch.Tensor, with_meh: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """images [B, H, W, 3] -> (cls_scores [B, A, C], bbox_preds [B, A, 4],
        lambdas [B, A] or None), float32. `generator` draws the dropout
        masks when cfg.mc_dropout > 0 (the JAX apply's "dropout" rng)."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.neck(self.backbone(x, generator))
        cls_maps, reg_maps = self.head(feats, generator)
        cls_scores = flatten_levels(cls_maps, self.cfg.num_classes).float()
        bbox_preds = flatten_levels(reg_maps, 4).float()
        lambdas = None
        if with_meh and self.cfg.use_meh:
            lam_maps = self.head.forward_L(tuple(f.detach() for f in feats), generator)
            lambdas = flatten_levels(lam_maps, 1)[..., 0].float()
        return cls_scores, bbox_preds, lambdas


def build_retinanet(cfg: RetinaNetConfig, device="cuda", seed: int = 0) -> MEHRetinaNet:
    """A seeded MEH-RetinaNet in eval mode on `device` (channels_last).
    Raises when device is CUDA and there is no card."""
    dev = resolve_device(device)
    with SkipDefaultInit():
        model = MEHRetinaNet(cfg)
    model.init_weights(seed)
    return model.to(device=dev, memory_format=torch.channels_last).eval()
