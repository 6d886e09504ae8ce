"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for
    and there is none. The port's entry points default to the card and
    never carry on on the CPU unless the caller passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pin_numerics() -> None:
    """The numerics the CLIs run under, process-wide: f32 convolutions and
    matmuls in full f32 (no TF32), and deterministic cuDNN algorithms, as
    the reference pins them (its tools/train_RetinaNet.py:80-87). TF32
    flips NMS survivors near the threshold."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
