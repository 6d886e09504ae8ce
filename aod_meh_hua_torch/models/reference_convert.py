"""Reference-trained (mmdet) checkpoints <-> the port's state_dicts.

Port of aod_meh_hua_tpu/models/reference_convert.py (`unconverted_keys`
:57-61, `convert_reference_retinanet` :64-104, `convert_reference_ssd`
:107-140, `export_reference_retinanet` :143-198). The reference saves raw
state_dict snapshots per AL cycle ('{cfg}_Cycle{c}_Epoch{e}_mycode.pth',
its tools/train_RetinaNet.py:213-219) in mmdet's names:
* mmdet/models/necks/fpn.py: lateral_convs.{i}.conv / fpn_convs.{i}.conv,
  the extra P6/P7 convs at fpn_convs 3 and 4 (start_level=1, num_outs=5);
* mmdet/models/dense_heads/Lambda_L2.py:41-54: {cls,reg,L}_convs.{i}.conv
  + retina_{cls,reg,L};
* the backbone in torchvision's names under 'backbone.', as the port's.
The port's SSD carries mmdet's names itself (models/ssd_detector.py), so
its conversion only checks and filters the keys.

Each converter returns (state_dict, unconverted keys); a key it does not
know is reported, not raised on (the reference converters' "Not
Convert:"), and num_batches_tracked, torch BN bookkeeping, is dropped
silently.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

# mmdet RetinaNet key -> the port's (models/detector.py); applied in order
_RETINA = (
    (re.compile(r"^(backbone\..*)$"), r"\1"),
    (re.compile(r"^neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)$"),
     r"neck.lateral_convs.\1.\2"),
    (re.compile(r"^neck\.fpn_convs\.([0-2])\.conv\.(weight|bias)$"), r"neck.fpn_convs.\1.\2"),
    (re.compile(r"^neck\.fpn_convs\.(\d+)\.conv\.(weight|bias)$"), None),  # extras, below
    (re.compile(r"^bbox_head\.(cls|reg|L)_convs\.(\d+)\.conv\.(weight|bias)$"),
     r"head.\1_convs.\2.\3"),
    (re.compile(r"^bbox_head\.(retina_(?:cls|reg|L))\.(weight|bias)$"), r"head.\1.\2"),
)
_SSD = re.compile(r"^(backbone\.features\.\d+\.(weight|bias)|neck\.l2_norm\.weight"
                  r"|neck\.extra_layers\.\d+\.[01]\.conv\.(weight|bias)"
                  r"|bbox_head\.(cls|reg|L)_convs\.\d+\.0\.(weight|bias))$")


def unconverted_keys(sd: Mapping[str, torch.Tensor], taken: set) -> List[str]:
    return sorted(k for k in sd if k not in taken and not k.endswith("num_batches_tracked"))


def convert_reference_retinanet(sd: Mapping[str, torch.Tensor], num_fpn_levels: int = 3
                                ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """mmdet SSL_L_RetinaNet state_dict -> the port's MEHRetinaNet
    state_dict. fpn_convs past the first num_fpn_levels are the extra
    levels (extra_convs.{i - num_fpn_levels})."""
    out: Dict[str, torch.Tensor] = {}
    taken: set = set()
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        for pat, rep in _RETINA:
            m = pat.match(key)
            if not m:
                continue
            if rep is None:
                dst = f"neck.extra_convs.{int(m[1]) - num_fpn_levels}.{m[2]}"
            else:
                dst = m.expand(rep)
            out[dst] = torch.as_tensor(value)
            taken.add(key)
            break
    return out, unconverted_keys(sd, taken)


def export_reference_retinanet(sd: Mapping[str, torch.Tensor], num_fpn_levels: int = 3
                               ) -> Dict[str, torch.Tensor]:
    """Inverse of convert_reference_retinanet: the port's MEHRetinaNet
    state_dict -> mmdet's names."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "backbone":
            dst = key
        elif parts[0] == "neck" and parts[1] == "extra_convs":
            dst = f"neck.fpn_convs.{int(parts[2]) + num_fpn_levels}.conv.{parts[3]}"
        elif parts[0] == "neck":
            dst = f"neck.{parts[1]}.{parts[2]}.conv.{parts[3]}"
        elif parts[0] == "head" and parts[1].startswith("retina_"):
            dst = f"bbox_head.{parts[1]}.{parts[2]}"
        elif parts[0] == "head":
            dst = f"bbox_head.{parts[1]}.{parts[2]}.conv.{parts[3]}"
        else:
            raise KeyError(f"no mmdet name for {key!r}")
        out[dst] = value
    return out


def convert_reference_ssd(sd: Mapping[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """mmdet SSD_L_SingleStageDetector state_dict -> the port's MEHSSD
    state_dict: the same names (VGG16 features.*, SSDNeck l2_norm +
    extra_layers, MyLSSDHead's Sequential index 0 per level and branch)."""
    out = {k: torch.as_tensor(v) for k, v in sd.items() if _SSD.match(k)}
    return out, unconverted_keys(sd, set(out))


def is_reference_retinanet(sd: Mapping[str, torch.Tensor]) -> bool:
    """True for a state_dict in mmdet's RetinaNet names."""
    return any(k.startswith("bbox_head.retina_") for k in sd)
