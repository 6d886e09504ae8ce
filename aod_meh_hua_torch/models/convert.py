"""JAX variables -> the port's state_dict.

Takes the JAX package's MEH-RetinaNet, MEH-SSD or two-stage variables,
{"params": ..., "batch_stats": ...} as nested dicts of numpy arrays (the
trees of aod_meh_hua_tpu/models/detector.py, ssd_detector.py and
two_stage.py), and returns a state_dict for models/detector.py's
MEHRetinaNet, models/ssd_detector.py's MEHSSD (mmdet's names, the mapping
of aod_meh_hua_tpu/models/reference_convert.py:107-140) or the models of
models/two_stage.py (the cascade's bbox_head_{i} to bbox_heads.{i}, the
double head's conv_branch_{i} and fc_branch_{i} to their lists; the
Faster R-CNN variants' necks, neck/{lateral_i, fpn_i, downsample_i,
pafpn_i} of PAFPN and neck/{lateral_i, carafe_i/{channel_compressor,
content_encoder}, fpn_conv_i} of the CARAFE FPN, Libra's
bfp/refine/{g, theta, phi, conv_out}, GRoIE's groie_pre and groie_post,
and the backbone blocks' gen_attention, whose key_bias, geom_bias and
gamma keep their names and whose geom_fc_x/y are bias-free Dense; the
proposal families' trees: TridentNet's one shared stage-3 kernel per
block, Cascade RPN's deform conv kernel [9, in, out] -> [out, in, 3, 3],
Grid R-CNN's per-point deconvs and GroupNorms). Conv kernels go HWIO ->
OIHW and Dense kernels [in, out] -> [out, in]; a flax ConvTranspose
kernel [kh, kw, in, out], which lax.conv_transpose correlates unflipped,
goes to torch's ConvTranspose2d weight [in, out, kh, kw] flipped in both
spatial axes (the grid head's deconv{1,2}_{i}); the
box heads' first fc reads its input in the JAX head's (h, w, c) order,
so its columns carry over as they are. BN scale/bias/mean/var (the
frozen backbone's and the double head's trainable BN alike), GroupNorm's
scale/bias and L2Norm's scale go to weight/bias/running_mean/running_var and weight. Dynamic
R-CNN's statistics (batch_stats["__dynamic_rcnn__"]: iou_hist,
beta_hist, iou_thr, beta) go to the `dynamic.` buffers of the same
names; a variables tree holds no step counter (the train state does:
engine/checkpoint.py load_train_state). The JAX
package keeps one tree whether fused_blocks is on or off
(models/resnet.py:93-122), and so does the port: the same tree loads
into either.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .vgg import MMCV_VGG16_CONV_IDX

# JAX module name -> the port's, applied to each component of the path
_NAME_RULES = (
    (re.compile(r"^(layer\d+)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^lateral_(\d+)$"), r"lateral_convs.\1"),
    (re.compile(r"^fpn_(\d+)$"), r"fpn_convs.\1"),
    (re.compile(r"^extra_(\d+)$"), r"extra_convs.\1"),
    (re.compile(r"^conv_(\d+)$"), r"\1"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
    (re.compile(r"^downsample_gn$"), "downsample.1"),
    (re.compile(r"^shared_fc_(\d+)$"), r"shared_fcs.\1"),
    (re.compile(r"^bbox_head_(\d+)$"), r"bbox_heads.\1"),
    (re.compile(r"^conv_branch_(\d+)$"), r"conv_branch.\1"),
    (re.compile(r"^fc_branch_(\d+)$"), r"fc_branch.\1"),
    (re.compile(r"^downsample_(\d+)$"), r"downsample_convs.\1"),
    (re.compile(r"^pafpn_(\d+)$"), r"pafpn_convs.\1"),
    (re.compile(r"^carafe_(\d+)$"), r"carafe.\1"),
    (re.compile(r"^fpn_conv_(\d+)$"), r"fpn_convs.\1"),
)
# GeneralizedAttention's own parameters keep their names
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "key_bias": "key_bias", "geom_bias": "geom_bias", "gamma": "gamma"}
# the flax ConvTranspose modules of the ported trees (Grid R-CNN's grid head)
_CONV_TRANSPOSE = re.compile(r"^deconv\d+_\d+$")
# Dynamic R-CNN's state in batch_stats (JAX engine/two_stage.py:479)
DYNAMIC_KEY = "__dynamic_rcnn__"
DYNAMIC_LEAVES = ("iou_hist", "beta_hist", "iou_thr", "beta")


def _module_name(name: str) -> str:
    for pat, rep in _NAME_RULES:
        if pat.match(name):
            return pat.sub(rep, name)
    return name


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# the JAX SSD's module names -> mmdet's (reference_convert.py:107-140)
_VGG_CONVS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
              "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3", "conv6",
              "conv7")
_SSD_RULES = (
    (re.compile(r"^backbone\.(conv\d_\d|conv6|conv7)$"),
     lambda m: f"backbone.features.{MMCV_VGG16_CONV_IDX[_VGG_CONVS.index(m[1])]}"),
    (re.compile(r"^neck\.extra_(\d+)_reduce$"), lambda m: f"neck.extra_layers.{m[1]}.0.conv"),
    (re.compile(r"^neck\.extra_(\d+)_conv$"), lambda m: f"neck.extra_layers.{m[1]}.1.conv"),
    (re.compile(r"^neck\.l2_norm$"), lambda m: "neck.l2_norm"),
    (re.compile(r"^head\.(cls|reg|L)_(\d+)$"), lambda m: f"bbox_head.{m[1]}_convs.{m[2]}.0"),
)


def _ssd_module(mods) -> str:
    path = ".".join(mods)
    for pat, rep in _SSD_RULES:
        m = pat.match(path)
        if m:
            return rep(m)
    raise KeyError(f"no port module for the JAX SSD's {path!r}")


def _kernel(arr: np.ndarray, module: str) -> np.ndarray:
    """A flax kernel in the port's layout: a conv's HWIO -> OIHW, a
    ConvTranspose's [kh, kw, in, out] -> [in, out, kh, kw] flipped
    spatially, a deform conv's [9, in, out] -> [out, in, 3, 3] (taps
    row-major), a Dense kernel [in, out] -> [out, in]."""
    if arr.ndim == 4:
        if _CONV_TRANSPOSE.match(module):
            return arr[::-1, ::-1].transpose(2, 3, 0, 1)
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3:
        taps, cin, cout = arr.shape
        return arr.transpose(2, 1, 0).reshape(cout, cin, 3, 3)
    return arr.T


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} numpy tree -> the state_dict of the port
    model of its family (MEHRetinaNet, MEHSSD for a tree with VGG convs,
    the two-stage models for one with an RPN head). SSD has no
    batch_stats. A leaf of no known kind raises."""
    ssd = "conv1_1" in tree.get("params", {}).get("backbone", {})
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(tree.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if mods == [DYNAMIC_KEY]:
                if collection != "batch_stats" or name not in DYNAMIC_LEAVES:
                    raise KeyError(f"{collection}/{DYNAMIC_KEY}/{name}: not Dynamic "
                                   "R-CNN's state")
                out[f"dynamic.{name}"] = torch.from_numpy(np.array(arr, order="C"))
                continue
            if name not in _LEAF:
                raise KeyError(f"{'/'.join(path)}: no port counterpart")
            if name == "kernel":
                arr = _kernel(arr, mods[-1] if mods else "")
            module = _ssd_module(mods) if ssd else ".".join(_module_name(m) for m in mods)
            key = f"{module}.{_LEAF[name]}" if module else _LEAF[name]
            out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out
