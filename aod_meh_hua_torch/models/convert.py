"""JAX variables -> the port's state_dict.

Takes the JAX package's MEH-RetinaNet variables, {"params": ...,
"batch_stats": ...} as nested dicts of numpy arrays (the tree of
aod_meh_hua_tpu/models/detector.py), and returns a state_dict for
models/detector.py's MEHRetinaNet. Conv kernels go HWIO -> OIHW; BN
scale/bias/mean/var go to weight/bias/running_mean/running_var. The JAX
package keeps one tree whether fused_blocks is on or off
(models/resnet.py:93-122), and so does the port: the same tree loads
into either.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# JAX module name -> the port's, applied to each component of the path
_NAME_RULES = (
    (re.compile(r"^(layer\d+)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^lateral_(\d+)$"), r"lateral_convs.\1"),
    (re.compile(r"^fpn_(\d+)$"), r"fpn_convs.\1"),
    (re.compile(r"^extra_(\d+)$"), r"extra_convs.\1"),
    (re.compile(r"^conv_(\d+)$"), r"\1"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


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


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} numpy tree -> MEHRetinaNet state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(tree.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            key = ".".join([_module_name(m) for m in mods] + [_LEAF[name]])
            out[key] = torch.from_numpy(np.array(arr, order="C"))  # an owned copy
    return out
