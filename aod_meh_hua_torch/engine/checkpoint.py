"""Checkpointing: torch-serialized model and optimizer state + the
per-cycle AL checkpoint.

Counterparts of aod_meh_hua_tpu/engine/checkpoint.py:22-108
(`save_checkpoint`, `load_checkpoint`, `train_state_path`,
`save_train_state`, `load_train_state`, `cycle_ckpt_path`, `latest_path`,
`save_cycle_checkpoint`), which mirror the reference's per-cycle
'{cfg}_Cycle{c}_Epoch{e}_mycode' snapshots with the GC of every other
snapshot (tools/train_RetinaNet.py:213-219), the epoch checkpoints and
'latest' pointer (Epoch_Based_Runner_Lambda.py:144-169) and
cfg.resume_from (apis/train_Lambda.py:72-75).

The file names, the train_state.json progress keys and the meta json are
the JAX package's; the format the port writes is torch's own:
`torch.save` of the model state_dict, and for the train state also the
SGD momentum buffers by parameter name and the step.

The families' model files go by family (`load_model_state_dict(path,
family)`): "retinanet", "ssd" and the two-stage families (the generic
trainer's {family}_final.ckpt, a JAX-written one included). Dynamic
R-CNN's statistics are buffers of its model, so its files and train
states carry them; a JAX TrainState's step becomes their step counter.

It reads three formats, told apart by their first bytes (`sniff_format`):
torch's zip and legacy pickle files (its own, or the reference's mmdet
.pth, raw or in mmcv's {"state_dict", "meta"} wrapper), and the JAX
package's flax-msgpack files, decoded by engine/flax_msgpack.py (the
machine with the card has neither flax nor msgpack) and carried over by
models/convert.py. So `load_model_state_dict` takes a cycle checkpoint
of either package or of the reference, and `load_train_state` a JAX
train_state.ckpt, whose optax SGD trace is torch's momentum_buffer.

Across ranks (al/loop.py) only rank 0 writes, what every rank assembled
with parallel.gather_to_host before the rank guard; a resume loads the
file on every rank and the driver places the state again, replicated or
re-sharded.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.convert import from_jax_variables
from ..models.two_stage import TWO_STAGE_FAMILIES
from ..models.reference_convert import (convert_reference_retinanet,
                                         convert_reference_ssd, is_reference_retinanet)
from .flax_msgpack import msgpack_restore


def save_checkpoint(path: str, obj: Any) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)
    return path


def sniff_format(path: str) -> str:
    """"torch_zip", "torch_legacy" or "msgpack" by the file's first bytes:
    PK\\x03\\x04 (torch's zip), 0x80 then a protocol byte 2-5 (a pickle,
    torch's legacy format writes protocol 2), or a msgpack map (0x80-0x8f,
    0xde, 0xdf; 0x80 alone is an empty map, and nothing may follow it, so
    the second byte tells it from a pickle). Anything else raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch_zip"
    if head[:1] == b"\x80" and head[1:2] in (b"\x02", b"\x03", b"\x04", b"\x05"):
        return "torch_legacy"
    if head[:1] and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "msgpack"
    raise ValueError(f"{path}: not a torch or flax-msgpack checkpoint (starts {head!r})")


def load_checkpoint(path: str, map_location="cpu") -> Any:
    """A torch file's object, or a msgpack file's state dict (numpy leaves)."""
    if sniff_format(path) == "msgpack":
        with open(path, "rb") as f:
            return msgpack_restore(f.read())
    return torch.load(path, map_location=map_location, weights_only=True)


def to_model_state_dict(obj: Any, family: str) -> Dict[str, torch.Tensor]:
    """A loaded checkpoint -> the family's port state_dict: a JAX
    variables tree ({"params", "batch_stats"}, or bare params), mmcv's
    {"state_dict", "meta"} wrapper, an mmdet state_dict (RetinaNet, SSD),
    or the port's own. Unknown keys of an mmdet file raise, and so does an
    mmdet Faster R-CNN file."""
    if isinstance(obj, dict) and "params" in obj:
        return from_jax_variables(obj)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if family in TWO_STAGE_FAMILIES:
        if any(k.startswith("roi_head.") for k in obj):
            raise NotImplementedError(
                f"an mmdet {family} .pth: its import (the box head's (c, h, w) fc "
                "input) is not ported yet (ROADMAP Queue 1 item 15)")
        return dict(obj)
    if family == "ssd":
        sd, rest = convert_reference_ssd(obj)
    elif is_reference_retinanet(obj):
        sd, rest = convert_reference_retinanet(obj)
    else:
        return dict(obj)
    if rest:
        raise KeyError(f"checkpoint keys with no port counterpart: {rest[:5]}")
    return sd


def load_model_state_dict(path: str, family: str) -> Dict[str, torch.Tensor]:
    """Model weights from any checkpoint the port reads (see the module
    docstring), as the family's port state_dict."""
    obj = load_checkpoint(path)
    if sniff_format(path) == "msgpack":
        obj = obj if "params" in obj else {"params": obj}
    return to_model_state_dict(obj, family)


def _find_trace(tree: Any) -> Optional[dict]:
    """optax.trace's momentum tree inside a serialized opt_state."""
    if not isinstance(tree, dict):
        return None
    if "trace" in tree and isinstance(tree["trace"], dict):
        return tree["trace"]
    for v in tree.values():
        found = _find_trace(v)
        if found is not None:
            return found
    return None


def train_state_path(save_dir: str) -> str:
    return os.path.join(save_dir, "train_state.ckpt")


def save_train_state(save_dir: str, state: dict, progress: dict) -> str:
    """Epoch-granular full-state snapshot ({"model": state_dict,
    "momentum": SGD momentum buffers by parameter name, "step": int}) for
    a mid-cycle resume.
    Overwrites in place, atomically (a preemption mid-write keeps the old
    one). `progress` records (cycle, run, epoch, run_iter) so the driver
    can replay the loader RNG to the exact batch stream."""
    os.makedirs(save_dir, exist_ok=True)
    path = train_state_path(save_dir)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(os.path.join(save_dir, "train_state.json"), "w") as f:
        json.dump(progress, f)
    return path


def load_train_state(path_or_dir: str, map_location="cpu"):
    """Returns (state, progress dict). Accepts the save_dir or the .ckpt.

    The port's own file gives {"model", "momentum", "step"} (an older one
    {"model", "optimizer": SGD state_dict, "step"}). A JAX TrainState
    (step, params, batch_stats, opt_state; flax writes the namedtuple as
    a map of its fields) gives the same keys: "momentum" maps each
    parameter's name to the optax trace,
    which is torch SGD's momentum_buffer (both keep buf = mu * buf +
    (g + wd * p))."""
    d = path_or_dir if os.path.isdir(path_or_dir) else os.path.dirname(path_or_dir)
    path = path_or_dir if path_or_dir.endswith(".ckpt") else train_state_path(d)
    state = load_checkpoint(path, map_location)
    if sniff_format(path) == "msgpack":
        variables = {"params": state["params"], "batch_stats": state.get("batch_stats") or {}}
        trace = _find_trace(state["opt_state"])
        if trace is None:
            raise KeyError(f"{path}: no optax trace (SGD momentum) in the opt_state")
        state = {"model": from_jax_variables(variables),
                 "momentum": from_jax_variables({"params": trace}),
                 "step": int(np.asarray(state["step"]))}
        if "dynamic.iou_thr" in state["model"]:  # Dynamic R-CNN's ring slot is the step's
            state["model"]["dynamic.step"] = torch.tensor(state["step"])
    with open(os.path.join(d, "train_state.json")) as f:
        progress = json.load(f)
    return state, progress


def cycle_ckpt_path(save_dir: str, name: str, cycle: int, epoch: int) -> str:
    return os.path.join(save_dir, f"{name}_Cycle{cycle}_Epoch{epoch}_mycode.ckpt")


def latest_path(save_dir: str) -> str:
    return os.path.join(save_dir, "latest.ckpt")


def save_cycle_checkpoint(save_dir: str, name: str, cycle: int, epoch: int, obj: Any,
                          keep_only_cycle: bool = True, meta: Optional[dict] = None) -> str:
    """Save the per-cycle snapshot; GC non-cycle checkpoints (the
    reference deletes every file without '_mycode', :214-216). `meta`
    (version, CLASSES, config) lands beside it as json."""
    os.makedirs(save_dir, exist_ok=True)
    if meta is not None:
        with open(os.path.join(save_dir, f"{name}_Cycle{cycle}_meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    if keep_only_cycle:
        for f in os.listdir(save_dir):
            if f.endswith(".ckpt") and "_mycode" not in f \
                    and not f.startswith("train_state"):
                os.remove(os.path.join(save_dir, f))
    path = cycle_ckpt_path(save_dir, name, cycle, epoch)
    save_checkpoint(path, obj)
    # 'latest' pointer (the runner's latest.pth symlink equivalent)
    lp = latest_path(save_dir)
    if os.path.islink(lp) or os.path.exists(lp):
        os.remove(lp)
    try:
        os.symlink(os.path.basename(path), lp)
    except OSError:
        save_checkpoint(lp, obj)
    return path
