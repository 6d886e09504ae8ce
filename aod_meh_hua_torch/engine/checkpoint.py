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
the JAX package's; the format is torch's own: `torch.save` of the model
state_dict, and for the train state also the SGD state_dict (its momentum
buffers) and the step. The port cannot read the JAX package's
flax-msgpack checkpoints (the machine with the card has neither flax nor
msgpack), nor the reference's mmdet-named .pth files: loading those is
ROADMAP Queue 1 item f.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch


def save_checkpoint(path: str, obj: Any) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def train_state_path(save_dir: str) -> str:
    return os.path.join(save_dir, "train_state.ckpt")


def save_train_state(save_dir: str, state: dict, progress: dict) -> str:
    """Epoch-granular full-state snapshot ({"model": state_dict,
    "optimizer": SGD state_dict, "step": int}) for a mid-cycle resume.
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
    """Returns (state, progress dict). Accepts the save_dir or the .ckpt."""
    d = path_or_dir if os.path.isdir(path_or_dir) else os.path.dirname(path_or_dir)
    path = path_or_dir if path_or_dir.endswith(".ckpt") else train_state_path(d)
    state = load_checkpoint(path, map_location)
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
