"""Environment capture: counterparts of aod_meh_hua_tpu/utils/env.py
`collect_env` (:10) and `save_code` (:38), after the reference's
mmdet/utils/collect_env.py and SaveCode (functions.py:103-116)."""

from __future__ import annotations

import os
import platform
import sys
import tarfile

import numpy as np
import torch

import aod_meh_hua_torch


def collect_env() -> dict:
    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "aod_meh_hua_torch": aod_meh_hua_torch.__version__,
    }
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    return info


def save_code(work_dir: str) -> str:
    """Snapshot the package's source into the run directory as one
    tar.gz; returns the archive path."""
    pkg_dir = os.path.dirname(os.path.abspath(aod_meh_hua_torch.__file__))
    os.makedirs(work_dir, exist_ok=True)
    out = os.path.join(work_dir, "code_snapshot.tar.gz")
    with tarfile.open(out, "w:gz") as tar:
        tar.add(pkg_dir, arcname="aod_meh_hua_torch",
                filter=lambda ti: None if "__pycache__" in ti.name else ti)
    return out
