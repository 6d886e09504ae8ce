"""Persistent decoded-canvas cache for eval/score sweeps.

A copy of aod_meh_hua_tpu/data/canvas_cache.py (`CanvasCache`,
`open_canvas_cache`, the fingerprint and the memmap layout). The AL
driver sweeps the same immutable pool every cycle; the eval-path
pipeline is deterministic (flip=False), so each image's prepared uint8
canvas is a pure function of (file, PipelineConfig): it is cached once
in memory-mapped files and every later sweep reads it back instead of
decoding and resizing the JPEG again.

Layout under `cache_dir`:
  fingerprint.json            pipeline + dataset identity; mismatch -> rebuild
  canvas_landscape.u8         memmap uint8 [n_land, ch, cw, 3]
  canvas_portrait.u8          memmap uint8 [n_port, ch', cw', 3]
  filled.u8 / img_shape.i32 / scale.f32   per-image metadata memmaps

Rows are assigned per orientation in dataset order, so writers touching
disjoint images (the decode thread pool) never collide. Only
uint8-transport pipelines (device_normalize=True) are cacheable.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np

from .pipeline import PipelineConfig

_VERSION = 1
_ORIENTATIONS = ("landscape", "portrait")


def _fingerprint(dataset, pipeline: PipelineConfig) -> dict:
    h = hashlib.sha1()
    n = len(dataset)
    for i in range(n):
        h.update(dataset.img_path(i).encode())
        h.update(b"L" if dataset.aspect_flag(i) else b"P")
    return {
        "version": _VERSION,
        "n": n,
        "paths_sha1": h.hexdigest(),
        "img_scale": list(pipeline.img_scale),
        "canvas": list(pipeline.canvas),
        "keep_ratio": pipeline.keep_ratio,
        "size_divisor": pipeline.size_divisor,
    }


class CanvasCache:
    """Open (or create) a canvas cache for `dataset` under `cache_dir`.

    get(idx) -> prepared-sample dict (as pipeline.prepare_sample with
    flip=False) or None on a cold row; put(idx, sample) fills a row.
    """

    def __init__(self, cache_dir: str, dataset, pipeline: PipelineConfig):
        if not pipeline.device_normalize:
            raise ValueError(
                "CanvasCache requires a uint8-transport pipeline "
                "(device_normalize=True); the float path normalizes on "
                "host and would quadruple the cache size")
        self.dir = cache_dir
        self.pipeline = pipeline
        self._ds = dataset
        n = len(dataset)

        # dataset-order row assignment per orientation
        # dtype=bool keeps the n=0 case indexable (np.array([]) is float64)
        orient = np.array([bool(dataset.aspect_flag(i)) for i in range(n)], bool)
        self._is_land = orient
        self._row = np.zeros(n, np.int64)
        self._row[orient] = np.arange(int(orient.sum()))
        self._row[~orient] = np.arange(int((~orient).sum()))
        counts = {"landscape": int(orient.sum()),
                  "portrait": int((~orient).sum())}

        os.makedirs(cache_dir, exist_ok=True)
        fp = _fingerprint(dataset, pipeline)
        fp_path = os.path.join(cache_dir, "fingerprint.json")
        fresh = True
        if os.path.exists(fp_path):
            try:
                with open(fp_path) as f:
                    fresh = json.load(f) != fp
            except (json.JSONDecodeError, OSError):
                fresh = True
        if fresh:
            for name in os.listdir(cache_dir):
                os.unlink(os.path.join(cache_dir, name))

        self._canvas = {}
        for o in _ORIENTATIONS:
            ch, cw = pipeline.canvas_for(o)
            shape = (max(counts[o], 1), ch, cw, 3)
            self._canvas[o] = self._open(f"canvas_{o}.u8", np.uint8, shape)
        self._filled = self._open("filled.u8", np.uint8, (n,))
        self._img_shape = self._open("img_shape.i32", np.int32, (n, 2))
        self._scale = self._open("scale.f32", np.float32, (n, 4))
        if fresh:
            with open(fp_path, "w") as f:
                json.dump(fp, f)

    def _open(self, name: str, dtype, shape):
        path = os.path.join(self.dir, name)
        mode = "r+" if os.path.exists(path) and os.path.getsize(path) == int(
            np.prod(shape)) * np.dtype(dtype).itemsize else "w+"
        return np.memmap(path, dtype=dtype, mode=mode, shape=shape)

    # ----- stats -----

    def __len__(self):
        return int(self._filled.shape[0])

    @property
    def n_filled(self) -> int:
        return int(np.count_nonzero(self._filled))

    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._canvas.values())

    # ----- access -----

    def _orientation(self, idx: int) -> str:
        return "landscape" if self._is_land[idx] else "portrait"

    def get(self, idx: int) -> Optional[dict]:
        if not self._filled[idx]:
            return None
        o = self._orientation(idx)
        h, w = (int(v) for v in self._img_shape[idx])
        d = self.pipeline.size_divisor
        return dict(
            image=self._canvas[o][self._row[idx]],  # memmap view; batch
            # assembly's np.stack is the copy
            img_shape=np.array([h, w], np.int32),
            pad_shape=np.array([(h + d - 1) // d * d, (w + d - 1) // d * d],
                               np.int32),
            scale_factor=self._scale[idx].copy(),
            flipped=False,
            orientation=o,
        )

    def put(self, idx: int, sample: dict) -> None:
        o = self._orientation(idx)
        self._canvas[o][self._row[idx]] = sample["image"]
        self._img_shape[idx] = sample["img_shape"]
        self._scale[idx] = sample["scale_factor"]
        self._filled[idx] = 1  # after the row write: readers gate on this


def open_canvas_cache(cache_dir: Optional[str], dataset,
                      pipeline: PipelineConfig, log=None) -> Optional[CanvasCache]:
    """Best-effort factory: returns None (sweeps run uncached) when the
    pipeline is not uint8-transport or the disk can't hold the canvases."""
    if cache_dir is None or not pipeline.device_normalize:
        return None
    # capacity guard before allocating ~N * canvas bytes
    n = len(dataset)
    ch, cw = pipeline.canvas
    need = n * ch * cw * 3
    probe = cache_dir
    while probe and not os.path.isdir(probe):
        probe = os.path.dirname(probe)
    have = shutil.disk_usage(probe or "/").free
    existing = 0
    if os.path.isdir(cache_dir):
        existing = sum(os.path.getsize(os.path.join(cache_dir, f))
                       for f in os.listdir(cache_dir))
    if need > (have + existing) * 0.9:
        if log:
            log(f"canvas cache disabled: needs ~{need / 1e9:.1f} GB, "
                f"{have / 1e9:.1f} GB free at {cache_dir}")
        return None
    try:
        return CanvasCache(cache_dir, dataset, pipeline)
    except (OSError, ValueError) as e:
        if log:
            log(f"canvas cache disabled: {e}")
        return None
