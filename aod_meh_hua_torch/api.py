"""High-level inference API for the ported families (MEH-RetinaNet,
MEH-SSD, Faster R-CNN).

Port of aod_meh_hua_tpu/api.py:24-111 (`init_detector`), :112-205
(`make_eval_step_for`), :214-341 (`_default_pipeline`, `Detector` with
its dense `tta`) and :439-525 (`predict_batch`, `inference_detector`,
`async_inference_detector`), which mirror the reference's
mmdet/apis/inference.py:16 (init_detector), :89 (inference_detector) and
:155 (async_inference_detector).

In PyTorch's idiom the module carries its weights: `init_detector`
returns the model on its device, where the JAX function returns
(model, variables), and `Detector` takes (cfg, model) where the JAX one
takes (cfg, model, variables). Its steps run on the model's device. The
other families of the JAX registry raise (ROADMAP Queue 1 item 15), and
so do Faster R-CNN's test-time augmentation and uncertainty column (the
JAX package's are the dense families' only), and drawing (item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .data.pipeline import PipelineConfig, load_image, prepare_sample
from .engine.batch import EvalBatch
from .engine.checkpoint import load_model_state_dict
from .engine.eval import detections_to_per_class, make_eval_step
from .engine.tta import canvas_for_scale, make_tta_candidate_step, make_tta_merge_step
from .engine.two_stage import make_faster_rcnn_eval_step
from .models.detector import build_retinanet
from .models.ssd_detector import build_ssd
from .models.two_stage import build_faster_rcnn
from .utils.config import ALL_FAMILIES

# the dense families: TTA and the per-detection uncertainty are theirs
_DENSE = ("retinanet", "ssd")
_BUILD = {"retinanet": build_retinanet, "ssd": build_ssd, "faster_rcnn": build_faster_rcnn}


def _family(cfg) -> str:
    return getattr(cfg, "family", "retinanet")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def init_detector(cfg, checkpoint: Optional[str] = None, seed: int = 0,
                  device="cuda") -> torch.nn.Module:
    """A detector of a ported family in eval mode on `device`, seeded by
    `seed` (torch's generator: the weights differ from the JAX package's
    for the same seed), with the weights of `checkpoint` when one is
    given: the port's files, the JAX package's flax-msgpack files and
    the reference's mmdet .pth (engine/checkpoint.py)."""
    family = _family(cfg)
    if family not in ALL_FAMILIES:
        _not_ported(f"the {family} family", "15")
    model = _BUILD[family](cfg, device=device, seed=seed)
    if checkpoint:
        model.load_state_dict(load_model_state_dict(checkpoint, family))
    return model


def make_eval_step_for(model, cfg, device="cuda"):
    """The family's eval step on `device`: step(EvalBatch) -> NMSResult."""
    if _family(cfg) == "faster_rcnn":
        return make_faster_rcnn_eval_step(model, cfg, device=device)
    return make_eval_step(model, cfg, device=device)


def _default_pipeline(cfg) -> PipelineConfig:
    if _family(cfg) == "ssd":
        return PipelineConfig(img_scale=cfg.canvas, canvas=cfg.canvas,
                              std=(1.0, 1.0, 1.0), keep_ratio=False,
                              device_normalize=True)
    return PipelineConfig(canvas=cfg.canvas, device_normalize=True)


class Detector:
    """A model with its per-orientation eval steps, on the model's device."""

    def __init__(self, cfg, model: torch.nn.Module, pipeline: Optional[PipelineConfig] = None,
                 with_uncertainty: bool = False):
        """with_uncertainty (retinanet/ssd): per-class results become
        [k, 6], the per-detection Shannon entropy appended (the reference's
        bbox2tupleresult)."""
        family = _family(cfg)
        if with_uncertainty and family not in _DENSE:
            raise ValueError("with_uncertainty is a retinanet/ssd capability")
        if family not in ALL_FAMILIES:
            _not_ported(f"the {family} family", "15")
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.pipeline = pipeline or _default_pipeline(cfg)
        self.with_uncertainty = with_uncertainty
        self._steps: Dict[str, object] = {}
        self._tta_steps: Dict[tuple, object] = {}
        self._tta_merge = make_tta_merge_step(cfg)

    def _step(self, orientation: str):
        if orientation not in self._steps:
            ocfg = self.cfg.for_orientation(orientation)
            self._steps[orientation] = (
                make_eval_step(self.model, ocfg, with_uncertainty=True, device=self.device)
                if self.with_uncertainty else make_eval_step_for(self.model, ocfg, self.device))
        return self._steps[orientation]

    def _per_class(self, out, batch_valid=None) -> List[List[np.ndarray]]:
        if self.with_uncertainty:
            dets, unc = out
            return detections_to_per_class(dets, self.cfg.num_fg_classes,
                                           batch_valid=batch_valid, unc=unc)
        return detections_to_per_class(out, self.cfg.num_fg_classes, batch_valid=batch_valid)

    def __call__(self, image: Union[str, np.ndarray]) -> List[np.ndarray]:
        """One image (a path or a BGR uint8 array) -> per-class [k, 5]
        arrays in original image coordinates (the reference's bbox2result
        format); [k, 6] with the per-detection uncertainty when
        with_uncertainty."""
        img = load_image(image) if isinstance(image, str) else image
        s = prepare_sample(img, None, self.pipeline, flip=False)
        batch = EvalBatch(s["image"][None], s["img_shape"][None], s["scale_factor"][None],
                          np.ones(1, bool))
        return self._per_class(self._step(s["orientation"])(batch))[0]

    def tta(self, image: Union[str, np.ndarray], scales: Optional[Sequence] = None,
            flip: bool = True, return_masks: bool = False) -> List[np.ndarray]:
        """Test-time-augmented inference (MultiScaleFlipAug + aug_test,
        reference datasets/pipelines/test_time_aug.py:10 +
        dense_test_mixins.py:71; JAX aod_meh_hua_tpu/api.py:269-341): one
        candidate pass per (scale, flip), the candidates mapped back to
        original coordinates and merged through ONE NMS. Returns per-class
        [k, 5] arrays like __call__. `scales` are (long, short) resize
        bounds, the pipeline's img_scale by default; the SSD warps to
        each scale's square input_size.

        The dense families only: the two-stage, cascade and mask
        families' TTA (and `return_masks`) come with the model zoo
        (ROADMAP Queue 1 item 15); Sparse R-CNN raises, as the reference
        does (sparse_roi_head.py:302)."""
        img = load_image(image) if isinstance(image, str) else image
        scales = [tuple(s) for s in (scales or [self.pipeline.img_scale])]
        flips = [False, True] if flip else [False]
        fam = _family(self.cfg)
        if fam == "sparse_rcnn":
            raise NotImplementedError("Sparse R-CNN does not support `aug_test`")
        if fam not in _DENSE:
            _not_ported(f"TTA of the {fam} family", "15")
        aug_boxes, aug_scores = [], []
        for scale in scales:
            canvas = (canvas_for_scale(scale) if self.pipeline.keep_ratio
                      else (min(scale), max(scale)))
            pipe = dataclasses.replace(self.pipeline, img_scale=scale, canvas=canvas)
            for f in flips:
                s = prepare_sample(img, None, pipe, flip=f)
                key = (scale, s["orientation"])
                if key not in self._tta_steps:
                    if fam == "ssd":
                        cfg_s = dataclasses.replace(self.cfg, input_size=max(scale))
                    else:
                        cfg_s = dataclasses.replace(self.cfg, canvas=canvas)
                    self._tta_steps[key] = make_tta_candidate_step(
                        self.model, cfg_s.for_orientation(s["orientation"]))
                batch = EvalBatch(s["image"][None], s["img_shape"][None],
                                  s["scale_factor"][None], np.ones(1, bool))
                b, sc = self._tta_steps[key](batch, np.array([f], bool))
                aug_boxes.append(b)
                aug_scores.append(sc)
        dets = self._tta_merge(torch.cat(aug_boxes, dim=1), torch.cat(aug_scores, dim=1))
        return detections_to_per_class(dets, self.cfg.num_fg_classes)[0]

    def predict_batch(self, images: Sequence[Union[str, np.ndarray]],
                      max_batch: int = 8) -> List[List[np.ndarray]]:
        """Batched inference: the images grouped by orientation, each group
        padded to a fixed max_batch (the padding rows repeat the group's
        first image and are dropped), through the same eval step; the
        per-image per-class arrays in input order."""
        samples = [prepare_sample(load_image(i) if isinstance(i, str) else i,
                                  None, self.pipeline, flip=False)
                   for i in images]
        results: List[Optional[List[np.ndarray]]] = [None] * len(images)
        by_orient: Dict[str, List[int]] = {}
        for idx, s in enumerate(samples):
            by_orient.setdefault(s["orientation"], []).append(idx)
        for orient, idxs in by_orient.items():
            step = self._step(orient)
            for lo in range(0, len(idxs), max_batch):
                chunk = idxs[lo:lo + max_batch]
                rows = chunk + [chunk[0]] * (max_batch - len(chunk))
                stack = lambda key: np.stack([samples[i][key] for i in rows])  # noqa: E731
                bvalid = np.arange(max_batch) < len(chunk)
                out = step(EvalBatch(stack("image"), stack("img_shape"),
                                     stack("scale_factor"), bvalid))
                for i, per in zip(chunk, self._per_class(out, batch_valid=bvalid)):
                    results[i] = per
        return results  # type: ignore[return-value]


def show_result(image, per_class_dets, out_file: Optional[str] = None,
                score_thr: float = 0.3):
    """Drawing detections needs utils/visualize.py without OpenCV."""
    _not_ported("show_result (utils/visualize.py)", "13")


def inference_detector(detector: Detector, imgs) -> Union[List, List[List]]:
    """The reference's helper: one image, or a list of images."""
    if isinstance(imgs, (list, tuple)):
        return [detector(i) for i in imgs]
    return detector(imgs)


async def async_inference_detector(detector: Detector, img):
    """Awaitable single-image inference (reference
    mmdet/apis/inference.py:155): the step runs in the loop's default
    thread-pool executor, so the event loop stays free meanwhile."""
    import asyncio

    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, detector, img)
