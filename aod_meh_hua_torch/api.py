"""High-level inference API for the ported families (MEH-RetinaNet,
MEH-SSD, the two-stage families of utils/config.py ZOO_FAMILIES).

Port of aod_meh_hua_tpu/api.py:24-111 (`init_detector`), :112-205
(`make_eval_step_for`), :214-420 (`_default_pipeline`, `Detector` with
its `tta` and `_tta_two_stage` but for the mask branch) and :439-525
(`predict_batch`, `inference_detector`,
`async_inference_detector`), which mirror the reference's
mmdet/apis/inference.py:16 (init_detector), :89 (inference_detector) and
:155 (async_inference_detector).

In PyTorch's idiom the module carries its weights: `init_detector`
returns the model on its device, where the JAX function returns
(model, variables), and `Detector` takes (cfg, model) where the JAX one
takes (cfg, model, variables). Its steps run on the model's device. The
other families of the JAX registry raise (ROADMAP Queue 1 item 15), and
so do the two-stage families' uncertainty column (the JAX package's is
the dense families' only) and drawing (item 13). TTA covers the dense
families, Faster R-CNN and Cascade R-CNN; the other two-stage families
raise there, as in the JAX package, whose TTA lacks them too. The
RPN-only and Cascade RPN families' detections are their proposals, one
class (num_fg_classes 1); Fast R-CNN's eval takes proposals from outside
(engine/rpn_only.py make_fast_rcnn_eval_step), so its Detector and
make_eval_step_for raise a ValueError, as JAX api.py:204-209 does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .data.pipeline import PipelineConfig, load_image, prepare_sample
from .engine.batch import EvalBatch
from .engine.checkpoint import load_model_state_dict
from .engine.eval import detections_to_per_class, make_eval_step
from .engine.tta import (canvas_for_scale, make_tta_candidate_step, make_tta_cascade_roi_step,
                         make_tta_merge_step, make_tta_proposal_merge, make_tta_roi_step,
                         make_tta_rpn_step, make_tta_two_stage_merge)
from .engine.two_stage import make_two_stage_eval_step
from .models.detector import build_retinanet
from .models.ssd_detector import build_ssd
from .models.two_stage import TWO_STAGE_FAMILIES, build_two_stage
from .utils.config import ALL_FAMILIES

# the dense families: TTA and the per-detection uncertainty are theirs
_DENSE = ("retinanet", "ssd")
_BUILD = {"retinanet": build_retinanet, "ssd": build_ssd,
          **{f: build_two_stage for f in TWO_STAGE_FAMILIES}}
# the two-stage families with a TTA (the JAX package's list at api.py:296, less
# the mask families, which are not ported)
_TWO_STAGE_TTA = ("faster_rcnn", "cascade_rcnn")
_MASK_FAMILIES = ("mask_rcnn", "mask_scoring_rcnn", "point_rend", "htc", "scnet")


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
        load_weights(model, load_model_state_dict(checkpoint, family))
    return model


def load_weights(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """model.load_state_dict, strict but for Dynamic R-CNN's statistics
    (the `dynamic.` buffers): a file without them (another family's, a
    JAX variables tree before its first dynamic step) leaves them at
    their initial values, and a JAX variables tree, which keeps no step
    counter, leaves the step at 0."""
    missing = set(model.state_dict()) - set(state_dict)
    if missing and all(k.startswith("dynamic.") for k in missing):
        unexpected = model.load_state_dict(state_dict, strict=False).unexpected_keys
        if unexpected:
            raise RuntimeError(f"Unexpected key(s) in state_dict: {unexpected[:5]}")
    else:
        model.load_state_dict(state_dict)


def make_eval_step_for(model, cfg, device="cuda"):
    """The family's eval step on `device`: step(EvalBatch) -> NMSResult (a
    one-class ProposalResult for rpn and cascade_rpn); fast_rcnn raises a
    ValueError (its eval takes proposals)."""
    if _family(cfg) in TWO_STAGE_FAMILIES:
        return make_two_stage_eval_step(model, cfg, device=device)
    return make_eval_step(model, cfg, device=device)


def _default_pipeline(cfg) -> PipelineConfig:
    if _family(cfg) == "ssd":
        return PipelineConfig(img_scale=cfg.canvas, canvas=cfg.canvas,
                              std=(1.0, 1.0, 1.0), keep_ratio=False,
                              device_normalize=True)
    return PipelineConfig(canvas=cfg.canvas, device_normalize=True)


def _one(sample) -> EvalBatch:
    """One prepared sample as a batch of one."""
    return EvalBatch(sample["image"][None], sample["img_shape"][None],
                     sample["scale_factor"][None], np.ones(1, bool))


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
        return self._per_class(self._step(s["orientation"])(_one(s)))[0]

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

        Faster and Cascade R-CNN take `_tta_two_stage`. The mask families'
        TTA (and `return_masks`) come with those families (ROADMAP Queue
        1 item 15); Dynamic and Double-Head R-CNN raise, as the JAX
        package does; Sparse R-CNN raises, as the reference does
        (sparse_roi_head.py:302)."""
        img = load_image(image) if isinstance(image, str) else image
        scales = [tuple(s) for s in (scales or [self.pipeline.img_scale])]
        flips = [False, True] if flip else [False]
        fam = _family(self.cfg)
        if fam in _TWO_STAGE_TTA:
            return self._tta_two_stage(img, scales, flips, fam)
        if fam == "sparse_rcnn":
            raise NotImplementedError("Sparse R-CNN does not support `aug_test`")
        if fam in _MASK_FAMILIES or fam not in ALL_FAMILIES:
            _not_ported(f"TTA of the {fam} family", "15")
        if fam not in _DENSE:
            raise NotImplementedError(
                f"TTA is implemented for the dense MEH families, faster_rcnn and "
                f"cascade_rcnn (the JAX package's coverage less the mask families); "
                f"got {fam!r}")
        aug_boxes, aug_scores = [], []
        for scale, pipe in self._tta_pipelines(scales):
            for f in flips:
                s = prepare_sample(img, None, pipe, flip=f)
                key = (scale, s["orientation"])
                if key not in self._tta_steps:
                    if fam == "ssd":
                        cfg_s = dataclasses.replace(self.cfg, input_size=max(scale))
                    else:
                        cfg_s = dataclasses.replace(self.cfg, canvas=pipe.canvas)
                    self._tta_steps[key] = make_tta_candidate_step(
                        self.model, cfg_s.for_orientation(s["orientation"]))
                b, sc = self._tta_steps[key](_one(s), np.array([f], bool))
                aug_boxes.append(b)
                aug_scores.append(sc)
        dets = self._tta_merge(torch.cat(aug_boxes, dim=1), torch.cat(aug_scores, dim=1))
        return detections_to_per_class(dets, self.cfg.num_fg_classes)[0]

    def _tta_pipelines(self, scales):
        """(scale, the pipeline resizing to it into its canvas) per scale."""
        for scale in scales:
            canvas = (canvas_for_scale(scale) if self.pipeline.keep_ratio
                      else (min(scale), max(scale)))
            yield scale, dataclasses.replace(self.pipeline, img_scale=scale, canvas=canvas)

    @functools.cached_property
    def _tta2_merges(self):
        """The two-stage TTA's proposal merge and box merge (the cascade's
        class-agnostic boxes take the same mean), built on first use."""
        return make_tta_proposal_merge(self.cfg), make_tta_two_stage_merge(self.cfg)

    def _tta_two_stage(self, img: np.ndarray, scales, flips, fam: str) -> List[np.ndarray]:
        """Two-stage TTA (reference two_stage.py:184 aug_test:
        aug_test_rpn, merge_aug_proposals, then the RoI stage's
        aug_test_bboxes; JAX api.py:343-420 without its mask branch): the
        RPN per augmentation, one merged proposal set in original
        coordinates, the RoI stage per augmentation on that shared set
        (the cascade's every stage with its refinement), the boxes and
        probabilities meaned, one NMS."""
        cascade = fam == "cascade_rcnn"
        proposal_merge, box_merge = self._tta2_merges
        runs = []  # (rpn step, roi step, batch, flipped)
        for scale, pipe in self._tta_pipelines(scales):
            for f in flips:
                s = prepare_sample(img, None, pipe, flip=f)
                key = (scale, s["orientation"])
                if key not in self._tta_steps:
                    cfg_s = dataclasses.replace(self.cfg, canvas=pipe.canvas).for_orientation(
                        s["orientation"])
                    self._tta_steps[key] = (
                        make_tta_rpn_step(self.model, cfg_s),
                        (make_tta_cascade_roi_step if cascade else make_tta_roi_step)(
                            self.model, cfg_s))
                runs.append((*self._tta_steps[key], _one(s), np.array([f], bool)))
        # stage 1: the RPN per augmentation; its features stay on the device
        stage1 = [rpn(batch, fl) for rpn, _, batch, fl in runs]
        merged, merged_valid = proposal_merge(*(torch.cat([o[i] for o in stage1], dim=1)
                                                for i in (1, 2, 3)))
        # stage 2: the RoI stage per augmentation on the shared merged proposals
        outs = [roi(feats, batch, fl, merged, merged_valid)
                for (_, roi, batch, fl), (feats, _, _, _) in zip(runs, stage1)]
        dets = box_merge(torch.stack([o[0] for o in outs]),
                         torch.stack([o[1] for o in outs]), merged_valid)
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
