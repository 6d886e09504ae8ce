"""The port's two-stage test-time augmentation (aod_meh_hua_torch:
engine/tta.py make_tta_rpn_step, make_tta_proposal_merge,
make_tta_roi_step, make_tta_cascade_roi_step and the merges; api.py
Detector.tta and _tta_two_stage) against the JAX package's
api.Detector.tta, on the CPU, f32, for Faster and Cascade R-CNN; and the
families whose TTA raises.

Weights: tests/torch_parity.py jax_two_stage draws on the tiny configs
(the RPN and class heads sharpened), carried over with
from_jax_variables. Each image goes through two scales (the tiny
canvas's (128, 64) and a smaller (96, 48), a canvas of its own) with
and without the flip: the RPN per augmentation, one merged proposal
set, the RoI stage per augmentation on it, the mean, one NMS.

Tolerances: the per-class detections rtol 1e-4 (atol 1e-3 on boxes in
pixels), the same number of rows per class; the steps' pieces, fed the
same inputs, rtol 1e-5.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import tta as jtta
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.engine.batch import EvalBatch
from aod_meh_hua_torch.engine import tta as ttta
from aod_meh_hua_torch.engine.two_stage import extract_rois
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_two_stage
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

SCALES = [(128, 64), (96, 48)]


def _img(seed, h=70, w=110):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _detectors(family):
    jmodel, variables = jax_two_stage(family)
    cfg_t, cfg_j = tcfg.ZOO_FAMILIES[family][1](), jcfg.ZOO_FAMILIES[family][1]()
    model = tapi.init_detector(cfg_t, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    kw = dict(img_scale=SCALES[0], canvas=cfg_t.canvas, device_normalize=True)
    return (tapi.Detector(cfg_t, model, pipeline=PipelineConfig(**kw)),
            japi.Detector(cfg_j, jmodel, variables, pipeline=JPipelineConfig(**kw)))


def _assert_same(got, want):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"class {c}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=1e-4, err_msg=f"class {c}")
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-4, atol=1e-3,
                                   err_msg=f"class {c}")


@pytest.mark.parametrize("family", ["faster_rcnn", "cascade_rcnn"])
def test_two_stage_tta_matches_jax(family):
    """Two scales with the flip, on a landscape and a portrait image: the
    port's Detector.tta gives JAX's detections; without augmentation the
    TTA is one pass of the same stages."""
    tdet, jdet = _detectors(family)
    n_rows = 0
    for seed, (h, w) in ((0, (70, 110)), (1, (90, 60))):
        img = _img(seed, h, w)
        got = tdet.tta(img, scales=SCALES, flip=True)
        _assert_same(got, jdet.tta(img, scales=SCALES, flip=True))
        n_rows += sum(len(a) for a in got)
    assert n_rows > 10
    one = tdet.tta(_img(0), scales=SCALES[:1], flip=False)
    _assert_same(one, jdet.tta(_img(0), scales=SCALES[:1], flip=False))


def test_cascade_tta_averages_logits_then_probabilities():
    """The cascade's RoI step averages the stages' raw LOGITS under one
    softmax (its probabilities are not the mean of three softmaxes); the
    merge then MEANS the augmentations' probabilities and boxes. Both
    against the JAX steps on the same inputs."""
    tdet, jdet = _detectors("cascade_rcnn")
    cfg_t, cfg_j = tdet.cfg, jdet.cfg
    model = tdet.model
    rng = np.random.RandomState(3)
    img = rng.randn(1, 64, 128, 3).astype(np.float32)
    batch = (img, np.array([[60, 120]], np.int32), np.full((1, 4), 1.2, np.float32),
             np.ones(1, bool))
    flipped = np.array([True])
    t_rpn = ttta.make_tta_rpn_step(model, cfg_t)
    feats, props, scores, valid = t_rpn(EvalBatch(*batch), flipped)
    jb = JEvalBatch(*(jnp.asarray(a) for a in batch))
    jfeats, jprops, jscores, jvalid = jtta.make_tta_rpn_step(jdet.model, cfg_j)(
        jdet.variables, jb, jnp.asarray(flipped))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(props.numpy(), np.asarray(jprops), rtol=1e-5, atol=1e-3)
    merged, mvalid = ttta.make_tta_proposal_merge(cfg_t)(props, scores, valid)
    boxes, probs = ttta.make_tta_cascade_roi_step(model, cfg_t)(feats, EvalBatch(*batch),
                                                               flipped, merged, mvalid)
    jboxes, jprobs = jtta.make_tta_cascade_roi_step(jdet.model, cfg_j)(
        jdet.variables, jfeats, jb, jnp.asarray(flipped), jnp.asarray(merged.numpy()),
        jnp.asarray(mvalid.numpy()))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    # three stage softmaxes averaged would differ: the logits are averaged first
    with torch.no_grad():
        into = ttta._into_aug(merged, EvalBatch(*(torch.from_numpy(a) for a in batch)),
                              torch.from_numpy(flipped))
        first = torch.softmax(model.roi_forward(extract_rois(cfg_t, feats, into), 0)[0], -1)
    assert not torch.allclose(first.reshape(probs.shape), probs, rtol=1e-3)
    two = torch.stack([probs, probs.flip(1)])
    dets = ttta.make_tta_two_stage_merge(cfg_t)(torch.stack([boxes, boxes]), two, mvalid)
    jdets = jtta.make_tta_cascade_merge(cfg_j)(jnp.asarray(np.stack([boxes.numpy()] * 2)),
                                               jnp.asarray(two.numpy()),
                                               jnp.asarray(mvalid.numpy()))
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(jdets.scores), rtol=1e-5)


@pytest.mark.parametrize("family,match", [
    ("dynamic_rcnn", "got 'dynamic_rcnn'"), ("double_head_rcnn", "got 'double_head_rcnn'"),
    ("mask_rcnn", "item 15"), ("htc", "item 15"), ("sparse_rcnn", "does not support")])
def test_tta_raises_where_jax_has_none(family, match):
    """Dynamic and Double-Head R-CNN have no TTA in the JAX package either
    (its list at api.py:296), and raise as it does; the mask families,
    with their masks, wait for their port; Sparse R-CNN raises as the
    reference does."""
    cfg = tcfg.tiny_faster_rcnn_config()
    det = tapi.Detector(cfg, tapi.init_detector(cfg, device="cpu"),
                        pipeline=PipelineConfig(img_scale=SCALES[0], canvas=cfg.canvas,
                                                device_normalize=True))
    if family in tcfg.ZOO_FAMILIES:
        det.cfg = tcfg.ZOO_FAMILIES[family][1]()
    else:
        det.cfg = SimpleNamespace(family=family, num_fg_classes=6)
    with pytest.raises(NotImplementedError, match=match):
        det.tta(_img(0), return_masks=family == "mask_rcnn")
