"""The RPN-only and Fast R-CNN families (aod_meh_hua_torch:
utils/config.py, models/rpn_only.py, engine/rpn_only.py, data/loader.py's
proposals) against the JAX package's, on the CPU, f32; the configs of
all five proposal families and the registry.

Each family's models share one JAX variables draw of its tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads
sharpened) carried over with from_jax_variables; the samplers of both
packages run on JAX's own draws (torch_parity.jax_family_uniforms: one
key per image, (kp, kn) in the sampler).

Tolerances: configs equal field by field; forwards within 1e-4 of each
output's max-abs; two SGD steps from the shared weights, the aux values
rtol 1e-4 (num_pos exact) and every tensor after each step within 1e-4
of its max-abs of JAX's; the eval steps' valid slots, labels and slots
equal, scores and boxes rtol 1e-4 (boxes atol 1e-4 px); the proposal
transforms, the padding, AR@100 and the loader's ProposalBatch equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.data import loader as jloader
from aod_meh_hua_tpu.data.pipeline import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data.voc import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import rpn_only as jrpn
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.data import loader as tloader
from aod_meh_hua_torch.data.pipeline import PipelineConfig, load_image, prepare_sample
from aod_meh_hua_torch.data.voc import VOCDataset
from aod_meh_hua_torch.engine import rpn_only as trpn
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.utils import config as tcfg
from test_data import make_voc
from torch_parity import jax_two_stage, proposal_batch, two_stage_batch
from torch_proposal_parity import (losses_match_jax, max_abs_rel, params_match_jax,
                                   port_model)
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

CLASSES = {"rpn": "RPNOnlyConfig", "cascade_rpn": "CascadeRPNConfig",
           "tridentnet": "TridentNetConfig", "fast_rcnn": "FastRCNNConfig",
           "grid_rcnn": "GridRCNNConfig"}


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# --- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("family", list(CLASSES))
def test_config_fields_equal_jax(family):
    """Every field of the JAX dataclass equal in the port's (which adds the
    Faster R-CNN variants' switches at their defaults), the full and tiny
    configs, the anchors' geometry and num_fg_classes."""
    name = CLASSES[family]
    j, t = _defaults(getattr(jcfg, name)), _defaults(getattr(tcfg, name))
    assert set(j) <= set(t)
    for k, v in j.items():
        assert _value(t[k]) == _value(v), k
    assert getattr(tcfg, name).family == getattr(jcfg, name).family == family
    (tfull, ttiny), (jfull, jtiny) = tcfg.ZOO_FAMILIES[family], jcfg.ZOO_FAMILIES[family]
    assert tfull is getattr(tcfg, name)
    for tc, jc in ((tfull(), jfull()), (ttiny(), jtiny())):
        got = dataclasses.asdict(tc)
        assert {k: got[k] for k in dataclasses.asdict(jc)} == dataclasses.asdict(jc)
        assert tc.featmap_sizes() == jc.featmap_sizes()
        assert tc.level_bounds() == jc.level_bounds()
        assert tc.num_fg_classes == jc.num_fg_classes
        np.testing.assert_array_equal(tts.anchor_table(tc), np.concatenate(
            jc.build_anchor_generator().grid_anchors(jc.featmap_sizes())).astype(np.float32))


def test_registry_holds_the_five_in_the_jax_order():
    assert len(tcfg.ZOO_FAMILIES) == 19
    assert list(tcfg.ZOO_FAMILIES) == [f for f in jcfg.ZOO_FAMILIES if f in tcfg.ZOO_FAMILIES]
    assert set(CLASSES) <= set(tcfg.ZOO_FAMILIES) and "detectors" not in tcfg.ZOO_FAMILIES
    assert set(tmodels.TWO_STAGE_FAMILIES) == set(tts.TRAIN_STEPS) == set(tcfg.ZOO_FAMILIES)


# --- models ----------------------------------------------------------------------

def test_rpn_forward_matches_jax():
    jmodel, variables = jax_two_stage("rpn")
    jc = jcfg.tiny_rpn_config()
    images = two_stage_batch(jc, seed=1)[0]
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    model = port_model("rpn", variables)
    with torch.no_grad():
        _, cls, reg = model(torch.from_numpy(images))
    assert max_abs_rel(cls, want[0]) < 1e-4 and max_abs_rel(reg, want[1]) < 1e-4
    assert not hasattr(model, "bbox_head")


def test_fast_rcnn_forward_matches_jax():
    """The FPN levels and the box head on the JAX module's zero RoIs, and
    the head on random RoI features; no RPN head in either tree."""
    jmodel, variables = jax_two_stage("fast_rcnn")
    jc = jcfg.tiny_fast_rcnn_config()
    images = two_stage_batch(jc, seed=1)[0]
    feats, (jcls, jreg) = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    model = port_model("fast_rcnn", variables)
    assert model.rpn_head is None and "rpn_head" not in variables["params"]
    rois = np.random.RandomState(0).randn(5, 7, 7, jc.fpn_channels).astype(np.float32)
    wcls, wreg = jmodel.apply(variables, jnp.asarray(rois), method=lambda m, r: m.roi_forward(r))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
        for g, w in zip(got, feats):
            assert max_abs_rel(g.permute(0, 2, 3, 1), w) < 1e-4
        cls, reg = model.roi_forward(torch.from_numpy(rois))
    assert max_abs_rel(cls, wcls) < 1e-4 and max_abs_rel(reg, wreg) < 1e-4


# --- train steps -----------------------------------------------------------------

def test_rpn_train_steps_match_jax():
    losses_match_jax("rpn")
    params_match_jax("rpn", "rpn_head.rpn_conv.weight")


def test_fast_rcnn_train_steps_match_jax():
    losses_match_jax("fast_rcnn")
    params_match_jax("fast_rcnn", "bbox_head.fc_cls.weight")


# --- eval steps and proposal recall ----------------------------------------------

def _eval_batch(jc):
    arrays = two_stage_batch(jc, seed=1)
    images = np.concatenate([arrays[0], two_stage_batch(jc, seed=2)[0]])
    shapes = np.concatenate([arrays[5], arrays[5]])
    sf = np.repeat(np.array([[1.0], [1.5], [0.7], [1.25]], np.float32), 4, axis=1)
    return images, shapes, sf, np.ones(4, bool)


def dets_match(got, want, n_min):
    """The same valid slots, labels and slots; scores rtol 1e-4, boxes
    rtol 1e-4 and atol 1e-4 px."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)
    assert got.valid.sum() >= n_min


def test_rpn_eval_and_recall_match_jax():
    """The proposals of four images with their own scale factors as a
    one-class ProposalResult, and AR@100 against boxes of each image."""
    jmodel, variables = jax_two_stage("rpn")
    jc, tc = jcfg.tiny_rpn_config(), tcfg.tiny_rpn_config()
    batch = _eval_batch(jc)
    want = jrpn.make_rpn_eval_step(jmodel, jc)(variables,
                                               JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tts.make_two_stage_eval_step(port_model("rpn", variables), tc, "cpu")(
        TEvalBatch(*batch))
    assert type(got) is trpn.ProposalResult and not got.labels.any()
    dets_match(got, want, 4 * tc.rpn.test_max_per_img)
    rng = np.random.RandomState(3)
    gts = [np.asarray(want.boxes[i][:6]) + rng.randn(6, 4).astype(np.float32) * 4
           for i in range(4)] + [np.zeros((0, 4), np.float32)]
    boxes = [b.numpy() for b in got.boxes] + [np.zeros((0, 4), np.float32)]
    valid = [v.numpy() for v in got.valid] + [np.zeros(0, bool)]
    for top_k in (100, 3):
        ar = trpn.proposal_recall(boxes, valid, gts, top_k=top_k)
        assert ar == jrpn.proposal_recall(boxes, valid, gts, top_k=top_k)
    assert 0 < trpn.proposal_recall(boxes, valid, gts) <= 1


def test_fast_rcnn_eval_matches_jax():
    """The eval on canvas-coordinate proposals with prop_valid (four slots
    of the second image invalid), four images with their own scales."""
    jmodel, variables = jax_two_stage("fast_rcnn")
    jc, tc = jcfg.tiny_fast_rcnn_config(), tcfg.tiny_fast_rcnn_config()
    batch = _eval_batch(jc)
    pa, pb = proposal_batch(jc, seed=1), proposal_batch(jc, seed=2)
    props, pvalid = np.concatenate([pa[5], pb[5]]), np.concatenate([pa[6], pb[6]])
    want = jrpn.make_fast_rcnn_eval_step(jmodel, jc)(
        variables, JEvalBatch(*(jnp.asarray(a) for a in batch)), jnp.asarray(props),
        jnp.asarray(pvalid))
    model = port_model("fast_rcnn", variables)
    got = trpn.make_fast_rcnn_eval_step(model, tc, "cpu")(TEvalBatch(*batch), props, pvalid)
    dets_match(got, want, 20)
    with pytest.raises(ValueError, match="external proposals"):
        tts.make_two_stage_eval_step(model, tc, "cpu")


# --- the loader's proposals ------------------------------------------------------

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    base, lst, _ = make_voc(str(tmp_path_factory.mktemp("pvoc")), "VOC2007", n=6, seed=0)
    return base, lst


def _props_of(i):
    rng = np.random.RandomState(i)
    xy = rng.uniform(0, 300, (7, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 200, (7, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
def test_transform_proposals_follows_the_gts(voc, flip):
    """A proposal equal to a gt box comes out as the transformed gt box, in
    both orientations (landscape and portrait canvases), flipped or not;
    every proposal as JAX's transform_proposals takes it."""
    base, lst = voc
    ds = VOCDataset(lst, base)
    pipe = PipelineConfig(flip_ratio=1.0 if flip else 0.0)
    orients = set()
    for i in range(len(ds)):
        img, ann = load_image(ds.img_path(i)), ds.get_ann_info(i)
        # the image and its boxes transposed: the other orientation
        turned = {**ann, "bboxes": ann["bboxes"][:, [1, 0, 3, 2]]}
        for im, an in ((img, ann), (np.ascontiguousarray(img.transpose(1, 0, 2)), turned)):
            s = prepare_sample(im, an, pipe, rng=np.random.RandomState(i))
            orients.add(s["orientation"])
            ann = an
            props = np.concatenate([ann["bboxes"], _props_of(i)])
            got = tloader.transform_proposals(props, s)
            np.testing.assert_allclose(got[:len(ann["bboxes"])], s["gt_bboxes"], atol=1e-4)
            np.testing.assert_array_equal(got, jloader.transform_proposals(props, s))
            assert s["flipped"] == flip
    assert orients == {"landscape", "portrait"}


def test_pad_proposals_equals_jax():
    plist = [_props_of(0), _props_of(1)[:3], np.zeros((0, 4), np.float32)]
    for slots in (5, 8):
        got, want = tloader._pad_proposals(plist, slots), jloader._pad_proposals(plist, slots)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_train_loader_proposal_batches_equal_jax(voc):
    """TrainLoader(proposal_source=...) yields ProposalBatch, bit-equal to
    the JAX loader's over one epoch with flips."""
    base, lst = voc
    jc, tc = jcfg.tiny_fast_rcnn_config(num_proposals=9), tcfg.tiny_fast_rcnn_config(
        num_proposals=9)
    kw = dict(img_scale=(128, 60), canvas=tc.canvas, device_normalize=True)
    got = list(tloader.TrainLoader(VOCDataset(lst, base), np.arange(6), tc,
                                   PipelineConfig(**kw), batch_size=2, seed=4, prefetch=False,
                                   proposal_source=_props_of))
    want = list(jloader.TrainLoader(JVOCDataset(lst, base), np.arange(6), jc,
                                    JPipelineConfig(**kw), batch_size=2, seed=4,
                                    prefetch=False, proposal_source=_props_of))
    assert len(got) == len(want) >= 3
    for (go, gb), (wo, wb) in zip(got, want):
        assert go == wo and type(gb) is trpn.ProposalBatch and gb._fields == wb._fields
        for name, g, w in zip(wb._fields, gb, wb):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert all((b.prop_valid.sum(1) == 7).all() for _, b in got)


def test_with_masks_still_raises(voc):
    base, lst = voc
    with pytest.raises(NotImplementedError, match="item 15.4"):
        tloader.TrainLoader(VOCDataset(lst, base), [0], tcfg.tiny_fast_rcnn_config(),
                            PipelineConfig(canvas=(64, 128)), batch_size=2, with_masks=True)
    assert os.path.exists(lst)
