"""Test-time augmentation of the port (aod_meh_hua_torch/engine/tta.py and
api.py Detector.tta) against the JAX package's, on the CPU, f32.

Weights: tests/torch_parity.py jax_retinanet draws on the tiny config
and jax_ssd's thin SSD, the RetinaNet cls head sharpened (kernel x150)
so that there are detections to merge; the port loads them with
from_jax_variables.

Tolerances: canvas_for_scale and the flip geometry exact; identity TTA
(one scale, no flip) bit-equal to the port's Detector.__call__ (the same
candidates through the same NMS); the merged TTA results per class with
equal counts (the same survivors), boxes and scores to rtol 1e-4 (atol
1e-4) of JAX's Detector.tta, the sums of the two libraries' convolutions
taken in other orders. The SSD's one scale is 300 (SSD512's model is in
neither package), so its TTA is that scale and its flip.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.engine import tta as jtta
from aod_meh_hua_tpu.utils.config import SSDConfig as JSSDConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.engine import tta as ttta
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils.config import SSDConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import THIN_SSD, jax_retinanet, jax_ssd, sharpen

pytestmark = pytest.mark.usefixtures("few_threads")

SHARPEN = 150.0
SCALES = [(250, 120), (200, 100)]  # tiny canvases (128, 256) and (128, 224)


def _pipe(cls):
    return cls(img_scale=(250, 120), canvas=ttiny().canvas, device_normalize=True)


def _img(seed=0, h=100, w=200):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def shared():
    jmodel, variables = jax_retinanet()
    variables = sharpen(variables, SHARPEN)
    model = tapi.init_detector(ttiny(), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return (japi.Detector(jtiny(), jmodel, variables, pipeline=_pipe(JPipelineConfig)),
            tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig)))


def _assert_same(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"class {c}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4, err_msg=f"class {c}")


@pytest.mark.parametrize("scale", [(1000, 600), (250, 120), (200, 100), (1333, 800), (300, 300)])
def test_canvas_for_scale_matches_jax(scale):
    assert ttta.canvas_for_scale(scale) == jtta.canvas_for_scale(scale)


def test_flip_geometry_matches_jax():
    """_flip_x on random boxes, some rows flipped, against JAX's: exact;
    and its own inverse up to the rounding of w - (w - x) (1e-4 at
    coordinates below 200)."""
    rng = np.random.RandomState(0)
    boxes = (rng.rand(3, 7, 4) * 200).astype(np.float32)
    flipped = np.array([True, False, True])
    width = np.array([200, 150, 96], np.int32)
    got = ttta._flip_x(torch.from_numpy(boxes), torch.from_numpy(flipped),
                       torch.from_numpy(width))
    want = np.asarray(jtta._flip_x(boxes, flipped, width))
    np.testing.assert_array_equal(got.numpy(), want)
    back = ttta._flip_x(got, torch.from_numpy(flipped), torch.from_numpy(width))
    np.testing.assert_allclose(back.numpy(), boxes, rtol=0, atol=1e-4)


def test_flipped_candidates_mirror_the_mirrored_image(shared):
    """Candidates of (img, flip) mapped back equal the mirror, in the
    original frame, of the candidates of the mirrored image without flip:
    the network sees the same pixels, so only the mapping differs."""
    _, tdet = shared
    cfg = ttiny()
    step = ttta.make_tta_candidate_step(tdet.model, cfg)
    img = _img(2)
    w0 = img.shape[1]

    def run(image, f):
        from aod_meh_hua_torch.data.pipeline import prepare_sample
        from aod_meh_hua_torch.engine.batch import EvalBatch

        s = prepare_sample(image, None, _pipe(PipelineConfig), flip=f)
        b, sc = step(EvalBatch(s["image"][None], s["img_shape"][None], s["scale_factor"][None],
                               np.ones(1, bool)), np.array([f]))
        return b[0].numpy(), sc[0].numpy()

    b_flip, s_flip = run(img, True)
    b_mirror, s_mirror = run(np.ascontiguousarray(img[:, ::-1]), False)
    np.testing.assert_array_equal(s_flip, s_mirror)
    back = np.stack([w0 - b_mirror[:, 2], b_mirror[:, 1], w0 - b_mirror[:, 0], b_mirror[:, 3]],
                    axis=-1)
    np.testing.assert_allclose(b_flip, back, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed", [1, 3])
def test_identity_tta_is_the_plain_call(shared, seed):
    _, tdet = shared
    img = _img(seed)
    plain = tdet(img)
    tta = tdet.tta(img, scales=[(250, 120)], flip=False)
    assert sum(len(a) for a in plain) > 0
    for p, t in zip(plain, tta):
        np.testing.assert_array_equal(p, t)


@pytest.mark.parametrize("shape", [(100, 200), (180, 90)], ids=["landscape", "portrait"])
def test_multiscale_flip_tta_matches_jax(shared, shape):
    jdet, tdet = shared
    img = _img(5, *shape)
    got = tdet.tta(img, scales=SCALES, flip=True)
    want = jdet.tta(img, scales=SCALES, flip=True)
    _assert_same(got, want)
    assert sum(len(a) for a in got) > 0


def test_ssd_flip_tta_matches_jax():
    jmodel, variables = jax_ssd()
    model = tapi.init_detector(SSDConfig(**THIN_SSD), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    img = _img(4, 120, 160)
    got = tapi.Detector(SSDConfig(**THIN_SSD), model).tta(img, scales=[(300, 300)])
    want = japi.Detector(JSSDConfig(**THIN_SSD), jmodel, variables).tta(img, scales=[(300, 300)])
    _assert_same(got, want)
    assert sum(len(a) for a in got) > 0


@pytest.mark.parametrize("family,match", [
    ("dynamic_rcnn", "got 'dynamic_rcnn'"), ("double_head_rcnn", "got 'double_head_rcnn'"),
    ("mask_rcnn", "item 15"), ("fcos", "item 15"),
    ("sparse_rcnn", "does not support `aug_test`")])
def test_other_families_raise(shared, family, match):
    """The families without a TTA raise from tta: those the port has no
    model for naming the model zoo's item, Dynamic and Double-Head R-CNN
    as the JAX package does (its TTA lacks them too), Sparse R-CNN as
    the reference does. Faster and Cascade R-CNN's TTA:
    tests/test_torch_tta_two_stage.py."""
    _, tdet = shared
    det = tapi.Detector(ttiny(), tdet.model, pipeline=_pipe(PipelineConfig))
    det.cfg = SimpleNamespace(family=family, num_fg_classes=6)
    with pytest.raises(NotImplementedError, match=match):
        det.tta(_img(0))
