"""Grid R-CNN (aod_meh_hua_torch: models/grid_rcnn.py,
engine/grid_rcnn.py) against the JAX package's, on the CPU, f32; the
train steps in tests/test_torch_grid_rcnn_steps.py.

The models share one JAX variables draw of the tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads
sharpened), the grid head's per-point deconvs carried over flipped into
torch's ConvTranspose2d layout (models/convert.py). The samplers and the
jitter run on JAX's own draws: k_rpn, k_roi, k_jit = split(key, 3), each
split per image (torch_parity.jax_family_uniforms).

Tolerances: the sub-regions, neighbourhoods, grid targets and sampled
RoIs exact; the jitter offsets rtol 1e-6 and the jittered boxes rtol
1e-6 (atol 1e-4 px); the head within 1e-4 of each output's max-abs;
the eval's NMS survivors, their scores and their refined boxes rtol 1e-4
(boxes atol 1e-4 px), with the heatmaps' argmax ties taken at the first
index in both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import grid_rcnn as jgrid
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.models import grid_rcnn as jmodels
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import grid_rcnn as tgrid
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.models import grid_rcnn as tmodels
from aod_meh_hua_torch.utils import config as tcfg
from test_torch_rpn_fast_rcnn import _eval_batch, dets_match
from torch_parity import jax_family_uniforms, jax_two_stage, two_stage_batch
from torch_proposal_parity import max_abs_rel, port_model
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

TC, JC = tcfg.tiny_grid_rcnn_config(), jcfg.tiny_grid_rcnn_config()
WHOLE = TC.grid_roi_size * 4


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sub_regions_and_neighbors_equal_jax():
    for gs in (2, 3, 4):
        assert tmodels.grid_neighbors(gs) == jmodels.grid_neighbors(gs)
        assert (tmodels.calc_sub_regions(gs * gs, gs, WHOLE)
                == jmodels.calc_sub_regions(gs * gs, gs, WHOLE))
    np.testing.assert_array_equal(tgrid.grid_point_factors(9, 3), jgrid._grid_point_factors(9, 3))


def _boxes(rng, n, lo=0.0, hi=100.0):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 50, (n, 2))], 1).astype(np.float32)


def test_grid_targets_match_jax():
    """Jittered boxes around their gts (some smaller than the grid): the
    per-point discs in the sub-regions and the roi_ok mask, batched."""
    rng = np.random.RandomState(0)
    gts = _boxes(rng, 2 * 30).reshape(2, 30, 4)
    boxes = (gts + rng.randn(2, 30, 4) * 4).astype(np.float32)
    boxes[:, :3, 2:] = boxes[:, :3, :2] + 1.2
    got, ok = tgrid.grid_targets(_t(boxes), _t(gts), 9, WHOLE, 1)
    for i in range(2):
        want, wok = jgrid.grid_targets(jnp.asarray(boxes[i]), jnp.asarray(gts[i]), 9, WHOLE, 1)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(wok))
    assert got.sum() > 0 and not ok[:, :3].any()


def test_jitter_matches_jax():
    """jitter_offsets of the [0, 1) draws of each image's key are JAX's
    uniform(-0.15, 0.15) of that key, and the jittered boxes, clipped to
    the image less one, _jitter_boxes'."""
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 2 * 20, hi=120).reshape(2, 20, 4)
    shapes = np.array([[64, 128], [56, 104]], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    u = _t(np.stack([np.asarray(jax.random.uniform(k, (20, 4))) for k in keys]))
    off = tgrid.jitter_offsets(u)
    got = tgrid.jitter_boxes(off, _t(boxes), _t(shapes))
    for i, k in enumerate(keys):
        np.testing.assert_allclose(off[i].numpy(), np.asarray(
            jax.random.uniform(k, (20, 4), minval=-0.15, maxval=0.15)), rtol=1e-6, atol=1e-7)
        want = jgrid._jitter_boxes(k, jnp.asarray(boxes[i]), jnp.asarray(shapes[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    assert (got[..., 2] <= torch.from_numpy(shapes[:, 1:2] - 1.0)).all()


def test_grid_head_matches_jax():
    """The grid head in training (the fused and the unfused heatmaps) and
    at eval, from the JAX draw: the GN convs, both neighbour fusions and
    the per-point deconvs."""
    jmodel, variables = jax_two_stage("grid_rcnn")
    x = np.random.RandomState(2).randn(5, 14, 14, TC.fpn_channels).astype(np.float32)
    run = jax.jit(lambda v, a, t: jmodel.apply(v, a, t, method=lambda m, f, tr: m.grid(f, tr)),
                  static_argnums=2)
    model = port_model("grid_rcnn", variables)
    for train in (True, False):
        want = run(variables, jnp.asarray(x), train)
        with torch.no_grad():
            got = model.grid(_t(x), train)
        assert got[0].shape == (5, 28, 28, 9)
        for g, w in zip(got, want):
            assert max_abs_rel(g, w) < 1e-4
    assert sum(1 for n in model.grid_head.state_dict() if n.startswith("deconv")) == 36


def test_roi_sampler_and_jitter_of_the_step_match_jax():
    """The step's RoI sampler (the gts prepended) on JAX's k_roi draws and
    the jitter on its k_jit draws: the sampled RoIs index for index, the
    jittered boxes as JAX's."""
    arrays = two_stage_batch(JC, seed=1)
    _, gtb, gtl, gtv, _, shapes = arrays
    rng = np.random.RandomState(3)
    p = TC.rpn.train_max_per_img
    props = np.stack([np.concatenate([gtb[i][gtv[i]] + rng.randn(gtv[i].sum(), 4) * 2,
                                      _boxes(rng, p - gtv[i].sum(), hi=80)]) for i in range(2)]
                     ).astype(np.float32)
    pv = np.ones((2, p), bool)
    key = jax.random.PRNGKey(11)
    _, k_roi, k_jit = jax.random.split(key, 3)
    want = jax.jit(jax.vmap(lambda *a: jts._roi_sample_single(*a, cfg=JC)))(
        jax.random.split(k_roi, 2), jnp.asarray(props), jnp.asarray(pv), jnp.asarray(gtb),
        jnp.asarray(gtl), jnp.asarray(gtv))
    uniforms = jax_family_uniforms("grid_rcnn", key, TC, 2)
    got = tts.roi_sample(uniforms("roi", TC.max_gt + p, 2), _t(props), _t(pv), _t(gtb),
                         _t(gtl), _t(gtv), TC)
    for name in ("rois", "labels", "is_pos", "valid", "gt_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    s = TC.rcnn.sampler_num
    jit = tgrid.jitter_boxes(tgrid.jitter_offsets(uniforms("jitter", s * 4, 1)[0].reshape(
        2, s, 4)), got.rois, _t(shapes))
    wjit = jax.vmap(jgrid._jitter_boxes)(jax.random.split(k_jit, 2), want.rois,
                                         jnp.asarray(shapes))
    np.testing.assert_allclose(jit.numpy(), np.asarray(wjit), rtol=1e-6, atol=1e-4)
    assert got.is_pos.sum() > 0


@functools.lru_cache(maxsize=None)
def _jax_eval(jmodel):
    """One JAX eval step (one compile) for both cases."""
    return jgrid.make_grid_rcnn_eval_step(jmodel, JC)


@pytest.mark.parametrize("tied", [False, True])
def test_eval_matches_jax(tied):
    """Four images with their own scale factors: the cls-only scores, the
    multiclass NMS on the proposals and the boxes refined by the grid's
    boundary voting. `tied`: every last deconv's weight zero, so that each
    point's heatmap is its bias everywhere and the argmax takes the first
    index of the tie in both packages."""
    jmodel, variables = jax_two_stage("grid_rcnn")
    if tied:
        params = dict(variables["params"])
        head = dict(params["grid_head"])
        for i in range(TC.grid_points):
            head[f"deconv2_{i}"] = {**head[f"deconv2_{i}"], "kernel": np.zeros_like(
                head[f"deconv2_{i}"]["kernel"])}
        params["grid_head"] = head
        variables = {**variables, "params": params}
    batch = _eval_batch(JC)
    want = _jax_eval(jmodel)(variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    model = port_model("grid_rcnn", variables)
    got = tts.make_two_stage_eval_step(model, TC, "cpu")(TEvalBatch(*batch))
    dets_match(got, want, 20)
    if tied:  # each point's heatmap one value: the argmax is a tie of all cells
        with torch.no_grad():
            heat = model.grid(torch.randn(3, 14, 14, TC.fpn_channels))[0]
        assert (heat == heat[:, :1, :1, :]).all()
