"""The eval step of the Faster R-CNN variants on the port's trunk
(aod_meh_hua_torch: Libra R-CNN, PAFPN, CARAFE, GRoIE and empirical
attention through engine/two_stage.py TwoStageEvalStep) against the JAX
package's make_faster_rcnn_eval_step, on the CPU, f32; GRoIE's
extraction alone and its exported eval step (the other families':
tests/test_torch_export_rcnn_variants.py).

Each family's models share one JAX variables draw of its tiny config
(tests/torch_parity.py two_stage_pair: the RPN and class heads
sharpened, every attention block's gamma, key_bias and geom_bias
non-zero) carried over with from_jax_variables.

Tolerances: the detections as tests/test_torch_two_stage.py holds Faster
R-CNN's (the same valid slots, labels and sources, scores rtol 1e-4,
boxes rtol 1e-4 with atol 1e-3 px); GRoIE's extraction rtol 1e-5 with
atol 1e-5 of its max-abs (RoIAlign's atol, tests/test_torch_two_stage.py);
the exported program bit-equal to the eager step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.utils import config as tcfg
from test_torch_export_rcnn_variants import exported_equals_eager
from torch_parity import two_stage_batch, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("libra_rcnn", "pafpn", "carafe", "groie", "empirical_attention")


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_eval_step_matches_jax(family):
    """The eval step's NMSResult on four images with their own scale
    factors: the same valid slots, labels and sources, rtol 1e-4."""
    jmodel, variables, model = two_stage_pair(family)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](), tcfg.ZOO_FAMILIES[family][1]()
    arrays = two_stage_batch(jc, seed=1)
    images = np.concatenate([arrays[0], two_stage_batch(jc, seed=2)[0]])
    shapes = np.concatenate([arrays[5], arrays[5]])
    sf = np.repeat(np.array([[1.0], [1.5], [0.7], [1.25]], np.float32), 4, axis=1)
    batch = (images, shapes, sf, np.ones(4, bool))
    want = jts.make_faster_rcnn_eval_step(jmodel, jc)(
        variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tts.make_two_stage_eval_step(model, tc, device="cpu")(TEvalBatch(*batch))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)
    assert got.valid.sum() > 20


def _t(a):
    return torch.from_numpy(np.array(a))


def test_groie_extraction_matches_jax():
    """Every RoI on every level at 1 / stride (RoIs of all sizes, some
    past the border), the shared pre-conv, the sum and the attention."""
    jmodel, variables, model = two_stage_pair("groie")
    jc, tc = jcfg.tiny_groie_config(), tcfg.tiny_groie_config()
    rng = np.random.RandomState(12)
    feats = [rng.randn(2, 64 // s, 128 // s, 16).astype(np.float32) for s in (4, 8, 16, 32, 64)]
    xy = rng.uniform(-8, 120, (2, 30, 2))
    rois = np.concatenate([xy, xy + np.exp(rng.uniform(np.log(2), np.log(100), (2, 30, 2)))],
                          -1).astype(np.float32)
    want = jts._extract_rois_groie(jmodel, variables, jc, [jnp.asarray(f) for f in feats],
                                   jnp.asarray(rois))
    with torch.no_grad():
        got = tts.extract_rois_groie(model, tc, [_t(f).permute(0, 3, 1, 2) for f in feats],
                                     _t(rois))
    assert got.shape == (60, 7, 7, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_exported_groie_equals_the_eager_step(orientation):
    exported_equals_eager("groie", orientation)
