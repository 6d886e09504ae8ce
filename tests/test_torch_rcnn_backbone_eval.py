"""The eval step of the rest of Faster R-CNN's config variants on the
port's trunk (aod_meh_hua_torch: PISA, GN+WS, ResNeSt, HRNet, FPG, and
the backbone_type switches ResNeXt, Res2Net and RegNet, through
engine/two_stage.py TwoStageEvalStep) against the JAX package's
make_faster_rcnn_eval_step (PISA's eval is Faster R-CNN's, with 2000
proposals), on the CPU, f32.

Each case's models share one JAX variables draw of its tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads sharpened)
carried over with from_jax_variables.

Tolerances: the detections as tests/test_torch_rcnn_variant_eval.py holds
the other variants' (the same valid slots, labels and sources, scores
rtol 1e-4, boxes rtol 1e-4 with atol 1e-3 px).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.api import load_weights
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.two_stage import build_two_stage
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_two_stage, two_stage_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

CASES = {"pisa_faster_rcnn": ("pisa_faster_rcnn", {}), "gn_ws": ("gn_ws", {}),
         "resnest": ("resnest", {}), "hrnet": ("hrnet", {}), "fpg": ("fpg", {}),
         "resnext": ("faster_rcnn", {"backbone_type": "resnext"}),
         "res2net": ("faster_rcnn", {"backbone_type": "res2net"}),
         "regnet": ("faster_rcnn", {"backbone_type": "regnet", "regnet_arch": "regnetx_400mf"})}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_matches_jax(case):
    """The eval step's NMSResult on four images with their own scale
    factors: the same valid slots, labels and sources, rtol 1e-4."""
    family, over = CASES[case]
    jmodel, variables = jax_two_stage(family, **over)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](**over), tcfg.ZOO_FAMILIES[family][1](**over)
    model = build_two_stage(tc, device="cpu")
    load_weights(model, from_jax_variables(variables))
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
