"""The train steps of the Faster R-CNN variants on the port's trunk
(aod_meh_hua_torch: Libra R-CNN, PAFPN and CARAFE through
engine/two_stage.py's Faster R-CNN step; GRoIE's and empirical
attention's, by the same rules, in tests/test_torch_rcnn_attention_steps.py)
against the JAX package's, on the CPU, f32.

Each family's models share one JAX variables draw of its tiny config
(tests/torch_parity.py two_stage_pair: the RPN and class heads
sharpened, every attention block's gamma, key_bias and geom_bias
non-zero) carried over with from_jax_variables. The samplers of both
packages run on JAX's own uniforms, drawn from the key tree the JAX step
splits (torch_parity.jax_step_uniforms: Libra's RoI sampler takes
seven).

Tolerances: two SGD steps from the shared weights on one batch, the aux
values rtol 1e-5 (num_pos exact) and every tensor after each step within
1e-4 of its max-abs of JAX's. The eval steps: tests/test_torch_rcnn_variant_eval.py
(each JAX train step's compile takes 8-18 s, so the families' steps are
split between two files).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.train import create_train_state as tcreate_state
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_step_uniforms, two_stage_batch, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("libra_rcnn", "pafpn", "carafe")
STEPS = 2


@functools.lru_cache(maxsize=None)
def _train(family):
    """STEPS SGD steps in each package from the shared weights on one
    batch, the port's samplers on JAX's draws: per step (JAX aux, port
    aux, JAX params as a port state_dict, port state_dict)."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    jmodel, variables, _ = two_stage_pair(family)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](), tcfg.ZOO_FAMILIES[family][1]()
    arrays = two_stage_batch(jc, seed=1)
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=jc.frozen_stages)
    state = jax.device_put(state, jax.devices()[0])
    jstep = jts.make_faster_rcnn_train_step(jmodel, jc, tx)
    model = tmodels.build_two_stage(tc, device="cpu")
    tapi.load_weights(model, from_jax_variables(variables))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcreate_state(model, tcfg.TrainConfig(batch_size=2), frozen_stages=tc.frozen_stages)
    tstep = tts.make_two_stage_train_step(model, tc, opt, device="cpu")
    n_anchor = tc.level_bounds()[-1][1]
    n_roi = tc.max_gt + tc.rpn.train_max_per_img
    out = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(40 + i)
        state, jaux = jstep(state, JBatch(*(jnp.asarray(a) for a in arrays)), key)
        taux = tstep(TBatch(*arrays), uniforms=jax_step_uniforms(key, 2, n_anchor, n_roi,
                                                                 tts.roi_draws(tc)))
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": variables["batch_stats"]})
        out.append(({k: float(v) for k, v in jaux.items()}, {k: float(v) for k, v in taux.items()},
                    want, {k: v.clone() for k, v in model.state_dict().items()}))
    return initial, out


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_losses_match_jax(family):
    losses_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_params_match_jax(family):
    params_match_jax(family)


def losses_match_jax(family):
    """The aux values of each step: rtol 1e-5, num_pos exact."""
    _, out = _train(family)
    for i, (jaux, taux, _, _) in enumerate(out):
        assert set(taux) == set(jaux) == {"loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                          "loss_bbox", "num_pos"}
        assert taux["num_pos"] == jaux["num_pos"] > 0, i
        for name in jaux:
            np.testing.assert_allclose(taux[name], jaux[name], rtol=1e-5,
                                       err_msg=f"step {i} {name}")
        assert np.isfinite(taux["loss"])


def params_match_jax(family):
    """After each step every tensor within 1e-4 of its max-abs of JAX's;
    the frozen stem and layer1 unchanged; the family's own modules moved."""
    initial, out = _train(family)
    for i, (_, _, want, got) in enumerate(out):
        assert set(got) == set(want)
        for name, w in want.items():
            scale = max(w.abs().max().item(), 1e-12)
            err = (got[name] - w).abs().max().item()
            assert err <= 1e-4 * scale, (i, name, err, scale)
    final = out[-1][3]
    assert torch.equal(final["backbone.conv1.weight"], initial["backbone.conv1.weight"])
    own = {"libra_rcnn": "bfp.refine.", "pafpn": "neck.downsample_convs.",
           "carafe": "neck.carafe.", "groie": "groie_post.",
           "empirical_attention": "backbone.layer3.0.gen_attention."}[family]
    moved = [k for k in final if k.startswith(own) and not torch.equal(final[k], initial[k])]
    assert moved, own
