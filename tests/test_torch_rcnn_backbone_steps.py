"""The train steps of Faster R-CNN's other backbones and necks on the port's
trunk (aod_meh_hua_torch: HRNet + HRFPN here; ResNeSt and GN+WS,
FPG, PISA and the backbone_type switches in the files that import
train_against_jax) through engine/two_stage.py's steps, against the JAX
package's, on the CPU, f32.

Each case's models share one JAX variables draw of its tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads sharpened)
carried over with from_jax_variables. The samplers of both packages run
on JAX's own uniforms, drawn from the key tree the JAX step splits
(torch_parity.jax_step_uniforms; PISA's RoI sampler takes three).

Tolerances: two SGD steps from the shared weights on one batch, the aux
values rtol 1e-5 (num_pos exact) and every tensor after each step within
1e-4 of its max-abs of JAX's; the frozen stem and layer1 unmoved (each
JAX compile of a train step takes 8-18 s, so the cases are split over
files of at most 60 s).
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
from aod_meh_hua_torch.engine.train import frozen_mask
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_step_uniforms, jax_two_stage, two_stage_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

STEPS = 2
# a tensor of each case's own modules, which the steps must move
OWN = {"hrnet": "backbone.stage4_module0.fuse3_0_conv0.weight",
       "resnest": "backbone.layer2.0.conv2.fc1.weight",
       "gn_ws": "bbox_head.shared_conv_0.weight", "fpg": "neck.s4_l4_across_skip.conv.weight",
       "pisa_faster_rcnn": "bbox_head.fc_cls.weight",
       "resnext": "backbone.layer2.0.conv2.weight", "res2net": "backbone.layer2.0.conv2_1.weight",
       "regnet": "backbone.layer2.0.conv2.weight", "libra_rcnn": "bfp.refine.theta.weight",
       "pafpn": "neck.downsample_convs.0.weight", "carafe": "neck.carafe.1.content_encoder.weight",
       "groie": "groie_post.gamma", "empirical_attention": "backbone.layer3.0.gen_attention.gamma"}


def _jax_step(family, jmodel, jc, tx):
    if family == "pisa_faster_rcnn":
        from aod_meh_hua_tpu.engine.pisa import make_pisa_rcnn_train_step

        return make_pisa_rcnn_train_step(jmodel, jc, tx)
    return jts.make_faster_rcnn_train_step(jmodel, jc, tx)


@functools.lru_cache(maxsize=None)
def train_against_jax(family, over=()):
    """STEPS SGD steps in each package from one JAX draw of the family's
    tiny config (with the overrides `over`, a tuple of items) on one
    batch, the port's samplers on JAX's draws: (the initial port state,
    per step (JAX aux, port aux, JAX params as a port state_dict, port
    state_dict))."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    over = dict(over)
    jmodel, variables = jax_two_stage(family, **over)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](**over), tcfg.ZOO_FAMILIES[family][1](**over)
    arrays = two_stage_batch(jc, seed=1)
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=jc.frozen_stages)
    state = jax.device_put(state, jax.devices()[0])
    jstep = _jax_step(family, jmodel, jc, tx)
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
                                   "batch_stats": variables.get("batch_stats", {})})
        out.append(({k: float(v) for k, v in jaux.items()}, {k: float(v) for k, v in taux.items()},
                    want, {k: v.clone() for k, v in model.state_dict().items()}))
    return initial, out, frozen_mask(model, tc.frozen_stages)


def losses_match_jax(family, over=()):
    """The aux values of each step: rtol 1e-5, num_pos exact."""
    _, out, _ = train_against_jax(family, over)
    keys = {"loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "num_pos"}
    if family == "pisa_faster_rcnn":
        keys.add("loss_carl")
    for i, (jaux, taux, _, _) in enumerate(out):
        assert set(taux) == set(jaux) == keys
        assert taux["num_pos"] == jaux["num_pos"] > 0, i
        for name in jaux:
            np.testing.assert_allclose(taux[name], jaux[name], rtol=1e-5,
                                       err_msg=f"step {i} {name}")


def params_match_jax(family, over=(), name=None):
    """After each step every tensor within 1e-4 of its max-abs of JAX's;
    the frozen tensors unmoved; the case's own module moved."""
    initial, out, mask = train_against_jax(family, over)
    for i, (_, _, want, got) in enumerate(out):
        assert set(got) == set(want)
        for k, w in want.items():
            scale = max(w.abs().max().item(), 1e-12)
            err = (got[k] - w).abs().max().item()
            assert err <= 1e-4 * scale, (i, k, err, scale)
    final = out[-1][3]
    for k, frozen in mask.items():
        assert torch.equal(final[k], initial[k]) == frozen, k
    own = OWN[name or family]
    assert not torch.equal(final[own], initial[own]), own


def test_hrnet_train_steps_losses_match_jax():
    losses_match_jax("hrnet")


def test_hrnet_train_steps_params_match_jax():
    params_match_jax("hrnet")
