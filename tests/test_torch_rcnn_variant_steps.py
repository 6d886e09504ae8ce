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

import pytest

from test_torch_rcnn_backbone_steps import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("libra_rcnn", "pafpn", "carafe")


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_losses_match_jax(family):
    losses_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_params_match_jax(family):
    params_match_jax(family)
