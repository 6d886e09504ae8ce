"""The train steps of the two Faster R-CNN variants with attention blocks
(aod_meh_hua_torch: GRoIE, whose RoI features fuse through a
GeneralizedAttention, and empirical attention, whose backbone runs them
in c4 and c5; through engine/two_stage.py's Faster R-CNN step) against
the JAX package's, on the CPU, f32: the rules and the shared draws of
tests/test_torch_rcnn_variant_steps.py (every attention block's gamma,
key_bias and geom_bias non-zero), in a file of their own for the time
budget (each JAX train step's compile takes 8-18 s).
"""

import pytest

from test_torch_rcnn_variant_steps import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("groie", "empirical_attention")


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_losses_match_jax(family):
    losses_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_train_steps_params_match_jax(family):
    params_match_jax(family)
