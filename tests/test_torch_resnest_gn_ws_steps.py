"""The train steps of ResNeSt and GN+WS Faster R-CNN on the port's trunk
against the JAX package's, on the CPU, f32: the rules and the shared
draws of tests/test_torch_rcnn_backbone_steps.py (train_against_jax), in
a file of their own for the time budget. GN+WS's GroupNorm scales and
biases train (only conv1 and layer1 are frozen, by name)."""

import pytest

from test_torch_rcnn_backbone_steps import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("resnest", "gn_ws")


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_losses_match_jax(family):
    losses_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_params_match_jax(family):
    params_match_jax(family)
