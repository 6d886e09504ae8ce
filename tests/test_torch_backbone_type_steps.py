"""The train steps of Faster R-CNN with the backbone_type switches
ResNeXt and Res2Net on the tiny config against the JAX package's, on the
CPU, f32: the rules and the shared draws of
tests/test_torch_rcnn_backbone_steps.py (train_against_jax), in a file
of their own for the time budget (RegNet's:
tests/test_torch_fpg_regnet_steps.py)."""

import pytest

from test_torch_rcnn_backbone_steps import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

SWITCHES = {"resnext": (("backbone_type", "resnext"),),
            "res2net": (("backbone_type", "res2net"),)}


@pytest.mark.parametrize("backbone", list(SWITCHES))
def test_train_steps_losses_match_jax(backbone):
    losses_match_jax("faster_rcnn", SWITCHES[backbone])


@pytest.mark.parametrize("backbone", list(SWITCHES))
def test_train_steps_params_match_jax(backbone):
    params_match_jax("faster_rcnn", SWITCHES[backbone], name=backbone)
