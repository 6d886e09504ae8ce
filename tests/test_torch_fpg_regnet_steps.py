"""The train steps of FPG Faster R-CNN (the tiny config's five stacked
stages) and of Faster R-CNN with backbone_type "regnet" (RegNetX-400MF,
the smallest arch) on the port's trunk against the JAX package's, on the
CPU, f32: the rules and the shared draws of
tests/test_torch_rcnn_backbone_steps.py (train_against_jax), in a file
of their own for the time budget (ResNeXt and Res2Net:
tests/test_torch_backbone_type_steps.py)."""

import pytest

from test_torch_rcnn_backbone_steps import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

REGNET = (("backbone_type", "regnet"), ("regnet_arch", "regnetx_400mf"))


def test_fpg_train_steps_losses_match_jax():
    losses_match_jax("fpg")


def test_fpg_train_steps_params_match_jax():
    params_match_jax("fpg")


def test_regnet_train_steps_losses_match_jax():
    losses_match_jax("faster_rcnn", REGNET)


def test_regnet_train_steps_params_match_jax():
    params_match_jax("faster_rcnn", REGNET, name="regnet")
