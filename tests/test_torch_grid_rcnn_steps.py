"""Grid R-CNN's train steps (aod_meh_hua_torch: engine/grid_rcnn.py
make_grid_rcnn_train_step) against the JAX package's, on the CPU, f32.

The models share one JAX variables draw of the tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads
sharpened); the RPN's and the RoI sampler's draws and the jitter's are
JAX's (k_rpn, k_roi, k_jit = split(key, 3), each split per image).

Tolerances: two SGD steps from the shared weights, the aux values rtol
1e-4 (num_pos exact) and every tensor after each step within 1e-4 of its
max-abs of JAX's, the grid head's deconvs moved (the JAX step's compile
takes most of the file's time).
"""

import pytest

from torch_proposal_parity import losses_match_jax, params_match_jax
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


def test_train_steps_losses_match_jax():
    losses_match_jax("grid_rcnn")


def test_train_steps_params_match_jax():
    params_match_jax("grid_rcnn", "grid_head.deconv1_4.weight")
