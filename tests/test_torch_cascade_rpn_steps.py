"""Cascade RPN's forward and train steps (aod_meh_hua_torch:
models/cascade_rpn.py, engine/cascade_rpn.py make_crpn_train_step)
against the JAX package's, on the CPU, f32.

The models share one JAX variables draw of the tiny config
(tests/torch_parity.py jax_two_stage, s1_cls sharpened); the stage-1
sampler runs on JAX's own draws (one key per image, (kp, kn)).

Tolerances: the forward within 1e-4 of each output's max-abs; two SGD
steps from the shared weights, the aux values rtol 1e-4 (num_pos exact)
and every tensor after each step within 1e-4 of its max-abs of JAX's,
the deform conv's kernel moved (the JAX step's compile takes most of the
file's time).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.models import cascade_rpn as tmodels
from torch_parity import jax_two_stage, two_stage_batch
from torch_proposal_parity import losses_match_jax, max_abs_rel, params_match_jax, port_model
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

JC = jcfg.tiny_cascade_rpn_config()


def test_forward_matches_jax():
    """The JAX module's __call__ (stage 1 at zero offsets): stage 0's
    deltas and stage 1's objectness and deltas."""
    jmodel, variables = jax_two_stage("cascade_rpn")
    images = two_stage_batch(JC, seed=1)[0]
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    model = port_model("cascade_rpn", variables)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for g, w in zip(got, want):
        assert max_abs_rel(g, w) < 1e-4
    assert isinstance(model, tmodels.CascadeRPNNet) and model.rpn_head is None


def test_train_steps_match_jax():
    """Stage 0's region-assigned IoU loss, stage 1's BCE and IoU loss on
    the refined anchors: the losses and every parameter after each step."""
    losses_match_jax("cascade_rpn")
    params_match_jax("cascade_rpn", "s1_conv.weight")
