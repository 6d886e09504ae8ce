"""Shared runs of the proposal families' parity tests
(tests/test_torch_rpn_fast_rcnn.py, test_torch_cascade_rpn.py,
test_torch_trident.py, test_torch_grid_rcnn.py): two SGD steps of a
family's tiny config in each package from one JAX variables draw
(torch_parity.jax_two_stage, the RPN and class heads sharpened), the
port's samplers on JAX's own draws (torch_parity.jax_family_uniforms),
and the families' forwards.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.rpn_only import ProposalBatch as TProposalBatch
from aod_meh_hua_torch.engine.train import create_train_state as tcreate_state
from aod_meh_hua_torch.engine.train import frozen_mask
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import (jax_family_uniforms, jax_two_stage, proposal_batch,
                          two_stage_batch)

STEPS = 2


def jax_train_step(family, jmodel, jc, tx):
    """The JAX package's train step of a proposal family (its trainer's
    make_steps, tools/train_detector.py:161-192)."""
    from aod_meh_hua_tpu.engine import cascade_rpn, grid_rcnn, rpn_only, trident

    make = {"rpn": rpn_only.make_rpn_train_step, "fast_rcnn": rpn_only.make_fast_rcnn_train_step,
            "cascade_rpn": cascade_rpn.make_crpn_train_step,
            "tridentnet": trident.make_trident_train_step,
            "grid_rcnn": grid_rcnn.make_grid_rcnn_train_step}[family]
    return make(jmodel, jc, tx)


def trident_batch(jc, variables, seed=1):
    """two_stage_batch of TridentNet's tiny config whose gts are, per
    image, the three best proposals of branch 0 (the port's model on the
    variables) moved by a few pixels: the no-gt RoI sampler then samples
    positives, which random boxes against the tiny RPN's 48 proposals
    rarely give. The move keeps the RPN's L1 targets off its own
    predictions, where the L1 gradient's sign is a rounding's."""
    images, gt_boxes, gt_labels, gt_valid, av, shapes = two_stage_batch(jc, seed=seed)
    tc = tcfg.ZOO_FAMILIES["tridentnet"][1]()
    model = port_model("tridentnet", variables)
    b = images.shape[0]
    with torch.no_grad():
        feat = model.features(torch.from_numpy(images))
        cls, reg = model.rpn(feat)
        props = tts.make_proposal_fn(tc)(cls[:b], reg[:b], torch.from_numpy(tts.anchor_table(tc)),
                                         torch.from_numpy(shapes), tc.rpn.train_nms_pre,
                                         tc.rpn.train_max_per_img)[0].numpy()
    gt_boxes[:] = 0
    gt_valid[:] = False
    moved = props[:, :3] + np.float32([2.0, 1.0, 3.0, 2.0])
    limit = np.stack([shapes[:, 1], shapes[:, 0]] * 2, -1)[:, None].astype(np.float32)
    gt_boxes[:, :3], gt_valid[:, :3] = np.minimum(moved, limit), True
    return images, gt_boxes, gt_labels, gt_valid, av, shapes


def family_batch(family, jc, seed=1, variables=None):
    """(JAX batch, port batch) of numpy arrays: a ProposalBatch for
    fast_rcnn, trident_batch's for tridentnet, a Batch otherwise."""
    if family == "tridentnet":
        arrays = trident_batch(jc, variables, seed)
        return JBatch(*(jnp.asarray(a) for a in arrays)), TBatch(*arrays)
    if family == "fast_rcnn":
        from aod_meh_hua_tpu.engine.rpn_only import ProposalBatch as JProposalBatch

        arrays = proposal_batch(jc, seed=seed)
        return JProposalBatch(*(jnp.asarray(a) for a in arrays)), TProposalBatch(*arrays)
    arrays = two_stage_batch(jc, seed=seed)
    return JBatch(*(jnp.asarray(a) for a in arrays)), TBatch(*arrays)


def port_model(family, variables, **over):
    model = tmodels.build_two_stage(tcfg.ZOO_FAMILIES[family][1](**over), device="cpu")
    tapi.load_weights(model, from_jax_variables(variables))
    return model


@functools.lru_cache(maxsize=None)
def train_against_jax(family):
    """STEPS SGD steps in each package from one JAX draw of the family's
    tiny config on one batch, the port's samplers on JAX's draws: (the
    initial port state, per step (JAX aux, port aux, JAX params as a port
    state_dict, port state_dict), the frozen mask)."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    jmodel, variables = jax_two_stage(family)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](), tcfg.ZOO_FAMILIES[family][1]()
    jbatch, tbatch = family_batch(family, jc, variables=variables)
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=jc.frozen_stages)
    state = jax.device_put(state, jax.devices()[0])
    jstep = jax_train_step(family, jmodel, jc, tx)
    model = port_model(family, variables)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcreate_state(model, tcfg.TrainConfig(batch_size=2), frozen_stages=tc.frozen_stages)
    tstep = tts.make_two_stage_train_step(model, tc, opt, device="cpu")
    out = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(40 + i)
        state, jaux = jstep(state, jbatch, key)
        taux = tstep(tbatch, uniforms=jax_family_uniforms(family, key, tc, 2))
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": variables.get("batch_stats", {})})
        out.append(({k: float(v) for k, v in jaux.items()}, {k: float(v) for k, v in taux.items()},
                    want, {k: v.clone() for k, v in model.state_dict().items()}))
    return initial, out, frozen_mask(model, tc.frozen_stages)


def losses_match_jax(family):
    """The aux values of each step: the JAX step's keys, rtol 1e-4,
    num_pos exact and positive."""
    _, out, _ = train_against_jax(family)
    for i, (jaux, taux, _, _) in enumerate(out):
        assert set(taux) == set(jaux), (set(taux), set(jaux))
        assert taux["num_pos"] == jaux["num_pos"] > 0, i
        for name in jaux:
            np.testing.assert_allclose(taux[name], jaux[name], rtol=1e-4,
                                       err_msg=f"step {i} {name}")


def params_match_jax(family, own):
    """After each step every tensor within 1e-4 of its max-abs of JAX's;
    the frozen tensors unmoved; the tensor `own` (a module of the
    family's own) moved."""
    initial, out, mask = train_against_jax(family)
    for i, (_, _, want, got) in enumerate(out):
        assert set(got) == set(want)
        for k, w in want.items():
            scale = max(w.abs().max().item(), 1e-12)
            err = (got[k] - w).abs().max().item()
            assert err <= 1e-4 * scale, (i, k, err, scale)
    final = out[-1][3]
    for k, frozen in mask.items():
        assert torch.equal(final[k], initial[k]) == frozen, k
    assert not torch.equal(final[own], initial[own]), own


def max_abs_rel(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    want = torch.from_numpy(np.array(want, np.float32))
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-12)).item()
