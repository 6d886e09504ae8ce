"""TridentNet (aod_meh_hua_torch: models/trident.py, engine/trident.py)
against the JAX package's, on the CPU, f32.

The models share one JAX variables draw of the tiny config
(tests/torch_parity.py jax_two_stage: the RPN and class heads
sharpened). The samplers run on JAX's own draws: k_rpn, k_roi =
split(key), each split into one key per branch-major row r * B + i,
(kp, kn) in the sampler (torch_parity.jax_family_uniforms). The train
batch's gts are branch 0's best proposals (torch_proposal_parity
trident_batch), so that the no-gt sampler samples positives.

Tolerances: the branches, the frozen set and the sampled RoIs exact; the
forwards within 1e-4 of each output's max-abs (the test branch against
a plain dilation-2 conv within 1e-6); the shared kernel's gradient the
sum of the three branches' within 1e-5 of its max-abs; two SGD steps,
the aux values rtol 1e-4 (num_pos exact) and every tensor within 1e-4
of its max-abs of JAX's; the eval's scores and boxes rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import trident as jtrident
from aod_meh_hua_tpu.engine.train import frozen_mask as jfrozen_mask
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import trident as ttrident
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.engine.train import frozen_mask
from aod_meh_hua_torch.models import trident as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from test_torch_rpn_fast_rcnn import _eval_batch, dets_match
from torch_parity import jax_sampler_draws, jax_two_stage, two_stage_batch
from torch_proposal_parity import (losses_match_jax, max_abs_rel, params_match_jax,
                                   port_model, train_against_jax, trident_batch)
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

TC, JC = tcfg.tiny_trident_config(), jcfg.tiny_trident_config()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_branches_are_branch_major_and_the_test_branch_is_dilation_2():
    """TridentConv3x3 on [R * B] rows: row r * B + i is image i at
    dilation r + 1; the single test branch is a plain dilation-2 conv."""
    torch.manual_seed(0)
    conv = tmodels.TridentConv3x3(4, 5, stride=2)
    torch.nn.init.normal_(conv.weight)
    x = torch.randn(2, 4, 9, 11)
    with torch.no_grad():
        rows = conv(x.repeat(3, 1, 1, 1))
        single = conv(x, single_branch_idx=1)
    for r, d in enumerate((1, 2, 3)):
        want = F.conv2d(x, conv.weight, stride=2, padding=d, dilation=d)
        torch.testing.assert_close(rows[r * 2:(r + 1) * 2], want, rtol=0, atol=0)
    torch.testing.assert_close(single, F.conv2d(x, conv.weight, stride=2, padding=2,
                                                dilation=2), rtol=0, atol=0)


def test_shared_kernel_gradient_sums_the_branches():
    """One parameter: its gradient is the sum of the three branches'."""
    torch.manual_seed(1)
    conv = tmodels.TridentConv3x3(3, 4)
    torch.nn.init.normal_(conv.weight)
    x, g = torch.randn(6, 3, 8, 8), torch.randn(6, 4, 8, 8)
    (conv(x) * g).sum().backward()
    want = torch.zeros_like(conv.weight)
    for r, d in enumerate((1, 2, 3)):
        w = conv.weight.detach().clone().requires_grad_(True)
        (F.conv2d(x[r * 2:(r + 1) * 2], w, padding=d, dilation=d) * g[r * 2:(r + 1) * 2]) \
            .sum().backward()
        want += w.grad
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    assert (conv.weight.grad - want).abs().max() <= 1e-5 * want.abs().max()


def test_forward_matches_jax():
    """The JAX module's __call__ (the test branch's RPN and the head on
    zero RoIs), the training forward's R * B rows, the test branch equal
    to branch test_branch_idx of the rows."""
    jmodel, variables = jax_two_stage("tridentnet")
    images = two_stage_batch(JC, seed=1)[0]
    jrpn_cls, jrpn_reg, (jcls, jreg) = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    jrows = jax.jit(lambda v, im: jmodel.apply(v, im, method=lambda m, i: m.features(i)))(
        variables, jnp.asarray(images))
    model = port_model("tridentnet", variables)
    s = TC.rcnn.roi_size
    with torch.no_grad():
        feat, cls, reg = model(_t(images))
        rows = model.features(_t(images))
        hcls, hreg = model.roi_forward(torch.zeros(1, s, s, TC.stem_width * 16))
    assert max_abs_rel(cls, jrpn_cls) < 1e-4 and max_abs_rel(reg, jrpn_reg) < 1e-4
    assert max_abs_rel(hcls, jcls) < 1e-4 and max_abs_rel(hreg, jreg) < 1e-4
    assert rows.shape[0] == 3 * 2 and max_abs_rel(rows.permute(0, 2, 3, 1), jrows) < 1e-4
    i = TC.test_branch_idx
    assert (rows[i * 2:(i + 1) * 2] - feat).abs().max() <= 1e-6 * feat.abs().max()


def test_frozen_set_equals_jax():
    """The caffe C4 backbone's stem (conv1, bn1) and layer1 by name, as
    the JAX mask (engine/train.py:52-67) freezes them; the caffe
    normalisation (BGR means, std 1) as JAX's."""
    _, variables = jax_two_stage("tridentnet")
    mask = jfrozen_mask(variables["params"], 1)
    flags = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda p, m: np.full(p.shape, float(m), np.float32), variables["params"], mask)})
    want = {k for k, v in flags.items() if v.flatten()[0] == 1.0}
    got = {k for k, frozen in frozen_mask(port_model("tridentnet", variables), 1).items()
           if frozen}
    assert got == want and {k.split(".")[1] for k in got} == {"conv1", "bn1", "layer1"}
    assert (TC.img_mean, TC.img_std, TC.img_to_rgb) == (JC.img_mean, JC.img_std, False)


def test_roi_sample_no_gt_matches_jax():
    """The no-gt RoI sampler on each branch row with its own JAX draws:
    the sampled RoIs, labels, targets and positives index for index."""
    rng = np.random.RandomState(5)
    rows, p = 6, TC.rpn.train_max_per_img
    xy = rng.uniform(0, 100, (rows, p, 2))
    props = np.concatenate([xy, xy + rng.uniform(5, 40, (rows, p, 2))], -1).astype(np.float32)
    pv = rng.uniform(size=(rows, p)) > 0.1
    gtb = np.zeros((rows, TC.max_gt, 4), np.float32)
    gtb[:, :4] = props[:, [0, 3, 7, 11]] + rng.randn(rows, 4, 4).astype(np.float32)
    gtv = np.zeros((rows, TC.max_gt), bool)
    gtv[:, :4] = True
    gtl = rng.randint(0, TC.num_classes, (rows, TC.max_gt)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), rows)
    want = jax.jit(jax.vmap(lambda *a: jtrident._roi_sample_no_gt(*a, cfg=JC)))(
        keys, jnp.asarray(props), jnp.asarray(pv), jnp.asarray(gtb), jnp.asarray(gtl),
        jnp.asarray(gtv))
    draws = [jax_sampler_draws(k, p, 2) for k in keys]
    got = ttrident.roi_sample_no_gt(*(_t(np.stack([d[j] for d in draws])) for j in range(2)),
                                    _t(props), _t(pv), _t(gtb), _t(gtl), _t(gtv), TC)
    for name in ("rois", "labels", "label_weights", "is_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=1e-6, atol=1e-6)
    assert got.is_pos.sum() > 0 and not got.is_gt.any()


def test_train_steps_match_jax():
    """The branch-replicated step: the losses with positives each step, and
    every parameter after each step (the shared stage-3 kernel moved)."""
    losses_match_jax("tridentnet")
    params_match_jax("tridentnet", "backbone.layer3.0.conv2.weight")
    assert all(taux["loss_bbox"] > 0 for _, taux, _, _ in train_against_jax("tridentnet")[1])


def test_eval_matches_jax():
    """The test branch's eval on four images with their own scale factors."""
    jmodel, variables = jax_two_stage("tridentnet")
    batch = _eval_batch(JC)
    want = jtrident.make_trident_eval_step(jmodel, JC)(
        variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tts.make_two_stage_eval_step(port_model("tridentnet", variables), TC, "cpu")(
        TEvalBatch(*batch))
    dets_match(got, want, 20)
    assert trident_batch(JC, variables)[3].sum() == 6
