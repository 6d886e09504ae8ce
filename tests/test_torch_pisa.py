"""PISA Faster R-CNN's ranks, weights and sampler in the port
(aod_meh_hua_torch/engine/pisa.py: group_rank_desc, isr_p_label_weights,
carl_loss_dense, score_hlr_neg and pisa_sample) against the JAX
package's (aod_meh_hua_tpu/engine/pisa.py), on the CPU, f32. The train
steps: tests/test_torch_pisa_steps.py; across ranks:
tests/test_torch_pisa_ranks.py.

The sampler runs on JAX's own draws: each image's key split into kp, kn
and kpack (tests/torch_parity.py jax_sampler_draws), the JAX side the
step's own sample_single (taken from the closure of
make_pisa_rcnn_train_step, jitted over the batch as the step runs it).
Its cases: an under-full sample, an over-full one, images with no valid
negative (the fallback weight of 1), and about 2,000 valid negatives
whose scores lie within 1e-5 of each other, below the f32 spacing of
num_valid - rank + max_score (1.2e-4 at 2,000), where the importance
ranks are decided by ties.

Tolerances: ranks, indices, labels and flags equal; the weights and
targets rtol 1e-5; ISR-P's weights and CARL's loss and gradient rtol
1e-5 (atol 1e-7 on the gradient's zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aod_meh_hua_tpu.engine import pisa as jpisa
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import pisa as tpisa
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_sampler_draws, jax_two_stage
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

C = 6  # the tiny config's classes


def _t(a):
    return torch.from_numpy(np.array(a))


def _closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


def jax_sample_single():
    """The JAX step's own per-image sampler (make_pisa_rcnn_train_step's
    sample_single), jitted over a batch as the step runs it."""
    jmodel, _ = jax_two_stage("pisa_faster_rcnn")
    step = jpisa.make_pisa_rcnn_train_step(jmodel, jcfg.tiny_pisa_rcnn_config(), optax.sgd(0.1))
    train_step = _closure(step, "jfn").__wrapped__
    return jax.jit(jax.vmap(_closure(_closure(train_step, "loss_fn"), "sample_single")))


@pytest.mark.parametrize("ties", [False, True])
def test_group_rank_desc_matches_jax(ties):
    rng = np.random.RandomState(3 + ties)
    n, groups = 500, 7
    values = (rng.randint(0, 5, n) if ties else rng.randn(n)).astype(np.float32)
    gid = rng.randint(0, groups, n).astype(np.int32)
    mask = rng.rand(n) < 0.8
    want = np.asarray(jpisa.group_rank_desc(jnp.asarray(values), jnp.asarray(gid),
                                            jnp.asarray(mask), groups))
    got = tpisa.group_rank_desc(_t(values), _t(gid), _t(mask), groups).numpy()
    np.testing.assert_array_equal(got[mask], want[mask])
    rows = tpisa.group_rank_desc(_t(values).reshape(5, 100), _t(gid).reshape(5, 100),
                                 _t(mask).reshape(5, 100), groups)
    for r in range(5):
        m = mask[r * 100:(r + 1) * 100]
        one = jpisa.group_rank_desc(jnp.asarray(values[r * 100:(r + 1) * 100]),
                                    jnp.asarray(gid[r * 100:(r + 1) * 100]), jnp.asarray(m),
                                    groups)
        np.testing.assert_array_equal(rows[r].numpy()[m], np.asarray(one)[m])


def _roi_rows(seed, n=120, dup=False):
    """RoI rows of a sample: logits, deltas at the label, labels (a third
    positive), label weights, targets, rois, gt groups. dup: every fourth
    positive a copy of the one before (equal IoUs: the ranks tie)."""
    rng = np.random.RandomState(seed)
    labels = np.where(rng.rand(n) < 0.35, rng.randint(0, C, n), C).astype(np.int64)
    xy = rng.uniform(0, 90, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1).astype(np.float32)
    deltas = (rng.randn(n, 4) * 0.3).astype(np.float32)
    targets = np.where(labels[:, None] < C, rng.randn(n, 4) * 0.3, 0).astype(np.float32)
    if dup:
        pos = np.flatnonzero(labels < C)
        for i, j in zip(pos[3::4], pos[2::4]):
            labels[i], rois[i], deltas[i], targets[i] = labels[j], rois[j], deltas[j], targets[j]
    lw = np.where(labels < C, 1.0, rng.uniform(0.3, 1.5, n)).astype(np.float32)
    cls = (rng.randn(n, C + 1) * 2).astype(np.float32)
    group = (np.arange(n) // 60 * 8 + rng.randint(0, 3, n)).astype(np.int64)
    return cls, deltas, labels, lw, targets, rois, group


@pytest.mark.parametrize("dup", [False, True])
def test_isr_p_and_carl_match_jax(dup):
    cls, deltas, labels, lw, targets, rois, group = _roi_rows(7, dup=dup)
    stds = (0.1, 0.1, 0.2, 0.2)
    want = jpisa.isr_p_label_weights(jnp.asarray(cls), jnp.asarray(deltas), jnp.asarray(labels),
                                     jnp.asarray(lw), jnp.asarray(targets), jnp.asarray(rois),
                                     jnp.asarray(group), C, stds, 2.0, 0.0, use_sigmoid=False)
    cls_t = _t(cls).requires_grad_()
    got = tpisa.isr_p_label_weights(cls_t, _t(deltas), _t(labels), _t(lw), _t(targets),
                                    _t(rois), _t(group), C, stds, 2.0, 0.0)
    assert not got.requires_grad  # ISR-P's weights carry no gradient
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def jcarl(c):
        return jpisa.carl_loss_dense(c, jnp.asarray(labels), jnp.asarray(deltas),
                                     jnp.asarray(targets), C, 1.0, 1.0, 0.2, 40.0,
                                     use_sigmoid=False)

    want_loss, want_grad = jax.value_and_grad(jcarl)(jnp.asarray(cls))
    loss = tpisa.carl_loss_dense(cls_t, _t(labels), _t(deltas), _t(targets), C, 1.0, 1.0, 0.2,
                                 torch.tensor(40.0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    # the softmax score keeps its gradient: CARL reaches the class logits
    assert cls_t.grad.abs().max() > 0
    np.testing.assert_allclose(cls_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


def _sample_case(case, seed):
    """(cands, cand_valid, cls_ng, delta_ng, gt_boxes, gt_labels, gt_valid)
    of two images of the tiny config (max_gt 8)."""
    rng = np.random.RandomState(seed)
    n_props = {"under_full": 12, "over_full": 256, "no_valid_negative": 120,
               "ties": 2000}[case]
    out = []
    for _ in range(2):
        g = rng.randint(1, 4)
        gxy = rng.uniform(0, 80, (8, 2))
        gt = np.concatenate([gxy, gxy + rng.uniform(15, 45, (8, 2))], 1).astype(np.float32)
        gt_valid = np.arange(8) < g
        gt_labels = rng.randint(0, C, 8).astype(np.int64)
        # a third of the proposals jitter a gt (positives), the rest anywhere
        src = gt[rng.randint(0, g, n_props)]
        near = src + rng.randn(n_props, 4).astype(np.float32) * 3
        xy = rng.uniform(0, 100, (n_props, 2))
        far = np.concatenate([xy, xy + rng.uniform(5, 40, (n_props, 2))], 1)
        props = np.where(rng.rand(n_props, 1) < 0.3, near, far).astype(np.float32)
        cands = np.concatenate([gt, props])
        valid = np.concatenate([gt_valid, rng.rand(n_props) < 0.95])
        p = len(cands)
        cls = (rng.randn(p, C + 1) * 2).astype(np.float32)
        if case == "no_valid_negative":
            cls[:, C] += 12.0  # every foreground score below hlr_score_thr
        if case == "ties":
            # foreground scores within 1e-5 of each other, above the threshold
            cls = np.full((p, C + 1), 0.0, np.float32)
            cls[:, :C] += (rng.randint(0, 3, (p, C)) * 1e-5).astype(np.float32)
        delta = (rng.randn(p, 4 * C) * 0.2).astype(np.float32)
        out.append((cands, valid, cls, delta, gt, gt_labels, gt_valid))
    return [np.stack(a) for a in zip(*out)]


@pytest.mark.parametrize("case", ["under_full", "over_full", "no_valid_negative", "ties"])
def test_pisa_sample_matches_jax_index_for_index(case):
    arrays = _sample_case(case, {"under_full": 1, "over_full": 2, "no_valid_negative": 3,
                                 "ties": 4}[case])
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    want = [np.asarray(a) for a in jax_sample_single()(keys, *(jnp.asarray(a) for a in arrays))]
    p = arrays[0].shape[1]
    draws = [jax_sampler_draws(k, p, 3) for k in keys]
    u = tuple(_t(np.stack([d[i] for d in draws])) for i in range(3))
    with torch.no_grad():
        got = tpisa.pisa_sample(u, *(_t(a) for a in arrays), tcfg.tiny_pisa_rcnn_config())
    rois, labels, lw, bbox_t, is_pos, valid, gt_idx = want
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.is_pos.numpy(), is_pos)
    np.testing.assert_array_equal(got.rois.numpy(), rois)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_array_equal(got.gt_idx.numpy(), gt_idx)
    np.testing.assert_allclose(got.label_weights.numpy(), lw, rtol=1e-5)
    np.testing.assert_allclose(got.bbox_targets.numpy(), bbox_t, rtol=1e-5, atol=1e-6)
    negs = valid & ~is_pos
    assert negs.any() and is_pos.any()
    if case == "under_full":
        assert not valid.all()
    if case == "no_valid_negative":  # random negatives at the fallback weight
        np.testing.assert_array_equal(lw[negs], 1.0)
    if case in ("over_full", "ties"):
        assert valid.all() and (lw[negs] != lw[negs][0]).any()
