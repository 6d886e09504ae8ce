"""The port's semi-supervised steps (aod_meh_hua_torch/engine/ssl.py,
engine/self_ssl.py) against the JAX package's, on the CPU, f32.

One tiny JAX MEH-RetinaNet (tests/torch_parity.py jax_retinanet, its cls
kernel x150 so that anchors pass the 0.5 softmax gate and propose
pseudo boxes), carried to the port with from_jax_variables, and one
seeded training batch (torch_parity.train_batch) whose real GT has no
exact IoU tie among the anchors of its low-quality matches (checked
here): the jitted JAX program breaks such ties otherwise than eager JAX
and the port (ROADMAP Queue 3), so on this batch the jitted JAX loss is
the reference (the eager one takes over a minute here and gives the
same values).

Tolerances:
- make_pseudo_loss_fn on the same head outputs (the port model's), at
  the default 0.5 gate and at 0 (every anchor proposes): every term to
  rtol 1e-4 of JAX's; the pseudo NMS survivors identical (validity and
  labels equal, boxes to rtol 1e-4); at the 0.5 gate, the gradient of
  the loss with respect to the head outputs to 1e-4 of each one's
  max-abs: everywhere for cls and lambda, and for the
  box deltas everywhere but at the positive anchors whose target is the
  encoding of their own decoded box (the proposer of a surviving pseudo
  box, or an anchor that a low-quality match gives the box it proposed).
  There |reg - target| is rounding noise (under 1e-4) and the sign of
  the L1 gradient is arbitrary: JAX's jitted and eager programs already
  part there (by 2% of the max-abs of head.reg_convs.0.bias's gradient
  on this batch), and any two implementations would; through the
  backward the signs reach every trunk parameter.
- Two make_pseudo_train_step steps, the model's forward included:
  losses to rtol 1e-4, every parameter to 1e-4 of its tensor's max-abs,
  with the unsharpened head, whose
  near-uniform softmax passes no anchor through the 0.5 gate: the step
  trains the JSD-weighted cls term and the MEH regression, and its
  gradient is defined everywhere.
- Self-SSL: flip_level_maps_w exact; the consistency loss to rtol 1e-5
  of JAX's and 0 for mirrored outputs; make_self_ssl_loss_fn to rtol
  1e-4 of JAX's on shared weights, and its gradient reaches the cls
  branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import self_ssl as jself
from aod_meh_hua_tpu.engine import ssl as jssl
from aod_meh_hua_tpu.ops import bbox as jbbox
from aod_meh_hua_tpu.ops import nms as jnms
from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.engine import self_ssl as tself
from aod_meh_hua_torch.engine import ssl as tssl
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.train import create_train_state
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.utils.config import TrainConfig as TTrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import jax_retinanet, no_exact_low_quality_ties, sharpen, train_batch

pytestmark = pytest.mark.usefixtures("few_threads")

SHARPEN = 150.0


@pytest.fixture(scope="module")
def shared():
    jmodel, variables = jax_retinanet()
    variables = sharpen(variables, SHARPEN)
    arrays = train_batch(jtiny(), seed=3)
    return jmodel, variables, arrays


def _port_model(variables):
    model = build_retinanet(ttiny(), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return model


def test_batch_has_no_exact_low_quality_ties(shared):
    assert no_exact_low_quality_ties(jtiny(), shared[2])


class _PortHeads(torch.nn.Module):
    """Stands in for the model: its parameters are the head outputs."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(o.copy()))
                                              for o in outputs)

    def forward(self, images, with_meh=True):
        return tuple(self.outputs)


class _JaxHeads:
    def apply(self, variables, images):
        return tuple(variables["params"])


@pytest.fixture(scope="module")
def head_outputs(shared):
    """The port model's head outputs on the batch (cls, reg, lambda)."""
    _, variables, arrays = shared
    with torch.no_grad():
        return [o.numpy() for o in _port_model(variables)(torch.from_numpy(arrays[0]))]


@pytest.mark.parametrize("thr", [0.5, 0.0])
def test_pseudo_loss_and_gradient_match_jax(shared, head_outputs, thr):
    """Both packages' make_pseudo_loss_fn on the same head outputs: every
    term, and at the 0.5 gate d loss / d (cls, reg, lambda) (at 0 every
    anchor proposes, and the terms and the cR1 pinning are checked)."""
    _, _, arrays = shared
    jc, tc = jtiny(), ttiny()
    jloss, janchors = jssl.make_pseudo_loss_fn(_JaxHeads(), jc, prob_threshold=thr)
    jb = JBatch(*(jnp.asarray(a) for a in arrays))
    loss = lambda p: jloss(p, {}, jb, jnp.asarray(janchors))  # noqa: E731
    heads_j = [jnp.asarray(o) for o in head_outputs]
    if thr:
        want_grad, want = jax.jit(jax.grad(loss, has_aux=True))(heads_j)
    else:
        want = jax.jit(loss)(heads_j)[1]
    heads = _PortHeads(head_outputs)
    tloss, tanchors = tssl.make_pseudo_loss_fn(heads, tc, prob_threshold=thr)
    np.testing.assert_array_equal(tanchors, janchors)
    total, got = tloss(TBatch(*(torch.from_numpy(a) for a in arrays)),
                       torch.from_numpy(tanchors))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=1e-4,
                                   err_msg=name)
    assert float(want["loss_bbox"]) > 0 and float(want["loss_meh"]) > 0
    if thr == 0.0:
        # 'cR1': every level proposes, so each level's cls value is pinned
        # to its bbox value and the sums agree
        np.testing.assert_allclose(float(got["loss_cls"].detach()), float(got["loss_bbox"]),
                                   rtol=1e-5)
        return

    total.backward()
    got_grad = [p.grad.numpy() for p in heads.outputs]
    # the positive anchors on their own target: |reg - target| is noise
    cls, reg = (torch.from_numpy(o) for o in head_outputs[:2])
    anchors, av = torch.from_numpy(tanchors), torch.from_numpy(arrays[4])
    noise = np.zeros(reg.shape[:2], bool)
    for s0, s1 in tc.level_bounds():
        pos, targets, _, _ = tssl.pseudo_targets(tc, torch.softmax(cls[:, s0:s1], -1),
                                                 reg[:, s0:s1], anchors[s0:s1], av[:, s0:s1])
        near = (torch.abs(reg[:, s0:s1] - targets) < 1e-4).any(dim=-1)
        noise[:, s0:s1] = (pos & near).numpy()
    assert 0 < noise.sum() < (np.abs(got_grad[1]).max(axis=-1) > 0).sum()
    for name, g, w, keep in zip(("cls", "reg", "lambda"), got_grad, want_grad,
                                (slice(None), ~noise, slice(None))):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g[keep], w[keep], rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_pseudo_survivors_match_jax(shared):
    """The pseudo GT of every (image, level) at the 0.5 gate, built as the
    JAX loss builds it (engine/ssl.py:61-69), against pseudo_detections."""
    jmodel, variables, arrays = shared
    jc, tc = jtiny(), ttiny()
    images, av = arrays[0], arrays[4]
    cls_j, reg_j, _ = jax.jit(jmodel.apply)(variables, images)
    with torch.no_grad():
        cls_t, reg_t, _ = _port_model(variables)(torch.from_numpy(images))
    anchors = np.concatenate(jc.build_anchor_generator().grid_anchors(jc.featmap_sizes()))
    anchors = anchors.astype(np.float32)

    def jax_level(cls_i, reg_i, anc, valid_i):
        probs = jax.nn.softmax(cls_i, axis=-1)
        conf_ok = (probs.max(axis=-1) >= 0.5) & valid_i
        boxes = jbbox.delta_decode(anc, reg_i, means=jc.target_means, stds=jc.target_stds)
        masked = jnp.where(conf_ok[:, None], probs, 0.0)
        return jnms.multiclass_nms(boxes, masked, 0.5, 0.5, 100, pre_nms_cands=min(
            jc.test.pre_nms_cands, boxes.shape[0] * jc.num_classes))

    bounds = jc.level_bounds()
    levels = jax.jit(lambda c, r, v: [
        jax.vmap(jax_level, in_axes=(0, 0, None, 0))(c[:, s0:s1], r[:, s0:s1], anchors[s0:s1],
                                                     v[:, s0:s1])
        for s0, s1 in bounds])(cls_j, reg_j, av)
    survivors = 0
    for (s0, s1), want in zip(bounds, levels):
        got = tssl.pseudo_detections(tc, torch.softmax(cls_t[:, s0:s1], -1), reg_t[:, s0:s1],
                                     torch.from_numpy(anchors[s0:s1]),
                                     torch.from_numpy(av[:, s0:s1]))
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        np.testing.assert_array_equal(got.labels.numpy()[valid], np.asarray(want.labels)[valid])
        np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                                   rtol=1e-4, atol=1e-3)
        survivors += int(valid.sum())
    assert survivors > 0


def test_pseudo_train_steps_match_jax(shared):
    jmodel, _, arrays = shared
    variables = jax_retinanet()[1]
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2))
    state = jax.device_put(state, jax.devices()[0])
    jstep = jssl.make_pseudo_train_step(jmodel, jtiny(), tx)
    model = _port_model(variables)
    tstep = tssl.make_pseudo_train_step(model, ttiny(),
                                        create_train_state(model, TTrainConfig(batch_size=2)),
                                        device="cpu")
    for i in range(2):
        state, jaux = jstep(state, JBatch(*(jnp.asarray(a) for a in arrays)))
        taux = tstep(TBatch(*arrays))
        for name in jaux:
            np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-4,
                                       err_msg=f"step {i}: {name}")
        assert float(jaux["loss_bbox"]) == 0 and float(jaux["loss_cls"]) > 0
        assert float(jaux["loss_meh"]) > 0
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": variables["batch_stats"]})
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()) + 1e-12,
                                       err_msg=f"step {i}: {name}")


# --- self-SSL ----------------------------------------------------------------

FEATS, A, C = [(4, 6), (2, 3)], 3, 5


def _flat(maps):
    return np.concatenate([m.reshape(m.shape[0], -1, C) for m in maps], axis=1)


def _maps(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, A * C).astype(np.float32) for h, w in FEATS]


def test_flip_level_maps_w_exact():
    flat = _flat(_maps(0))
    want = np.asarray(jself.flip_level_maps_w(jnp.asarray(flat), FEATS, A))
    got = tself.flip_level_maps_w(torch.from_numpy(flat), FEATS, A).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _flat([m[:, :, ::-1] for m in _maps(0)]))


def test_consistency_loss_matches_jax_and_is_zero_for_mirrored_outputs():
    flat, flat_f = _flat(_maps(1)), _flat(_maps(2))
    want = float(jself.self_ssl_consistency_loss(jnp.asarray(flat), jnp.asarray(flat_f),
                                                 FEATS, A))
    got = float(tself.self_ssl_consistency_loss(torch.from_numpy(flat),
                                                torch.from_numpy(flat_f), FEATS, A))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mirrored = _flat([m[:, :, ::-1] for m in _maps(1)])
    assert float(tself.self_ssl_consistency_loss(
        torch.from_numpy(flat), torch.from_numpy(mirrored), FEATS, A)) == 0.0


def test_self_ssl_loss_fn_matches_jax_and_differentiates(shared):
    jmodel, variables, arrays = shared
    images = arrays[0][:1]
    want = float(jax.jit(jself.make_self_ssl_loss_fn(jmodel, jtiny()))(variables, images))
    model = _port_model(variables)
    loss = tself.make_self_ssl_loss_fn(model, ttiny())(torch.from_numpy(images))
    np.testing.assert_allclose(float(loss), want, rtol=1e-4)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values() if g is not None)
    assert grads["head.retina_cls.weight"].abs().max() > 0
    assert grads["backbone.layer4.0.conv1.weight"].abs().max() > 0
    assert grads["head.retina_L.weight"] is None  # with_meh=False: the MEH branch is idle
