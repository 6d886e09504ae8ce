"""The port's training slice (aod_meh_hua_torch/engine/train.py and the ops
it runs) against the JAX package's, on the CPU, f32 (TF32 does not arise
on the CPU).

1. Losses, box encoding, anchor flags and targets on seeded inputs:
   losses to rtol 1e-5; delta_encode to 1e-6; anchor_valid_flags bit-equal;
   max_iou_assign and anchor_targets bit-equal in labels and assignments
   and within 1e-6 in targets and weights, on the cases of
   tests/test_assigner.py:15-85 (ties, the ignore band, padded GTs, no
   GT, invalid anchors) and a random one.
2. The train step: one JAX init (tests/torch_parity.py TINY) carried over
   with from_jax_variables, the same seeded batch, two steps in each
   package (so that momentum counts). Every loss component agrees to
   rtol 1e-4 at both steps; the updated parameters agree to 1e-4 of each
   tensor's max-abs, and the updates themselves (new - old) to 1e-3 of
   their own max-abs plus two f32 ulps of the tensor's max-abs (the
   rounding of new - old).
3. The ports of tests/test_engine.py's test_frozen_params_do_not_move and
   test_meh_gradient_partition, schedule_lr, and the global-norm clip
   against optax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import make_train_step as jmake_train_step
from aod_meh_hua_tpu.engine import schedule_lr as jschedule_lr
from aod_meh_hua_tpu.ops import anchor_valid_flags as janchor_valid_flags
from aod_meh_hua_tpu.ops import assigner as jassigner
from aod_meh_hua_tpu.ops import bbox as jbbox
from aod_meh_hua_tpu.ops import losses as jlosses
from aod_meh_hua_tpu.utils.config import RetinaNetConfig as JRetinaNetConfig
from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.engine import train as ttrain
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.ops import anchors as tanchors
from aod_meh_hua_torch.ops import assigner as tassigner
from aod_meh_hua_torch.ops import bbox as tbbox
from aod_meh_hua_torch.ops import losses as tlosses
from aod_meh_hua_torch.utils.config import RetinaNetConfig as TRetinaNetConfig
from aod_meh_hua_torch.utils.config import TrainConfig as TTrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny
from torch_parity import TINY, jax_retinanet, no_exact_low_quality_ties, train_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


def _t(a):
    return torch.from_numpy(np.array(a))


# --- losses ----------------------------------------------------------------

def _loss_inputs(seed=0, n=64, c=6):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2.0).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int32)  # c is background
    weight = rng.uniform(0, 1, n).astype(np.float32)
    pred, target = (rng.randn(n, 4).astype(np.float32) for _ in range(2))
    return logits, labels, weight, pred, target


LOSS_CASES = [
    ("sigmoid_focal_loss_elementwise", lambda m, a: m.sigmoid_focal_loss_elementwise(
        a["logits"], a["labels"], gamma=2.0, alpha=0.25)),
    ("sigmoid_focal_loss", lambda m, a: m.sigmoid_focal_loss(
        a["logits"], a["labels"], a["weight"], avg_factor=a["avg"])),
    ("edl_softmax_focal_loss", lambda m, a: m.edl_softmax_focal_loss(
        a["logits"], a["labels"], a["weight"], reduction="sum")),
    ("edl_focal_loss", lambda m, a: m.edl_focal_loss(
        a["logits"], a["labels"], reduction="none", loss_weight=0.5)),
    ("edl_relu_loss", lambda m, a: m.edl_relu_loss(a["logits"], a["labels"], a["weight"])),
    ("l1_loss", lambda m, a: m.l1_loss(a["pred"], a["target"], a["weight"][:, None],
                                       avg_factor=a["avg"])),
    ("weight_reduce_loss", lambda m, a: m.weight_reduce_loss(a["pred"], a["weight"],
                                                             reduction="mean")),
]


@pytest.mark.parametrize("name,call", LOSS_CASES, ids=[n for n, _ in LOSS_CASES])
def test_losses_match_jax(name, call):
    logits, labels, weight, pred, target = _loss_inputs()
    arrays = dict(logits=logits, labels=labels, weight=weight, pred=pred, target=target,
                  avg=np.float32(17.0))
    want = np.asarray(call(jlosses, {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = call(tlosses, {k: _t(v) for k, v in arrays.items()}).numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("name,call", LOSS_CASES[:5], ids=[n for n, _ in LOSS_CASES[:5]])
def test_losses_labels_beyond_num_classes(name, call):
    """GT labels past the model's classes (a 20-class VOC tree under the
    6-class tiny model, as the --mini CLI trains) are rows of zeros, as
    in jax.nn.one_hot; the port's one-hot raised on them."""
    logits, _, weight, pred, target = _loss_inputs()
    labels = np.random.RandomState(1).randint(0, 20, logits.shape[0]).astype(np.int32)
    arrays = dict(logits=logits, labels=labels, weight=weight, pred=pred, target=target,
                  avg=np.float32(17.0))
    want = np.asarray(call(jlosses, {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = call(tlosses, {k: _t(v) for k, v in arrays.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)


# --- boxes, anchor flags, targets -------------------------------------------

def test_delta_encode_matches_jax():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 200, (2, 300, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 90, (2, 300, 2))], -1).astype(np.float32)
    gts = np.concatenate([xy + rng.uniform(-8, 8, (2, 300, 2)),
                          xy + rng.uniform(4, 90, (2, 300, 2))], -1).astype(np.float32)
    gts[0, :5] = 0.0  # padded rows: the eps floor keeps them finite
    for stds, eps in (((1.0, 1.0, 1.0, 1.0), 0.0), ((0.1, 0.1, 0.2, 0.2), 1e-6)):
        want = np.asarray(jbbox.delta_encode(jnp.asarray(props), jnp.asarray(gts),
                                             means=(0.0, 0.1, 0.0, -0.1), stds=stds, eps=eps))
        got = tbbox.delta_encode(_t(props), _t(gts), means=(0.0, 0.1, 0.0, -0.1),
                                 stds=stds, eps=eps).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("full", [False, True])
def test_anchor_valid_flags_bit_equal(full):
    jc = (JRetinaNetConfig() if full else jtiny()).for_orientation("portrait")
    tc = (TRetinaNetConfig() if full else ttiny()).for_orientation("portrait")
    h, w = jc.canvas
    shapes = np.array([[h, w], [h - 1, w - 33], [h // 3, 17], [1, 1]], np.int32)
    want = janchor_valid_flags(jc.build_anchor_generator(), jc.featmap_sizes(), shapes)
    got = tanchors.anchor_valid_flags(tc.build_anchor_generator(), tc.featmap_sizes(), shapes)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < got[2].sum() < got[0].sum() == got.shape[1]


# (anchors, gts, gt_valid, anchor_valid, assigner kwargs): tests/test_assigner.py:15-85
ASSIGN_CASES = {
    "docstring": ([[0, 0, 10, 10], [10, 10, 20, 20]], [[0, 0, 10, 9]], None, None,
                  dict(pos_iou_thr=0.5, neg_iou_thr=0.5)),
    "ignore_band": ([[0, 0, 10, 10], [0, 0, 10, 4.5], [50, 50, 60, 60]], [[0, 0, 10, 10]],
                    None, None, dict(pos_iou_thr=0.5, neg_iou_thr=0.4)),
    "low_quality": ([[0, 0, 10, 10], [20, 20, 30, 30]], [[0, 0, 10, 22]], None, None,
                    dict(pos_iou_thr=0.5, neg_iou_thr=0.4)),
    "last_gt_wins_tie": ([[0, 0, 10, 22]], [[0, 0, 10, 10], [0, 0, 10, 10]], None, None,
                         dict(pos_iou_thr=0.9, neg_iou_thr=0.2)),
    "argmax_only": ([[0, 0, 10, 22], [0, 0, 10, 22]], [[0, 0, 10, 10]], None, None,
                    dict(pos_iou_thr=0.9, neg_iou_thr=0.5, gt_max_assign_all=False)),
    "padded_gt": ([[0, 0, 10, 10]], [[0, 0, 10, 10], [0, 0, 10, 10]], [True, False], None,
                  dict(pos_iou_thr=0.5, neg_iou_thr=0.4)),
    "no_valid_gt": ([[0, 0, 10, 10], [5, 5, 15, 15]], [[0, 0, 10, 10]], [False], None, {}),
    "invalid_anchor": ([[0, 0, 10, 10], [0, 0, 10, 14]], [[0, 0, 10, 10]], None, [False, True],
                       dict(pos_iou_thr=0.9, neg_iou_thr=0.3)),
}


def _random_case():
    """A level of the tiny config's anchors, 5 GTs and 3 padded rows (one
    a duplicate, for ties), random pad-region flags."""
    rng = np.random.RandomState(7)
    anchors = ttiny().build_anchor_generator().grid_anchors(ttiny().featmap_sizes())[1]
    xy = rng.uniform(0, 200, (8, 2))
    gts = np.concatenate([xy, xy + rng.uniform(10, 60, (8, 2))], -1)
    gts[4] = gts[3]
    return (anchors, gts, [True] * 5 + [False] * 3, rng.uniform(size=len(anchors)) > 0.2,
            dict(pos_iou_thr=0.5, neg_iou_thr=0.4))


_ASSIGN_KW = ("pos_iou_thr", "neg_iou_thr", "min_pos_iou", "gt_max_assign_all")
_jassign = jax.jit(jassigner.max_iou_assign, static_argnames=_ASSIGN_KW)
_jtargets = jax.jit(jassigner.anchor_targets,
                    static_argnames=_ASSIGN_KW + ("num_classes", "target_stds"))


@pytest.mark.parametrize("case", list(ASSIGN_CASES) + ["random"])
def test_assign_and_targets_match_jax(case):
    anchors, gts, gt_valid, anchor_valid, kw = ASSIGN_CASES.get(case) or _random_case()
    anchors = np.asarray(anchors, np.float32)
    gts = np.asarray(gts, np.float32)
    gt_valid = np.ones(len(gts), bool) if gt_valid is None else np.asarray(gt_valid)
    av = np.ones(len(anchors), bool) if anchor_valid is None else np.asarray(anchor_valid)
    labels = (np.arange(len(gts)) % 3).astype(np.int32)

    want = np.asarray(_jassign(jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(gt_valid),
                               jnp.asarray(av), **kw))
    got = tassigner.max_iou_assign(_t(anchors), _t(gts)[None], _t(gt_valid)[None],
                                   _t(av)[None], **kw)[0].numpy()
    np.testing.assert_array_equal(got, want)

    jt = _jtargets(jnp.asarray(anchors), jnp.asarray(av), jnp.asarray(gts), jnp.asarray(labels),
                   jnp.asarray(gt_valid), num_classes=3, target_stds=(0.1, 0.1, 0.2, 0.2), **kw)
    tt = tassigner.anchor_targets(_t(anchors), _t(av)[None], _t(gts)[None], _t(labels)[None],
                                  _t(gt_valid)[None], num_classes=3,
                                  target_stds=(0.1, 0.1, 0.2, 0.2), **kw)
    for name in ("labels", "num_pos"):
        np.testing.assert_array_equal(getattr(tt, name)[0].numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    pos = np.asarray(jt.labels) < 3
    np.testing.assert_array_equal(tt.gt_inds[0].numpy()[pos], np.asarray(jt.gt_inds)[pos])
    for name in ("label_weights", "bbox_targets", "bbox_weights"):
        np.testing.assert_allclose(getattr(tt, name)[0].numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


class _FixedHeads(torch.nn.Module):
    """Stands in for the model: the same head outputs whatever the images."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = outputs

    def forward(self, images, with_meh=True):
        return self.outputs

    def apply(self, variables, images):  # the Flax model's call
        return tuple(jnp.asarray(o.numpy()) for o in self.outputs)


@pytest.mark.parametrize("cls_loss,meh_loss", [
    ("edl_softmax_focal", "l2"), ("edl_focal", "l1"), ("focal", "msle")])
def test_loss_fn_variants_match_jax(cls_loss, meh_loss):
    """make_retina_loss_fn's total and terms for every cls_loss and every
    meh_loss on the same head outputs and targets (rtol 1e-5)."""
    from aod_meh_hua_tpu.engine.train import make_retina_loss_fn as jmake_loss_fn

    over = dict(cls_loss=cls_loss, meh_loss=meh_loss)
    jc, tc = jtiny(**over), ttiny(**over)
    arrays = train_batch(jc, seed=6)
    n_anchor = jc.level_bounds()[-1][1]
    rng = np.random.RandomState(2)
    heads = (torch.from_numpy(rng.randn(2, n_anchor, jc.num_classes).astype(np.float32) * 2),
             torch.from_numpy(rng.randn(2, n_anchor, 4).astype(np.float32) * 0.3),
             torch.from_numpy(np.abs(rng.randn(2, n_anchor)).astype(np.float32)))
    fake = _FixedHeads(heads)
    jloss, janchors = jmake_loss_fn(fake, jc)
    _, want = jax.jit(jloss)(None, None, JBatch(*(jnp.asarray(a) for a in arrays)),
                             jnp.asarray(janchors))
    tloss, tanchors_ = ttrain.make_retina_loss_fn(fake, tc)
    _, got = tloss(TBatch(*(torch.from_numpy(a) for a in arrays)), torch.from_numpy(tanchors_))
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, err_msg=name)
    assert float(got["loss_meh"]) > 0


@pytest.mark.parametrize("over", [
    dict(cls_loss="focal"), dict(cls_loss="edl_focal"), dict(meh_loss="l1"),
    dict(meh_loss="msle"), dict(use_meh=False)],
    ids=["focal", "edl_focal", "meh_l1", "meh_msle", "no_meh"])
def test_ablation_flags_match_jax(over):
    """The ablation flags through the whole model: JAX's make_loss_fn
    (jitted; the batch has no exact low-quality IoU tie) and the port's on
    one JAX init carried over, every term to rtol 1e-4. Without the MEH
    branch the JAX tree has no lambda head, nor has the port's model, and
    loss_meh is 0."""
    from aod_meh_hua_tpu.engine.train import make_loss_fn as jmake_loss_fn

    jc, tc = jtiny(**over), ttiny(**over)
    jmodel, variables = jax_retinanet(**over)
    arrays = train_batch(jc, seed=3)
    assert no_exact_low_quality_ties(jc, arrays)
    jloss, janchors = jmake_loss_fn(jmodel, jc)
    _, want = jax.jit(jloss)(variables["params"], variables["batch_stats"],
                             JBatch(*(jnp.asarray(a) for a in arrays)), jnp.asarray(janchors))
    model = build_retinanet(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    tloss, tanchors = ttrain.make_loss_fn(model, tc)
    _, got = tloss(TBatch(*(torch.from_numpy(a) for a in arrays)), torch.from_numpy(tanchors))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=1e-4,
                                   err_msg=name)
    has_meh = over.get("use_meh", True)
    assert (float(got["loss_meh"]) > 0) == has_meh
    assert hasattr(model.head, "retina_L") == hasattr(model.head, "L_convs") == has_meh
    assert ("L_convs" in variables["params"]["head"]) == has_meh


# --- the train step -----------------------------------------------------------

TCFG = dict(batch_size=2)
STEPS = 2


@pytest.fixture(scope="module")
def two_steps():
    """The JAX step's aux and params after each of two steps, and the
    same two steps through the port (fresh model from the same init)."""
    jc = jtiny(**TINY)
    jmodel, variables = jax_retinanet(**TINY)
    arrays = train_batch(jc, seed=3)
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(**TCFG))
    # committed like the step's outputs, so the second step reuses the first's program
    state = jax.device_put(state, jax.devices()[0])
    step = jmake_train_step(jmodel, jc, tx)
    jaux, jparams = [], []
    for _ in range(STEPS):
        state, aux = step(state, JBatch(*(jnp.asarray(a) for a in arrays)))
        jaux.append({k: float(v) for k, v in aux.items()})
        jparams.append(from_jax_variables({"params": jax.device_get(state.params),
                                           "batch_stats": variables["batch_stats"]}))

    tc = ttiny(**TINY)
    model = build_retinanet(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ttrain.create_train_state(model, TTrainConfig(**TCFG))
    tstep = ttrain.make_train_step(model, tc, opt, device="cpu")
    taux, tparams = [], []
    for _ in range(STEPS):
        aux = tstep(TBatch(*arrays))
        taux.append({k: float(v) for k, v in aux.items()})
        tparams.append({k: v.clone() for k, v in model.state_dict().items()})
    return initial, jaux, jparams, taux, tparams


def test_train_step_losses_match_jax(two_steps):
    _, jaux, _, taux, _ = two_steps
    for i, (j, t) in enumerate(zip(jaux, taux)):
        assert set(t) == set(j)
        for name in j:
            np.testing.assert_allclose(t[name], j[name], rtol=1e-4, err_msg=f"step {i}: {name}")
        assert t["loss_meh"] > 0 and t["num_pos"] > 2
    assert taux[1]["loss"] < taux[0]["loss"]


def test_train_step_params_match_jax(two_steps):
    initial, _, jparams, _, tparams = two_steps
    for step, (want_sd, got_sd) in enumerate(zip(jparams, tparams)):
        assert set(want_sd) == set(got_sd)
        for name, want in want_sd.items():
            got = got_sd[name]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-4 * float(want.abs().max()) + 1e-12,
                                       err_msg=f"step {step}: {name}")
            # the update is read as new - old, so it carries the params' rounding
            dw, dt = want - initial[name], got - initial[name]
            ulp = np.finfo(np.float32).eps * float(want.abs().max())
            np.testing.assert_allclose(dt.numpy(), dw.numpy(), rtol=0,
                                       atol=1e-3 * float(dw.abs().max()) + 2 * ulp,
                                       err_msg=f"step {step}: update of {name}")


def test_frozen_params_do_not_move(two_steps):
    initial, _, _, _, tparams = two_steps
    model = build_retinanet(ttiny(**TINY), device="cpu")
    mask = ttrain.frozen_mask(model)
    frozen = [n for n, m in mask.items() if m]
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1."))
                          for n in frozen)
    last = tparams[-1]
    for name, is_frozen in mask.items():
        moved = not torch.equal(last[name], initial[name])
        assert moved != is_frozen, name
    assert not ttrain.frozen_mask(model, frozen_stages=0)["backbone.conv1.weight"]


def test_meh_gradient_partition():
    """The MEH loss's gradient touches the lambda branch only; the others'
    never do."""
    tc = ttiny(**TINY)
    _, variables = jax_retinanet(**TINY)
    model = build_retinanet(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    loss_fn, anchors = ttrain.make_retina_loss_fn(model, tc)
    arrays = train_batch(jtiny(**TINY), seed=4)
    batch = TBatch(*(torch.from_numpy(a) for a in arrays))
    _, aux = loss_fn(batch, torch.from_numpy(anchors))
    names, params = zip(*model.named_parameters())
    meh = torch.autograd.grad(aux["loss_meh"], params, retain_graph=True, allow_unused=True)
    rest = torch.autograd.grad(aux["loss_cls"] + aux["loss_bbox"], params, allow_unused=True)
    in_meh = [("L_convs" in n) or ("retina_L" in n) for n in names]
    for name, g, lam in zip(names, meh, in_meh):
        assert (g is not None and g.abs().max() > 0) == lam, f"MEH gradient at {name}"
    for name, g, lam in zip(names, rest, in_meh):
        assert lam == (g is None or g.abs().max() == 0), f"main gradient at {name}"


def test_schedule_lr_and_set_learning_rate():
    j, t = JTrainConfig(), TTrainConfig()
    for outer in range(j.outer_epoch):
        for inner in range(j.epoch_ratio[0]):
            assert ttrain.schedule_lr(t, outer, inner) == jschedule_lr(j, outer, inner)
    model = build_retinanet(ttiny(), device="cpu")
    opt = ttrain.make_optimizer(t, model)
    ttrain.set_learning_rate(opt, ttrain.schedule_lr(t, 1, 2))
    assert [g["lr"] for g in opt.param_groups] == [pytest.approx(1e-4)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ttrain.make_optimizer(dataclasses.replace(t, optimizer="adamw"), model)


def test_grad_clip_matches_optax_and_keeps_frozen_gradients(monkeypatch):
    rng = np.random.RandomState(5)
    grads = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                             None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        ttrain._clip_by_global_norm(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    # one TrainConfig.grad_clip decides both the frozen parameters'
    # requires_grad and the clip the step applies, over every gradient
    clips = []

    def recorder(params, max_norm, shard_group=None):
        params = list(params)
        clips.append((max_norm, params[0].grad is not None))
        real_clip(params, max_norm, shard_group)

    real_clip = ttrain._clip_by_global_norm
    monkeypatch.setattr(ttrain, "_clip_by_global_norm", recorder)
    tc = ttiny()
    batch = TBatch(*train_batch(tc, seed=4, b=1))
    model = build_retinanet(tc, device="cpu")
    for clip, frozen_grad in ((None, False), (10.0, True)):
        opt = ttrain.create_train_state(model, TTrainConfig(grad_clip=clip))
        assert model.backbone.conv1.weight.requires_grad is frozen_grad
        assert model.head.retina_L.weight.requires_grad
        ttrain.make_train_step(model, tc, opt, device="cpu")(batch)
    assert clips == [(10.0, True)]  # conv1.weight, frozen, comes first
