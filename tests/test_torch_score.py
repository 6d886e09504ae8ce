"""The port's pool scoring against the JAX package's, on the CPU.

1. Candidate selection (per-level top-k, decode) on logits with many
   exact ties, as a zeroed pad region gives them.
2. `make_output_scorer` on identical synthetic head outputs: 32 images,
   20 classes, background-dominated logits with planted object clusters
   (the generator of tests/test_acquisition_oracle.py:64-102, shrunk).
   Zero sets must be identical and scores agree to rtol 1e-4.
3. `score_pool` end to end: the same in-memory (orientation, EvalBatch,
   indices) triples through the JAX model and the port's (weights
   carried over by `from_jax_variables`, fused_blocks on in the port),
   with the cls head sharpened so that objects pass the 0.3 gates.
   Zero sets identical, scores to rtol 1e-4 (f32 head outputs differ by
   ~1e-6 between the two convolution libraries, and the MI amplifies
   that through the lambda rescale), at least one non-zero score.
4. The scale pools (Entropy_ALL, Entropy_NoNMS): `make_scale_output_scorer`
   on the 32-image pool of item 2 against the JAX package's (zero sets identical,
   rtol 1e-4) and, as tests/test_acquisition_oracle.py:378-410
   (TestScaleAcquisitionOracle) does, against the float64 transcription
   of the reference in tests/reference_oracle.py:446 (|delta| < 5e-3,
   zero sets identical, Spearman > 0.998, the same acquired set up to
   boundary-marginal flips); `make_score_step` through the model for
   both pools is the scale core on the model's head outputs.
5. The sampled MI (hua.mi_mode="sampled"): at small concentrations the
   aleatoric term is about 0 (torch's own Dirichlet sampler returns the
   uniform point there); it converges to the closed form as
   tests/test_dirichlet.py:36 does; one generator seed gives one result;
   and through `make_output_scorer` at 500 draws it selects within the
   reference estimator's own Monte-Carlo noise
   (tests/test_acquisition_oracle.py:298-328), on a smaller pool, class
   count and nms_pre than item 2's because sampling on the CPU is slow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracle as oracle
from aod_meh_hua_tpu.al.uncertainty import score_pool as jscore_pool
from aod_meh_hua_tpu.data.splits import update_labeled_set
from aod_meh_hua_tpu.engine.batch import EvalBatch as JBatch
from aod_meh_hua_tpu.engine.postprocess import make_candidate_selector as jselector
from aod_meh_hua_tpu.engine.score import make_output_scorer as jscorer
from aod_meh_hua_tpu.engine.score import make_scale_output_scorer as jscale_scorer
from aod_meh_hua_tpu.models.detector import init_retinanet
from aod_meh_hua_tpu.ops.dirichlet import dirichlet_mi_sampled as jmi_sampled
from aod_meh_hua_tpu.utils.config import TestCfg as JTestCfg
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.al.uncertainty import score_pool as tscore_pool
from aod_meh_hua_torch.engine.batch import EvalBatch as TBatch
from aod_meh_hua_torch.engine.batch import prepare_images
from aod_meh_hua_torch.engine.postprocess import make_candidate_selector as tselector
from aod_meh_hua_torch.engine.score import make_output_scorer as tscorer
from aod_meh_hua_torch.engine.score import make_scale_core, make_score_step
from aod_meh_hua_torch.engine.score import make_scale_output_scorer as tscale_scorer
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.ops import fused_block
from aod_meh_hua_torch.ops.dirichlet import dirichlet_mi_sampled, dirichlet_mutual_information
from aod_meh_hua_torch.utils.config import TestCfg as TTestCfg
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

# binding top-k on the first three levels (4608/1152/288 > 256), reference thresholds
ORACLE_TEST = dict(nms_pre=256, score_thr=0.05, nms_iou_thr=0.5, max_per_img=100,
                   pre_nms_cands=1000)


def _cfgs(**over):
    hua = over.pop("hua", {})
    j = jtiny(num_classes=20, test=JTestCfg(**ORACLE_TEST), **over)
    t = ttiny(num_classes=20, test=TTestCfg(**ORACLE_TEST), **over)
    return (dataclasses.replace(j, hua=dataclasses.replace(j.hua, **hua)),
            dataclasses.replace(t, hua=dataclasses.replace(t.hua, **hua)))


def _gen_image(cfg, seed):
    """Head outputs of one image: background logits (std 0.35, so the
    max background prob stays under the 0.3 gate) with 0..5 planted
    object clusters; ~30% of images get none (exact-zero scores)."""
    rng = np.random.RandomState(100_000 + seed)
    bounds = cfg.level_bounds()
    a_total, c = bounds[-1][1], cfg.num_classes
    logits = (rng.randn(a_total, c) * 0.35).astype(np.float32)
    deltas = (rng.randn(a_total, 4) * 0.15).astype(np.float32)
    lams = (np.abs(rng.randn(a_total)) * 0.8 + 0.2).astype(np.float32)
    feats = cfg.featmap_sizes()
    for _ in range(rng.poisson(1.3)):
        lvl = rng.choice(len(bounds), p=[0.45, 0.3, 0.15, 0.07, 0.03])
        h, w = feats[lvl]
        y, x, a, cls = rng.randint(h), rng.randint(w), rng.randint(9), rng.randint(c)
        boost = rng.uniform(3.5, 7.0)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            idx = bounds[lvl][0] + (min(y + dy, h - 1) * w + min(x + dx, w - 1)) * 9 + a
            logits[idx, cls] += boost * rng.uniform(0.7, 1.0)
    ch, cw = cfg.canvas
    shape, sf = ((ch, (cw * 3) // 4), 1.6) if seed % 2 == 0 else (((ch * 3) // 4, cw), 0.8)
    return logits, deltas, lams, np.asarray(shape, np.int32), np.full(4, sf, np.float32)


def _pool(cfg, n=32):
    imgs = [_gen_image(cfg, i) for i in range(n)]
    return [np.stack([im[k] for im in imgs]) for k in range(5)]


def test_candidate_selection_with_ties():
    jc, tc = _cfgs()
    logits, deltas, lams, shapes, _ = _pool(jc, n=3)
    logits[:, 100:900] = logits[:, 99:100]  # 800 identical rows: tied keys
    jsel, janchors = jselector(jc)
    tsel, tanchors = tselector(tc)
    np.testing.assert_array_equal(janchors, tanchors)
    want = jax.jit(jsel)(janchors, logits, deltas, lams, shapes)
    got = tsel(torch.from_numpy(tanchors), *(torch.from_numpy(a) for a in
                                               (logits, deltas, lams, shapes)))
    assert got.bounds == tuple(want.bounds)
    np.testing.assert_array_equal(got.lambdas.numpy(), np.asarray(want.lambdas))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6 * 256)
    np.testing.assert_allclose(got.max_prob.numpy(), np.asarray(want.max_prob), rtol=1e-6)


@pytest.mark.parametrize("hua", [{}, dict(agg_order="scale_first", cls_weight=True)])
def test_output_scorer_matches_jax(hua):
    jc, tc = _cfgs(hua=hua)
    cls, deltas, lams, shapes, sfs = _pool(jc)
    ju, jm = (np.asarray(a) for a in jscorer(jc)(cls, deltas, lams, shapes, sfs))
    tu, tm = (a.numpy() for a in tscorer(tc, device="cpu")(cls, deltas, lams, shapes, sfs))
    np.testing.assert_array_equal(tu == 0, ju == 0)
    assert 0 < (ju == 0).sum() < len(ju)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=1e-6)


TINY = dict(block_counts=(2, 2, 1, 1), stem_width=32, num_classes=20)


def _triples(seed=0, batch=4):
    """(orientation, batch arrays, indices): 6 landscape + 4 portrait
    seeded uint8 canvases with varied img_shapes/scale_factors; the last
    landscape batch is padded."""
    rng = np.random.RandomState(seed)
    out, start = [], 0
    for orientation, n in (("landscape", 6), ("portrait", 4)):
        h, w = jtiny().for_orientation(orientation).canvas
        imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
        shapes = np.array([[rng.randint(h // 2, h + 1), rng.randint(w // 2, w + 1)]
                           for _ in range(n)], np.int32)
        sfs = np.repeat(rng.uniform(0.5, 2.0, (n, 1)), 4, axis=1).astype(np.float32)
        for i in range(0, n, batch):
            k = min(batch, n - i)
            rows = np.r_[np.arange(i, i + k), np.full(batch - k, i + k - 1)]
            valid = np.arange(batch) < k
            out.append((orientation, (imgs[rows], shapes[rows], sfs[rows], valid),
                        np.arange(start + i, start + i + k)))
        start += n
    return out


def test_score_pool_matches_jax():
    jc = jtiny(**TINY)
    jmodel, variables = init_retinanet(jc, jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    triples = _triples()
    # sharpen the cls head so that logits have std ~1.5: random weights
    # otherwise give ~uniform softmax (0.05) and every score reads 0
    probe = triples[0][1][0][:2].astype(np.float32) / 64.0 - 2.0
    logits = np.asarray(jax.jit(jmodel.apply)(variables, probe)[0])
    kernel = variables["params"]["head"]["retina_cls"]["kernel"]
    variables["params"]["head"]["retina_cls"]["kernel"] = kernel * (1.5 / logits.std())

    n = sum(len(idx) for *_, idx in triples)
    ju, jm = jscore_pool(jmodel, variables, jc, [(o, JBatch(*b), i) for o, b, i in triples], n)

    tc = ttiny(fused_blocks=True, **TINY)
    model = build_retinanet(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    before = fused_block.fused_bottleneck.launches
    tu, tm = tscore_pool(model, tc, [(o, TBatch(*b), i) for o, b, i in triples], n,
                         device="cpu")
    assert fused_block.fused_bottleneck.launches == before
    assert tu.shape == (n,) and np.isfinite(tu).all() and np.isfinite(tm).all()
    assert (tu > 0).any()
    np.testing.assert_array_equal(tu == 0, ju == 0)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=1e-5)


def test_score_pool_random_is_host_side():
    tc = ttiny(hua=dataclasses.replace(ttiny().hua, pool="Random"))
    u, m = tscore_pool(None, tc, [], 7, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(np.sort(u), np.arange(7.0))
    assert (m == 0).all()


# --- scale pools --------------------------------------------------------------

SCALE_AGG = "scaleAvg_classAvg"  # the reference AL scripts' default for these pools


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


@pytest.fixture(scope="module", params=["Entropy_ALL", "Entropy_NoNMS"])
def scale_pools(request):
    """(pool, JAX scores, port scores, float64 oracle scores) of the 32
    images of _pool through each package's scale scorer."""
    with_lambda = request.param == "Entropy_ALL"
    jc, tc = _cfgs(hua=dict(pool=request.param, agg=SCALE_AGG))
    cls, _, lams, _, _ = _pool(jc)
    lam = lams if with_lambda else None
    ju = np.asarray(jscale_scorer(jc)(cls, lam))
    tu = tscale_scorer(tc, device="cpu")(cls, lam).numpy()
    bounds = jc.level_bounds()
    hua = jc.hua
    ora = np.array([oracle.score_image_scale(
        [c[s0:s1] for s0, s1 in bounds],
        [lm[s0:s1] for s0, s1 in bounds] if with_lambda else None,
        fg_score_thr=hua.fg_score_thr, lambda_eps=hua.lambda_eps,
        lambda_scale=hua.lambda_scale, agg=SCALE_AGG) for c, lm in zip(cls, lams)])
    return request.param, ju, tu, ora


def test_scale_scorer_matches_jax(scale_pools):
    name, ju, tu, _ = scale_pools
    assert 0 < (ju == 0).sum() < len(ju), name
    np.testing.assert_array_equal(tu == 0, ju == 0, err_msg=name)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=1e-6, err_msg=name)


def test_scale_scorer_matches_oracle(scale_pools):
    name, _, tu, ora = scale_pools
    n = len(ora)
    assert (ora == 0).sum() > n // 20 and (ora > 0).sum() > n // 2, name
    assert np.abs(tu - ora).max() < 5e-3, name
    np.testing.assert_array_equal(tu == 0, ora == 0, err_msg=name)
    nz = ora > 0
    assert _spearman(tu[nz], ora[nz]) > 0.998, name
    x_all, x_l, x_s = np.arange(n), np.arange(0, n, 13), 8
    want = oracle.update_x_l(ora, x_all, x_l, x_s, 0.15, np.random.RandomState(7))
    got, _ = update_labeled_set(tu, x_all, x_l, x_s, np.random.RandomState(7), zero_rate=0.15)
    sym = set(want.tolist()) ^ set(got.tolist())
    if sym:  # only boundary-marginal flips
        unl = np.setdiff1d(x_all, x_l)
        kth = np.sort(ora[unl])[-(x_s - int(x_s * 0.15))]
        assert len(sym) <= 4 and max(abs(ora[i] - kth) for i in sym) < 5e-3, (name, sorted(sym))


@pytest.mark.parametrize("pool", ["Entropy_ALL", "Entropy_NoNMS"])
def test_score_step_scale_pools(pool):
    """The scale score step through the model (fused blocks on, plain on
    the CPU) is the scale core on the model's head outputs, and its
    max-confidence the full-map softmax max."""
    tc = ttiny(fused_blocks=True, **TINY)
    tc = dataclasses.replace(tc, hua=dataclasses.replace(tc.hua, pool=pool, agg=SCALE_AGG))
    model = build_retinanet(tc, device="cpu")
    with torch.no_grad():
        model.head.retina_cls.weight.mul_(150.0)  # logits of std ~1.5: FG anchors exist
    _, (images, shapes, sfs, valid), _ = _triples(seed=2)[0]
    unc, mconf = make_score_step(model, tc, device="cpu")(TBatch(images, shapes, sfs, valid))
    with torch.no_grad():
        cls, _, lam = model(prepare_images(torch.from_numpy(images), torch.from_numpy(shapes), tc))
    want = make_scale_core(tc)(cls, lam if pool == "Entropy_ALL" else None)
    assert unc.shape == (4,)
    torch.testing.assert_close(unc, want, rtol=0, atol=0)
    assert (unc > 0).any()
    torch.testing.assert_close(mconf, torch.softmax(cls, -1).flatten(1).amax(1), rtol=0, atol=0)


# --- the sampled MI --------------------------------------------------------------

def test_sampled_mi_small_alpha():
    """Near-certain anchors: alpha = p * lambda with p of 1e-6 and below.
    Draws keep their mass at the vertices, so the aleatoric term is about
    0, as jax.random.dirichlet gives."""
    alpha = np.array([[1e-8, 1e-8, 1e-8], [5e-4, 1e-9, 2e-9], [0.05, 0.05, 0.05]], np.float32)
    g = torch.Generator().manual_seed(0)
    got = dirichlet_mi_sampled(torch.from_numpy(alpha), g, num_samples=2000, chunk=200)
    want = jmi_sampled(jax.random.PRNGKey(0), jnp.asarray(alpha), num_samples=2000, chunk=200)
    exact = dirichlet_mutual_information(torch.from_numpy(alpha))
    assert got.aleatoric[:2].abs().max() < 1e-3 and np.abs(np.asarray(want.aleatoric)[:2]).max() < 1e-3
    np.testing.assert_allclose(got.aleatoric.numpy(), exact.aleatoric.numpy(), atol=0.02)
    np.testing.assert_allclose(got.aleatoric.numpy(), np.asarray(want.aleatoric), atol=0.02)
    np.testing.assert_allclose(got.total.numpy(), exact.total.numpy(), atol=0.02)


def test_sampled_mi_converges_and_is_seeded():
    rng = np.random.RandomState(20)
    alpha = torch.from_numpy(rng.uniform(0.3, 20.0, (16, 20)).astype(np.float32))
    exact = dirichlet_mutual_information(alpha)
    mc = dirichlet_mi_sampled(alpha, torch.Generator().manual_seed(0), num_samples=4000, chunk=200)
    for name, atol in (("total", 0.02), ("aleatoric", 0.02), ("epistemic", 0.03)):
        np.testing.assert_allclose(getattr(mc, name).numpy(), getattr(exact, name).numpy(),
                                   atol=atol, err_msg=name)
    runs = [dirichlet_mi_sampled(alpha, torch.Generator().manual_seed(s)).epistemic
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="multiple of chunk"):
        dirichlet_mi_sampled(alpha, torch.Generator(), num_samples=120, chunk=50)


SAMPLED_TEST = dict(nms_pre=32, score_thr=0.05, nms_iou_thr=0.5, max_per_img=100,
                    pre_nms_cands=1000)


def test_sampled_selection_within_reference_noise():
    """500 draws through make_output_scorer rank and select within the
    reference estimator's own noise: Spearman against the closed form
    > 0.99, and the acquired set overlaps the closed form's at least as
    much as the float64 oracle's 500-draw estimate does, less 2."""
    tc = ttiny(num_classes=8, test=TTestCfg(**SAMPLED_TEST))
    tc = dataclasses.replace(tc, hua=dataclasses.replace(tc.hua, mi_mode="sampled"))
    cls, deltas, lams, shapes, sfs = _pool(tc, n=24)
    step = tscorer(tc, device="cpu")
    sampled = step(cls, deltas, lams, shapes, sfs, torch.Generator().manual_seed(7))[0].numpy()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        step(cls, deltas, lams, shapes, sfs)

    _, anchors = tselector(tc)
    bounds = tc.level_bounds()
    t, hua = tc.test, tc.hua
    rng = np.random.RandomState(11)

    def ora(i, mi):
        return oracle.score_image(
            *([a[i][s0:s1] for s0, s1 in bounds] for a in (cls, deltas, lams)),
            [anchors[s0:s1] for s0, s1 in bounds], tuple(shapes[i]), sfs[i],
            nms_pre=t.nms_pre, score_thr=t.score_thr, nms_iou_thr=t.nms_iou_thr,
            max_per_img=t.max_per_img, obj_score_thr=hua.obj_score_thr,
            memb_iou_thr=hua.memb_iou_thr, fg_score_thr=hua.fg_score_thr,
            lambda_eps=hua.lambda_eps, lambda_scale=hua.lambda_scale, agg=hua.agg,
            target_means=tc.target_means, target_stds=tc.target_stds, mi=mi,
            rng=rng)["unc"]

    closed = np.array([ora(i, "closed") for i in range(len(cls))])
    ref = np.array([ora(i, "sampled") for i in range(len(cls))])
    np.testing.assert_array_equal(sampled == 0, closed == 0)
    nz = closed > 0
    assert nz.sum() >= len(cls) // 2
    assert _spearman(sampled[nz], closed[nz]) > 0.99
    x_all, x_l, x_s = np.arange(len(cls)), np.arange(0, len(cls), 13), 8
    pick = lambda u: set(update_labeled_set(u, x_all, x_l, x_s, np.random.RandomState(0))[0])
    sel_closed = pick(closed)
    assert len(pick(sampled) & sel_closed) >= len(pick(ref) & sel_closed) - 2
