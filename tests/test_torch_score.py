"""The port's Entropy_NMS scoring slice against the JAX package's, on the
CPU.

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
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.al.uncertainty import score_pool as jscore_pool
from aod_meh_hua_tpu.engine.batch import EvalBatch as JBatch
from aod_meh_hua_tpu.engine.postprocess import make_candidate_selector as jselector
from aod_meh_hua_tpu.engine.score import make_output_scorer as jscorer
from aod_meh_hua_tpu.models.detector import init_retinanet
from aod_meh_hua_tpu.utils.config import TestCfg as JTestCfg
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.al.uncertainty import score_pool as tscore_pool
from aod_meh_hua_torch.engine.batch import EvalBatch as TBatch
from aod_meh_hua_torch.engine.postprocess import make_candidate_selector as tselector
from aod_meh_hua_torch.engine.score import make_output_scorer as tscorer
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.ops import fused_block
from aod_meh_hua_torch.utils.config import TestCfg as TTestCfg
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

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
