"""The port's eval slice (aod_meh_hua_torch/engine/eval.py and
utils/voc_eval.py) against the JAX package's, on the CPU.

1. make_eval_step on one batch of seeded uint8 canvases with varied
   img_shapes and scale_factors: the JAX init of tests/torch_parity.py
   TINY in both packages, the cls head sharpened so that detections pass
   the 0.05 score gate, the port with fused_blocks on (its plain version
   on the CPU). Each image has the same NMS survivors: labels equal,
   scores to rtol 1e-4, boxes to 1e-4 of the box scale, candidate
   indices equal but for swaps of candidates whose scores lie within
   1e-6, and the with_uncertainty column to 1e-5.
2. detections_to_per_class gives the same per-class arrays, up to the
   order of near-tied detections.
3. The copied voc_eval gives the same result as the JAX package's on
   seeded detections, bit for bit, in both AP modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine.eval import detections_to_per_class as jper_class
from aod_meh_hua_tpu.engine.eval import make_eval_step as jmake_eval_step
from aod_meh_hua_tpu.utils import voc_eval as jvoc
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.engine.eval import detections_to_per_class as tper_class
from aod_meh_hua_torch.engine.eval import make_eval_step as tmake_eval_step
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.ops import fused_block
from aod_meh_hua_torch.utils import voc_eval as tvoc
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny
from torch_parity import TINY, jax_retinanet
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


def _eval_batch(cfg, seed=0, b=3):
    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    images = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    shapes = np.array([[h, w], [h - 30, w], [h, w - 70]][:b], np.int32)
    sfs = np.repeat(rng.uniform(0.6, 1.8, (b, 1)), 4, axis=1).astype(np.float32)
    return images, shapes, sfs, np.ones(b, bool)


@pytest.fixture(scope="module")
def eval_outputs():
    """The JAX eval step's (dets, unc) and the port's on the same weights
    and batch, the cls head sharpened to logit std 1.5."""
    jmodel, variables = jax_retinanet(**TINY)
    tc = ttiny(fused_blocks=True, **TINY)
    model = build_retinanet(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    arrays = _eval_batch(tc)
    with torch.no_grad():
        logits = model(torch.from_numpy(arrays[0][:1]).float() / 64.0 - 2.0)[0]
    kernel = variables["params"]["head"]["retina_cls"]["kernel"]
    variables["params"]["head"]["retina_cls"]["kernel"] = kernel * (1.5 / logits.std().item())
    model.load_state_dict(from_jax_variables(variables))

    jdets, junc = jmake_eval_step(jmodel, jtiny(**TINY), with_uncertainty=True)(
        variables, JEvalBatch(*(jnp.asarray(a) for a in arrays)))
    before = fused_block.fused_bottleneck.launches
    tdets, tunc = tmake_eval_step(model, tc, with_uncertainty=True, device="cpu")(
        TEvalBatch(*arrays))
    plain = tmake_eval_step(model, tc, device="cpu")(TEvalBatch(*arrays))
    assert fused_block.fused_bottleneck.launches == before  # the CPU runs the plain version
    return jax.device_get(jdets), np.asarray(junc), tdets, tunc, plain


def _survivors(dets, unc, i):
    """(candidate index, label, score, box, unc) of image i's valid slots."""
    v = np.asarray(dets.valid[i])
    return list(zip(*(np.asarray(a[i])[v] for a in (dets.anchor_idx, dets.labels, dets.scores,
                                                     dets.boxes, unc))))


def test_eval_step_matches_jax(eval_outputs):
    """Each JAX survivor has one port survivor with its label, box and
    score, and the same candidate index. Head outputs differ by about 1e-6
    between the two libraries, so two candidates whose ranking keys lie
    about 1e-7 apart may trade places in the per-level top-k; a pair whose
    index differs must be such a swap: JAX's survivor at the port's index
    has the same score within 1e-6."""
    jdets, junc, tdets, tunc, plain = eval_outputs
    valid = np.asarray(jdets.valid)
    assert valid.sum(axis=1).min() > 0, "every image needs detections"
    np.testing.assert_array_equal(tdets.valid.numpy(), valid)
    box_tol = 1e-4 * np.abs(np.asarray(jdets.boxes)).max()
    swaps = 0
    for i in range(len(valid)):
        want, got = _survivors(jdets, junc, i), _survivors(tdets, tunc, i)
        j_score = {int(idx): s for idx, _, s, _, _ in want}
        used = set()
        for idx, label, score, box, u in want:
            match = [k for k, (_, tl, ts, tb, _) in enumerate(got) if k not in used
                     and tl == label and abs(ts - score) <= 1e-4 * score
                     and np.abs(tb - box).max() <= box_tol]
            assert len(match) == 1, (i, idx, label)
            used.add(match[0])
            t_idx, _, _, _, t_u = got[match[0]]
            if t_idx != idx:
                swaps += 1
                assert abs(j_score.get(int(t_idx), np.inf) - score) <= 1e-6 * score, (i, idx)
            assert abs(t_u - u) <= 1e-5 and u > 0, (i, idx)
    assert swaps <= 4
    assert (junc[~valid] == 0).all() and (tunc.numpy()[~valid] == 0).all()
    for a, b in zip(plain, tdets):
        assert torch.equal(a, b)


def test_detections_to_per_class_matches_jax(eval_outputs):
    jdets, junc, tdets, tunc, _ = eval_outputs
    keep = np.array([True, False, True])
    want = jper_class(jdets, 20, batch_valid=keep, unc=junc)
    got = tper_class(tdets, 20, batch_valid=keep, unc=tunc)
    assert len(got) == len(want) == 2
    for gi, wi in zip(got, want):
        assert len(gi) == len(wi) == 20
        for g, w in zip(gi, wi):
            assert g.shape == w.shape and g.dtype == np.float32
            g, w = g[np.lexsort(g.T)], w[np.lexsort(w.T)]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def _seeded_results(seed, n_img=12, n_cls=4):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(n_img):
        n = rng.randint(0, 6)
        xy = rng.uniform(0, 300, (n, 2))
        gts = np.concatenate([xy, xy + rng.uniform(10, 80, (n, 2))], 1).astype(np.float32)
        labels = rng.randint(0, n_cls, n)
        ann = {"bboxes": gts, "labels": labels}
        if rng.rand() < 0.3:
            ann["bboxes_ignore"] = gts[:1] + 3.0
            ann["labels_ignore"] = labels[:1]
        anns.append(ann)
        per_cls = []
        for c in range(n_cls):
            m = rng.randint(0, 5)
            base = gts[rng.randint(0, n, m)] if n else np.zeros((m, 4), np.float32)
            boxes = base + rng.normal(0, 6, (m, 4)).astype(np.float32)
            per_cls.append(np.concatenate([boxes, rng.uniform(0, 1, (m, 1))], 1)
                           .astype(np.float32))
        dets.append(per_cls)
    return dets, anns


@pytest.mark.parametrize("mode", ["11points", "area"])
@pytest.mark.parametrize("seed", [0, 1])
def test_voc_eval_copy_bit_equal(mode, seed):
    dets, anns = _seeded_results(seed)
    want = jvoc.eval_map(dets, anns, mode=mode)
    got = tvoc.eval_map(dets, anns, mode=mode)
    assert got == want
    assert 0.0 < got["mAP"] < 1.0
