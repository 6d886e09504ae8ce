"""The port's inference API (aod_meh_hua_torch/api.py) and its pool-scoring
CLI (aod_meh_hua_torch/tools/score_pool.py) against the JAX package's, on
the CPU, f32.

Weights: tests/torch_parity.py jax_retinanet draws on the tiny config
(and jax_ssd's thin SSD), the cls head sharpened (kernel x150) so that
detections and pool scores are not all alike; the port loads them with
from_jax_variables, and the CLI reads the files the JAX package's own
engine/checkpoint.py save_checkpoint wrote.

Tolerances: Detector results per class with equal counts (so equal
labels), boxes and scores (and the sixth column, the per-detection
entropy) to rtol 1e-4; predict_batch equal to the single calls to rtol
1e-5 (the batch changes the sums' order); the CLI's hua and ensemble
scores to rtol 1e-4 of the JAX functions that the JAX tool calls, with
its --mini config and pipeline (tools/score_pool.py:84-91), and the same
zero set; random and numobj exact.
"""

import asyncio
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.al.baselines import score_pool_ensemble as jscore_pool_ensemble
from aod_meh_hua_tpu.al.uncertainty import score_num_objects as jscore_num_objects
from aod_meh_hua_tpu.al.uncertainty import score_pool as jscore_pool
from aod_meh_hua_tpu.data import ConcatVOC as JConcatVOC
from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.engine.checkpoint import save_checkpoint as jsave_checkpoint
from aod_meh_hua_tpu.utils.config import SSDConfig as JSSDConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.tools import score_pool as tcli
from aod_meh_hua_torch.utils.config import SSDConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import THIN_SSD, jax_retinanet, jax_ssd, mini_voc, numerics_flags_kept, sharpen

pytestmark = pytest.mark.usefixtures("few_threads")

SHARPEN = 150.0


def _pipe(cls, cfg):
    """The pipeline of tests/test_api.py: a resize rule that always fits
    the tiny canvas."""
    h, w = cfg.canvas
    return cls(img_scale=(max(h, w), min(h, w)), canvas=cfg.canvas, device_normalize=True)


def _images(n=5):
    """tests/test_api.py's mix of landscape and portrait images."""
    r = np.random.RandomState(7)
    shapes = [(40, 80), (36, 70), (80, 40), (50, 90), (70, 36)]
    return [(r.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes[:n]]


@pytest.fixture(scope="module")
def shared():
    jmodel, variables = jax_retinanet()
    variables = sharpen(variables, SHARPEN)
    model = tapi.init_detector(ttiny(), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, model


def _assert_same(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"class {c}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4, err_msg=f"class {c}")


@pytest.fixture(scope="module")
def jax_results(shared):
    """JAX's Detector(with_uncertainty=True) on each image: its first five
    columns are JAX's plain results (the same detections)."""
    jmodel, variables, _ = shared
    jdet = japi.Detector(jtiny(), jmodel, variables, pipeline=_pipe(JPipelineConfig, jtiny()),
                         with_uncertainty=True)
    return [jdet(img) for img in _images()]


@pytest.mark.parametrize("with_uncertainty", [False, True])
def test_detector_matches_jax(shared, jax_results, with_uncertainty):
    _, _, model = shared
    tdet = tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig, ttiny()),
                         with_uncertainty=with_uncertainty)
    plain = tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig, ttiny()))
    n_dets = 0
    for img, want in zip(_images(), jax_results):
        got = tdet(img)
        _assert_same(got, want if with_uncertainty else [a[:, :5] for a in want])
        assert all(a.shape[1] == (6 if with_uncertainty else 5) for a in got)
        n_dets += sum(len(a) for a in got)
        if with_uncertainty:
            for a, b in zip(got, plain(img)):
                np.testing.assert_array_equal(a[:, :5], b)
    assert n_dets > 0


def test_ssd_detector_matches_jax():
    jmodel, variables = jax_ssd()
    jcfg, tcfg = JSSDConfig(**THIN_SSD), SSDConfig(**THIN_SSD)
    model = tapi.init_detector(tcfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    img = _images(1)[0]
    got = tapi.Detector(tcfg, model)(img)
    want = japi.Detector(jcfg, jmodel, variables)(img)
    _assert_same(got, want)
    assert sum(len(a) for a in got) > 0


def test_predict_batch_matches_single(shared):
    """Padded fixed-shape batches, grouped by orientation, in input order,
    across a chunk boundary (5 images, max_batch 2: 3 chunks)."""
    _, _, model = shared
    det = tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig, ttiny()))
    imgs = _images()
    batched = det.predict_batch(imgs, max_batch=2)
    assert len(batched) == len(imgs)
    for img, b in zip(imgs, batched):
        _assert_same(b, det(img), rtol=1e-5)


def test_inference_detector_and_async(shared):
    _, _, model = shared
    det = tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig, ttiny()))
    imgs = _images(2)
    single = [det(i) for i in imgs]
    listed = tapi.inference_detector(det, imgs)
    for a, b in zip(listed, single):
        _assert_same(a, b, rtol=0)
    _assert_same(tapi.inference_detector(det, imgs[0]), single[0], rtol=0)

    async def go():
        return await asyncio.gather(*(tapi.async_inference_detector(det, i) for i in imgs))

    for a, b in zip(asyncio.run(go()), single):
        _assert_same(a, b, rtol=0)


def test_other_families_raise(shared):
    _, _, model = shared
    other = SimpleNamespace(family="fcos", canvas=(128, 256))
    with pytest.raises(NotImplementedError, match="item 15"):
        tapi.init_detector(other, device="cpu")
    with pytest.raises(ValueError, match="retinanet/ssd"):
        tapi.Detector(other, model, with_uncertainty=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        tapi.Detector(other, model)
    with pytest.raises(NotImplementedError, match="item 13"):
        tapi.show_result(_images(1)[0], [])


# --- the score_pool CLI ---------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The mini VOC tree, a --split of its 12 landscape images (one
    compiled JAX program per method; the other tests hold both
    orientations), and three checkpoints the JAX package wrote."""
    root = tmp_path_factory.mktemp("score_pool")
    voc = mini_voc(root / "voc")
    ds = JVOCDataset(os.path.join(voc, "ImageSets/Main/trainval.txt"), voc)
    split = root / "landscape.txt"
    split.write_text("\n".join(i for i in ds.img_ids if ds.image_size_by_id(i)[0] >
                                ds.image_size_by_id(i)[1]))
    members = [sharpen(jax_retinanet(seed)[1], SHARPEN) for seed in (1, 2, 3)]
    ckpts = [jsave_checkpoint(str(root / f"member{i}.ckpt"), v) for i, v in enumerate(members)]
    return SimpleNamespace(root=root, voc=voc, split=str(split), members=members, ckpts=ckpts,
                           jmodel=jax_retinanet()[0])


def _jax_loader(voc, split):
    """The JAX tool's --mini pool and loader (tools/score_pool.py:84-120)."""
    cfg = jtiny()
    pool = JConcatVOC([JVOCDataset(split, voc)])
    pipe = JPipelineConfig(img_scale=(250, 120), canvas=cfg.canvas)
    return pool, JEvalLoader(pool, np.arange(len(pool)), pipe, batch_size=8)


@pytest.mark.parametrize("method", ["hua", "ensemble", "random", "numobj", "mcdropout"])
def test_score_pool_cli_matches_jax(pool, method, capsys):
    out = str(pool.root / f"{method}.npy")
    ckpts = pool.ckpts if method == "ensemble" else pool.ckpts[:1]
    argv = ["--mini", "--cpu", "--voc07", pool.voc, "--split", pool.split, "--method", method,
            "--out", out, "--checkpoint", *ckpts, "--passes", "3"]
    with numerics_flags_kept():
        got = tcli.main(argv)
    np.testing.assert_array_equal(np.load(out), got)
    lines = capsys.readouterr().out.splitlines()
    jpool, jloader = _jax_loader(pool.voc, pool.split)
    n = len(jpool)
    assert n == 12
    assert lines[-2].startswith(f"scored {n} images with {method} in ")
    assert lines[-1].startswith("stats: zeros=")
    assert got.shape == (n,) and got.dtype == np.float64 and np.isfinite(got).all()
    if method == "random":
        np.testing.assert_array_equal(got, np.random.RandomState(20).permutation(n))
    elif method == "numobj":
        np.testing.assert_array_equal(got, jscore_num_objects(jpool, np.arange(n)))
    elif method == "mcdropout":
        assert (got > 0).all()
    else:
        if method == "hua":
            want, _ = jscore_pool(pool.jmodel, pool.members[0], jtiny(), jloader, n,
                                  rng=np.random.RandomState(20))
        else:
            want = jscore_pool_ensemble(pool.jmodel, pool.members, jtiny(), jloader, n)
        assert (want > 0).sum() >= 3
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_score_pool_cli_refusals(pool):
    base = ["--mini", "--cpu", "--voc07", pool.voc, "--out", str(pool.root / "x.npy")]
    with pytest.raises(ValueError, match="2\\+ checkpoints"), numerics_flags_kept():
        tcli.main(base + ["--method", "ensemble", "--checkpoint", pool.ckpts[0]])
    # SSDConfig has no mc_dropout field, in either package
    with pytest.raises(TypeError, match="mc_dropout"), numerics_flags_kept():
        tcli.main(base + ["--family", "ssd", "--method", "mcdropout"])
    if not torch.cuda.is_available():  # the card unless --cpu, and no carrying on without
        with pytest.raises(RuntimeError, match="no CUDA device"), numerics_flags_kept():
            tcli.main(["--mini", "--voc07", pool.voc, "--method", "random",
                       "--out", str(pool.root / "y.npy")])


def test_init_detector_reads_a_jax_checkpoint(pool):
    model = tapi.init_detector(ttiny(), checkpoint=pool.ckpts[1], seed=5, device="cpu")
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, pool.members[1]))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
