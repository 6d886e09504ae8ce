"""The port's MEH-RetinaNet (aod_meh_hua_torch/models) against the JAX
package's on the CPU: one JAX init of a tiny config, carried over with
`from_jax_variables`, the same seeded images through both.

The config is tiny_test_config(block_counts=(2, 2, 1, 1), stem_width=32),
so layer1_1 (Cin 128) and layer2_1 (Cin 256) pass the fused gate. The
JAX side runs fused_blocks=False (its plain path; its fused path needs a
TPU outside interpret mode); the port runs both. Head outputs agree to
1e-4 in f32 (TF32 does not arise on the CPU).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine.batch import prepare_images as jprepare
from aod_meh_hua_tpu.models.detector import init_retinanet
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.al.loop import ALDriver, ALPaths
from aod_meh_hua_torch.api import Detector
from aod_meh_hua_torch.al.uncertainty import score_pool
from aod_meh_hua_torch.engine.batch import prepare_images as tprepare
from aod_meh_hua_torch.engine.eval import make_eval_step
from aod_meh_hua_torch.engine.score import (make_output_scorer, make_scale_output_scorer,
                                            make_score_step)
from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import MEHRetinaNet, build_retinanet
from aod_meh_hua_torch.ops import fused_block
from aod_meh_hua_torch.models.ssd_detector import build_ssd
from aod_meh_hua_torch.tools import train_retinanet, train_ssd
from aod_meh_hua_torch.utils.config import ALConfig, SSDConfig, TrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import numerics_flags_kept
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

TINY = dict(block_counts=(2, 2, 1, 1), stem_width=32)


@pytest.fixture(scope="module")
def jax_model():
    model, variables = init_retinanet(jtiny(**TINY), jax.random.PRNGKey(0))
    return jax.jit(model.apply), jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _images(orientation, b=2, seed=0):
    h, w = jtiny().for_orientation(orientation).canvas
    return np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)


def _port_model(variables, fused):
    model = build_retinanet(ttiny(fused_blocks=fused, **TINY), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return model


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_head_outputs_match_jax(jax_model, fused, orientation):
    japply, variables = jax_model
    x = _images(orientation)
    want = [np.asarray(a) for a in japply(variables, x)]
    model = _port_model(variables, fused)
    before = fused_block.fused_bottleneck.launches
    with torch.no_grad():
        got = [a.numpy() for a in model(torch.from_numpy(x))]
    assert fused_block.fused_bottleneck.launches == before
    for name, g, w in zip(("cls_scores", "bbox_preds", "lambdas"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=name)


def test_state_dict_loads_fused_and_unfused(jax_model):
    _, variables = jax_model
    sd = from_jax_variables(variables)
    for fused in (False, True):
        model = MEHRetinaNet(ttiny(fused_blocks=fused, **TINY))
        assert set(model.state_dict()) == set(sd)
        model.load_state_dict(sd)
    gated = [name for name, m in model.backbone.named_modules()
             if hasattr(m, "fused_eligible") and m.fused_eligible(m.conv1.in_channels)]
    assert gated == ["layer1.1", "layer2.1"]


def test_prepare_images_matches_jax():
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (3, 32, 48, 3)).astype(np.uint8)
    shapes = np.array([[32, 48], [20, 48], [32, 30]], np.int32)
    cfg_j, cfg_t = jtiny(), ttiny()
    want = np.asarray(jprepare(images, shapes, cfg_j))
    got = tprepare(torch.from_numpy(images), torch.from_numpy(shapes), cfg_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert (got[1, 20:] == 0).all() and (got[2, :, 30:] == 0).all()
    f = torch.from_numpy(np.array(want))
    assert tprepare(f, torch.from_numpy(shapes), cfg_t) is f


def test_entry_points_raise_without_a_card():
    """Entry points default to the card and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ttiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_retinanet(cfg)
    model = build_retinanet(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_score_step(model, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_output_scorer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_pool(model, cfg, [], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_scale_output_scorer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(model, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, cfg, create_train_state(model, TrainConfig()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALDriver(cfg, TrainConfig(), ALConfig(), ALPaths(voc07="VOC2007", voc12=None,
                                                         work_dir="unused"))
    with pytest.raises(RuntimeError, match="no CUDA device"), numerics_flags_kept():
        train_retinanet.main(["--mini", "--voc07", "VOC2007", "--work-dir", "unused"])
    scfg = SSDConfig(width_mult=0.125)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ssd(scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALDriver(scfg, TrainConfig(), ALConfig(), ALPaths(voc07="VOC2007", voc12=None,
                                                          work_dir="unused"))
    with pytest.raises(RuntimeError, match="no CUDA device"), numerics_flags_kept():
        train_ssd.main(["--mini", "--voc07", "VOC2007", "--work-dir", "unused"])


def test_backward_through_a_fused_block_raises():
    """The fused kernel has no backward, as the JAX kernel defines no VJP:
    a backward through a fused block raises, whether the block's
    parameters or only its input require grad. A forward under no_grad
    or inference mode, or one never differentiated, is the plain one."""
    fused = build_retinanet(ttiny(fused_blocks=True, **TINY), device="cpu")
    plain = build_retinanet(ttiny(**TINY), device="cpu")
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_images("landscape", b=1))
    with torch.no_grad():
        want = plain(x)
        got = fused(x)
    with torch.inference_mode():
        got_inf = fused(x)
    free = fused(x)
    for g, gi, gf, w in zip(got, got_inf, free, want):
        assert torch.equal(g, gi) and torch.equal(g, gf.detach())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="fused_bottleneck has no backward"):
        free[0].sum().backward()
    for p in fused.parameters():
        p.requires_grad_(False)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_bottleneck has no backward"):
        fused(xg)[1].sum().backward()
    plain(xg)[1].sum().backward()
    assert xg.grad is not None and xg.grad.abs().max() > 0


def _two_stage_tta(image):
    """Detector.tta of a mask family (the dense families' TTA is ported,
    tests/test_torch_tta.py; Faster and Cascade R-CNN's too,
    tests/test_torch_tta_two_stage.py)."""
    det = Detector(ttiny(), build_retinanet(ttiny(), device="cpu"))
    det.cfg = SimpleNamespace(family="mask_rcnn")
    return det.tta(image)


@pytest.mark.parametrize("make", [
    lambda: MEHRetinaNet(ttiny(stem_s2d=True)), lambda: MEHRetinaNet(ttiny(backbone_int8=True)),
    lambda: MEHRetinaNet(ttiny(remat=True)),
    lambda: _two_stage_tta(np.zeros((40, 80, 3), np.uint8)),
    lambda: MEHRetinaNet(ttiny(compute_dtype="bfloat16"))],
    ids=["stem_s2d", "backbone_int8", "remat", "Detector.tta", "bfloat16"])
def test_unported_options_raise(make):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        make()


@pytest.mark.parametrize("override", [dict(test=dict(fast_topk=True))])
def test_unported_scoring_options_raise(override):
    base = ttiny()
    (field, values), = override.items()
    cfg = dataclasses.replace(base, **{field: dataclasses.replace(getattr(base, field), **values)})
    model = build_retinanet(base, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        make_score_step(model, cfg, device="cpu")


def _tiny_builds():
    from aod_meh_hua_torch.models import two_stage
    from aod_meh_hua_torch.models import detector, ssd_detector
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    yield "retinanet", detector, lambda: build_retinanet(ttiny(), device="cpu", seed=3)
    yield "ssd", ssd_detector, lambda: build_ssd(SSDConfig(width_mult=0.125), device="cpu",
                                                 seed=3)
    for family, (_, tiny) in ZOO_FAMILIES.items():
        yield family, two_stage, lambda tiny=tiny: two_stage.build_two_stage(tiny(), "cpu", 3)
    for backbone in ("resnext", "res2net", "regnet"):
        yield backbone, two_stage, lambda backbone=backbone: two_stage.build_two_stage(
            ZOO_FAMILIES["faster_rcnn"][1](backbone_type=backbone, regnet_arch="regnetx_400mf"),
            "cpu", 3)


@pytest.mark.parametrize("name", [n for n, _, _ in _tiny_builds()])
def test_builders_skip_only_overwritten_default_init(name, monkeypatch):
    """The builders construct under SkipDefaultInit: every conv and linear
    layer whose default init it skips is drawn again by init_weights, so
    the state dict equals a build with torch's default init, bit for bit."""
    import contextlib

    module, build = next((m, b) for n, m, b in _tiny_builds() if n == name)
    skipped = build().state_dict()
    monkeypatch.setattr(module, "SkipDefaultInit", contextlib.nullcontext)
    default = build().state_dict()
    assert list(skipped) == list(default)
    for k, v in default.items():
        assert torch.equal(skipped[k], v), k
