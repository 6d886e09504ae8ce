"""The necks and GN+WS's modules in the port (aod_meh_hua_torch:
models/hrnet.py HRFPN and its bilinear resize, models/fpg.py FPG,
models/gn_ws.py WSResNet, WSFPN and Shared4Conv1FCBBoxHead) against the
JAX package's, on the CPU, f32, and the canvas that HRNet and FPG refuse
(models/two_stage.py check_canvas) beside the JAX package's failure on it.

The modules run on seeded numpy draws of their JAX variables carried
over with from_jax_variables (tests/test_torch_backbones.py run_module).
HRFPN's resize and FPG run at the full-width level sizes (HRNet's and
FPG's 640 x 1024 canvas) in both orientations, at narrow channel widths.

Tolerances: the resize within 1e-6 of its max-abs; every module within
1e-5 of its output's max-abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aod_meh_hua_tpu.models import fpg as jfpg
from aod_meh_hua_tpu.models import gn_ws as jgn_ws
from aod_meh_hua_tpu.models import hrnet as jhrnet
from aod_meh_hua_tpu.models import build_faster_rcnn
from aod_meh_hua_tpu.engine.two_stage import _stage1
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.models import fpg as tfpg
from aod_meh_hua_torch.models import gn_ws as tgn_ws
from aod_meh_hua_torch.models import hrnet as thrnet
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.utils import config as tcfg
from test_torch_backbones import close_of_scale, draw_variables
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

# the stride-4..64 level sizes of the 640 x 1024 canvas
LEVELS = {"landscape": [(160, 256), (80, 128), (40, 64), (20, 32), (10, 16)],
          "portrait": [(256, 160), (128, 80), (64, 40), (32, 20), (16, 10)]}


def _levels(sizes, channels, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(sizes, channels)]


def _run(jmodule, tmodule, inputs, seed=0):
    """(JAX outputs, port outputs as NHWC numpy) of a module over a list
    of NHWC maps, the JAX variables drawn and carried over."""
    from aod_meh_hua_torch.models.convert import from_jax_variables

    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), inputs)
    variables = draw_variables(shapes, seed)
    tmodule.load_state_dict(from_jax_variables(variables))
    want = jmodule.apply(variables, [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = tmodule([torch.from_numpy(x).permute(0, 3, 1, 2) for x in inputs])
    return want, [g.permute(0, 2, 3, 1).numpy() for g in got]


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_hrfpn_resize_is_jax_image_resize(orientation):
    """jax.image.resize's bilinear upsample by 2, 4 and 8 of HRNet's
    branches at the full-width canvas is F.interpolate's bilinear with
    align_corners=False at the output size."""
    sizes = LEVELS[orientation]
    for i, x in enumerate(_levels(sizes[1:4], (3, 3, 3), seed=1), start=1):
        f = 2 ** i
        b, h, w, c = x.shape
        want = np.asarray(jax.image.resize(jnp.asarray(x), (b, h * f, w * f, c), "bilinear"))
        got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(h * f, w * f),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
        assert got.shape[1:3] == sizes[0]
        close_of_scale(got, want, tol=1e-6)


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_hrfpn_matches_jax(orientation):
    inputs = _levels(LEVELS[orientation][:4], (4, 8, 16, 32), seed=2)
    want, got = _run(jhrnet.HRFPN(out_channels=8), thrnet.HRFPN((4, 8, 16, 32), 8), inputs)
    assert [g.shape[1:3] for g in got] == LEVELS[orientation]
    for w, g in zip(want, got):
        close_of_scale(g, w)


def test_hrmodule_fuses_four_branches_as_jax():
    """The exchange unit at four branches: every coarser-to-finer 1x1 with
    its nearest upsample and every finer-to-coarser stride-2 chain."""
    inputs = _levels([(24, 32), (12, 16), (6, 8), (3, 4)], (4, 8, 16, 32), seed=3)
    want, got = _run(jhrnet.HRModule(channels=(4, 8, 16, 32), num_blocks=2),
                     thrnet.HRModule((4, 8, 16, 32), 2), inputs, seed=5)
    for w, g in zip(want, got):
        close_of_scale(g, w)


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_fpg_matches_jax(orientation):
    """The reference's nine stages over the full-width levels, 8 channels."""
    inputs = _levels(LEVELS[orientation][:4], (8, 12, 16, 20), seed=6)
    want, got = _run(jfpg.FPG(out_channels=8, inter_channels=8),
                     tfpg.FPG((8, 12, 16, 20), 8, 8), inputs, seed=7)
    assert [g.shape[1:3] for g in got] == LEVELS[orientation]
    for w, g in zip(want, got):
        close_of_scale(g, w)


@pytest.mark.parametrize("ws", [True, False])
def test_gn_ws_modules_match_jax(ws):
    """WSResNet, WSFPN (a level whose doubled coarser one is cropped) and
    the Shared4Conv1FC head, with and without weight standardisation."""
    x = np.random.RandomState(8).randn(2, 64, 96, 3).astype(np.float32)
    from test_torch_backbones import run_module

    want, got = run_module(jgn_ws.WSResNet(block_counts=(1, 1, 1, 1), stem_width=8, ws=ws),
                           tgn_ws.WSResNet((1, 1, 1, 1), 8, ws=ws), x, seed=9)
    for w, g in zip(want, got):
        close_of_scale(g.permute(0, 2, 3, 1).numpy(), w)
    inputs = _levels([(19, 32), (10, 16), (5, 8), (3, 4)], (32, 64, 128, 256), seed=10)
    want, got = _run(jgn_ws.WSFPN(out_channels=16, ws=ws),
                     tgn_ws.WSFPN((32, 64, 128, 256), 16, ws=ws), inputs, seed=11)
    for w, g in zip(want, got):
        close_of_scale(g, w)
    rois = np.random.RandomState(12).randn(10, 7, 7, 16).astype(np.float32)
    jhead = jgn_ws.Shared4Conv1FCBBoxHead(num_classes=6, conv_channels=16, fc_channels=32,
                                          ws=ws)
    thead = tgn_ws.Shared4Conv1FCBBoxHead(6, 16, 7, 16, 32, ws=ws)
    from aod_meh_hua_torch.models.convert import from_jax_variables

    variables = draw_variables(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), rois), 13)
    thead.load_state_dict(from_jax_variables(variables))
    want = jhead.apply(variables, jnp.asarray(rois))
    with torch.no_grad():
        got = thead(torch.from_numpy(rois))
    for w, g in zip(want, got):
        close_of_scale(g.numpy(), w)


@pytest.mark.parametrize("canvas", [(96, 128), (128, 96), (608, 1024)])
@pytest.mark.parametrize("family", ["hrnet", "fpg"])
def test_odd_stride_64_canvas_refused_where_jax_fails(family, canvas):
    """A side that does not divide by 64: the port refuses the config at
    model build and at step creation with a ValueError naming the canvas
    and the level; the JAX package builds FPG's neck into a shape error,
    and HRNet's RPN into fewer rows than its anchor table."""
    tc = tcfg.ZOO_FAMILIES[family][1](canvas=canvas)
    with pytest.raises(ValueError, match=rf"canvas \({canvas[0]}, {canvas[1]}\).*P6"):
        tmodels.build_two_stage(tc, device="cpu")
    with pytest.raises(ValueError, match="does not divide by 64"):
        tmodels.check_two_stage_options(tc.for_orientation("portrait"))
    if canvas == (608, 1024):  # the JAX side at full size is not traced here
        return
    jc = jcfg.ZOO_FAMILIES[family][1](canvas=canvas)
    jmodel = build_faster_rcnn(jc)
    x = jax.ShapeDtypeStruct((1, *canvas, 3), np.float32)
    if family == "fpg":
        with pytest.raises(TypeError, match="incompatible shapes"):
            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
        return
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
    _, rpn_cls, _ = jax.eval_shape(lambda v, i: jmodel.apply(v, i, method=_stage1), shapes, x)
    rows, anchors = rpn_cls.shape[1], jc.level_bounds()[-1][1]
    assert rows < anchors, (rows, anchors)
    # the shortfall is P6's: floor against the anchor table's ceiling
    h6, w6 = jc.featmap_sizes()[-1]
    assert anchors - rows == jc.rpn.num_anchors * (h6 * w6 - (canvas[0] // 64) * (canvas[1] // 64))


@pytest.mark.parametrize("family", ["hrnet", "fpg"])
def test_stride_64_canvases_build(family):
    for canvas in ((64, 128), (640, 1024), (1024, 640)):
        tmodels.check_two_stage_options(tcfg.ZOO_FAMILIES[family][1](canvas=canvas))
