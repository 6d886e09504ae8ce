"""torch.export of the two-stage families' eval step (aod_meh_hua_torch:
engine/two_stage.py TwoStageEvalStep, tools/deployment/export_model.py),
on the CPU, f32.

For each of Faster, Cascade, Dynamic and Double-Head R-CNN (the Faster
R-CNN variants: tests/test_torch_export_rcnn_variants.py), in both
orientations (the portrait program from cfg.for_orientation("portrait"),
its anchors and canvas that config's): the tiny model's eval step
exported at batch 2 against the eager step on the same batch: every
NMSResult field equal, bit for bit (Dynamic R-CNN's program through a
save and a load; the cascade's archive, saved, packaged and loaded in a
fresh process: tests/test_torch_serve_two_stage.py). The eager steps
are held to JAX in tests/test_torch_two_stage.py and
tests/test_torch_rcnn_entry_points.py.

Weights: one JAX variables draw per family (tests/torch_parity.py
two_stage_pair: the RPN and class heads sharpened), so that several
proposals suppress each other: the proposal NMS's fixpoint is checked to
be more than one application deep on this input. Also: the cascade's
three stages lie in one program, Dynamic R-CNN's statistics buffers ride
along unused, the double head's BN reads its running statistics and the
program writes no buffer, and the export CLI's config choice.
"""

import io

import numpy as np
import pytest
import torch

from aod_meh_hua_torch.engine.batch import EvalBatch
from aod_meh_hua_torch.engine.two_stage import TwoStageEvalStep, make_two_stage_eval_step
from aod_meh_hua_torch.tools.deployment import export_model
from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

from chip_smoke import fixpoint_depths
from torch_parity import two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

B = 2


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    shapes = np.array([[h, w], [h - 8, w - 16]], np.int32)
    images = rng.randn(B, h, w, 3).astype(np.float32)
    images[1, shapes[1, 0]:] = 0
    images[1, :, shapes[1, 1]:] = 0
    return EvalBatch(images, shapes, np.array([[1.0] * 4, [0.8, 0.9, 0.8, 0.9]], np.float32),
                     np.ones(B, bool))


# the families of this file; the Faster R-CNN variants export in
# tests/test_torch_export_rcnn_variants.py (this file's time budget)
FAMILIES = ("faster_rcnn", "cascade_rcnn", "dynamic_rcnn", "double_head_rcnn")


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("family", FAMILIES)
def test_exported_program_equals_the_eager_step(family, orientation):
    _, _, model = two_stage_pair(family)
    cfg = ZOO_FAMILIES[family][1]().for_orientation(orientation)
    batch = _batch(cfg)
    step = make_two_stage_eval_step(model, cfg, device="cpu")
    if orientation == "landscape":
        with fixpoint_depths() as depths:
            step(batch)
        proposals = depths[0]  # the level-grouped proposal NMS runs first
        assert proposals["k"] > cfg.rpn.test_max_per_img and proposals["depth"] >= 2, depths
    want = step(batch)
    assert int(want.valid.sum()) > 0

    program = export_model.export_eval_step(cfg, model, B)
    if family == "dynamic_rcnn":  # its statistics ride along, unused, through a save and load
        buf = io.BytesIO()
        export_model.save_program(program, buf)
        buf.seek(0)
        program = export_model.load_program(buf)
        assert torch.equal(program.state_dict["model.dynamic.iou_thr"], model.dynamic.iou_thr)
    got = export_model.run_program(program, batch)
    assert type(got) is type(want)
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    # the eval step writes no buffer: the double head's BN at its running statistics
    assert not program.graph_signature.buffers_to_mutate
    state = program.state_dict
    if family == "cascade_rcnn":  # the three stages in one program
        assert {k.split(".")[2] for k in state if k.startswith("model.bbox_heads.")} == \
            {"0", "1", "2"}
    if family == "double_head_rcnn":
        assert any(k.endswith("running_var") for k in state)


def test_config_for_takes_every_family():
    """Every zoo family's config and eval module; Fast R-CNN's eval takes
    proposals from outside, and is neither a module here nor exported."""
    for family, (full, tiny) in ZOO_FAMILIES.items():
        assert type(export_model.config_for(family)) is full
        if family == "fast_rcnn":
            with pytest.raises(ValueError, match="external proposals"):
                export_model.eval_module(tiny(), two_stage_pair(family)[2], device_loop=True)
            continue
        step = export_model.eval_module(tiny(), two_stage_pair(family)[2], device_loop=True)
        assert isinstance(step, TwoStageEvalStep) and step.device_loop
    assert set(export_model.EXPORTED_FAMILIES) == {"retinanet", "ssd", *ZOO_FAMILIES} - {
        "fast_rcnn"}
    with pytest.raises(SystemExit):
        export_model.parse_args(["--family", "mask_rcnn"])
