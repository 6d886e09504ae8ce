"""PISA Faster R-CNN's train step on the port's trunk
(aod_meh_hua_torch/engine/pisa.py make_pisa_rcnn_train_step through
engine/two_stage.py TRAIN_STEPS) against the JAX package's
make_pisa_rcnn_train_step, on the CPU, f32: two SGD steps under JAX's key
tree (the rules and draws of tests/test_torch_rcnn_backbone_steps.py;
the RoI sampler on each image's kp, kn and kpack), and CARL's gradient
through one SGD step: the class logits' softmax score keeps its gradient
(to fc_cls), so a step with that score detached moves fc_cls otherwise,
while the step itself is JAX's.
"""

import pytest
import torch

from aod_meh_hua_torch.engine import pisa as tpisa
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.train import create_train_state
from aod_meh_hua_torch.models.two_stage import build_two_stage
from aod_meh_hua_torch.utils.config import TrainConfig, tiny_pisa_rcnn_config
from test_torch_rcnn_backbone_steps import losses_match_jax, params_match_jax
from torch_parity import two_stage_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


def test_pisa_train_steps_losses_match_jax():
    losses_match_jax("pisa_faster_rcnn")


def test_pisa_train_steps_params_match_jax():
    params_match_jax("pisa_faster_rcnn")


def _one_step(cfg, init, batch, draws, detach_carl_score: bool):
    model = build_two_stage(cfg, device="cpu")
    model.load_state_dict(init)
    step = tts.make_two_stage_train_step(model, cfg, create_train_state(model, TrainConfig()),
                                         device="cpu")
    real = tpisa.carl_loss_dense

    def carl(cls_scores, *args):
        return real(cls_scores.detach() if detach_carl_score else cls_scores, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpisa, "carl_loss_dense", carl)
        aux = step(batch, uniforms=lambda stage, n, k: draws[stage])
    return aux, model.state_dict()


def test_carl_gradient_reaches_fc_cls():
    cfg = tiny_pisa_rcnn_config()
    init = build_two_stage(cfg, device="cpu", seed=4).state_dict()
    batch = TBatch(*two_stage_batch(cfg, seed=2))
    gen = torch.Generator().manual_seed(5)
    sizes = {"rpn": (cfg.level_bounds()[-1][1], 2),
             "roi": (cfg.max_gt + cfg.rpn.train_max_per_img, 3)}
    draws = {k: tuple(torch.rand((2, n), generator=gen) for _ in range(m))
             for k, (n, m) in sizes.items()}
    aux, real = _one_step(cfg, init, batch, draws, False)
    aux_d, detached = _one_step(cfg, init, batch, draws, True)
    assert aux["num_pos"] > 0 and aux["loss_carl"] > 0
    assert aux["loss_carl"] == aux_d["loss_carl"]  # the same loss, another gradient
    moved = (real["bbox_head.fc_cls.weight"] - init["bbox_head.fc_cls.weight"]).abs().max()
    diff = (real["bbox_head.fc_cls.weight"] - detached["bbox_head.fc_cls.weight"]).abs().max()
    assert diff > 1e-3 * moved
    # fc_reg sees the same gradient: CARL's weights enter it as values
    assert torch.equal(real["bbox_head.fc_reg.weight"], detached["bbox_head.fc_reg.weight"])
