"""torch.export of the Faster R-CNN variants' eval step (aod_meh_hua_torch:
engine/two_stage.py TwoStageEvalStep, tools/deployment/export_model.py),
on the CPU, f32: Libra R-CNN (the BFP's pools and resizes, its
non-local block), PAFPN, CARAFE (the reassembly) and empirical
attention (the backbone's attention blocks); GRoIE's program (RoIAlign
on every level, the fusion's attention) in
tests/test_torch_rcnn_variant_eval.py, which this file's time budget
leaves it to.

Each family's tiny model (tests/torch_parity.py two_stage_pair: the
heads sharpened, every attention block's gamma and biases non-zero), in
both orientations: the eval step exported at batch 2 against the eager
step on the same batch, every NMSResult field equal bit for bit; the
program holds the family's own modules and writes no buffer. The four
families before them: tests/test_torch_export_two_stage.py, whose cases
these continue (a tiny two-stage export takes 5-7 s). The eager steps
are held to JAX in tests/test_torch_rcnn_variant_eval.py.
"""

import pytest
import torch

from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
from aod_meh_hua_torch.tools.deployment import export_model
from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

from test_torch_export_two_stage import B, _batch
from torch_parity import two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

VARIANTS = ("libra_rcnn", "pafpn", "carafe", "empirical_attention")
# a parameter of each family's own module, in the program's state
OWN = {"libra_rcnn": "model.bfp.refine.theta.weight",
       "pafpn": "model.neck.downsample_convs.0.weight",
       "carafe": "model.neck.carafe.1.content_encoder.weight",
       "groie": "model.groie_post.gamma",
       "empirical_attention": "model.backbone.layer3.0.gen_attention.key_bias"}


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("family", VARIANTS)
def test_exported_variant_equals_the_eager_step(family, orientation):
    exported_equals_eager(family, orientation)


def exported_equals_eager(family, orientation):
    """The family's tiny eval step exported in `orientation` against the
    eager step: every NMSResult field equal, no buffer written, the
    family's own module in the program."""
    _, _, model = two_stage_pair(family)
    cfg = ZOO_FAMILIES[family][1]().for_orientation(orientation)
    batch = _batch(cfg)
    want = make_two_stage_eval_step(model, cfg, device="cpu")(batch)
    assert int(want.valid.sum()) > 0
    program = export_model.export_eval_step(cfg, model, B)
    got = export_model.run_program(program, batch)
    assert type(got) is type(want)
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    assert not program.graph_signature.buffers_to_mutate
    assert OWN[family] in program.state_dict
