"""torch.export of HRNet's and FPG's eval steps (aod_meh_hua_torch:
engine/two_stage.py TwoStageEvalStep, tools/deployment/export_model.py),
on the CPU, f32: HRFPN's bilinear resizes and pools, the exchange units,
FPG's stacked stages. GN+WS, ResNeSt and PISA:
tests/test_torch_export_rcnn_gn_ws.py. The rules of
tests/test_torch_export_rcnn_variants.py exported_equals_eager: each
family's tiny model in both orientations, exported at batch 2, every
NMSResult field equal to the eager step's bit for bit, no buffer written,
the family's own module in the program.
"""

import pytest

from test_torch_export_rcnn_variants import OWN, exported_equals_eager
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

OWN.update({"hrnet": "model.neck.fpn_conv0.weight",
            "fpg": "model.neck.s4_l4_lateral.conv.weight",
            "gn_ws": "model.bbox_head.shared_gn_0.weight",
            "resnest": "model.backbone.layer1.0.conv2.fc1.weight",
            "pisa_faster_rcnn": "model.bbox_head.fc_cls.weight"})


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("family", ["hrnet", "fpg"])
def test_exported_backbone_family_equals_the_eager_step(family, orientation):
    exported_equals_eager(family, orientation)
