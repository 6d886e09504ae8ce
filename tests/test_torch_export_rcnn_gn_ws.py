"""torch.export of GN+WS's, ResNeSt's and PISA's eval steps
(aod_meh_hua_torch: engine/two_stage.py TwoStageEvalStep,
tools/deployment/export_model.py), on the CPU, f32: the standardised
kernels and GroupNorms, the split-attention convs and radix softmax,
PISA's 2000 test proposals. The rules of
tests/test_torch_export_rcnn_variants.py exported_equals_eager, each
family in both orientations, bit for bit (HRNet and FPG:
tests/test_torch_export_rcnn_backbones.py).
"""

import pytest

from test_torch_export_rcnn_backbones import exported_equals_eager
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("family", ["gn_ws", "resnest", "pisa_faster_rcnn"])
def test_exported_family_equals_the_eager_step(family, orientation):
    exported_equals_eager(family, orientation)
