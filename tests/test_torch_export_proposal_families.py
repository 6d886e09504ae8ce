"""The proposal families' serving path (aod_meh_hua_torch:
engine/two_stage.py eval_module, tools/deployment/export_model.py and
serve.py), on the CPU, f32: Grid R-CNN's and Cascade RPN's tiny eval
steps exported with torch.export (every NMS fixpoint a device
while_loop) against their eager steps, and the RPN-only family behind
the HTTP server.

The models carry tests/torch_parity.py two_stage_pair's JAX draw. The
exported programs equal the eager steps bit for bit, in both
orientations for Grid R-CNN (the grid refinement on the NMS survivors)
and in the landscape one for Cascade RPN (a tiny two-stage export takes
5-11 s); the server's replies equal the Detector's rows (rtol 1e-5),
and the Detector's rows JAX's (rtol 1e-4, atol 1e-3 px). The eager
steps are held to JAX in the families' own files.
"""

import base64
import threading
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.data.voc import VOC_CLASSES
from aod_meh_hua_torch.engine import rpn_only as trpn
from aod_meh_hua_torch.models import rpn_only as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.tools.deployment import export_model, serve
from test_torch_export_rcnn_variants import OWN, exported_equals_eager
from test_torch_rcnn_entry_points import SCORE_THR, _post
from torch_parity import jax_two_stage
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

OWN.update({"grid_rcnn": "model.grid_head.deconv2_4.weight",
            "cascade_rpn": "model.s1_conv.weight"})


@pytest.mark.parametrize("family,orientation", [
    ("grid_rcnn", "landscape"), ("grid_rcnn", "portrait"), ("cascade_rpn", "landscape")])
def test_exported_proposal_family_equals_the_eager_step(family, orientation):
    exported_equals_eager(family, orientation)


def test_fast_rcnn_is_not_exported():
    assert "fast_rcnn" not in export_model.EXPORTED_FAMILIES
    assert {"rpn", "cascade_rpn", "tridentnet", "grid_rcnn"} <= set(export_model.EXPORTED_FAMILIES)
    with pytest.raises(SystemExit):
        serve.parse_args(["--family", "fast_rcnn"])


def test_rpn_server_replies_equal_the_detector_rows():
    """serve.py --family rpn --mini: the proposals as one-class rows, each
    reply (raw and base64 JPEG) the Detector's, the Detector's JAX's."""
    det = serve.build_detector(serve.parse_args(["--family", "rpn", "--mini", "--cpu"]))
    assert isinstance(det.model, tmodels.RPNOnly) and det.cfg.num_fg_classes == 1
    jmodel, variables = jax_two_stage("rpn")
    det.model.load_state_dict(from_jax_variables(variables))
    jdet = japi.Detector(jcfg.tiny_rpn_config(), jmodel, variables,
                         pipeline=JPipelineConfig(img_scale=det.pipeline.img_scale,
                                                  canvas=det.pipeline.canvas,
                                                  device_normalize=True))
    classes = VOC_CLASSES[:1]
    batcher = serve.Batcher(det, max_batch=2, delay_ms=1.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 serve.make_handler(batcher, classes, SCORE_THR))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predictions"
    rng = np.random.RandomState(4)
    n_rows = 0
    try:
        for h, w in ((60, 110), (90, 50)):
            ok, buf = cv2.imencode(".jpg", (rng.rand(h, w, 3) * 255).astype(np.uint8))
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            per_class = det(img)
            assert len(per_class) == 1
            want = [{"class_name": classes[0], "bbox": [float(v) for v in row[:4]],
                     "score": float(row[4])} for row in per_class[0]
                    if float(row[4]) >= SCORE_THR]
            for payload in (buf.tobytes(), base64.b64encode(buf.tobytes())):
                got = _post(url, payload)
                assert len(got) == len(want)
                for g, wr in zip(got, want):
                    np.testing.assert_allclose(g["bbox"] + [g["score"]],
                                               wr["bbox"] + [wr["score"]], rtol=1e-5, atol=1e-4)
                n_rows += len(got)
            (jrows,) = jdet(img)
            assert jrows.shape == per_class[0].shape
            np.testing.assert_allclose(per_class[0], jrows, rtol=1e-4, atol=1e-3)
        assert n_rows > 0
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    assert trpn.ProposalResult._fields == ("boxes", "scores", "labels", "valid", "anchor_idx")
