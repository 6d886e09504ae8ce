"""The entry points of the port's Cascade, Dynamic and Double-Head R-CNN
on the CPU: the eval steps through api.make_eval_step_for against the
JAX package's, Dynamic R-CNN's beta statistic, the
full-width heads' shapes and initialisers, the model-zoo trainer's
--mini --cpu run of each family
(aod_meh_hua_torch/tools/train_detector.py), its checkpoint back
through api.init_detector and a Detector, the FPS tool's --family
(tools/benchmark.py), and the HTTP server built by
tools/deployment/serve.py's build_detector for --family cascade_rcnn
--mini, whose replies are held to the Detector's rows, and that
Detector to the JAX package's api.Detector on the same weights.

Tolerances: the eval steps' detections rtol 1e-4 with the same valid
sets, labels and sources (tests/torch_parity.py two_stage_pair's
weights on both sides); the replies equal the Detector's rows to rtol 1e-5 (atol
1e-4: the batcher stacks the request alone, the rows go through JSON's
float repr); the port's Detector against JAX's rtol 1e-4 (atol 1e-3 on
boxes), as tests/test_torch_train_detector.py holds Faster R-CNN's.
"""

import base64
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.voc import VOC_CLASSES
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.tools import benchmark, train_detector
from aod_meh_hua_torch.tools.deployment import serve
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import (jax_two_stage, mini_voc, numerics_flags_kept, two_stage_batch,
                          two_stage_pair)
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("cascade_rcnn", "dynamic_rcnn", "double_head_rcnn")
SCORE_THR = 0.05
WAIT_S = 120


JEVAL = {"cascade_rcnn": jts.make_cascade_eval_step,
         "dynamic_rcnn": jts.make_faster_rcnn_eval_step,
         "double_head_rcnn": jts.make_double_head_eval_step}


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_step_matches_jax(family):
    """The family's eval step, rtol 1e-4, the same valid sets, labels and
    sources, on two images with their own scale factors; through the
    port's api.make_eval_step_for."""
    jmodel, variables, model = two_stage_pair(family)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](), tcfg.ZOO_FAMILIES[family][1]()
    arrays = two_stage_batch(jc, seed=2)
    batch = (arrays[0], arrays[5], np.array([[1.0] * 4, [1.4] * 4], np.float32),
             np.ones(2, bool))
    want = JEVAL[family](jmodel, jc)(variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tapi.make_eval_step_for(model, tc, device="cpu")(TEvalBatch(*batch))
    for name in ("valid", "labels", "anchor_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)
    assert got.valid.sum() > 10


@pytest.mark.parametrize("n_pos", [0, 3, 12])
def test_dynamic_beta_statistic(n_pos):
    """Dynamic R-CNN's beta statistic (JAX engine/two_stage.py:568-575):
    the min(k_max, num_pos)-th smallest mean |dx|, |dy| target over the
    positives, the initial beta with none; fewer and more positives than
    k_max = 5 both taken."""
    rs = np.random.RandomState(n_pos)
    targets = rs.randn(40, 4).astype(np.float32)
    pos = np.zeros(40, bool)
    pos[rs.permutation(40)[:n_pos]] = True
    got = tts.beta_statistic(torch.from_numpy(targets), torch.from_numpy(pos), 5, 0.7)
    xy = np.sort(np.abs(targets[pos, :2]).mean(axis=1))
    want = xy[min(5, n_pos) - 1] if n_pos else np.float32(0.7)
    assert got.shape == () and float(got) == float(want)


def test_port_heads_shapes_and_init():
    """The full-width heads' shapes and initialisers (the modules alone: a
    full R50 on the CPU is slow to initialise)."""
    casc = tmodels.CascadeRCNN.__new__(tmodels.CascadeRCNN)
    torch.nn.Module.__init__(casc)
    casc._build_roi_head(tcfg.CascadeRCNNConfig())
    gen = torch.Generator().manual_seed(1)
    assert len(casc.bbox_heads) == 3 and not hasattr(casc, "bbox_head")
    for head in casc._roi_heads():
        head.init_weights(gen)
        assert head.fc_reg.weight.shape == (4, 1024)
        assert abs(head.fc_cls.weight.std().item() - 0.01) < 1e-3
    c = tcfg.DoubleHeadRCNNConfig()
    dh = tmodels.DoubleConvFCBBoxHead(c.num_classes, c.fpn_channels, c.rcnn.roi_size,
                                      c.dh_num_convs, c.dh_num_fcs, c.dh_conv_out, c.dh_fc_out)
    dh.init_weights(gen)
    assert abs(dh.fc_reg.weight.std().item() - 0.001) < 1e-4
    assert len(dh.conv_branch) == 4 and len(dh.fc_branch) == 2
    assert dh.res_block.conv1.weight.shape == (256, 256, 3, 3)
    assert dh.conv_branch[0].conv1.weight.shape == (256, 1024, 1, 1)
    assert dh.fc_branch[0].weight.shape == (1024, 7 * 7 * 256)
    assert dh.fc_reg.weight.shape == (80, 1024)
    assert torch.equal(dh.res_block.bn1.running_var, torch.ones(256))
    dyn = tmodels.DynamicState(tcfg.DynamicRCNNConfig())
    assert dyn.iou_hist.shape == (100,) and float(dyn.iou_thr) == 0.5


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("families") / "voc")


@pytest.mark.parametrize("family", FAMILIES)
def test_train_detector_mini_trains_each_family(family, voc, tmp_path):
    """The trainer's --mini --cpu run of the family: one epoch with eval,
    the family's model and step, its checkpoint (Dynamic R-CNN's
    statistics in it) back through init_detector, and a Detector on it."""
    work = str(tmp_path / "work")
    with numerics_flags_kept():
        model, cfg, metrics = train_detector.main(
            ["--family", family, "--mini", "--cpu", "--voc07", voc, "--work-dir", work,
             "--epochs", "1", "--batch-size", "2"])
    assert type(cfg) is tcfg.ZOO_FAMILIES[family][0]
    assert type(model) is tmodels._MODELS[family]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"]) and "mAP" in metrics[0]
    loaded = tapi.init_detector(cfg, checkpoint=os.path.join(work, f"{family}_final.ckpt"),
                                device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    if family == "dynamic_rcnn":  # one step per batch of the epoch wrote a ring slot
        assert int(loaded.dynamic.step) >= 1
    jpg = os.path.join(voc, "JPEGImages", sorted(os.listdir(os.path.join(voc, "JPEGImages")))[0])
    rows = tapi.Detector(cfg, loaded, pipeline=train_detector.pipeline_for(cfg, True))(jpg)
    assert len(rows) == cfg.num_classes and all(r.shape[1] == 5 for r in rows)


@pytest.mark.parametrize("family", FAMILIES)
def test_benchmark_takes_each_family(family):
    """The FPS tool's --family builds the family's full config and times
    its eval step (here the tiny config's, on the CPU)."""
    seen = {}

    def timed(cfg, *args):
        seen["cfg"] = cfg
        return {"img_per_s": 1.0, "ms_per_img": 1.0, "device": "cpu"}

    with pytest.MonkeyPatch.context() as mp, numerics_flags_kept():
        mp.setattr(benchmark, "benchmark", timed)
        benchmark.main(["--family", family, "--cpu", "--iters", "1"])
    assert seen["cfg"] == tcfg.ZOO_FAMILIES[family][0]()
    out = benchmark.benchmark(tcfg.ZOO_FAMILIES[family][1](), batch=1, iters=1, warmup=0,
                              device="cpu")
    assert out["img_per_s"] > 0


def _post(url, payload):
    req = urllib.request.Request(url, data=payload)
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def test_server_replies_equal_the_detector_rows():
    """serve.py --family cascade_rcnn --mini: build_detector's Detector
    behind the batcher and the HTTP handler answers each request (raw and
    base64 JPEG) with the rows of the same Detector called directly, and
    that Detector gives the JAX package's rows on the same weights."""
    det = serve.build_detector(serve.parse_args(["--family", "cascade_rcnn", "--mini", "--cpu"]))
    assert isinstance(det.model, tmodels.CascadeRCNN)
    jmodel, variables = jax_two_stage("cascade_rcnn")
    det.model.load_state_dict(from_jax_variables(variables))
    jdet = japi.Detector(jcfg.tiny_cascade_config(), jmodel, variables,
                         pipeline=JPipelineConfig(img_scale=det.pipeline.img_scale,
                                                  canvas=det.pipeline.canvas,
                                                  device_normalize=True))
    classes = VOC_CLASSES[:det.cfg.num_fg_classes]
    batcher = serve.Batcher(det, max_batch=2, delay_ms=1.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 serve.make_handler(batcher, classes, SCORE_THR))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predictions"
    rng = np.random.RandomState(4)
    n_rows = 0
    try:
        for h, w in ((60, 110), (90, 50), (64, 128)):
            ok, buf = cv2.imencode(".jpg", (rng.rand(h, w, 3) * 255).astype(np.uint8))
            assert ok
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            per_class = det(img)
            want = [{"class_name": classes[c], "bbox": [float(v) for v in row[:4]],
                     "score": float(row[4])}
                    for c, dets in enumerate(per_class) for row in dets
                    if float(row[4]) >= SCORE_THR]
            for payload in (buf.tobytes(), base64.b64encode(buf.tobytes())):
                got = _post(url, payload)
                assert [r["class_name"] for r in got] == [r["class_name"] for r in want]
                for g, wr in zip(got, want):
                    np.testing.assert_allclose(g["bbox"] + [g["score"]],
                                               wr["bbox"] + [wr["score"]], rtol=1e-5, atol=1e-4)
                n_rows += len(got)
            for a, b in zip(per_class, jdet(img)):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        assert n_rows > 0
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
