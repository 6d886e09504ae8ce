"""The port's model-zoo trainer (aod_meh_hua_torch/tools/train_detector.py)
and the Faster R-CNN family's way through the API (init_detector with a
JAX-written checkpoint, Detector, the FPS tool), on the CPU, on the mini
VOC tree (tests/torch_parity.py mini_voc).

- The CLI's `--mini --cpu` run for one epoch writes the JAX tool's files
  (train_log.jsonl rows, metrics.json, {family}_meta.json,
  {family}_final.ckpt), and its checkpoint loads through init_detector.
- From shared weights (one JAX variables draw carried over), the port's
  eval loop (train_detector.evaluate) gives the JAX tool's eval loop's
  mAP, equal, and its per-image detections, rtol 1e-4, on the test split
  in both orientations. The JAX loop is built in process from the JAX
  package's loader, eval step, detections_to_per_class and eval_map, as
  tools/train_detector.py runs them (the JAX CLI's own --mini run costs
  45-50 s and is not spawned).
- A checkpoint the JAX package wrote (its save_checkpoint of the
  variables, the JAX tool's file) loads into the port bit for bit.
- Detector.predict_batch against JAX's, rtol 1e-4 and the same rows.
- The flags of other data, families and modes raise with their ROADMAP
  item (the ranks' flags are ported: tests/test_torch_two_stage_ranks.py);
  without --cpu the CLI asks for the card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.api import Detector as JDetector
from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data import TrainLoader as JTrainLoader
from aod_meh_hua_tpu.data import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.engine import detections_to_per_class as jper_class
from aod_meh_hua_tpu.engine.checkpoint import save_checkpoint as jsave_checkpoint
from aod_meh_hua_tpu.engine.two_stage import make_faster_rcnn_eval_step as jmake_eval
from aod_meh_hua_tpu.utils.config import tiny_faster_rcnn_config as jtiny
from aod_meh_hua_tpu.utils.voc_eval import eval_map as jeval_map
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.loader import TrainLoader
from aod_meh_hua_torch.data.voc import VOC_CLASSES, VOCDataset
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.tools import benchmark, train_detector
from aod_meh_hua_torch.utils import voc_eval as tvoc_eval
from aod_meh_hua_torch.utils.config import tiny_dynamic_rcnn_config
from aod_meh_hua_torch.utils.config import tiny_faster_rcnn_config as ttiny
from torch_parity import jax_faster_rcnn, mini_voc, numerics_flags_kept
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

JC, TC = jtiny(), ttiny()
CLASSES = VOC_CLASSES[:TC.num_classes]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("frcnn") / "voc")


@pytest.fixture(scope="module")
def cli(voc, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("frcnn_work"))
    with numerics_flags_kept():
        model, cfg, metrics = train_detector.main(
            ["--family", "faster_rcnn", "--mini", "--cpu", "--voc07", voc, "--work-dir", work,
             "--epochs", "1"])
    return work, model, cfg, metrics


@pytest.fixture(scope="module")
def shared():
    jmodel, variables = jax_faster_rcnn(seed=4)
    model = tapi.init_detector(TC, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, model


def test_cli_writes_the_jax_tools_files(cli):
    work, model, cfg, metrics = cli
    rows = [json.loads(line) for line in open(os.path.join(work, "train_log.jsonl"))]
    assert rows == metrics and len(rows) == 1
    assert set(rows[0]) == {"epoch", "loss", "lr", "mAP"} and rows[0]["lr"] == 0.0025
    assert np.isfinite(rows[0]["loss"]) and 0.0 <= rows[0]["mAP"] <= 1.0
    assert json.load(open(os.path.join(work, "metrics.json"))) == metrics
    assert json.load(open(os.path.join(work, "faster_rcnn_meta.json")))["family"] == "faster_rcnn"
    loaded = tapi.init_detector(cfg, checkpoint=os.path.join(work, "faster_rcnn_final.ckpt"),
                                device="cpu")
    for (k, a), (_, b) in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), k
    # trained: the heads moved from the seeded init, the frozen stem did not
    fresh = tapi.init_detector(cfg, seed=20, device="cpu").state_dict()
    trained = model.state_dict()
    assert not torch.equal(trained["bbox_head.fc_cls.weight"], fresh["bbox_head.fc_cls.weight"])
    assert torch.equal(trained["backbone.conv1.weight"], fresh["backbone.conv1.weight"])


def _jax_eval_loop(jmodel, variables, voc, batch_size=4):
    """The JAX tool's eval loop (tools/train_detector.py:593-645) with the
    --mini pipeline: per-image results in dataset order, and the mAP."""
    val = JVOCDataset(os.path.join(voc, "ImageSets/Main/test.txt"), voc, test_mode=True,
                      classes=CLASSES)
    pipe = JPipelineConfig(img_scale=(128, 60), canvas=JC.canvas, mean=JC.img_mean,
                           std=JC.img_std, device_normalize=True)
    steps, results, order = {}, [], []
    for orientation, ebatch, idx in JEvalLoader(val, np.arange(len(val)), pipe,
                                                batch_size=batch_size):
        if orientation not in steps:
            steps[orientation] = jmake_eval(jmodel, JC.for_orientation(orientation))
        dets = steps[orientation](variables, ebatch)
        results.extend(jper_class(dets, JC.num_classes, np.asarray(ebatch.valid)))
        order.extend(idx.tolist())
    anns = [val.get_ann_info(i) for i in order]
    m = jeval_map(results, anns, iou_thr=0.5, mode="11points")["mAP"]
    return [r for _, r in sorted(zip(order, results), key=lambda p: p[0])], m, order


def _assert_same(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-3)


def test_eval_loop_matches_jax(shared, voc):
    jmodel, variables, model = shared
    want, want_map, order = _jax_eval_loop(jmodel, variables, voc)
    val = VOCDataset(os.path.join(voc, "ImageSets/Main/test.txt"), voc, test_mode=True,
                     classes=CLASSES)
    got = train_detector.evaluate(model, TC, val, train_detector.pipeline_for(TC, True), 4,
                                  "cpu")
    _assert_same(got["results"], want)
    assert got["mAP"] == want_map
    assert sum(len(a) for r in got["results"] for a in r) > 20
    # random weights score 0 on the tree's boxes: the detections above 0.2
    # as ground truth give an mAP that each detection moves
    pseudo = [{"bboxes": np.concatenate([a[a[:, 4] > 0.2, :4] for a in r]),
               "labels": np.concatenate([np.full(int((a[:, 4] > 0.2).sum()), c)
                                         for c, a in enumerate(r)]).astype(np.int64)}
              for r in want]
    got_pseudo = tvoc_eval.eval_map(got["results"], pseudo, iou_thr=0.5, mode="11points")
    want_pseudo = jeval_map(want, pseudo, iou_thr=0.5, mode="11points")
    assert got_pseudo["mAP"] == want_pseudo["mAP"] > 0.3


def test_train_loader_on_the_two_stage_config_matches_jax(voc):
    """The loaders take a FasterRCNNConfig: one epoch's batches of the
    trainer's --mini loader, the RPN anchors' pad-region flags included,
    bit for bit as the JAX loader's for the same seed."""
    ann = os.path.join(voc, "ImageSets/Main/trainval.txt")
    jds = JVOCDataset(ann, voc, classes=CLASSES)
    tds = VOCDataset(ann, voc, classes=CLASSES)
    jpipe = JPipelineConfig(img_scale=(128, 60), canvas=JC.canvas, mean=JC.img_mean,
                            std=JC.img_std, device_normalize=True)
    idx = np.arange(len(tds))
    want = list(JTrainLoader(jds, idx, JC, jpipe, batch_size=2, seed=20))
    got = list(TrainLoader(tds, idx, TC, train_detector.pipeline_for(TC, True), batch_size=2,
                           seed=20))
    assert len(got) == len(want) > 3 and {o for o, _ in got} == {"landscape", "portrait"}
    for (go, gb), (wo, wb) in zip(got, want):
        assert go == wo
        for name, g, w in zip(wb._fields, gb, wb):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert gb.anchor_valid.shape[1] == TC.for_orientation(go).level_bounds()[-1][1]


def test_jax_written_checkpoint_loads(shared, tmp_path):
    _, variables, model = shared
    path = str(tmp_path / "faster_rcnn_final.ckpt")
    jsave_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, variables))
    loaded = tapi.init_detector(TC, checkpoint=path, device="cpu")
    want = model.state_dict()
    assert set(loaded.state_dict()) == set(want)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_checkpoints_by_family(shared):
    """A Faster R-CNN state_dict passes through as the port's own; an mmdet
    Faster R-CNN file (roi_head.*, its fc reading (c, h, w)) raises."""
    from aod_meh_hua_torch.engine.checkpoint import to_model_state_dict

    sd = shared[2].state_dict()
    assert to_model_state_dict(sd, "faster_rcnn").keys() == sd.keys()
    mmdet = {"roi_head.bbox_head.shared_fcs.0.weight": sd["bbox_head.shared_fcs.0.weight"]}
    with pytest.raises(NotImplementedError, match="item 15"):
        to_model_state_dict({"state_dict": mmdet}, "faster_rcnn")


def test_predict_batch_matches_jax(shared, voc):
    jmodel, variables, model = shared
    paths = sorted(os.path.join(voc, "JPEGImages", f)
                   for f in os.listdir(os.path.join(voc, "JPEGImages")))[:7]
    jpipe = JPipelineConfig(img_scale=(128, 60), canvas=JC.canvas, device_normalize=True)
    want = JDetector(JC, jmodel, variables, pipeline=jpipe).predict_batch(paths, max_batch=4)
    det = tapi.Detector(TC, model, pipeline=train_detector.pipeline_for(TC, True))
    got = det.predict_batch(paths, max_batch=4)
    _assert_same(got, want)
    _assert_same([det(paths[0]), tapi.inference_detector(det, paths[1])], got[:2])


def test_two_stage_detector_limits(shared):
    """The uncertainty column is the dense families'; Faster R-CNN's TTA
    gives the per-class rows (held to JAX's in
    tests/test_torch_tta_two_stage.py), Dynamic R-CNN's raises as the
    JAX package's does."""
    _, _, model = shared
    with pytest.raises(ValueError, match="retinanet/ssd"):
        tapi.Detector(TC, model, with_uncertainty=True)
    det = tapi.Detector(TC, model, pipeline=train_detector.pipeline_for(TC, True))
    rows = det.tta(np.zeros((60, 100, 3), np.uint8))
    assert len(rows) == TC.num_classes and all(r.shape[1] == 5 for r in rows)
    det.cfg = tiny_dynamic_rcnn_config()
    with pytest.raises(NotImplementedError, match="got 'dynamic_rcnn'"):
        det.tta(np.zeros((60, 100, 3), np.uint8))


def test_benchmark_runs_the_two_stage_step():
    out = benchmark.benchmark(TC, batch=2, iters=2, warmup=1, device="cpu")
    assert out["img_per_s"] > 0 and out["device"] == "cpu"


@pytest.mark.parametrize("flags,item", [
    (["--coco-train", "x.json"], "item 14"), (["--dataset-type", "lvis"], "item 14"),
    (["--instaboost"], "item 14"), (["--albu"], "item 14"),
    (["--oversample-thr", "0.001"], "item 14"), (["--teacher-ckpt", "t.ckpt"], "item 15"),
    (["--reference-config", "c.py"], "item 13"), (["--dtype", "bfloat16"], "item 16")])
def test_unported_flags_raise(flags, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        train_detector.main(["--family", "faster_rcnn", "--mini", "--cpu", "--voc07", "v",
                             "--work-dir", str(tmp_path)] + flags)


def test_cli_runs_on_the_card_unless_told(voc, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with numerics_flags_kept(), pytest.raises(RuntimeError, match="no CUDA device"):
        train_detector.main(["--family", "faster_rcnn", "--mini", "--voc07", voc,
                             "--work-dir", str(tmp_path)])
    with pytest.raises(SystemExit):  # the ported registry's choices only
        train_detector.main(["--family", "mask_rcnn", "--voc07", voc,
                             "--work-dir", str(tmp_path)])
