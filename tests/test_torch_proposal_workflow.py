"""The RPN -> gen_proposals -> Fast R-CNN workflow through the port's CLIs
(aod_meh_hua_torch.tools.train_detector, tools/gen_proposals.py) with
--mini --cpu on the mini VOC tree (tests/torch_parity.py mini_voc), and
against the JAX package's functions in process, on the CPU, f32.

The JAX package's own CLI workflow test fails (its RPN eval_fn rejects
det_masks; ROADMAP Test budget), so the port's workflow is held to JAX's
per-class detection path instead: the port's gen_proposals on a
JAX-trained RPN checkpoint (one JAX SGD step from a jax_two_stage draw,
saved by the JAX package's save_checkpoint) against the JAX RPN eval
step over the JAX loader, and the trainer's Fast R-CNN eval on those
proposals against JAX's make_fast_rcnn_eval_step with the JAX trainer's
proposal scaling and padding, from shared weights.

Tolerances: the .npz's keys and row counts equal, boxes and scores rtol
1e-4 (atol 1e-4 px); the Fast R-CNN detections per image and class
rtol 1e-4 (atol 1e-3 px, the trainer tests' rule) and the same mAP.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.data.loader import _pad_proposals as jpad
from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import detections_to_per_class as jper_class
from aod_meh_hua_tpu.engine import rpn_only as jrpn
from aod_meh_hua_tpu.engine.checkpoint import save_checkpoint as jsave_checkpoint
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_tpu.utils.voc_eval import eval_map as jeval_map
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.voc import VOC_CLASSES, VOCDataset
from aod_meh_hua_torch.tools import gen_proposals, train_detector
from aod_meh_hua_torch.utils import config as tcfg
from test_torch_train_detector import _assert_same
from torch_parity import jax_two_stage, mini_voc, numerics_flags_kept, two_stage_batch
from torch_proposal_parity import port_model
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

MINI_PIPE = dict(img_scale=(128, 60), canvas=(64, 128), device_normalize=True)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("props") / "voc")


@pytest.fixture(scope="module")
def workflow(voc, tmp_path_factory):
    """train_detector --family rpn, gen_proposals for trainval and test,
    train_detector --family fast_rcnn on them, each one epoch."""
    work = tmp_path_factory.mktemp("props_work")
    common = ["--mini", "--cpu", "--voc07", voc, "--epochs", "1"]
    with numerics_flags_kept():
        rpn = train_detector.main(["--family", "rpn", "--work-dir", str(work / "rpn")] + common)
        ckpt = str(work / "rpn" / "rpn_final.ckpt")
        files = {}
        for split in ("trainval", "test"):
            files[split] = str(work / f"{split}.npz")
            gen_proposals.main(["--voc07", voc, "--checkpoint", ckpt, "--split",
                                f"ImageSets/Main/{split}.txt", "--out", files[split],
                                "--mini", "--cpu"])
        fast = train_detector.main(["--family", "fast_rcnn", "--work-dir", str(work / "fast"),
                                    "--proposal-file", files["trainval"],
                                    "--proposal-file-val", files["test"]] + common)
    return work, rpn, files, fast


def test_the_workflow_runs_through_the_clis(workflow, voc):
    work, (_, _, rpn_rows), files, (model, cfg, fast_rows) = workflow
    assert set(rpn_rows[0]) == {"epoch", "loss", "lr", "mAP", "AR@100"}
    assert rpn_rows[0]["mAP"] == rpn_rows[0]["AR@100"] and 0 <= rpn_rows[0]["AR@100"] <= 1
    for split, n in (("trainval", 14), ("test", 4)):
        props = np.load(files[split])
        assert sorted(props.files, key=int) == [str(i) for i in range(n)]
        for rows in props.values():
            assert rows.shape[1] == 5 and rows.dtype == np.float32 and 0 < len(rows) <= 64
            assert (np.diff(rows[:, 4]) <= 0).all()  # score-ordered
    assert set(fast_rows[0]) == {"epoch", "loss", "lr", "mAP"} and np.isfinite(fast_rows[0]["loss"])
    loaded = tapi.init_detector(cfg, checkpoint=str(work / "fast" / "fast_rcnn_final.ckpt"),
                                device="cpu")
    for (k, a), (_, b) in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), k
    assert json.load(open(work / "fast" / "fast_rcnn_meta.json"))["family"] == "fast_rcnn"


@pytest.fixture(scope="module")
def jax_rpn_checkpoint(tmp_path_factory):
    """A JAX-trained RPN: one JAX SGD step from a jax_two_stage draw,
    written by the JAX package's save_checkpoint."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    jmodel, variables = jax_two_stage("rpn", seed=2)
    jc = jcfg.tiny_rpn_config()
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=jc.frozen_stages)
    state, _ = jrpn.make_rpn_train_step(jmodel, jc, tx)(
        state, JBatch(*(jnp.asarray(a) for a in two_stage_batch(jc, seed=3))),
        jax.random.PRNGKey(0))
    trained = {"params": jax.device_get(state.params), "batch_stats": variables["batch_stats"]}
    path = str(tmp_path_factory.mktemp("jax_rpn") / "rpn_final.ckpt")
    jsave_checkpoint(path, trained)
    return jmodel, trained, path


def test_gen_proposals_from_a_jax_checkpoint_equals_the_jax_eval_step(
        voc, jax_rpn_checkpoint, tmp_path):
    """The port's .npz of a JAX-written checkpoint against JAX's
    make_rpn_eval_step over the JAX loader: the same keys and rows."""
    jmodel, variables, path = jax_rpn_checkpoint
    got = gen_proposals.main(["--voc07", voc, "--checkpoint", path, "--mini", "--cpu",
                              "--out", str(tmp_path / "p.npz"), "--max-per-img", "40"])
    jc = jcfg.tiny_rpn_config()
    ds = JVOCDataset(os.path.join(voc, "ImageSets/Main/trainval.txt"), voc, test_mode=True)
    steps, want = {}, {}
    for orientation, ebatch, idx in JEvalLoader(ds, np.arange(len(ds)),
                                                JPipelineConfig(**MINI_PIPE), batch_size=8):
        if orientation not in steps:
            steps[orientation] = jrpn.make_rpn_eval_step(jmodel, jc.for_orientation(orientation))
        r = steps[orientation](variables, ebatch)
        for k, i in enumerate(idx):
            v = np.asarray(r.valid[k])
            want[str(int(i))] = np.concatenate([np.asarray(r.boxes[k])[v][:40],
                                                np.asarray(r.scores[k])[v][:40, None]], 1)
    assert set(got) == set(want) and len(want) == 14
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4, err_msg=k)
    assert dict(np.load(tmp_path / "p.npz")).keys() == got.keys()


def test_fast_rcnn_eval_on_the_proposals_matches_jax(workflow, voc):
    """The trainer's Fast R-CNN eval on the test split's proposals, from
    a JAX draw, against JAX's make_fast_rcnn_eval_step with the JAX
    trainer's scaling and padding (tools/train_detector.py:602-621): the
    same detections per image and class, and the same mAP."""
    _, _, files, _ = workflow
    jmodel, variables = jax_two_stage("fast_rcnn", seed=5)
    jc, tc = jcfg.tiny_fast_rcnn_config(), tcfg.tiny_fast_rcnn_config()
    classes = VOC_CLASSES[:tc.num_classes]
    props = dict(np.load(files["test"]))
    val = JVOCDataset(os.path.join(voc, "ImageSets/Main/test.txt"), voc, test_mode=True,
                      classes=classes)
    pipe = JPipelineConfig(**MINI_PIPE, mean=jc.img_mean, std=jc.img_std)
    steps, results, order = {}, [], []
    for orientation, ebatch, idx in JEvalLoader(val, np.arange(len(val)), pipe, batch_size=4):
        if orientation not in steps:
            steps[orientation] = jrpn.make_fast_rcnn_eval_step(
                jmodel, jc.for_orientation(orientation))
        sf = np.asarray(ebatch.scale_factors)
        plist = [props[str(i)][:, :4] * sf[k] for k, i in enumerate(idx)]
        while len(plist) < ebatch.images.shape[0]:
            plist.append(np.zeros((0, 4), np.float32))
        p, pv = jpad(plist, jc.num_proposals)
        dets = steps[orientation](variables, ebatch, jnp.asarray(p), jnp.asarray(pv))
        results.extend(jper_class(dets, jc.num_classes, np.asarray(ebatch.valid)))
        order.extend(idx.tolist())
    want = [r for _, r in sorted(zip(order, results), key=lambda q: q[0])]
    anns = [val.get_ann_info(i) for i in range(len(val))]
    got = train_detector.evaluate(
        port_model("fast_rcnn", variables), tc,
        VOCDataset(os.path.join(voc, "ImageSets/Main/test.txt"), voc, test_mode=True,
                   classes=classes),
        train_detector.pipeline_for(tc, True), 4, "cpu", proposals=props)
    _assert_same(got["results"], want)
    assert got["mAP"] == jeval_map(want, anns, iou_thr=0.5, mode="11points")["mAP"]
    assert sum(len(a) for r in got["results"] for a in r) > 10


def test_the_refusals_that_remain(voc, tmp_path):
    with pytest.raises(SystemExit, match="--proposal-file"):
        train_detector.main(["--family", "fast_rcnn", "--mini", "--cpu", "--voc07", voc,
                             "--work-dir", str(tmp_path)])
    base = ["--voc07", voc, "--checkpoint", "c.ckpt", "--cpu", "--mini"]
    with pytest.raises(NotImplementedError, match="item 14"):
        gen_proposals.main(base + ["--coco", "instances.json"])
    with pytest.raises(NotImplementedError, match="item 16"):
        gen_proposals.main(base + ["--dtype", "bfloat16"])
    with pytest.raises(NotImplementedError, match="item 15"):
        tapi.init_detector(jcfg.tiny_detectors_config(), device="cpu")
    with pytest.raises(ValueError, match="external proposals"):
        tapi.make_eval_step_for(port_model("fast_rcnn", jax_two_stage("fast_rcnn")[1]),
                                tcfg.tiny_fast_rcnn_config(), device="cpu")
