"""The two-stage families' deployment path on the CPU, f32: the proposal
NMS as a device while_loop at its real depth, the archive (tools/deployment/package_model.py), a load in a fresh
process, test_exported's sweep and ArchiveDetector (serve.py).

- The level-grouped proposal NMS (ops/nms.py grouped_nms) with
  device_loop, exported, against the eager host loop
  on 4,480 candidates per image (the full-width eval's count), with a
  suppression chain deeper than two while_loop bodies and the
  suppression mask built in several static row blocks: the same
  NMSResult, bit for bit.
- Each family's programs in both orientations against the eager step:
  tests/test_torch_export_two_stage.py.
- A Cascade R-CNN archive (both orientations' programs, the three stages
  in each): loaded in a fresh process, whose only imports are the
  port's loader, its detections equal the eager step's; test_exported's
  sweep of the mini VOC tree through the archive's programs equals the
  eager eval's per-image results and mAP; ArchiveDetector on landscape
  and portrait images equals a Detector with the same pipeline, bit for
  bit.

Weights: tests/torch_parity.py two_stage_pair (the RPN and class heads
sharpened).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.data.voc import VOC_CLASSES, VOCDataset
from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
from aod_meh_hua_torch.ops import nms
from aod_meh_hua_torch.tools.deployment import export_model, package_model, serve, test_exported
from aod_meh_hua_torch.tools.train_detector import evaluate
from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

from test_torch_export_two_stage import B, _batch
from torch_parity import mini_voc, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
FAMILY = "cascade_rcnn"
# the tiny canvas (64, 128): a resize rule that always fits it
PIPE = PipelineConfig(img_scale=(128, 64), canvas=(64, 128))


# --- the proposal NMS at its real depth ----------------------------------------------

K, GROUPS, CHAIN = 4480, 5, 20


def _proposal_candidates(seed=0):
    """Two images of K candidates in GROUPS levels: in level 0 a row of
    CHAIN boxes 10 wide, 1 apart, scores falling (each overlaps the next
    at IoU 0.82 and the one after at 0.67, so greedy NMS at 0.7 keeps
    every other one and the map's fixpoint is CHAIN deep), the rest
    random boxes; some invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, K, 2).astype(np.float32) * 900
    boxes = np.concatenate([xy, xy + 8 + rng.rand(2, K, 2).astype(np.float32) * 120], axis=-1)
    scores = rng.rand(2, K).astype(np.float32) * 0.5
    groups = np.sort(rng.randint(0, GROUPS, (2, K)), axis=1)
    x = np.arange(CHAIN, dtype=np.float32)
    boxes[0, :CHAIN] = np.stack([x, np.zeros(CHAIN), x + 10, np.full(CHAIN, 10.0)], -1)
    scores[0, :CHAIN] = np.linspace(0.99, 0.6, CHAIN)
    groups[0, :CHAIN] = 0
    valid = rng.rand(2, K) > 0.05
    valid[0, :CHAIN] = True
    return tuple(torch.from_numpy(a) for a in (boxes, scores, groups, valid))


class _Proposals(torch.nn.Module):
    def forward(self, boxes, scores, groups, valid):
        return nms.grouped_nms(boxes, scores, groups, valid, 0.7, 1000, device_loop=True)


def test_proposal_nms_while_loop_at_its_real_depth(monkeypatch):
    # row blocks of 1,024 (K x K at batch 2 is 40M IoUs, one block at the default)
    monkeypatch.setattr(nms, "SUPPRESSION_BLOCK", 2 * K * 1024)
    args = _proposal_candidates()
    assert CHAIN > 2 * nms.CHECK_INTERVAL
    got = torch.export.export(_Proposals(), args).module()(*args)
    want = nms.grouped_nms(*args, 0.7, 1000)
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    kept = set(want.anchor_idx[0][want.valid[0]].tolist())
    assert {i for i in range(CHAIN) if i in kept} == set(range(0, CHAIN, 2))


# --- the archive ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """The tiny cascade's programs in both orientations, saved and
    packaged, and ArchiveDetector on the archive."""
    _, _, model = two_stage_pair(FAMILY)
    cfg = ZOO_FAMILIES[FAMILY][1]()
    root = tmp_path_factory.mktemp("two_stage_archive")
    paths = {}
    for o in ("landscape", "portrait"):
        paths[o] = str(root / f"{o}.pt2")
        export_model.save_program(export_model.export_eval_step(cfg.for_orientation(o), model,
                                                                B), paths[o])
    geometry = {**package_model.geometry_for(cfg, B, mini=True),
                "img_scale": list(PIPE.img_scale)}
    tar = package_model.package(paths["landscape"], str(root / "store"), "cascade",
                                family=FAMILY, artifact_portrait=paths["portrait"],
                                geometry=geometry)
    return dict(model=model, cfg=cfg, root=root, tar=tar, det=serve.ArchiveDetector(tar))


def test_archive_loads_in_a_fresh_process(archive):
    """The archive's portrait program in a process that imports only the
    port's archive loader: the EvalBatch and NMSResult names registered
    there, its detections the eager step's."""
    cfg = archive["cfg"].for_orientation("portrait")
    batch = _batch(cfg)
    inp, out = str(archive["root"] / "batch.pt"), str(archive["root"] / "out.pt")
    torch.save(tuple(torch.from_numpy(np.asarray(a)) for a in batch), inp)
    code = ("import sys, torch\n"
            "from aod_meh_hua_torch.tools.deployment.package_model import load_archive\n"
            "from aod_meh_hua_torch.tools.deployment.export_model import run_program\n"
            "from aod_meh_hua_torch.engine.batch import EvalBatch\n"
            "manifest, programs = load_archive(sys.argv[1])\n"
            "dets = run_program(programs['portrait'], EvalBatch(*torch.load(sys.argv[2])))\n"
            "torch.save((manifest['family'], type(dets).__name__, tuple(dets)), sys.argv[3])\n")
    r = subprocess.run([sys.executable, "-c", code, archive["tar"], inp, out], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    family, kind, got = torch.load(out)
    assert (family, kind) == (FAMILY, "NMSResult")
    want = make_two_stage_eval_step(archive["model"], cfg, device="cpu")(batch)
    assert int(want.valid.sum()) > 0
    for g, v in zip(got, want):
        assert torch.equal(g, v)


def test_sweep_through_the_archive_equals_the_eager_eval(archive, tmp_path):
    det = archive["det"]
    assert set(det.programs) == {"landscape", "portrait"} and det.manifest["family"] == FAMILY
    voc = mini_voc(tmp_path / "voc")
    cfg = archive["cfg"]
    val = VOCDataset(os.path.join(voc, "ImageSets/Main/test.txt"), voc, test_mode=True,
                     classes=VOC_CLASSES[:cfg.num_classes])
    got = test_exported.sweep(det.programs, cfg, val, PIPE, B)
    want = evaluate(archive["model"], cfg, val, PIPE, B, "cpu")
    assert len(got["order"]) == len(val) and got["mAP"] == want["mAP"]
    results = [r for _, r in sorted(zip(got["order"], got["results"]), key=lambda p: p[0])]
    assert sum(len(a) for per in results for a in per) > 0
    for g, v in zip(results, want["results"]):
        for a, b in zip(g, v):
            np.testing.assert_array_equal(a, b)


def test_archive_detector_equals_the_detector(archive):
    det = archive["det"]
    assert det.batch == B
    rng = np.random.RandomState(5)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8)
              for h, w in [(60, 110), (100, 70), (50, 120)]]
    cfg = archive["cfg"]
    want = tapi.Detector(cfg, archive["model"], pipeline=PipelineConfig(
        img_scale=PIPE.img_scale, canvas=cfg.canvas, device_normalize=True)).predict_batch(
            images, max_batch=B)
    got = det.predict_batch(images)
    assert sum(len(a) for per in got for a in per) > 0
    for g, v in zip(got, want):
        assert len(g) == len(v) == cfg.num_fg_classes
        for a, b in zip(g, v):
            np.testing.assert_array_equal(a, b)
