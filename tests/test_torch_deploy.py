"""The port's deployment path: the NMS fixpoint as a device-side
while_loop (ops/nms.py), the fused bottleneck as an operator inside a
torch.export program (ops/fused_block.py, engine/eval.py EvalStep,
tools/deployment/export_model.py), the archive (package_model.py), the
sweep through a loaded program (test_exported.py) and ArchiveDetector
(serve.py), on the CPU, f32.

Weights: tests/torch_parity.py jax_retinanet draws on TINY with
fused_blocks=True (layer1.1 and layer2.1 fuse), the cls head sharpened
(kernel x150); the port loads them with from_jax_variables.

Tolerances: the while_loop's keep masks equal the host loop's; the
exported, saved and loaded program's detections equal the eager step's
bit for bit; against the JAX make_eval_step_for (unfused: the fused
block's arithmetic is the unfused block's, tests/test_torch_fused_block.py)
the same survivors (valid flags and labels equal) and boxes and scores
to rtol 1e-4 (atol 1e-4), the two libraries' sums taken in other orders;
ArchiveDetector's results equal the Detector's bit for bit (the same
canvases, normalised on the host instead of the device); the MANIFEST's
keys, geometry and classes equal the JAX tool's.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.api import make_eval_step_for as jmake_eval_step_for
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.engine.batch import EvalBatch
from aod_meh_hua_torch.engine.eval import make_eval_step
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.resnet import Bottleneck
from aod_meh_hua_torch.ops import fused_block, nms
from aod_meh_hua_torch.tools.deployment import export_model, package_model, serve
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from test_data import make_voc
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import TINY, jax_retinanet, sharpen

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
SHARPEN = 150.0
B = 2


def _cfg():
    return ttiny(fused_blocks=True, **TINY)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The fused tiny model and its JAX twin, and its landscape program
    exported and saved at batch B (the portrait program is exported on
    the card, chip_smoke.py)."""
    jmodel, variables = jax_retinanet(**TINY)
    variables = sharpen(variables, SHARPEN)
    model = tapi.init_detector(_cfg(), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    root = tmp_path_factory.mktemp("deploy")
    program = export_model.export_eval_step(_cfg(), model, B)
    path = str(root / "landscape.pt2")
    export_model.save_program(program, path)
    return dict(jmodel=jmodel, variables=variables, model=model, program=program, path=path,
                root=root)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    shapes = np.array([[h, w], [h - 24, w - 40]], np.int32)
    images = rng.randn(B, h, w, 3).astype(np.float32)
    images[1, shapes[1, 0]:] = 0
    images[1, :, shapes[1, 1]:] = 0
    return EvalBatch(images, shapes, np.array([[1.0] * 4, [0.8, 0.9, 0.8, 0.9]], np.float32),
                     np.ones(B, bool))


# --- the NMS fixpoint as a while_loop ------------------------------------------------

def _chain(n=40, seed=0):
    """One image's boxes [n, 4] and scores [n, 1]: a row of boxes 10 wide,
    3 apart, scores falling: each overlaps the next at IoU 0.54 and the
    one after at 0.25, so greedy NMS keeps every other box and the map's
    fixpoint is n deep. A second image of random boxes beside it."""
    x = np.arange(n, dtype=np.float32) * 3.0
    chain = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], axis=-1).astype(np.float32)
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 40
    rand = np.concatenate([xy, xy + 5 + rng.rand(n, 2).astype(np.float32) * 20], axis=-1)
    boxes = np.stack([chain, rand])
    scores = np.stack([np.linspace(0.9, 0.2, n, dtype=np.float32)[:, None],
                       rng.rand(n, 1).astype(np.float32)])
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def _depth(boxes, ok, thr):
    """Applications of the suppression map until the mask stops moving."""
    sup = (nms.bbox_overlaps(boxes, boxes) > thr) & torch.triu(
        torch.ones(boxes.shape[1], boxes.shape[1], dtype=torch.bool), 1)
    keep, n = ok, 0
    while True:
        new = ok & ~(keep[:, :, None] & sup).any(dim=1)
        n += 1
        if torch.equal(new, keep):
            return n
        keep = new


def test_while_loop_nms_masks_equal_the_host_loop():
    boxes, scores = _chain()
    ok = torch.ones(boxes.shape[:2], dtype=torch.bool)
    assert _depth(boxes, ok, 0.5) > 3 * nms.CHECK_INTERVAL
    host = nms._greedy_keep_sorted(boxes, ok, 0.5)
    dev = nms._greedy_keep_sorted(boxes, ok, 0.5, device_loop=True)
    assert torch.equal(host, dev)
    assert torch.equal(host[0], torch.arange(40) % 2 == 0)
    rng = np.random.RandomState(3)
    for _ in range(5):
        xy = torch.from_numpy(rng.rand(3, 60, 2).astype(np.float32) * 50)
        rb = torch.cat([xy, xy + 4 + torch.from_numpy(rng.rand(3, 60, 2).astype(np.float32)) * 30],
                       dim=-1)
        rok = torch.from_numpy(rng.rand(3, 60) > 0.2)
        assert torch.equal(nms._greedy_keep_sorted(rb, rok, 0.4),
                           nms._greedy_keep_sorted(rb, rok, 0.4, device_loop=True))


class _NMS(torch.nn.Module):
    def forward(self, boxes, scores):
        return nms.batched_multiclass_nms(boxes, scores, 0.05, 0.5, 30, 60, device_loop=True)


def test_exported_while_loop_nms_equals_the_eager_nms():
    boxes, scores = _chain()
    program = torch.export.export(_NMS(), (boxes, scores))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    got = torch.export.load(buf).module()(boxes, scores)
    want = nms.batched_multiclass_nms(boxes, scores, 0.05, 0.5, 30, 60)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.valid[0].sum()) == 20


# --- the exported eval step ---------------------------------------------------------

def _fused_blocks(model) -> int:
    return sum(isinstance(m, Bottleneck) and m.fused and m.stride == 1
               and m.conv1.in_channels % 128 == 0 for m in model.modules())


def test_exported_step_holds_the_operator_and_equals_the_eager_step(shared):
    cfg = _cfg()
    assert export_model.fused_nodes(shared["program"]) == _fused_blocks(shared["model"]) == 2
    batch = _batch(cfg)
    loaded = export_model.load_program(shared["path"])
    before = fused_block.fused_bottleneck.launches
    got = export_model.run_program(loaded, batch)
    assert fused_block.fused_bottleneck.launches == before  # the CPU runs the plain version
    want = make_eval_step(shared["model"], cfg, device="cpu")(batch)
    assert type(got) is nms.NMSResult
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.valid.sum()) > 0
    jout = jmake_eval_step_for(shared["jmodel"], jtiny(**TINY))(shared["variables"], batch)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(jout.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(jout.boxes), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(jout.scores), rtol=1e-4,
                               atol=1e-4)


def test_export_cli_refuses_other_families():
    with pytest.raises(SystemExit):  # a family the port does not build
        export_model.main(["--cpu", "--family", "mask_rcnn"])
    with pytest.raises(ValueError, match="retinanet smoke mode"):
        export_model.main(["--mini", "--cpu", "--family", "ssd"])


# --- the archive and the programs behind it ----------------------------------------

def _run(module, *args):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def test_export_package_test_exported_chain(tmp_path):
    """export_model --mini --cpu -> package_model -> test_exported, each
    its own process, as the JAX package's tests/test_deployment.py runs
    the JAX tools."""
    base, _, ids = make_voc(str(tmp_path / "voc"), "VOC2007", n=6, seed=7)
    with open(os.path.join(base, "ImageSets/Main/test.txt"), "w") as f:
        f.write("\n".join(ids[:4]))
    art = str(tmp_path / "det.pt2")
    out = _run("aod_meh_hua_torch.tools.deployment.export_model", "--mini", "--cpu",
               "--batch", "2", "--out", art)
    assert "round-trip OK: boxes (2, 20, 4)" in out
    out = _run("aod_meh_hua_torch.tools.deployment.package_model", art, "--output-folder",
               str(tmp_path / "store"), "--mini", "--batch", "2", "--voc-classes")
    assert "packaged ->" in out
    manifest, programs = package_model.load_archive(str(tmp_path / "store" / "det.tar"))
    assert manifest["geometry"]["batch"] == 2 and set(programs) == {"landscape"}
    out = _run("aod_meh_hua_torch.tools.deployment.test_exported", art, "--mini", "--cpu",
               "--voc07", base, "--split", "test", "--batch", "2")
    assert "mAP:" in out and "evaluated" in out


def _package(shared, name, force=False):
    return package_model.package(
        shared["path"], str(shared["root"] / "store"), name,
        geometry=package_model.geometry_for(_cfg(), B, mini=True), force=force)


def _images():
    r = np.random.RandomState(11)
    return [(r.rand(h, w, 3) * 255).astype(np.uint8) for h, w in [(100, 200), (90, 170),
                                                                  (180, 90)]]


def test_archive_detector_equals_the_detector(shared):
    """Two landscape images, one padded batch of B."""
    det = serve.ArchiveDetector(_package(shared, "landscape"))
    assert set(det.programs) == {"landscape"} and det.batch == B
    want = tapi.Detector(_cfg(), shared["model"], pipeline=PipelineConfig(
        img_scale=(250, 120), canvas=_cfg().canvas, device_normalize=True)).predict_batch(
            _images()[:2], max_batch=B)
    got = det.predict_batch(_images()[:2])
    assert sum(len(a) for per in got for a in per) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_archive_detector_letterboxes_a_portrait_image(shared):
    """Without a portrait program a portrait image is letterboxed into the
    landscape canvas: detections inside the image."""
    det = serve.ArchiveDetector(_package(shared, "letterbox"))
    img = _images()[2]
    canvas, shape, scale = det._prepare(img, tuple(det.geo["canvas"]))
    assert canvas.shape == (128, 256, 3) and shape[0] <= 128 and shape[1] <= 256
    per = det.predict_batch([img])[0]
    assert len(per) == _cfg().num_fg_classes
    rows = np.concatenate(per)
    assert np.isfinite(rows).all()
    assert (rows[:, [0, 2]] <= img.shape[1] + 1e-3).all()
    assert (rows[:, [1, 3]] <= img.shape[0] + 1e-3).all()


def test_package_refuses_to_clobber_without_force(shared):
    path = _package(shared, "clobber")
    with pytest.raises(FileExistsError, match="--force"):
        _package(shared, "clobber")
    assert _package(shared, "clobber", force=True) == path


def test_manifest_matches_the_jax_tool(tmp_path, monkeypatch):
    art = tmp_path / "det.pt2"
    art.write_bytes(b"program")
    flags = ["--mini", "--batch", "4", "--voc-classes", "--score-thr", "0.3",
             "--model-version", "2.0"]
    package_model.main([str(art), "--output-folder", str(tmp_path / "t"), *flags])
    spec = importlib.util.spec_from_file_location(
        "jax_package_model", os.path.join(REPO, "tools", "deployment", "package_model.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr(sys, "argv", ["package_model.py", str(art), "--output-folder",
                                      str(tmp_path / "j"), *flags])
    jmod.main()

    def manifest(folder):
        with tarfile.open(tmp_path / folder / "det.tar") as tf:
            return json.loads(tf.extractfile("MANIFEST.json").read())

    got, want = manifest("t"), manifest("j")
    assert set(got) == set(want)
    for key in ("geometry", "classes", "model_name", "model_version", "family", "score_thr"):
        assert got[key] == want[key], key
    assert got["runtime"] == "torch.export"
