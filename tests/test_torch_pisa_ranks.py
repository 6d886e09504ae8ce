"""PISA Faster R-CNN and GN+WS across ranks (aod_meh_hua_torch:
engine/pisa.py under a data mesh), on the CPU over two gloo ranks,
against the port's one-process step on the same global batch, and the
trainer's CLI with --family pisa_faster_rcnn.

The criterion is the JAX step's semantics (one jit over the sharded
global batch): ISR-P ranks each class's positives over the whole batch,
and max_l_num, the rescale sums, CARL's normaliser (with its gradient)
and the loss normalisers are global. So two ranks of one image each must
give the one-process step on both images: two SGD steps under the same
global uniforms, every parameter within 1e-4 of its max-abs and aux
within rtol 1e-5 (tests/test_torch_two_stage_ranks.py's rules, its
specs: the tiny config, seed 1, the heads sharpened, the zero-start
biases drawn), also when rank 1's image has no gt and samples no
positive. ResNeSt and GN+WS are the other families' case: their layers
act on each image alone (frozen BN, GroupNorm per image). GN+WS is held
for its first step only: its 53 GroupNorms amplify the rounding of the
ranks' split sums, so that from the second step on the two runs start
from states already apart (the second step's loss_cls 1.7e-3 apart, the
RoI head's first fc bias 8e-3 of its max after it, on the CPU; on an
H100 its f32 lies 1e-4 from f64 at full width).
"""

import json

import pytest

from aod_meh_hua_torch.tools import train_detector

import torch_dist_workers as w
from test_torch_two_stage_ranks import AUX_RTOL, _close, _spec
from torch_parity import mini_voc, numerics_flags_kept
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

CASES = [("pisa_faster_rcnn", False), ("pisa_faster_rcnn", True), ("resnest", False),
         ("gn_ws", False)]
ONE_STEP = ("gn_ws",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = {case: _spec(*case) for case in CASES}
    for case, spec in specs.items():
        if case[0] in ONE_STEP:
            spec["draws"] = spec["draws"][:1]
    calls = [(w.two_stage_steps, (specs[case],)) for case in CASES]
    ranks = w.run_ranks(w.programs, 2, str(tmp_path_factory.mktemp("pisa_ranks")), calls,
                        timeout=240)
    single = {case: w.two_stage_steps(0, 1, specs[case], mesh=False) for case in CASES}
    return {"ranks": {case: [r[i] for r in ranks] for i, case in enumerate(CASES)},
            "single": single}


@pytest.mark.parametrize("case", CASES, ids=[f"{f}{'-no_gt_on_rank1' if n else ''}"
                                             for f, n in CASES])
def test_two_ranks_equal_the_one_process_step(runs, case):
    family, _ = case
    ranks, single = runs["ranks"][case], runs["single"][case]
    assert ranks[0]["aux"] == ranks[1]["aux"]
    for r in ranks:
        for got, want in zip(r["aux"], single["aux"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=AUX_RTOL, abs=1e-12), (k, got, want)
        _close(r["state"], single["state"], family)
    assert all(a["num_pos"] > 0 for a in single["aux"])
    if family == "pisa_faster_rcnn":
        assert all(a["loss_carl"] > 0 for a in single["aux"])


def test_train_detector_mini_pisa(tmp_path):
    """--family pisa_faster_rcnn --mini --cpu: an epoch with eval, the
    checkpoint and the log."""
    voc = mini_voc(tmp_path / "voc")
    with numerics_flags_kept():
        model, cfg, metrics = train_detector.main([
            "--family", "pisa_faster_rcnn", "--mini", "--cpu", "--voc07", voc,
            "--work-dir", str(tmp_path / "work"), "--epochs", "1"])
    assert cfg.family == "pisa_faster_rcnn" and cfg.rpn.train_max_per_img == 64
    assert len(metrics) == 1 and "mAP" in metrics[0] and metrics[0]["loss"] > 0
    log = [json.loads(line) for line in (tmp_path / "work" / "train_log.jsonl").read_text()
           .splitlines()]
    assert log == metrics
    assert (tmp_path / "work" / "pisa_faster_rcnn_final.ckpt").exists()
