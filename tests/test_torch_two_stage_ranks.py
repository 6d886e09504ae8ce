"""The two-stage families across ranks (aod_meh_hua_torch: engine/two_stage.py
under a data mesh, models/two_stage.py HeadBatchNorm2d's global
statistics, tools/train_detector.py's ranks), on the CPU over two gloo
ranks, against the port's one-process step on the same global batch.

The criterion is the JAX step's semantics: one jit over the sharded
global batch (aod_meh_hua_tpu/parallel/mesh.py), in which every
reduction is the global batch's. So two ranks of one image each must
give the one-process step on both images:
- for each family (FAMILIES), after two SGD steps on one global batch of 2 under
  the same global uniforms (each rank keeps its rows): every parameter
  and buffer within 1e-4 of its max-abs, aux within rtol 1e-5, both ranks
  alike; Dynamic R-CNN's threshold, beta and rings across a refresh
  (interval 2) and the double head's BN running statistics among the
  buffers;
- a batch whose second image has no gt, so that rank 1 samples no
  positive RoI: the global k-th smallest beta and the global avg_reg
  still hold (a per-rank fallback to the initial beta, or a per-rank
  normaliser, would not), and the cascade's per-stage sums are called on
  the rank without positives too;
- tools/train_detector.py's evaluate sharded over the ranks gives the
  one-process per-image results in dataset order and its mAP;
- the trainer's --mini --cpu --num-devices 2 run leaves the checkpoint
  of the --mini --cpu run (1e-4 of max-abs) with the same metrics, only
  rank 0 writing.

Weights: each family's tiny config, seed 1, its RPN and class heads
sharpened (chip_smoke.py sharpen_frcnn: objectness logits of std 1.5,
class logits too), so that no proposal or sample sits at a near-tie.
The ranks run in spawned processes (tests/torch_dist_workers.py).
"""

import json

import numpy as np
import pytest
import torch

from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.checkpoint import load_checkpoint
from aod_meh_hua_torch.models.two_stage import build_two_stage
from aod_meh_hua_torch.tools import train_detector
from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

import torch_dist_workers as w
from chip_smoke import seed_zero_starts, sharpen_frcnn
from torch_parity import mini_voc, numerics_flags_kept, two_stage_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

# the families whose step couples the images of a batch in its own way,
# and Libra R-CNN (its RoI sampler on seven draws per image). PAFPN,
# CARAFE, GRoIE and empirical attention run Faster R-CNN's step with
# another model, whose layers act on each image alone (GRoIE's attention
# on each RoI), so their two-rank step is Faster R-CNN's case
FAMILIES = ("faster_rcnn", "cascade_rcnn", "dynamic_rcnn", "double_head_rcnn", "libra_rcnn")
STEPS = 2
PARAM_TOL = 1e-4   # of each tensor's max-abs
AUX_RTOL = 1e-5


def _cfg(family):
    # Dynamic R-CNN refreshes on the second step
    over = {"update_iter_interval": 2} if family == "dynamic_rcnn" else {}
    return ZOO_FAMILIES[family][1](**over)


def _spec(family, no_gt_on_rank1=False, seed=0):
    cfg = _cfg(family)
    arrays = list(two_stage_batch(cfg, seed=seed))
    if no_gt_on_rank1:
        arrays[3] = arrays[3].copy()
        arrays[3][1] = False
    model = build_two_stage(cfg, device="cpu", seed=1)
    # Libra's BFP: its non-local block's phi bias has no gradient in exact
    # arithmetic (the softmax over the keys cancels it), so from its zero
    # init it would hold the sums' rounding alone; its biases start from a
    # seeded draw (chip_smoke.seed_zero_starts; a no-op for the others)
    seed_zero_starts(model, seed + 3)
    sharpen_frcnn(model, cfg, torch.from_numpy(arrays[0]), torch.from_numpy(arrays[5]))
    n_props = cfg.max_gt + cfg.rpn.train_max_per_img
    sizes = {"rpn": cfg.level_bounds()[-1][1]}
    if family == "cascade_rcnn":
        sizes.update({f"roi{i}": n_props if i == 0 else cfg.max_gt + cfg.rcnn.sampler_num
                      for i in range(cfg.num_stages)})
    else:
        sizes["roi"] = n_props
    gen = torch.Generator().manual_seed(seed + 11)
    per_stage = {k: 2 if k == "rpn" else tts.roi_draws(cfg) for k in sizes}
    draws = [{k: tuple(torch.rand((2, n), generator=gen) for _ in range(per_stage[k]))
              for k, n in sizes.items()} for _ in range(STEPS)]
    return {"cfg": cfg, "init": model.state_dict(), "arrays": arrays, "draws": draws}


CASES = [(f, False) for f in FAMILIES] + [("dynamic_rcnn", True), ("cascade_rcnn", True),
                                          ("double_head_rcnn", True)]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("ranks") / "voc")


@pytest.fixture(scope="module")
def eval_spec(voc):
    cfg = ZOO_FAMILIES["cascade_rcnn"][1]()
    model = build_two_stage(cfg, device="cpu", seed=2)
    arrays = two_stage_batch(cfg, seed=3)
    sharpen_frcnn(model, cfg, torch.from_numpy(arrays[0]), torch.from_numpy(arrays[5]))
    return {"cfg": cfg, "init": model.state_dict(), "voc": voc, "batch": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eval_spec):
    """Every case's steps on two ranks (one spawn for all of them) and in
    one process; the sharded eval on two ranks and in one process."""
    specs = {case: _spec(*case) for case in CASES}
    calls = [(w.two_stage_steps, (specs[case],)) for case in CASES]
    calls.append((w.two_stage_eval, (eval_spec,)))
    ranks = w.run_ranks(w.programs, 2, str(tmp_path_factory.mktemp("two_stage_ranks")), calls,
                        timeout=240)
    single = {case: w.two_stage_steps(0, 1, specs[case], mesh=False) for case in CASES}
    by_case = {case: [r[i] for r in ranks] for i, case in enumerate(CASES)}
    return {"ranks": by_case, "single": single, "specs": specs,
            "eval": [r[-1] for r in ranks], "eval_single": w.two_stage_eval(0, 1, eval_spec)}


def _close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), (what, k)
            continue
        scale = max(v.abs().max().item(), 1e-30)
        err = (got[k] - v).abs().max().item() / scale
        assert err <= PARAM_TOL, (what, k, err)


@pytest.mark.parametrize("case", CASES, ids=[f"{f}{'-no_gt_on_rank1' if n else ''}"
                                             for f, n in CASES])
def test_two_ranks_equal_the_one_process_step(runs, case):
    family, no_gt = case
    ranks, single = runs["ranks"][case], runs["single"][case]
    assert ranks[0]["aux"] == ranks[1]["aux"]
    for r in ranks:
        for got, want in zip(r["aux"], single["aux"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=AUX_RTOL, abs=1e-12), (k, got, want)
        _close(r["state"], single["state"], family)
        for got, want in zip(r["dynamic"], single["dynamic"]):
            _close(got, want, "dynamic state")
    assert all(a["num_pos"] > 0 for a in single["aux"])
    init = runs["specs"][case]["init"]
    moved = [k for k, v in single["state"].items()
             if v.is_floating_point() and not torch.equal(v, init[k])]
    if family == "double_head_rcnn":  # the head's running statistics moved
        assert {k for k in moved if "running_" in k} == \
            {k for k in init if k.startswith("bbox_head") and "running_" in k}
    if family == "dynamic_rcnn":
        dyn = single["dynamic"]
        assert [int(d["step"]) for d in dyn] == list(range(1, STEPS + 1))
        cfg = runs["specs"][case]["cfg"]
        # the refresh at the second step moved the threshold or the beta
        assert (float(dyn[-1]["iou_thr"]) != cfg.rcnn.pos_iou_thr
                or float(dyn[-1]["beta"]) != cfg.initial_beta)


def test_a_rank_without_positives(runs):
    """Rank 1's image has no gt: on its own it would sample no positive
    RoI, and Dynamic R-CNN's beta there would fall back to the initial
    beta. The global statistic is rank 0's positives' k-th smallest."""
    case = ("dynamic_rcnn", True)
    single, ranks = runs["single"][case], runs["ranks"][case]
    assert all(a["num_pos"] > 0 for a in single["aux"])
    beta_hist = single["dynamic"][0]["beta_hist"]
    assert float(beta_hist[0]) != runs["specs"][case]["cfg"].initial_beta
    for r in ranks:
        assert torch.equal(r["dynamic"][0]["beta_hist"], beta_hist)


def test_sharded_eval_returns_results_in_dataset_order(runs, eval_spec):
    want = runs["eval_single"]
    assert sum(len(a) for per in want["results"] for a in per) > 0
    for got in runs["eval"]:
        assert got["mAP"] == want["mAP"]
        assert len(got["results"]) == len(want["results"])
        for g, v in zip(got["results"], want["results"]):
            for a, b in zip(g, v):
                np.testing.assert_array_equal(a, b)


def test_odd_batch_refused_before_the_ranks_start(tmp_path):
    with pytest.raises(SystemExit, match="must divide"):
        train_detector.main(["--family", "faster_rcnn", "--mini", "--cpu", "--voc07", "v",
                             "--work-dir", str(tmp_path), "--num-devices", "2",
                             "--batch-size", "3"])


@pytest.mark.parametrize("family", ["double_head_rcnn"])
def test_cli_num_devices_2_leaves_the_single_process_checkpoint(voc, tmp_path, family):
    argv = ["--family", family, "--mini", "--cpu", "--voc07", voc, "--epochs", "1"]
    with numerics_flags_kept():
        train_detector.main(argv + ["--work-dir", str(tmp_path / "one")])
        assert train_detector.main(argv + ["--work-dir", str(tmp_path / "two"),
                                           "--num-devices", "2"]) is None
    one = load_checkpoint(str(tmp_path / "one" / f"{family}_final.ckpt"))
    two = load_checkpoint(str(tmp_path / "two" / f"{family}_final.ckpt"))
    _close(two, one, "checkpoint")
    metrics = [json.loads((tmp_path / d / "metrics.json").read_text()) for d in ("one", "two")]
    assert metrics[1][0]["mAP"] == metrics[0][0]["mAP"]
    assert metrics[1][0]["loss"] == pytest.approx(metrics[0][0]["loss"], rel=AUX_RTOL)
    assert len((tmp_path / "two" / "train_log.jsonl").read_text().splitlines()) == 1
