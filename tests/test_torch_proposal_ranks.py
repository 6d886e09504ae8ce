"""The proposal families' train steps across ranks (aod_meh_hua_torch:
engine/rpn_only.py, cascade_rpn.py, trident.py, grid_rcnn.py under a data
mesh, engine/two_stage.py _make_step), on the CPU over two gloo ranks of
one image each, against the port's one-process step on the same global
batch of two: the JAX step's semantics, one jit over the sharded global
batch, in which every normaliser is the global batch's (Cascade RPN's
stage-0 A_tot * B / 200, the grid loss's positives, TridentNet's R * B
branch rows, each rank keeping its images' rows of every branch).

Weights: each family's tiny config from tests/torch_parity.py
jax_two_stage's draw (heads sharpened); the batches of the families'
parity files (torch_proposal_parity family_batch: TridentNet's gts near
its branch-0 proposals, Fast R-CNN's ProposalBatch). The draws of
engine/two_stage.py step_draws from a seeded CPU generator, the global
batch's on both ranks. The ranks run in spawned processes
(tests/torch_dist_workers.py).

Tolerances: after two SGD steps every parameter and buffer within 1e-4
of its max-abs, aux rtol 1e-5, both ranks alike, positives every step.
"""

import pytest
import torch

from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

import torch_dist_workers as w
from aod_meh_hua_tpu.utils import config as jcfg
from torch_parity import jax_two_stage
from torch_proposal_parity import family_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("rpn", "cascade_rpn", "tridentnet", "fast_rcnn", "grid_rcnn")
STEPS = 2
PARAM_TOL = 1e-4   # of each tensor's max-abs
AUX_RTOL = 1e-5


def _spec(family):
    cfg = ZOO_FAMILIES[family][1]()
    _, variables = jax_two_stage(family)
    _, batch = family_batch(family, jcfg.ZOO_FAMILIES[family][1](), variables=variables)
    gen = torch.Generator().manual_seed(11)
    draws = [{stage: tuple(torch.rand((2, n), generator=gen) for _ in range(k))
              for stage, (n, k) in tts.step_draws(cfg).items()} for _ in range(STEPS)]
    return {"cfg": cfg, "init": from_jax_variables(variables), "arrays": list(batch),
            "draws": draws}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = {f: _spec(f) for f in FAMILIES}
    ranks = w.run_ranks(w.programs, 2, str(tmp_path_factory.mktemp("proposal_ranks")),
                        [(w.two_stage_steps, (specs[f],)) for f in FAMILIES], timeout=240)
    single = {f: w.two_stage_steps(0, 1, specs[f], mesh=False) for f in FAMILIES}
    return {f: ([r[i] for r in ranks], single[f]) for i, f in enumerate(FAMILIES)}


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_equal_the_one_process_step(runs, family):
    ranks, single = runs[family]
    assert ranks[0]["aux"] == ranks[1]["aux"]
    for r in ranks:
        for got, want in zip(r["aux"], single["aux"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=AUX_RTOL, abs=1e-12), (k, got, want)
        assert r["state"].keys() == single["state"].keys()
        for k, v in single["state"].items():
            scale = max(v.abs().max().item(), 1e-30)
            assert (r["state"][k] - v).abs().max().item() <= PARAM_TOL * scale, (family, k)
    assert all(a["num_pos"] > 0 for a in single["aux"])
