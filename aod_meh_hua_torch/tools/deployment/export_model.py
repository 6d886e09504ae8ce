"""Serving export: the eval step (forward -> decode -> NMS) as a
torch.export program with the weights inside, for every family the port
builds but Fast R-CNN: the dense ones (RetinaNet, SSD; engine/eval.py
EvalStep) and the two-stage ones (engine/two_stage.py eval_module:
TwoStageEvalStep for Faster, Cascade, Dynamic and Double-Head R-CNN and
the Faster R-CNN variants, the cascade's three stages in one program,
Dynamic R-CNN's as Faster R-CNN's, the double head's BN at its running
statistics; its subclasses for the RPN-only and Cascade RPN families,
whose programs return their proposals as a one-class ProposalResult,
TridentNet's test branch and Grid R-CNN's grid refinement). Fast R-CNN's
eval takes proposals from outside and is not exported, as the JAX
package's make_eval_step_for refuses it.

Port of tools/deployment/export_model.py of the JAX package (flags
:17-84), whose artifact is a jax.export StableHLO blob; here it is a
torch.export ExportedProgram saved with torch.export.save (a .pt2 zip).
The program is traced at a fixed batch on float32 canvases normalised on
the host (the JAX artifacts' input, package_model.py's geometry block),
with every NMS fixpoint (the proposals' too) as a device-side
while_loop and, for fused_blocks=True, each fused block as one `aod_meh_hua_torch::
fused_bottleneck` node whose BN fold is recorded on the parameters
(models/resnet.py folds_in_graph). A program exported on the card runs
the kernel on the card when it is called.

    python -m aod_meh_hua_torch.tools.deployment.export_model \\
        [--family retinanet|ssd|faster_rcnn|cascade_rcnn|dynamic_rcnn|double_head_rcnn] \\
        [--checkpoint c.ckpt] [--out det.pt2] [--batch 8] [--mini] [--cpu]

It runs on the card unless given --cpu, and pins the numerics
(utils/device.py pin_numerics). `export_eval_step(cfg, model, batch)`
exports a model the caller built (e.g. fused, through api.py; pass
cfg.for_orientation("portrait") for the portrait program). Loading a
program needs the operator and the two namedtuples registered: use
`load_program`, which imports them. An exported program holds no
profiler range: it is timed as one.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional, Sequence

import torch

from ...engine.batch import EvalBatch
from ...engine.eval import EvalStep, batch_on
from ...engine.two_stage import eval_module as two_stage_eval_module
from ...models.resnet import folds_in_graph
from ...ops import fused_block  # noqa: F401 (registers aod_meh_hua_torch::fused_bottleneck)
from ...ops.nms import NMSResult
from ...utils.config import ALL_FAMILIES
from ...utils.device import pin_numerics

# every family the port builds but Fast R-CNN, whose eval step takes proposals
EXPORTED_FAMILIES = tuple(f for f in ALL_FAMILIES if f != "fast_rcnn")


def config_for(family: str, mini: bool = False):
    """The JAX tools' config choice (export_model.py :53-62): --mini the
    tiny RetinaNet (the retinanet smoke mode), else the family's default,
    a model-zoo family's from ZOO_FAMILIES."""
    from ...utils.config import ZOO_FAMILIES, RetinaNetConfig, SSDConfig, tiny_test_config

    if mini:
        return tiny_test_config()
    if family == "retinanet":
        return RetinaNetConfig()
    if family == "ssd":
        return SSDConfig()
    return ZOO_FAMILIES[family][0]()


def example_batch(cfg, batch: int, device) -> EvalBatch:
    """The traced input: `batch` float32 canvases of cfg.canvas (JAX's
    zeros), their shapes, scale factors and valid flags."""
    h, w = cfg.canvas
    return EvalBatch(torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device),
                     torch.zeros((batch, 2), dtype=torch.int32, device=device),
                     torch.ones((batch, 4), dtype=torch.float32, device=device),
                     torch.ones(batch, dtype=torch.bool, device=device))


def eval_module(cfg, model, device_loop: bool = False) -> torch.nn.Module:
    """The family's eval step as a module: a two-stage family's
    (engine/two_stage.py eval_module), EvalStep for the dense ones."""
    if cfg.family in ("retinanet", "ssd"):
        return EvalStep(model, cfg, device_loop=device_loop)
    return two_stage_eval_module(model, cfg, device_loop=device_loop)


def export_eval_step(cfg, model, batch: int) -> torch.export.ExportedProgram:
    """torch.export of the family's eval module (eval_module) at `batch` on
    the model's device: float32 canvases of cfg.canvas (pass
    cfg.for_orientation(...) for the portrait program, whose anchors and
    canvas are that config's), every NMS loop on the device, the fused
    blocks' folds in the graph. Raises whatever export raises."""
    device = next(model.parameters()).device
    step = eval_module(cfg, model, device_loop=True)
    with torch.no_grad(), folds_in_graph(model):
        program = torch.export.export(step, (example_batch(cfg, batch, device),))
    # the saved program keeps no input (at batch 8 the canvases are 60 MB),
    # as the JAX artifact keeps none
    program.example_inputs = None
    return program


def save_program(program: torch.export.ExportedProgram, f) -> None:
    """torch.export.save. Its warning that a conv weight in channels_last
    memory is not a "complete tensor" is dropped: such a weight is saved
    whole, with its strides, and loads back bit for bit
    (tests/test_torch_deploy.py)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, f)


def load_program(f) -> torch.export.ExportedProgram:
    """torch.export.load of a program this module exported, with what it
    needs registered by this module's imports: the fused operator and the
    EvalBatch / NMSResult serialisation names."""
    return torch.export.load(f)


def run_program(program, batch: EvalBatch) -> NMSResult:
    """Call a loaded program (its module, or the ExportedProgram) on an
    EvalBatch of numpy arrays or tensors, without autograd, on the
    device the program was exported on."""
    module = program.module() if isinstance(program, torch.export.ExportedProgram) else program
    device = next(module.parameters()).device
    with torch.no_grad():
        return module(batch_on(batch, device))


def fused_nodes(program: torch.export.ExportedProgram) -> int:
    """The number of aod_meh_hua_torch::fused_bottleneck calls in the
    program's graph."""
    op = torch.ops.aod_meh_hua_torch.fused_bottleneck.default
    return sum(n.op == "call_function" and n.target is op for n in program.graph.nodes)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="Export the eval step with torch.export")
    ap.add_argument("--family", default="retinanet", choices=sorted(EXPORTED_FAMILIES),
                    help="a dense family (retinanet, ssd) or a two-stage one (the cascade's "
                         "three stages export as one program)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="detector_export.pt2")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--mini", action="store_true", help="tiny model geometry (smoke/test mode)")
    ap.add_argument("--cpu", action="store_true", help="export on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    from ...api import init_detector

    args = parse_args(argv)
    if args.mini and args.family != "retinanet":
        raise ValueError("--mini is the retinanet smoke mode")
    pin_numerics()
    cfg = config_for(args.family, args.mini)
    model = init_detector(cfg, checkpoint=args.checkpoint, device="cpu" if args.cpu else "cuda")
    program = export_eval_step(cfg, model, args.batch)
    save_program(program, args.out)
    print(f"exported {args.family} eval step ({os.path.getsize(args.out) / 1e6:.1f} MB) "
          f"-> {args.out}")
    # round-trip sanity
    loaded = load_program(args.out)
    out = run_program(loaded, example_batch(cfg, args.batch, "cpu"))
    print(f"round-trip OK: boxes {tuple(out.boxes.shape)}")
    return args.out


if __name__ == "__main__":
    main()
