"""Evaluate EXPORTED detector programs on a VOC split, through the loaded
programs only, with the port's VOC mAP.

Port of tools/deployment/test_exported.py of the JAX package (:29-112;
after the reference's tools/deployment/test.py, which runs the deployed
ONNX/TensorRT engine over the test set). The programs are
export_model.py's: weights inside, one canvas orientation and one batch
size each, on the device they were exported on. Pass
--artifact-portrait too for a split with portrait images: batches of an
orientation without a program are skipped, with a warning, so a
one-program run is a partial eval. --family picks the config as the JAX
tool does (:67-72): the family's default, a two-stage one's from
ZOO_FAMILIES; --mini the tiny RetinaNet.

    python -m aod_meh_hua_torch.tools.deployment.export_model --batch 8 --out land.pt2
    python -m aod_meh_hua_torch.tools.deployment.test_exported land.pt2 \\
        --voc07 .../VOC2007 --split test --batch 8 [--cpu]

It runs on the card unless given --cpu (then the programs must have
been exported on the CPU). main returns the mAP; run(argv) returns it
with the per-image results (detections_to_per_class) and the dataset
index of each, in the sweep's order; sweep(programs, cfg, dataset, pipe,
batch) is its loop over loaded programs.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ...utils.device import pin_numerics, resolve_device
from .export_model import EXPORTED_FAMILIES, config_for, load_program, run_program


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """main's sweep: {"mAP", "results", "order"}."""
    ap = argparse.ArgumentParser(description="VOC mAP of exported programs")
    ap.add_argument("artifact", help="exported .pt2 (landscape program)")
    ap.add_argument("--artifact-portrait", default=None)
    ap.add_argument("--family", default="retinanet", choices=sorted(EXPORTED_FAMILIES))
    ap.add_argument("--voc07", required=True)
    ap.add_argument("--voc12", default=None)
    ap.add_argument("--split", default="test")
    ap.add_argument("--batch", type=int, default=1,
                    help="must match the exported program's batch size")
    ap.add_argument("--mini", action="store_true", help="tiny model geometry")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from ...data.pipeline import PipelineConfig
    from ...data.voc import ConcatVOC, VOCDataset

    pin_numerics()
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = config_for(args.family, args.mini)
    paths = {"landscape": args.artifact, "portrait": args.artifact_portrait}
    programs = {}
    for orientation, path in paths.items():
        if path:
            module = load_program(path).module()
            on = next(module.parameters()).device
            if on.type != device.type:
                raise ValueError(f"{path} was exported on {on}; this run is on {device}")
            programs[orientation] = module

    def _year(root):
        return VOCDataset(os.path.join(root, "ImageSets", "Main", f"{args.split}.txt"), root,
                          test_mode=True)

    dataset = (ConcatVOC([_year(args.voc07), _year(args.voc12)])
               if args.voc12 else _year(args.voc07))
    pipe = PipelineConfig(canvas=cfg.canvas)
    if args.mini:
        pipe = PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas)
    return sweep(programs, cfg, dataset, pipe, args.batch)


def sweep(programs: dict, cfg, dataset, pipe, batch_size: int) -> dict:
    """The loaded programs ({orientation: module}) over every image of
    `dataset` through `pipe`'s canvases at the programs' batch:
    {"mAP", "results" (detections_to_per_class, in the sweep's order),
    "order" (the dataset index of each)}; the images of an orientation
    without a program are skipped, with a warning."""
    from ...data.loader import EvalLoader
    from ...engine.eval import detections_to_per_class
    from ...utils.voc_eval import eval_map

    loader = EvalLoader(dataset, np.arange(len(dataset)), pipe, batch_size=batch_size)
    results, order, skipped = [], [], 0
    for orientation, batch, bidx in loader:
        prog = programs.get(orientation)
        if prog is None:
            skipped += len(bidx)
            continue
        dets = run_program(prog, batch)
        results.extend(detections_to_per_class(dets, cfg.num_classes, np.asarray(batch.valid)))
        order.extend(bidx.tolist())
    if skipped:
        print(f"WARNING: skipped {skipped} images with no matching-orientation artifact")
    annotations = [dataset.get_ann_info(i) for i in order]
    out = eval_map(results, annotations, iou_thr=0.5, mode="11points")
    print(f"evaluated {len(order)}/{len(dataset)} images")
    print(f"mAP: {out['mAP']:.4f}")
    return {"mAP": out["mAP"], "results": results, "order": order}


def main(argv: Optional[Sequence[str]] = None) -> float:
    return run(argv)["mAP"]


if __name__ == "__main__":
    main()
