"""Dump an RPN's proposals for a dataset to an .npz: the proposal file
that Fast R-CNN trains on.

Port of tools/gen_proposals.py of the JAX package (:26-111), after the
reference's workflow: train an RPN (configs/rpn/rpn_r50_fpn_1x_coco.py),
collect each image's proposals, and feed them to Fast R-CNN as
data.train.proposal_file (configs/fast_rcnn/*,
mmdet/datasets/custom.py:181 load_proposals). The file is an .npz keyed
by the dataset index, str(i), of [P, 5] float32 rows (x1, y1, x2, y2,
score) in original-image coordinates, score-ordered, at most
--max-per-img (the config's test_max_per_img by default); it is what
`python -m aod_meh_hua_torch.tools.train_detector --family fast_rcnn
--proposal-file out.npz` reads. One eval step per orientation
(engine/rpn_only.py RPNEvalStep). The checkpoint is the port's
(`rpn_final.ckpt` of train_detector) or the JAX package's flax-msgpack
one (engine/checkpoint.py). It keeps the JAX flags and adds nothing but
the card by default: --cpu asks for the CPU. --coco (ROADMAP Queue 1
item 14) and --dtype bfloat16 (item 16) raise NotImplementedError.

    python -m aod_meh_hua_torch.tools.gen_proposals --voc07 VOC2007 \\
        --checkpoint work/rpn_final.ckpt [--split ImageSets/Main/trainval.txt] \\
        [--out proposals.npz] [--mini] [--cpu]

In process: main(argv) writes the file and returns the dict it holds.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Dump RPN proposals to .npz")
    p.add_argument("--voc07", default=None)
    p.add_argument("--coco", default=None, help="COCO json annotation file (not ported)")
    p.add_argument("--coco-img-prefix", default=None, help="(not ported)")
    p.add_argument("--split", default=None, help="VOC image-id list (default trainval.txt)")
    p.add_argument("--checkpoint", required=True, help="trained RPN checkpoint")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-per-img", type=int, default=None,
                   help="cap on the proposals kept per image (default: the config's "
                        "test_max_per_img)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--out", default="proposals.npz")
    p.add_argument("--mini", action="store_true", help="tiny model (smoke)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    args = parse_args(argv)
    if args.coco or args.coco_img_prefix:
        raise NotImplementedError("--coco (COCO data) is not ported yet (ROADMAP Queue 1 item 14)")
    if args.dtype != "float32":
        raise NotImplementedError(f"--dtype {args.dtype}: the port's models run float32 "
                                  "(ROADMAP Queue 1 item 16)")
    if not args.voc07:
        raise SystemExit("one of --voc07 or --coco is required")
    from ..api import init_detector
    from ..data.loader import EvalLoader
    from ..data.pipeline import PipelineConfig
    from ..data.voc import VOCDataset
    from ..engine.two_stage import make_two_stage_eval_step
    from ..utils.config import RPNOnlyConfig, tiny_rpn_config
    from ..utils.device import pin_numerics, resolve_device

    pin_numerics()
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = tiny_rpn_config() if args.mini else RPNOnlyConfig()
    model = init_detector(cfg, checkpoint=args.checkpoint, seed=0, device=device)
    split = args.split or os.path.join(args.voc07, "ImageSets/Main/trainval.txt")
    if not os.path.isabs(split) and not os.path.exists(split):
        split = os.path.join(args.voc07, split)
    ds = VOCDataset(split, args.voc07, test_mode=True)
    pipe = (PipelineConfig(img_scale=(128, 60), canvas=cfg.canvas, device_normalize=True)
            if args.mini else PipelineConfig(canvas=cfg.canvas, device_normalize=True))
    cap = args.max_per_img or cfg.rpn.test_max_per_img
    steps, out = {}, {}
    for orientation, ebatch, idx in EvalLoader(ds, np.arange(len(ds)), pipe,
                                               batch_size=args.batch_size):
        if orientation not in steps:
            steps[orientation] = make_two_stage_eval_step(
                model, cfg.for_orientation(orientation), device)
        r = steps[orientation](ebatch)  # original coordinates: the step divides
        boxes, scores, valid = (t.cpu().numpy() for t in (r.boxes, r.scores, r.valid))
        for k, i in enumerate(idx):
            v = valid[k]
            out[str(int(i))] = np.concatenate([boxes[k][v][:cap], scores[k][v][:cap, None]],
                                              axis=1).astype(np.float32)
    np.savez_compressed(args.out, **out)
    n = [len(v) for v in out.values()]
    print(f"wrote {args.out}: {len(out)} images, proposals/img min {min(n)} "
          f"mean {np.mean(n):.1f} max {max(n)}")
    return out


if __name__ == "__main__":
    main()
