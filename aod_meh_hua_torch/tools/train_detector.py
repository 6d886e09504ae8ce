"""Generic (non-AL) detector training for the model-zoo families, on the
card: a step-decayed SGD epoch loop with the VOC mAP evaluated every
--eval-interval epochs.

Port of tools/train_detector.py of the JAX package (:27-667; the
reference's upstream mmdet tools/train.py over a VOC config) for the
families of utils/config.py ZOO_FAMILIES: `faster_rcnn`, `cascade_rcnn`,
`dynamic_rcnn` and `double_head_rcnn`, each with its own train step
(engine/two_stage.py TRAIN_STEPS, the JAX tool's make_steps). It keeps
the JAX flags this family uses (--family, --voc07, --voc12, --work-dir,
--epochs, --lr-steps, --batch-size, --lr, --momentum, --weight-decay,
--seed, --eval-interval, --mini, --no-validate) and adds --cpu, the
port's way to ask for the CPU; it runs on the card otherwise. It writes
the JAX tool's files: one `train_log.jsonl` row per epoch ({"epoch",
"loss", "lr"} and "mAP" after an eval), `metrics.json`,
`{family}_final.ckpt` (a torch state_dict, which api.init_detector and
engine/checkpoint.py load, as they load the JAX tool's msgpack file;
Dynamic R-CNN's statistics are in it) and
`{family}_meta.json`. main pins the numerics process-wide
(utils/device.py pin_numerics). The flags of other data, families and
modes raise NotImplementedError with their ROADMAP item.

The samplers draw from a torch.Generator on the device seeded by --seed
(the JAX tool splits a PRNGKey per step: the draws differ). Each
orientation trains with its own step, whose anchor table is that
canvas's; the JAX tool builds one step on the landscape canvas and feeds
it the portrait batches too.

    python -m aod_meh_hua_torch.tools.train_detector --family cascade_rcnn \\
        --voc07 .../VOC2007 [--voc12 .../VOC2012] --work-dir work [--mini] [--cpu]

In process: main(argv) trains and returns the model, the config and the
per-epoch rows.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from aod_meh_hua_torch.utils.config import ZOO_FAMILIES
from aod_meh_hua_torch.utils.device import pin_numerics, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="Train a model-zoo detector on VOC")
    ap.add_argument("--family", default=None, choices=sorted(ZOO_FAMILIES))
    ap.add_argument("--reference-config", default=None,
                    help="an upstream reference zoo config file (not ported)")
    ap.add_argument("--voc07", default=None, help="VOC2007 root")
    ap.add_argument("--voc12", default=None, help="optional VOC2012 root")
    ap.add_argument("--coco-train", default=None, help="COCO instances JSON (not ported)")
    ap.add_argument("--coco-val", default=None, help="(not ported)")
    ap.add_argument("--coco-img-prefix", default=None, help="(not ported)")
    ap.add_argument("--coco-img-prefix-val", default=None, help="(not ported)")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr-steps", type=int, nargs="*", default=[8, 11],
                    help="epochs at which lr drops x0.1 (1x schedule)")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.0025,
                    help="reference per-GPU lr for batch 2")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--eval-interval", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--mini", action="store_true", help="tiny model smoke mode")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--num-devices", type=int, default=None, help="(not ported)")
    ap.add_argument("--distributed", action="store_true", help="(not ported)")
    ap.add_argument("--coordinator", default=None, help="(not ported)")
    ap.add_argument("--num-processes", type=int, default=None, help="(not ported)")
    ap.add_argument("--process-id", type=int, default=None, help="(not ported)")
    ap.add_argument("--proposal-file", default=None, help="fast_rcnn (not ported)")
    ap.add_argument("--proposal-file-val", default=None, help="fast_rcnn (not ported)")
    ap.add_argument("--oversample-thr", type=float, default=None, help="(not ported)")
    ap.add_argument("--dataset-type", default="coco", choices=["coco", "lvis"],
                    help="the JSON flavour of --coco-* (not ported)")
    ap.add_argument("--instaboost", action="store_true", help="(not ported)")
    ap.add_argument("--albu", action="store_true", help="(not ported)")
    ap.add_argument("--teacher-ckpt", default=None, help="ld (not ported)")
    return ap.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for a flag of data, a family or a mode the port lacks."""
    refused = [
        (args.reference_config, "--reference-config (reference zoo configs)", "13"),
        (args.coco_train or args.coco_val or args.coco_img_prefix
         or args.coco_img_prefix_val, "--coco-* (COCO and LVIS data)", "14"),
        (args.dataset_type != "coco", "--dataset-type lvis", "14"),
        (args.oversample_thr, "--oversample-thr (ClassBalancedDataset)", "14"),
        (args.instaboost, "--instaboost (data/instaboost.py)", "14"),
        (args.albu, "--albu (data/albu.py)", "14"),
        (args.proposal_file or args.proposal_file_val, "--proposal-file (Fast R-CNN)", "15"),
        (args.teacher_ckpt, "--teacher-ckpt (LD)", "15"),
        ((args.num_devices or 1) > 1 or args.distributed or args.coordinator
         or args.num_processes or args.process_id is not None,
         "the trainer across ranks (--num-devices, --distributed)", "15"),
        (args.dtype != "float32", f"--dtype {args.dtype}", "16"),
    ]
    for given, flag, item in refused:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def pipeline_for(cfg, mini: bool):
    from aod_meh_hua_torch.data.pipeline import PipelineConfig

    if mini:  # the tiny canvas is (64, 128): a keep-ratio scale that always fits
        return PipelineConfig(img_scale=(128, 60), canvas=cfg.canvas, mean=cfg.img_mean,
                              std=cfg.img_std, device_normalize=True)
    return PipelineConfig(canvas=cfg.canvas, mean=cfg.img_mean, std=cfg.img_std,
                          device_normalize=True)


def evaluate(model, cfg, val, pipe, batch_size: int, device) -> Dict:
    """The eval sweep of `val` (every image, both orientations) through the
    family's eval step: {"results": per image per class [k, 5] arrays in
    dataset order, "mAP": VOC07 11-point mAP at IoU 0.5}."""
    from aod_meh_hua_torch.api import make_eval_step_for
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.engine.eval import detections_to_per_class
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    steps, results, order = {}, [], []
    for orientation, ebatch, idx in EvalLoader(val, np.arange(len(val)), pipe,
                                               batch_size=batch_size):
        if orientation not in steps:
            steps[orientation] = make_eval_step_for(model, cfg.for_orientation(orientation),
                                                    device)
        dets = steps[orientation](ebatch)
        results.extend(detections_to_per_class(dets, cfg.num_classes,
                                               np.asarray(ebatch.valid)))
        order.extend(idx.tolist())
    results = [r for _, r in sorted(zip(order, results), key=lambda p: p[0])]
    anns = [val.get_ann_info(i) for i in range(len(val))]
    return {"results": results,
            "mAP": eval_map(results, anns, iou_thr=0.5, mode="11points")["mAP"]}


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    refuse_unported(args)
    if not args.family:
        raise SystemExit("--family is required")
    if not args.voc07:
        raise SystemExit("--voc07 is required")
    pin_numerics()
    from aod_meh_hua_torch.api import init_detector
    from aod_meh_hua_torch.data.loader import TrainLoader
    from aod_meh_hua_torch.data.voc import VOC_CLASSES, ConcatVOC, VOCDataset
    from aod_meh_hua_torch.engine.checkpoint import save_checkpoint
    from aod_meh_hua_torch.engine.train import create_train_state, set_learning_rate
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.utils.config import TrainConfig

    device = resolve_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.work_dir, exist_ok=True)
    full_cls, tiny_fn = ZOO_FAMILIES[args.family]
    cfg = tiny_fn() if args.mini else full_cls()
    tcfg = TrainConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                       batch_size=args.batch_size, seed=args.seed)
    model = init_detector(cfg, seed=args.seed, device=device)
    optimizer = create_train_state(model, tcfg, frozen_stages=cfg.frozen_stages)

    # the --mini heads have fewer than 20 classes: the matching class subset
    classes = VOC_CLASSES[:cfg.num_classes]
    datasets = [VOCDataset(os.path.join(args.voc07, "ImageSets/Main/trainval.txt"),
                           args.voc07, classes=classes)]
    if args.voc12:
        datasets.append(VOCDataset(os.path.join(args.voc12, "ImageSets/Main/trainval.txt"),
                                   args.voc12, classes=classes))
    train_set = ConcatVOC(datasets)
    val = None
    if not args.no_validate:
        test_txt = os.path.join(args.voc07, "ImageSets/Main/test.txt")
        if os.path.exists(test_txt):
            val = VOCDataset(test_txt, args.voc07, test_mode=True, classes=classes)
    pipe = pipeline_for(cfg, args.mini)
    loader = TrainLoader(train_set, np.arange(len(train_set)), cfg, pipe,
                         batch_size=args.batch_size, seed=args.seed)
    steps = {}
    generator = torch.Generator(device=device).manual_seed(args.seed)
    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    metrics = []
    for epoch in range(args.epochs):
        lr = args.lr * (0.1 ** sum(epoch >= s for s in args.lr_steps))
        set_learning_rate(optimizer, lr)
        t0 = time.time()
        losses = []
        for orientation, batch in loader:
            if orientation not in steps:
                steps[orientation] = make_two_stage_train_step(
                    model, cfg.for_orientation(orientation), optimizer, device=device)
            losses.append(steps[orientation](batch, generator)["loss"])
        mean_loss = float(np.mean([float(v) for v in losses]))
        print(f"epoch {epoch}: {len(losses)} iters, mean loss {mean_loss:.4f}, "
              f"lr {lr:g}, {time.time() - t0:.1f}s", flush=True)
        row = {"epoch": epoch, "loss": mean_loss, "lr": lr}
        if val is not None and (epoch + 1) % args.eval_interval == 0:
            row["mAP"] = evaluate(model, cfg, val, pipe, max(args.batch_size, 4),
                                  device)["mAP"]
            print(f"epoch {epoch}: mAP {row['mAP']:.4f}", flush=True)
        metrics.append(row)
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")
    ckpt = os.path.join(args.work_dir, f"{args.family}_final.ckpt")
    save_checkpoint(ckpt, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    with open(os.path.join(args.work_dir, f"{args.family}_meta.json"), "w") as f:
        json.dump({"family": args.family, "epochs": args.epochs, "dtype": args.dtype}, f)
    with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(f"saved {ckpt}")
    return model, cfg, metrics


if __name__ == "__main__":
    main()
