"""Generic (non-AL) detector training for the model-zoo families, on the
card: a step-decayed SGD epoch loop with the VOC mAP evaluated every
--eval-interval epochs.

Port of tools/train_detector.py of the JAX package (:27-667; the
reference's upstream mmdet tools/train.py over a VOC config) for the
families of utils/config.py ZOO_FAMILIES (Faster, Cascade, Dynamic and
Double-Head R-CNN, the Faster R-CNN variants, and the proposal families
`rpn`, `cascade_rpn`, `tridentnet`, `fast_rcnn` and `grid_rcnn`), each
with its train step (engine/two_stage.py TRAIN_STEPS, the JAX tool's
make_steps, :128-192). It keeps the JAX flags these families use
(--family, --voc07, --voc12, --work-dir, --epochs, --lr-steps,
--batch-size, --lr, --momentum, --weight-decay, --seed, --eval-interval,
--mini, --no-validate, the ranks' flags --num-devices, --distributed,
--coordinator, --num-processes and --process-id, and Fast R-CNN's
--proposal-file and --proposal-file-val) and adds --cpu, the port's way
to ask for the CPU; it runs on the card otherwise. The RPN-only and
Cascade RPN families are evaluated by class-agnostic AR@100
(engine/rpn_only.py proposal_recall, reported as "mAP" and "AR@100", JAX
:501-511); Fast R-CNN trains and evaluates on the proposals of an .npz
keyed by dataset index, [P, 5] in original-image coordinates
(tools/gen_proposals.py writes one; JAX :84-92, :526-538, :602-621). It writes
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

Several ranks, one device each, data parallel (JAX :326-334, :419-429,
:590-610): under a launcher (torchrun, slurm, mpi) or with --distributed
the ranks come from the environment or --coordinator/--num-processes/
--process-id, and --num-devices counts the global devices; --num-devices
N alone starts N local ranks (spawn), rank r on card r (or on the CPU
under --cpu), as tools/train_retinanet.py does. Every rank walks the same
global batches and takes its rows of each (parallel.shard_batch); the
step on N ranks is the one-process step on the global batch
(engine/two_stage.py _make_step), so --batch-size must divide by N. The
eval is sharded by rank (parallel.rank_indices) and gathered
(collect_objects) before the mAP. Only rank 0 writes the log, the
checkpoint, the meta file and metrics.json.

    python -m aod_meh_hua_torch.tools.train_detector --family cascade_rcnn \\
        --voc07 .../VOC2007 [--voc12 .../VOC2012] --work-dir work [--mini] [--cpu] \\
        [--num-devices N]
    torchrun --nproc-per-node N -m aod_meh_hua_torch.tools.train_detector ...

In process: main(argv) trains and returns the model, the config and the
per-epoch rows (in the process that starts local ranks: None, once every
rank is done).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from aod_meh_hua_torch.parallel.launch import launcher_requested, spawn_local_ranks
from aod_meh_hua_torch.tools.train_retinanet import spawns_local_ranks
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
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel over N devices, one process each; without a "
                         "launcher environment the CLI starts the N local ranks itself")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: init torch.distributed from the launcher's "
                         "environment or the flags below")
    ap.add_argument("--coordinator", default=None, help="coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--proposal-file", default=None,
                    help="fast_rcnn: .npz of per-image [P, 5] proposals keyed by dataset "
                         "index, original image coordinates (tools/gen_proposals.py)")
    ap.add_argument("--proposal-file-val", default=None,
                    help="fast_rcnn: proposals of the val split; defaults to --proposal-file")
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
        (args.teacher_ckpt, "--teacher-ckpt (LD)", "15"),
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


def fast_rcnn_proposals(proposals, ebatch, idx, num_slots: int):
    """The eval batch's proposals for Fast R-CNN: each image's [P, 5]
    original-coordinate rows of the .npz scaled to its canvas, the padding
    rows empty, in num_slots slots (JAX :612-619)."""
    from aod_meh_hua_torch.data.loader import _pad_proposals

    sf = np.asarray(ebatch.scale_factors)
    plist = [proposals[str(int(i))][:, :4] * sf[k] for k, i in enumerate(idx)]
    plist += [np.zeros((0, 4), np.float32)] * (len(sf) - len(plist))
    return _pad_proposals(plist, num_slots)


def evaluate(model, cfg, val, pipe, batch_size: int, device, process_id: int = 0,
             process_count: int = 1, work_dir: str = "", proposals=None) -> Dict:
    """The eval sweep of `val` (every image, both orientations) through the
    family's eval step: {"results": per image per class [k, 5] arrays in
    dataset order, "mAP": VOC07 11-point mAP at IoU 0.5}; for the RPN-only
    and Cascade RPN families "mAP" and "AR@100" are the class-agnostic
    proposal recall at 100 (proposal_recall). Fast R-CNN's step takes
    `proposals` (the .npz's arrays by dataset index). Across ranks each
    sweeps its rank_indices slice and the results are gathered
    (collect_objects, a collective: every rank calls it) into dataset
    order, from which every rank computes the one mAP."""
    from aod_meh_hua_torch.api import make_eval_step_for
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.engine.eval import detections_to_per_class
    from aod_meh_hua_torch.engine.rpn_only import make_fast_rcnn_eval_step, proposal_recall
    from aod_meh_hua_torch.parallel import collect_objects, rank_indices
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    fast = cfg.family == "fast_rcnn"
    steps, results, order = {}, [], []
    for orientation, ebatch, idx in EvalLoader(
            val, rank_indices(len(val), process_id, process_count), pipe,
            batch_size=batch_size):
        if orientation not in steps:
            make = make_fast_rcnn_eval_step if fast else make_eval_step_for
            steps[orientation] = make(model, cfg.for_orientation(orientation), device)
        if fast:
            dets = steps[orientation](ebatch, *fast_rcnn_proposals(proposals, ebatch, idx,
                                                                   cfg.num_proposals))
        else:
            dets = steps[orientation](ebatch)
        results.extend(detections_to_per_class(dets, cfg.num_fg_classes,
                                               np.asarray(ebatch.valid)))
        order.extend(idx.tolist())
    if process_count > 1:
        parts = collect_objects(work_dir, "eval", (results, order))
        results = [r for res, _ in parts for r in res]
        order = [i for _, o in parts for i in o]
    results = [r for _, r in sorted(zip(order, results), key=lambda p: p[0])]
    anns = [val.get_ann_info(i) for i in range(len(val))]
    if cfg.family in ("rpn", "cascade_rpn"):
        boxes = [r[0][:, :4] for r in results]
        ar = proposal_recall(boxes, [np.ones(len(b), bool) for b in boxes],
                             [a["bboxes"] for a in anns])
        return {"results": results, "mAP": ar, "AR@100": ar}
    return {"results": results,
            "mAP": eval_map(results, anns, iou_thr=0.5, mode="11points")["mAP"]}


def join_ranks(args, device: str):
    """(process_id, process_count, device, mesh): this process's place
    among the ranks, its one device and the data mesh (None for one
    process), as JAX :326-334 and :419-429 take them; --batch-size must
    divide by the ranks."""
    from aod_meh_hua_torch.parallel import init_distributed, make_mesh
    from aod_meh_hua_torch.parallel.launch import rank_device

    if not launcher_requested(args):
        return 0, 1, resolve_device(device), None
    info = init_distributed(args.coordinator, args.num_processes, args.process_id,
                            device=device)
    proc_id, proc_count = info["process_index"], info["process_count"]
    num_devices = args.num_devices or info["global_devices"]
    print(f"distributed: process {proc_id}/{proc_count}, {info['local_devices']} local "
          "devices", flush=True)
    if num_devices != proc_count:
        raise ValueError(f"--num-devices {num_devices}: the port runs one device per process "
                         f"and {proc_count} are running")
    if args.batch_size % num_devices:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--num-devices {num_devices}")
    dev = resolve_device(rank_device(device))
    mesh = make_mesh(num_devices, device_type=dev.type) if num_devices > 1 else None
    return proc_id, proc_count, dev, mesh


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    refuse_unported(args)
    if not args.family:
        raise SystemExit("--family is required")
    if not args.voc07:
        raise SystemExit("--voc07 is required")
    if spawns_local_ranks(args):
        if args.batch_size % args.num_devices:
            raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                             f"--num-devices {args.num_devices}")
        return spawn_local_ranks(main, sys.argv[1:] if argv is None else argv,
                                 args.num_devices, args.cpu)
    pin_numerics()
    from aod_meh_hua_torch.api import init_detector
    from aod_meh_hua_torch.data.loader import TrainLoader
    from aod_meh_hua_torch.data.voc import VOC_CLASSES, ConcatVOC, VOCDataset
    from aod_meh_hua_torch.engine.checkpoint import save_checkpoint
    from aod_meh_hua_torch.engine.train import create_train_state, set_learning_rate
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.parallel import gather_to_host, replicate, shard_batch
    from aod_meh_hua_torch.utils.config import TrainConfig

    proposals = proposals_val = None
    if args.family == "fast_rcnn":
        if not args.proposal_file:
            raise SystemExit("--family fast_rcnn requires --proposal-file "
                             "(generate with tools/gen_proposals.py)")
        # read whole: the loader's decode threads index it together
        proposals = dict(np.load(args.proposal_file))
        proposals_val = (dict(np.load(args.proposal_file_val)) if args.proposal_file_val
                         else proposals)
    proc_id, proc_count, device, mesh = join_ranks(args, "cpu" if args.cpu else "cuda")
    is_main = proc_id == 0
    os.makedirs(args.work_dir, exist_ok=True)
    full_cls, tiny_fn = ZOO_FAMILIES[args.family]
    cfg = tiny_fn() if args.mini else full_cls()
    tcfg = TrainConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                       batch_size=args.batch_size, seed=args.seed)
    model = init_detector(cfg, seed=args.seed, device=device)
    if mesh is not None:
        replicate(model, mesh)
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
    # every rank walks the same global batches, in the same orientations
    loader = TrainLoader(train_set, np.arange(len(train_set)), cfg, pipe,
                         batch_size=args.batch_size, seed=args.seed,
                         proposal_source=(None if proposals is None
                                          else lambda i: proposals[str(i)][:, :4]))
    steps = {}
    # every rank draws the global batch's uniforms from the same stream
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
                    model, cfg.for_orientation(orientation), optimizer, device=device,
                    mesh=mesh)
            rows = batch if mesh is None else shard_batch(batch, mesh)
            losses.append(steps[orientation](rows, generator)["loss"])
        mean_loss = float(np.mean([float(v) for v in losses]))
        print(f"epoch {epoch}: {len(losses)} iters, mean loss {mean_loss:.4f}, "
              f"lr {lr:g}, {time.time() - t0:.1f}s", flush=True)
        row = {"epoch": epoch, "loss": mean_loss, "lr": lr}
        if val is not None and (epoch + 1) % args.eval_interval == 0:
            ev = evaluate(model, cfg, val, pipe, max(args.batch_size, 4), device, proc_id,
                          proc_count, args.work_dir, proposals_val)
            row.update({k: ev[k] for k in ("mAP", "AR@100") if k in ev})
            print(f"epoch {epoch}: mAP {row['mAP']:.4f}", flush=True)
        metrics.append(row)
        if is_main:
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    state = gather_to_host(model)  # collective when sharded: every rank calls it
    if is_main:
        ckpt = os.path.join(args.work_dir, f"{args.family}_final.ckpt")
        save_checkpoint(ckpt, state)
        with open(os.path.join(args.work_dir, f"{args.family}_meta.json"), "w") as f:
            json.dump({"family": args.family, "epochs": args.epochs, "dtype": args.dtype}, f)
        with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
        print(f"saved {ckpt}")
    return model, cfg, metrics


if __name__ == "__main__":
    main()
