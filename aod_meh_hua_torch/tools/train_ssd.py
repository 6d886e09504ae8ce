"""AL experiment driver for MEH-SSD300 on PASCAL VOC, on the card.

Mirrors tools/train_ssd.py:19-188 of the JAX package flag for flag
(itself the reference's tools/train_SSD.py CLI): the same AL cycle loop as
the RetinaNet driver with the SSD schedule (Config_SSD.py:125-171):
batch 8, outer_epoch 2, epoch_ratio (5, 1), the lr step at inner epoch
1, a 500-iteration linear warmup from ratio 1e-3, and 11 cycles of
1000-image acquisitions with X_L repeated 16 times; --mini shrinks the
VGG to width 0.125 and the schedule to one epoch per run and two cycles;
--config reads a reference-style SSD config file instead (its model,
schedule and AL settings, and its data roots when neither --voc07 nor
--voc12 is given). It runs on the card; --cpu runs it on the CPU. main pins the numerics
process-wide (utils/device.py pin_numerics): no TF32, deterministic
cuDNN. The flags of modes the port does not have yet raise
NotImplementedError with their ROADMAP item. Several ranks as in
tools/train_retinanet.py (a launcher, --distributed, or --num-devices N
alone, which starts the local ranks; --fsdp).

    python -m aod_meh_hua_torch.tools.train_ssd --voc07 .../VOC2007 \
        --work-dir work_dirs/ssd_meh [--mini] [--cpu] [--num-devices N [--fsdp F]]

In process: main(argv) runs the experiment and returns the ALDriver (in
the process that starts local ranks: None, once every rank is done).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from aod_meh_hua_torch.models.vgg import MMCV_VGG16_CONV_IDX
from aod_meh_hua_torch.parallel.launch import spawn_local_ranks
from aod_meh_hua_torch.tools.train_retinanet import (driver_dist_kwargs, hua_from_args,
                                                     refuse_unported, spawns_local_ranks)
from aod_meh_hua_torch.utils.device import pin_numerics


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train MEH-SSD300 with active learning")
    p.add_argument("--config", default=None,
                   help="reference-style SSD config file (utils/config.py "
                        "load_reference_config)")
    p.add_argument("--work-dir", default="work_dirs/ssd_meh")
    p.add_argument("--voc07", default=None, help="path to .../VOC2007")
    p.add_argument("--voc12", default=None, help="path to .../VOC2012")
    p.add_argument("--uncertainty", default=None,
                   help="pool: Random | Entropy_ALL | Entropy_NMS | Entropy_NoNMS")
    p.add_argument("--Unc-type", dest="unc_type", default=None,
                   help="SACA | SSCS | SACS | SSCA (2-level agg shorthand)")
    p.add_argument("--agg", default=None, help="full HUA agg spec")
    p.add_argument("--agg-order", default=None, choices=["class_first", "scale_first"],
                   help="HUA aggregation-order ablation")
    p.add_argument("--cls-weight", action="store_true",
                   help="clsW: weight image scores by distinct-class count")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--resume-cycle", type=int, default=-1)
    p.add_argument("--load-cycle", type=int, default=-1)
    p.add_argument("--resume-from", default=None,
                   help="mid-cycle resume from a train_state snapshot dir; pass 'auto' "
                        "to use <work-dir>/model_save")
    p.add_argument("--zero-rate", type=float, default=0.15)
    p.add_argument("--score-thr", type=float, default=0.3, help="HUA object score threshold")
    p.add_argument("--iou-thr", type=float, default=0.5, help="HUA membership IoU threshold")
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8, help="train batch")
    p.add_argument("--score-batch-size", type=int, default=None,
                   help="pool-scoring / eval batch size (default 64)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel over N devices, one process each (the "
                        "reference's DDP mode, train.py:75-85); without a launcher "
                        "environment the CLI starts the N local ranks itself")
    p.add_argument("--fsdp", type=int, default=1,
                   help="ZeRO-3 parameter-sharding degree: folds the device "
                        "mesh to (num_devices/fsdp, fsdp) = (data, fsdp) and "
                        "shards params + optimizer state over 'fsdp'")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--cycles", type=int, default=None, help="override number of AL cycles")
    p.add_argument("--pretrained", default=None, help="mmcv vgg16_caffe .pth")
    p.add_argument("--mini", action="store_true",
                   help="smoke mode: thin VGG + 1-epoch schedule")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: init torch.distributed, train over the "
                        "global mesh, rank-shard the pool/eval sweeps "
                        "(the reference's --launcher DDP mode)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (manual launches; "
                        "read from the launcher's environment otherwise)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--canvas-cache-dir", default="auto",
                   help="decoded-canvas cache root ('auto' = <work_dir>/canvas_cache, "
                        "'none' = off)")
    return p.parse_args(argv)


def attach_pretrained_vgg(model, path: str) -> None:
    """Load an mmcv VGG16 state_dict (features.N, optionally under
    'backbone.' or in mmcv's {"state_dict"} wrapper) into the model's
    backbone, whose names are mmcv's; every conv, conv6 and conv7
    included, must be present (the JAX package's convert_mmcv_vgg16)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()}
    want = [f"features.{i}.{leaf}" for i in MMCV_VGG16_CONV_IDX for leaf in ("weight", "bias")]
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks VGG16 tensors: {missing[:5]}")
    model.backbone.load_state_dict({k: sd[k] for k in want})


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    refuse_unported(args)
    if spawns_local_ranks(args):
        return spawn_local_ranks(main, sys.argv[1:] if argv is None else argv,
                                 args.num_devices, args.cpu)
    pin_numerics()
    from aod_meh_hua_torch.al.loop import ALDriver, ALPaths
    from aod_meh_hua_torch.utils.config import (
        ALConfig, SSDConfig, TrainConfig, load_reference_config, reference_data_roots)

    if args.config:
        model_cfg, train_cfg, al_cfg, ns = load_reference_config(args.config)
        if model_cfg.family != "ssd":
            raise SystemExit(f"{args.config} is not an SSD config (model.type dispatch)")
        if not args.voc07 and not args.voc12:
            args.voc07, args.voc12 = reference_data_roots(ns)
        model_cfg = dataclasses.replace(model_cfg, compute_dtype=args.dtype)
        train_cfg = dataclasses.replace(train_cfg, seed=args.seed, batch_size=args.batch_size)
        al_cfg = dataclasses.replace(al_cfg, zero_rate=args.zero_rate)
    else:
        model_cfg = SSDConfig(compute_dtype=args.dtype)
        # SSD schedule (Config_SSD.py:125-171)
        train_cfg = TrainConfig(batch_size=args.batch_size, seed=args.seed, outer_epoch=2,
                                epoch_ratio=(5, 1), lr_step_epoch=1, warmup_iters=500,
                                warmup_ratio=1e-3)
        al_cfg = ALConfig(cycles=tuple(range(11)), x_l_0_size=1000, x_s_size=1000,
                          x_l_repeat=16, x_u_repeat=16, zero_rate=args.zero_rate)
    if not args.voc07:
        raise SystemExit("--voc07 is required (no data_root in the config)")
    if args.mini:
        model_cfg = dataclasses.replace(model_cfg, width_mult=0.125, max_gt=8)
        train_cfg = dataclasses.replace(train_cfg, outer_epoch=1, epoch_ratio=(1,),
                                        warmup_iters=0)
        al_cfg = dataclasses.replace(al_cfg, cycles=(0, 1), x_l_0_size=4, x_s_size=2,
                                     x_l_repeat=1, score_batch_size=8)
    model_cfg = dataclasses.replace(model_cfg, hua=hua_from_args(model_cfg.hua, args))
    if args.cycles:
        al_cfg = dataclasses.replace(al_cfg, cycles=tuple(range(args.cycles)))
    if args.score_batch_size:
        al_cfg = dataclasses.replace(al_cfg, score_batch_size=args.score_batch_size)

    np.random.seed(args.seed)
    paths = ALPaths(voc07=args.voc07, voc12=args.voc12, work_dir=args.work_dir)
    driver = ALDriver(model_cfg, train_cfg, al_cfg, paths, validate=not args.no_validate,
                      name="ssd_meh",
                      cache_dir=None if args.canvas_cache_dir == "none" else args.canvas_cache_dir,
                      device="cpu" if args.cpu else "cuda", **driver_dist_kwargs(args))
    if args.pretrained:
        if not os.path.exists(args.pretrained):
            raise FileNotFoundError(args.pretrained)
        driver.pretrained_loader = lambda model: attach_pretrained_vgg(model, args.pretrained)
    resume_from = args.resume_from
    if resume_from == "auto":
        resume_from = paths.save_dir
    driver.run(resume_cycle=args.resume_cycle, load_cycle=args.load_cycle,
               resume_from=resume_from)
    return driver


if __name__ == "__main__":
    main()
