"""AL experiment driver for MEH-RetinaNet on PASCAL VOC, on the card.

Mirrors tools/train_retinanet.py:24-190 of the JAX package flag for flag
(itself the reference's tools/train_RetinaNet.py:49-74 CLI): --voc07/
--voc12 data roots, --work-dir, the HUA pool and aggregation flags, the
zeroRate/score_thr/iou_thr knobs, the batch sizes, --cycles, the cycle,
load and mid-cycle resume flags, --no-validate, --canvas-cache-dir, the
deep-ensemble baseline (--baseline ensemble, --ensemble-size), --config
(a reference-style config file, utils/config.py load_reference_config:
its model, schedule and AL settings, and its data roots when neither
--voc07 nor --voc12 is given) and the --mini smoke mode. It runs on the
card; --cpu runs it on the CPU.
main pins the numerics process-wide (utils/device.py pin_numerics): no
TF32, deterministic cuDNN.
The flags of modes the port does not have yet raise NotImplementedError
with their ROADMAP item.

Several ranks, one device each (al/loop.py ALDriver): under a launcher
(torchrun, slurm, mpi) or with --distributed the ranks come from the
environment or --coordinator/--num-processes/--process-id, and
--num-devices counts the global devices; --num-devices N alone starts N
local ranks (spawn), rank r on card r (or on the CPU under --cpu).
--fsdp F shards the model over F of them (ZeRO-3).

    python -m aod_meh_hua_torch.tools.train_retinanet --voc07 .../VOC2007 \
        --work-dir work_dirs/retinanet_meh [--mini] [--cpu] [--num-devices N [--fsdp F]]
    torchrun --nproc-per-node N -m aod_meh_hua_torch.tools.train_retinanet ...

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

from aod_meh_hua_torch.parallel.launch import launcher_requested, spawn_local_ranks
from aod_meh_hua_torch.utils.device import pin_numerics


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train MEH-RetinaNet with active learning")
    p.add_argument("--config", default=None,
                   help="reference-style config file (utils/config.py load_reference_config)")
    p.add_argument("--work-dir", default="work_dirs/retinanet_meh")
    p.add_argument("--voc07", default=None, help="path to .../VOC2007")
    p.add_argument("--voc12", default=None, help="path to .../VOC2012")
    p.add_argument("--uncertainty", default=None,
                   help="pool: Random | Entropy_ALL | Entropy_NMS | Entropy_NoNMS")
    p.add_argument("--Unc-type", dest="unc_type", default=None,
                   help="SACA | SSCS | SACS | SSCA (2-level agg shorthand)")
    p.add_argument("--agg", default=None, help="full HUA agg spec, e.g. objectSum_scaleMax_classSum")
    p.add_argument("--agg-order", default=None, choices=["class_first", "scale_first"],
                   help="HUA aggregation-order ablation")
    p.add_argument("--cls-weight", action="store_true",
                   help="clsW: weight image scores by distinct-class count")
    p.add_argument("--baseline", default=None, choices=["ensemble"],
                   help="replace HUA scoring with a baseline: 'ensemble' trains N seeds "
                        "per cycle and scores with the deep-ensemble sigmoid MI "
                        "(CalEnsembleUnc.py:86-181)")
    p.add_argument("--ensemble-size", type=int, default=3,
                   help="members for --baseline ensemble (the reference uses 3)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--resume-cycle", type=int, default=-1)
    p.add_argument("--load-cycle", type=int, default=-1)
    p.add_argument("--resume-from", default=None,
                   help="mid-cycle resume from a train_state snapshot dir; pass 'auto' "
                        "to use <work-dir>/model_save")
    p.add_argument("--ckpt-interval", type=int, default=None,
                   help="train-state snapshot every N inner epochs (0=off)")
    p.add_argument("--zero-rate", type=float, default=0.15)
    p.add_argument("--score-thr", type=float, default=0.3, help="HUA object score threshold")
    p.add_argument("--iou-thr", type=float, default=0.5, help="HUA membership IoU threshold")
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=None, help="train batch")
    p.add_argument("--score-batch-size", type=int, default=None,
                   help="pool-scoring / eval batch size (default 64)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="ZeRO-3 parameter-sharding degree: folds the device "
                        "mesh to (num_devices/fsdp, fsdp) = (data, fsdp) and "
                        "shards params + optimizer state over 'fsdp'")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel over N devices, one process each (the "
                        "reference's DDP mode, train.py:75-85); without a launcher "
                        "environment the CLI starts the N local ranks itself")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--int8-scoring", action="store_true", help="int8 pool scoring (not ported)")
    p.add_argument("--cycles", type=int, default=None, help="override number of AL cycles")
    p.add_argument("--pretrained", default=None,
                   help="torchvision resnet50 state_dict (.pth) for the backbone")
    p.add_argument("--mini", action="store_true",
                   help="smoke-test mode: shrunken model/canvas + 1-epoch schedule")
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


STR2UNC = {"SACA": "scaleAvg_classAvg", "SSCS": "scaleSum_classSum",
           "SACS": "scaleAvg_classSum", "SSCA": "scaleSum_classAvg"}


def refuse_unported(args) -> None:
    """Raise for a flag of a mode the port does not have yet (both CLIs;
    a flag one of them lacks counts as not given)."""
    get = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    refused = [
        (get("int8_scoring", False), "--int8-scoring", "16"),
        (args.dtype != "float32", f"--dtype {args.dtype}", "16"),
    ]
    for given, flag, item in refused:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def hua_from_args(hua, args):
    """The HUA config with the CLI's pool and aggregation flags applied."""
    if args.uncertainty:
        hua = dataclasses.replace(hua, pool=args.uncertainty)
    if args.unc_type:
        hua = dataclasses.replace(hua, agg=STR2UNC[args.unc_type])
    if args.agg:
        hua = dataclasses.replace(hua, agg=args.agg)
    if args.agg_order:
        hua = dataclasses.replace(hua, agg_order=args.agg_order)
    if args.cls_weight:
        hua = dataclasses.replace(hua, cls_weight=True)
    return dataclasses.replace(hua, obj_score_thr=args.score_thr, memb_iou_thr=args.iou_thr)


def attach_pretrained_backbone(model, path: str) -> None:
    """Load a torchvision ResNet-50 state_dict into model.backbone, whose
    parameter names are torchvision's (the counterpart of the JAX
    package's models/pretrained.py attach_pretrained_backbone). The fc
    layer and BN's num_batches_tracked are dropped; every backbone
    tensor must be present."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    want = model.backbone.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks backbone tensors: {missing[:5]}")
    model.backbone.load_state_dict({k: sd[k] for k in want})


def driver_dist_kwargs(args) -> dict:
    """The ALDriver's distributed arguments from either train CLI's flags."""
    return dict(num_devices=args.num_devices, distributed=launcher_requested(args),
                coordinator=args.coordinator, num_processes=args.num_processes,
                process_id=args.process_id, fsdp=args.fsdp)


def spawns_local_ranks(args) -> bool:
    """--num-devices N > 1 with no launcher: the CLI starts the N ranks."""
    return bool(args.num_devices and args.num_devices > 1 and not launcher_requested(args))


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    refuse_unported(args)
    if spawns_local_ranks(args):
        return spawn_local_ranks(main, sys.argv[1:] if argv is None else argv,
                                 args.num_devices, args.cpu)
    pin_numerics()
    from aod_meh_hua_torch.al.loop import ALDriver, ALPaths
    from aod_meh_hua_torch.data.pipeline import PipelineConfig
    from aod_meh_hua_torch.utils.config import (
        ALConfig, RetinaNetConfig, TrainConfig, load_reference_config, reference_data_roots,
        tiny_test_config)

    if args.config:
        model_cfg, train_cfg, al_cfg, ns = load_reference_config(args.config)
        if not args.voc07 and not args.voc12:
            # all or nothing: an explicit --voc07 must not pick up the
            # config's (likely machine-specific) VOC2012 data_root
            args.voc07, args.voc12 = reference_data_roots(ns)
    else:
        model_cfg, train_cfg, al_cfg = RetinaNetConfig(), TrainConfig(), ALConfig()
    if not args.voc07:
        raise SystemExit("--voc07 is required (no data_root in the config)")
    pipeline = None
    if args.mini:
        model_cfg = tiny_test_config()
        train_cfg = dataclasses.replace(train_cfg, outer_epoch=1, epoch_ratio=(1,))
        al_cfg = dataclasses.replace(al_cfg, cycles=(0, 1), x_l_0_size=4,
                                     x_s_size=2, x_l_repeat=1, score_batch_size=8)
        pipeline = PipelineConfig(img_scale=(250, 120), canvas=model_cfg.canvas,
                                  device_normalize=True)

    model_cfg = dataclasses.replace(model_cfg, hua=hua_from_args(model_cfg.hua, args),
                                    compute_dtype=args.dtype)
    train_cfg = dataclasses.replace(
        train_cfg, seed=args.seed,
        **({"batch_size": args.batch_size} if args.batch_size else {}),
        **({"ckpt_interval": args.ckpt_interval} if args.ckpt_interval is not None else {}),
    )
    al_cfg = dataclasses.replace(
        al_cfg, zero_rate=args.zero_rate,
        **({"cycles": tuple(range(args.cycles))} if args.cycles else {}),
        **({"score_batch_size": args.score_batch_size} if args.score_batch_size else {}),
    )

    np.random.seed(args.seed)
    paths = ALPaths(voc07=args.voc07, voc12=args.voc12, work_dir=args.work_dir)
    driver = ALDriver(model_cfg, train_cfg, al_cfg, paths, pipeline=pipeline,
                      validate=not args.no_validate,
                      cache_dir=None if args.canvas_cache_dir == "none" else args.canvas_cache_dir,
                      baseline=args.baseline, ensemble_size=args.ensemble_size,
                      device="cpu" if args.cpu else "cuda", **driver_dist_kwargs(args))
    if args.pretrained:
        if not os.path.exists(args.pretrained):
            raise FileNotFoundError(args.pretrained)
        driver.pretrained_loader = lambda model: attach_pretrained_backbone(
            model, args.pretrained)
    resume_from = args.resume_from
    if resume_from == "auto":
        resume_from = paths.save_dir
    driver.run(resume_cycle=args.resume_cycle, load_cycle=args.load_cycle,
               resume_from=resume_from)
    return driver


if __name__ == "__main__":
    main()
