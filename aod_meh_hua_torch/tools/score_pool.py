"""Standalone pool scoring: score a VOC pool with any acquisition method,
on the card.

Mirrors tools/score_pool.py:23-170 of the JAX package flag for flag (the
reference's manual scorers calculate_uncertainty, Ensemble_uncertainty
and MCDropout_uncertainty, mmdet/apis/test.py:65, CalEnsembleUnc.py:86,
CalMCDropoutUnc.py:86, as one CLI): load the checkpoint(s), sweep the
pool, write the uncertainty array and print the same two lines. Methods:
hua (the HUA pools of --uncertainty), random, numobj, ensemble (2+
--checkpoint files) and mcdropout (--passes). The checkpoints may be the
port's, the JAX package's flax-msgpack files or the reference's mmdet
.pth. It runs on the card; --cpu runs it on the CPU. main pins the
numerics process-wide (utils/device.py pin_numerics).

--dtype defaults to float32 here, where the JAX CLI's default is
bfloat16: the port's models run float32, and --dtype bfloat16 and --int8
raise NotImplementedError with their ROADMAP item.

--num-devices N shards the sweep over N ranks, one device each: under a
launcher (torchrun, slurm, mpi) the ranks come from its environment,
else the CLI starts N local ranks (spawn). Each rank sweeps its
parallel.rank_indices slice at --batch-size / N (the batch is global, as
in JAX), the scores meet in parallel.allgather_sum, and rank 0 writes
--out. MC dropout draws rank r's masks from seed + r, so its scores
depend on the rank count.

    python -m aod_meh_hua_torch.tools.score_pool --voc07 .../VOC2007 \\
        --checkpoint c.ckpt --out unc.npy [--cpu] [--num-devices N]
    ... --method ensemble --checkpoint a.ckpt b.ckpt c.ckpt
    ... --method mcdropout --passes 25

In process: main(argv) returns the scores, [N] float64 in pool order (in
the process that starts local ranks: None, once every rank is done).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from aod_meh_hua_torch.parallel.launch import detect_launch_env, spawn_local_ranks
from aod_meh_hua_torch.utils.device import pin_numerics


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Score an unlabeled pool")
    p.add_argument("--voc07", required=True)
    p.add_argument("--voc12", default=None)
    p.add_argument("--split", default=None, help="image-id list (default trainval)")
    p.add_argument("--family", default="retinanet", choices=["retinanet", "ssd"])
    p.add_argument("--checkpoint", nargs="+", default=None,
                   help="model checkpoint(s); 2+ for ensemble")
    p.add_argument("--method", default="hua",
                   choices=["hua", "random", "ensemble", "mcdropout", "numobj"])
    p.add_argument("--uncertainty", default="Entropy_NMS",
                   help="hua pool: Entropy_NMS | Entropy_ALL | Entropy_NoNMS")
    p.add_argument("--agg", default=None)
    p.add_argument("--agg-order", default=None, choices=["class_first", "scale_first"],
                   help="HUA aggregation-order ablation")
    p.add_argument("--cls-weight", action="store_true",
                   help="clsW: weight image scores by distinct-class count")
    p.add_argument("--passes", type=int, default=25, help="MC-dropout passes")
    p.add_argument("--batch-size", type=int, default=8,
                   help="GLOBAL sweep batch (split across --num-devices)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="shard the pool sweep over N devices, one process each")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="float32 (the JAX CLI's default is bfloat16, which the port's "
                        "models do not run yet)")
    p.add_argument("--int8", action="store_true", help="int8 backbone (not ported)")
    p.add_argument("--out", default="uncertainty.npy")
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--canvas-cache-dir", default=None,
                   help="decoded-canvas cache root (off by default)")
    p.add_argument("--mini", action="store_true", help="tiny model (smoke mode)")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for a flag of a mode the port does not have yet."""
    refused = [
        (args.int8, "--int8", "16"),
        (args.dtype != "float32", f"--dtype {args.dtype}", "16"),
    ]
    for given, flag, item in refused:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    args = parse_args(argv)
    refuse_unported(args)
    if args.num_devices and args.num_devices > 1 and not detect_launch_env():
        return spawn_local_ranks(main, sys.argv[1:] if argv is None else argv,
                                 args.num_devices, args.cpu)
    pin_numerics()
    from aod_meh_hua_torch.al.baselines import score_pool_ensemble, score_pool_mc_dropout
    from aod_meh_hua_torch.al.uncertainty import score_num_objects, score_pool
    from aod_meh_hua_torch.api import _default_pipeline, init_detector
    from aod_meh_hua_torch.data.canvas_cache import open_canvas_cache
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.data.pipeline import PipelineConfig
    from aod_meh_hua_torch.data.voc import ConcatVOC, VOCDataset
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.models.ssd_detector import build_ssd
    from aod_meh_hua_torch.parallel import allgather_sum, init_distributed, rank_indices
    from aod_meh_hua_torch.parallel.launch import rank_device
    from aod_meh_hua_torch.utils.config import RetinaNetConfig, SSDConfig, tiny_test_config

    device = "cpu" if args.cpu else "cuda"
    rank, world = 0, 1
    if detect_launch_env():
        info = init_distributed(device=device)
        rank, world = info["process_index"], info["process_count"]
        device = rank_device(device)
    if args.num_devices is not None and args.num_devices != world:
        raise ValueError(f"--num-devices {args.num_devices}: {world} processes are running, "
                         "one device each")
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} must divide by --num-devices {world}")
    if args.mini:
        if args.family == "ssd":
            cfg, pipe = SSDConfig(width_mult=0.125, max_gt=8), None
        else:
            cfg = tiny_test_config()
            pipe = PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas)
    else:
        cfg, pipe = (SSDConfig() if args.family == "ssd" else RetinaNetConfig()), None
    hua = cfg.hua
    if args.agg:
        hua = dataclasses.replace(hua, agg=args.agg)
    if args.agg_order:
        hua = dataclasses.replace(hua, agg_order=args.agg_order)
    if args.cls_weight:
        hua = dataclasses.replace(hua, cls_weight=True)
    cfg = dataclasses.replace(cfg, hua=dataclasses.replace(hua, pool=args.uncertainty))
    pipe = pipe or _default_pipeline(cfg)

    datasets = [VOCDataset(
        args.split or os.path.join(args.voc07, "ImageSets/Main/trainval.txt"), args.voc07)]
    if args.voc12:
        datasets.append(VOCDataset(
            os.path.join(args.voc12, "ImageSets/Main/trainval.txt"), args.voc12))
    pool = ConcatVOC(datasets)
    n = len(pool)
    rng = np.random.RandomState(args.seed)
    cache = None
    if args.canvas_cache_dir:
        cache_dir = args.canvas_cache_dir if world == 1 else \
            os.path.join(args.canvas_cache_dir, f"r{rank}")  # a rank sweeps its own slice
        cache = open_canvas_cache(cache_dir, pool, pipe, log=print)
    loader = EvalLoader(pool, rank_indices(n, rank, world), pipe,
                        batch_size=args.batch_size // world, cache=cache)

    ckpts = args.checkpoint or [None]
    model = init_detector(cfg, checkpoint=ckpts[0], seed=args.seed, device=device)

    t0 = time.time()
    if args.method == "random":
        unc = rng.permutation(n).astype(np.float64)
    elif args.method == "numobj":
        unc = score_num_objects(pool, np.arange(n))
    elif args.method == "ensemble":
        if len(ckpts) < 2:
            raise ValueError("ensemble needs 2+ checkpoints")
        models = [model] + [init_detector(cfg, checkpoint=c, seed=args.seed, device=device)
                            for c in ckpts[1:]]
        unc = score_pool_ensemble(models, cfg, loader, n, device=device)
    elif args.method == "mcdropout":
        # SSDConfig has no mc_dropout field: this raises for --family ssd, as in JAX
        mc_cfg = dataclasses.replace(cfg, mc_dropout=0.1)
        build = build_ssd if mc_cfg.family == "ssd" else build_retinanet
        mc_model = build(mc_cfg, device=device, seed=args.seed)
        mc_model.load_state_dict(model.state_dict())  # dropout adds no parameter
        gen = torch.Generator(device=device).manual_seed(args.seed + rank)
        unc = score_pool_mc_dropout(mc_model, mc_cfg, loader, n, gen, args.passes,
                                    device=device)
    else:  # hua
        unc, _ = score_pool(model, cfg, loader, n, rng=rng, device=device, progress=True)
    if world > 1 and args.method not in ("random", "numobj"):
        unc = allgather_sum(unc)  # each rank swept its slice
    dt = time.time() - t0
    if rank:
        return unc

    np.save(args.out, unc)
    print(f"scored {n} images with {args.method} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.1f} img/s) -> {args.out}")
    print(f"stats: zeros={int((unc == 0).sum())} mean={unc.mean():.4f} "
          f"max={unc.max():.4f}")
    return unc


if __name__ == "__main__":
    main()
