"""Inference FPS benchmark: the eval step's throughput (forward ->
decode -> NMS) on seeded random weights and inputs.

Port of tools/analysis/benchmark.py of the JAX package (after the
reference's tools/analysis_tools/benchmark.py:51-123): warm-up
iterations skipped, then `iters` steps at a fixed batch of normalised
float32 canvases, the clock stopped after the device finishes. It keeps
the JAX flags and adds --cpu, the port's way to ask for the CPU; it
runs on the card otherwise. --dtype defaults to float32, as the port's
score_pool does (the JAX tool's default, bfloat16, raises: ROADMAP
Queue 1 item 16).

    python -m aod_meh_hua_torch.tools.benchmark [--family retinanet|ssd|faster_rcnn] \\
        [--batch 8] [--iters 50] [--warmup 5] [--cpu]

`benchmark(cfg, ...)` is the same measurement on a config the caller
gives: RetinaNetConfig(fused_blocks=True) for the fused kernel, the
tests' tiny ones. The step is the family's (api.make_eval_step_for): for
the two-stage families their eval step (for rpn and cascade_rpn the
proposals); fast_rcnn, whose eval takes proposals, raises a ValueError.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.batch import EvalBatch
from ..utils.device import pin_numerics, resolve_device


def benchmark(cfg, batch: int = 8, iters: int = 50, warmup: int = 5, device="cuda",
              seed: int = 0) -> dict:
    """img/s and ms per image of the family's eval step on
    init_detector(cfg) on `device`, over `iters` steps after `warmup`;
    the batch is seeded normal noise (x0.2) on the canvas, valid
    everywhere."""
    from ..api import init_detector, make_eval_step_for
    from ..engine.eval import batch_on

    dev = resolve_device(device)
    model = init_detector(cfg, device=dev, seed=seed)
    step = make_eval_step_for(model, cfg, device=dev)
    h, w = cfg.canvas
    rng = np.random.RandomState(seed)
    data = batch_on(EvalBatch(rng.randn(batch, h, w, 3).astype(np.float32) * 0.2,
                              np.tile([[h, w]], (batch, 1)).astype(np.int32),
                              np.ones((batch, 4), np.float32), np.ones(batch, bool)), dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        step(data)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(data)
    sync()
    dt = time.perf_counter() - t0
    return {"img_per_s": batch * iters / dt, "ms_per_img": 1000 * dt / (batch * iters),
            "batch": batch, "iters": iters, "device": str(dev)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="Eval-step FPS benchmark")
    ap.add_argument("--family", default="retinanet",
                    help="retinanet, ssd or a ported zoo family (utils/config.py "
                         "ZOO_FAMILIES; the others: ROADMAP item 15)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    from ..utils.config import ZOO_FAMILIES, RetinaNetConfig, SSDConfig

    if args.dtype != "float32":
        raise NotImplementedError(
            "--dtype bfloat16: the port's models run float32 (ROADMAP Queue 1 item 16)")
    if args.family == "retinanet":
        cfg = RetinaNetConfig()
    elif args.family == "ssd":
        cfg = SSDConfig()
    elif args.family in ZOO_FAMILIES:
        cfg = ZOO_FAMILIES[args.family][0]()
    else:
        raise NotImplementedError(
            f"the {args.family} family is not ported yet (ROADMAP Queue 1 item 15)")
    pin_numerics()
    out = benchmark(cfg, args.batch, args.iters, args.warmup, "cpu" if args.cpu else "cuda")
    print(f"family={args.family} batch={args.batch} dtype={args.dtype}: "
          f"{out['img_per_s']:.1f} img/s ({out['ms_per_img']:.2f} ms/img) on {out['device']}")
    return out


if __name__ == "__main__":
    main()
