#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every CUDA kernel
   of the port from the sources in this checkout (one nvcc per source,
   all started together, timed) while the SSD paths of 12, on which no
   hand-written kernel lies, run on the card.
2. Kernel phase, TF32 off: each kernel against its plain PyTorch version
   at its paths' shapes (the TTA's batch-1 canvases too) and at small
   edge cases, and CUDA-event times of the kernel, the plain version and
   the library yardstick (for the fused bottleneck the unfused cuDNN
   chain of the same block, for the transposed matmul one torch.matmul);
   for the fused bottleneck also the operator against its launch called
   directly, in turns (the operator's dispatch).
3. Scoring path: a full-width MEH-RetinaNet (R50-FPN, 9 anchors, 20
   classes, 608x1024 canvases in both orientations, fused_blocks=True),
   seeded random weights with a sharpened cls head, scores a pool of
   seeded synthetic uint8 canvases through `score_pool` (Entropy_NMS).
   Checks the kernel's launch count, finite scores, NMS survivors and
   non-zero scores, and holds the fused model's head outputs and first
   batch's scores against the unfused model's. Profiles one score step.
4. Probe path (aod_meh_hua_torch/tools/pallas_probe.py) at batch 8: the
   C2 1x1 conv four ways (the transposed-matmul kernel the fourth), the
   fused bottleneck against the unfused block, and the R50 conv census
   in bf16 and in f32. Checks that each kernel launched once per call
   the probe made.
5. conv1x1_matmul: one landscape batch through the full-width model with
   the 1x1 convs as matrix products and through the same weights
   without, head outputs held together, forwards timed.
6. The other pools on the scoring model (fused_blocks on), one batch of
   each orientation: Entropy_ALL and Entropy_NoNMS (closed-form MI), and
   Entropy_NMS with the sampled MI from seeded CUDA generators, held to
   the closed-form scores within a Monte-Carlo tolerance (SAMPLED_* below).
7. Eval path: `make_eval_step` (fused) over the synthetic pool, the
   detections per class, and VOC mAP (the copied voc_eval) against
   synthetic ground truth; with the detections as ground truth the mAP
   must be 1.
8. Training path: a full-width model (fused_blocks off, as training
   needs) takes 2 warm-up and 10 timed steps on one seeded synthetic
   batch with TrainConfig() defaults; losses finite and falling, the
   frozen stem and layer1 bit-for-bit unchanged, the lambda branch and
   the head moved; one portrait step. Then two steps of the tiny config
   on the card and on the CPU (the port's plain path), held together.
9. AL phase, the system's real entry point: the port's JPEG decoder and
   resize against the hashes of the committed fixtures
   (aod_meh_hua_torch/data/fixtures/fixtures.json, made with OpenCV);
   then a synthetic VOC07 tree of the fixture JPEGs (32 trainval and 8
   test ids, seeded annotations) through the port's CLI, in process, at
   full width (RetinaNetConfig(), the default pipeline): a 2-cycle AL
   run (see al_path for its cuts), each cycle's fresh model with its cls
   head sharpened so that the pool holds objects past the score gates.
   Checks that the cuts reached the driver, the cycles, the losses and
   mAPs, that enough unlabeled images score above 0 and cycle 0
   acquires the top-scored ones, and the artifacts; times the decoder, the
   training epochs, the eval and pool sweeps from JPEG and from the
   canvas cache and each cycle, and the device's busy share over one
   training epoch. Neither kernel lies on this path (fused_blocks is off
   where the model trains): their launches there are counted and
   reported, and must be 0.
   Its CLI must pin the numerics (TF32 off, deterministic cuDNN): the
   flags are set to torch's defaults just before it and read just after.
10. Batch 64, the CLIs' default sweep batch: the full-width RetinaNet's
   Entropy_NMS sweep and eval step at batch 64 and at batch 8 over the
   same 128 canvases, fused and unfused, peak memory and img/s; the
   batch-64 scores held to the batch-8 ones.
11. NMS fixpoint: one score step profiled with the convergence checked
   after every map application and every CHECK_INTERVAL of them: host
   syncs, wall and device time.
12. SSD300 (SSDConfig(): VGG16, 8732 anchors, 21 columns; its training,
   tiny steps and scoring while the kernels build, before 2): 2 + 10 train
   steps at batch 8 with the SSD CLI's warmup, a tiny SSD's two steps on
   the card against the CPU, Entropy_NMS through score_pool at batch 64
   over 128 canvases with the foreground logits sharpened, Entropy_ALL
   and NoNMS on one batch, eval with its mAP; the host cost of the
   augment chain; and last the SSD CLI in process on the fixture tree for
   two cycles (cut in data size only), its numerics flags checked as the
   RetinaNet CLI's. No hand-written kernel lies on the SSD paths: their
   launches there must be 0.
13. Baselines (al/baselines.py): three full-width fused members (seeds
   0-2, cls heads sharpened) score the synthetic pool through
   score_pool_ensemble at batch 8, 5 fused launches per member forward,
   one batch held to the unfused members; score_pool_mc_dropout (rate
   0.1, 25 passes, one batch of each orientation) launches no kernel (a
   block with dropout does not fuse), is bit-reproducible from one CUDA
   generator seed and gives 0 at rate 0; the tiny config's ensemble and
   MC steps on the card against the CPU.
14. Semi-supervised steps: make_pseudo_train_step at full width, batch
   2, its cls head sharpened so that pseudo boxes exist: the cR1 check
   per level, 2 + 5 timed steps; the tiny config's two pseudo steps on
   the card against the CPU; one self-SSL forward and backward, timed.
15. Inference API: init_detector(RetinaNetConfig(fused_blocks=True)) and
   a Detector on the fixture JPEGs (the port's decoder): __call__ per
   image, predict_batch(max_batch=8) held to the single calls, the six
   columns of with_uncertainty, 5 fused launches per forward.
16. Last, after the AL phases, on their fixture tree: the score_pool CLI
   (`python -m aod_meh_hua_torch.tools.score_pool`'s main, in process)
   with each method (hua, random, numobj, ensemble from three seeded
   checkpoints, mcdropout with 25 passes), and the RetinaNet CLI with
   --baseline ensemble --ensemble-size 3 for two cycles under the AL
   phase's cuts; neither launches a kernel, and both pin the numerics.
17. Serving phase, on the AL phase's tree: a full-width fused RetinaNet
   (seed 0, its cls head sharpened) behind the port's serving path.
   Detector.tta on the fixture JPEGs: identity TTA equal to __call__ bit
   for bit, then TTA_SCALES with the flip (5 launches per augmented
   forward), ms per image, held to the same TTA through an unfused twin
   with the same weights (rtol 1e-4, at most SERVE_MAX_FLIPS named
   decision flips). The eval step exported with torch.export at
   batch 8 in both orientations (5 fused operator nodes each) and saved
   by a subprocess started before the score_pool CLI phase
   (start_serving_export), packaged and loaded back: on the 26 synthetic canvases its
   detections against the eager step's (bit-equal, or to rtol 1e-4 with
   at most SERVE_MAX_FLIPS named decision flips), its launches, its ms
   per batch against eager in turns; test_exported's sweep of the AL
   tree's test split, per image against the eager step on the same
   loader batches (as the canvases), and its mAP equal to the eager
   eval's. The HTTP server
   (Batcher, make_handler) on 127.0.0.1:0 around the Detector, then
   around the archive (ArchiveDetector): SERVE_REQUESTS POSTs from
   SERVE_CLIENTS threads, raw and base64, each reply held to the
   Detector's rows; p50/p99 latency, req/s, mean coalesced batch,
   launches. Last the FPS tool (tools/benchmark.py) at batch 8, fused
   and unfused.
18. Faster R-CNN (FasterRCNNConfig(): R50-FPN, frozen_stages 1, 3 RPN
   anchors at strides 4-64, RoIAlign 7x7 over P2-P5, the 2-fc 1024 head,
   20 classes, 608x1024 in both orientations), random weights from seed
   0 with the RPN cls head sharpened (and for eval the class head): 2 +
   10 train steps at batch 2 (ms per step, peak memory, finite losses,
   positives every step, frozen stages unmoved), one step's device time
   by stage (the steps' profiler ranges) and each proposal NMS
   fixpoint's depth; the tiny config's two steps on the card against the
   CPU under the same uniforms; the eval step over the 26 synthetic
   canvases at batch 8 (img/s, peak memory, the split, the depths) with
   the first two canvases of the timed sweep's first batch held to the
   CPU's eval step on those canvases (no flip allowed); the trainer's CLI (tools/train_detector.py) for one
   epoch at full width with eval on a fixture tree (build/chip_smoke_frcnn/),
   its checkpoint back through init_detector and a Detector's
   predict_batch on the 8 test JPEGs against the eval step's rows; the
   FPS tool with --family faster_rcnn. Neither kernel lies on this path:
   both launch counts must read 0.
19. The other two-stage families at full width, the same readings as
   Faster R-CNN's (zoo_path): Cascade R-CNN (CascadeRCNNConfig(): three
   class-agnostic heads at IoU 0.5/0.6/0.7) trained, its tiny config's
   two steps on the card against the CPU (uniforms per stage), and its
   eval (RoIAlign x3); Dynamic R-CNN (proposal NMS at IoU 0.85) trained
   with the fixpoint's depth, and its tiny config's five steps (interval
   4) on card and CPU with the threshold and beta after the refresh
   equal; Double-Head R-CNN (the conv branch on 1.3x RoIs, its BN
   training) trained, its tiny steps with the BN running statistics, and
   its eval. Then Detector.tta of Faster and Cascade R-CNN at
   TTA_SCALES with the flip (ms per image, one image against the CPU's
   TTA), serve.py's build_detector for --family cascade_rcnn --mini
   behind the HTTP server (each reply equal to the Detector's rows), and
   the trainer's CLI with --family cascade_rcnn for one epoch on a
   fixture tree (build/chip_smoke_zoo/), its Detector and the FPS tool.
   Each path's launch counts must read 0.
20. The two-stage deploy phase (two_stage_deploy_path): Faster and
   Cascade R-CNN at full width (seed 0, heads sharpened) exported with
   torch.export at batch 8 in both orientations (every NMS a device
   while_loop, the cascade's three stages in one program), saved,
   packaged into one archive each and loaded back: export and load
   seconds, archive MB, the 26 synthetic canvases through the loaded
   programs against the eager TwoStageEvalStep (no image may differ),
   ms per batch of the two in turns (each family's programs trace in a
   subprocess of its own, started before the Faster R-CNN phase, while
   it and the zoo phase run); the cascade's
   archive behind the HTTP server (ArchiveDetector, 16 requests of the
   fixture JPEGs, each reply held to a Detector's rows); the Faster,
   Double-Head and PISA R-CNN train steps at full width on two gloo ranks
   sharing cuda:0 (global batch 2, one group of rank subprocesses)
   against the one-process step, after each of two steps (see
   two_stage_ranks_path), ms per step per rank. Each path's launch
   counts must read 0.
21. The Faster R-CNN variants phase (variants_path): Libra R-CNN (the BFP
   after the FPN, the IoU-balanced sampler on seven draws per image,
   balanced L1, RPN neg_pos_ub 5), PAFPN, CARAFE, GRoIE (RoIAlign on
   every level, the 5x5 pre-conv, the '0100' attention) and empirical
   attention ('0010' blocks in c4 and c5) at full width, each with its
   zero-start parameters drawn (seed_zero_starts: every attention block's
   gamma and biases, the BFP's conv biases):
   the readings of Faster R-CNN's (training, the tiny steps on the card
   against the CPU, eval over the 26 canvases with the split by stage,
   the variants' own modules in their profiler ranges), then the
   trainer's CLI with --family libra_rcnn for one epoch on a fixture tree
   (build/chip_smoke_variants/), its Detector and the FPS tool. Each
   path's launch counts must read 0.
22. The rest of Faster R-CNN's config variants (backbones_path): PISA,
   GN+WS, ResNeSt, HRNet and FPG (640x1024) and the backbone_type
   switches ResNeXt, Res2Net and RegNetX through zoo_family_path (2 + 2
   train steps, the tiny steps from the CPU's state, the eval over the
   26 canvases, the switches' over SWITCH_POOL's 16), the PISA trainer's
   CLI, and GN+WS exported at batch 8 by a subprocess and held to eager
   (PISA's train step on two gloo ranks runs in the deploy phase). Each
   path's launch counts must read 0.
23. The proposal families (proposals_path): RPN-only, Fast R-CNN,
   Cascade RPN, TridentNet and Grid R-CNN at full width (608x1024, seed
   0, heads sharpened): 2 + 2 train steps at batch 2 (TridentNet's 6
   branch rows, its gts near its branch-0 proposals), the tiny steps on
   the card against the CPU from the CPU's state, the eval over the 26
   canvases at batch 8 with one profiled batch (AR@100 of the two RPN
   families against synthetic gts, their proposals held to the CPU's as
   sets; Fast R-CNN on the RPN's proposals of the pool; the others'
   detections held to the CPU's); the RPN -> gen_proposals -> Fast
   R-CNN workflow through the CLIs on a fixture tree; the trainer's CLI
   with --family grid_rcnn, its Detector and the FPS tool. No export on
   the card. Each path's launch counts must read 0.
24. Distributed phase (aod_meh_hua_torch/parallel/; the card is one, and
   NCCL refuses two ranks on one card): NCCL at world size 1, where the
   full-width data-parallel step (TrainConfig(), batch 2) must equal the
   plain step bit for bit after 2 steps and the FSDP2 step must be
   within 1e-6 of each tensor's max-abs; then two ranks sharing cuda:0
   over gloo, subprocesses of this script with torchrun's variables
   (--rank-program): the DP and FSDP2 steps on the same batch, one image
   per rank, held to the single-process step to 1e-4 of max-abs (a
   tensor that starts at zero, to that or to the largest spread that the
   plain step's function computed in other orders shows on such
   tensors, see DIST_RTOL); the
   fused Entropy_NMS sweep of the 26 canvases rank-sliced, merged with
   allgather_sum and held to the single-process sweep at rtol 1e-4 but
   for named decision flips, with each rank's fused launches, img/s and
   peak memory; last the RetinaNet CLI on two ranks under the AL phase's
   cuts on its tree, which must acquire the AL phase's X_L_1 (but for
   named near-ties at the cut), only rank 0 writing. Every subprocess
   has a wall limit and a process-group timeout.
25. Prints the script's seconds, a per-case line, a `{"kernels": [...]}`
   line, the card line and, last, `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, without a card or outside a checkout
of the repository. Every failed check raises.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent

BATCH = 8
POOL = {"landscape": 14, "portrait": 12}   # 4 batches of 8, two of them padded
F32_TOL = 1e-4    # of max|ref|: the same f32 sums in another order
BF16_TOL = 0.06   # of max|ref|: bf16 rounding of intermediates (tests/test_fused_block.py)
MATMUL_TOL = 2.0 ** -7  # of max|ref|: one bf16 ulp; kernel and plain version round one f32 sum
TF32_PEAK_OPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)
PROBE_ITERS = 10
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the timed train steps of the two-stage families after Faster R-CNN (zoo and
# variants phases): 2, for the script's time limit
TWO_STAGE_STEPS = 2
# the canvases of the timed sweep's first batch that the two-stage families
# after Faster R-CNN hold to the CPU's eval step (Faster R-CNN keeps 2): 1,
# for the script's time limit (a full-width CPU eval of
# TridentNet's 1,000 RoIs per canvas through its res5 head takes about 20 s)
LATER_CPU_CANVASES = 1
# and evaluate the pool's first batch of each orientation (16 canvases) where Faster
# R-CNN and the proposal families take all 26 (zoo_family_path)
TRAIN_RTOL = 1e-4   # card vs CPU losses; parameters to 1e-4 of each tensor's max|p|
# card vs CPU updates (new - old): 1e-3 of each tensor's max|update| plus two
# f32 ulps of its max|p| (the rounding of new - old), tests/test_torch_train.py's
UPDATE_RTOL = 1e-3
# Sampled MI against the closed form, per image over SAMPLED_SEEDS seeds of
# 500 draws: |mean - closed| <= SAMPLED_K * sd / sqrt(seeds) + SAMPLED_BIAS * closed.
# sd is the seeds' spread; the bias term covers the plug-in entropy of the
# 500-draw mean, low by about (C - 1) / (2 * 500 * (S + 1)) nats per anchor
# (-0.5% to -0.8% of the score over a 32-image synthetic pool on the CPU;
# on an H100 the mean of 4 seeds sat -0.45% off on average, at most 0.78%,
# and one seed's sd reached 0.64% of the score). So 4 standard errors and
# 1.5%: a sampler off by 3% fails on these images.
SAMPLED_SEEDS = 4
SAMPLED_K = 4.0
SAMPLED_BIAS = 0.015
SCALE_AGG = "scaleAvg_classAvg"  # the reference AL scripts' aggregation for the scale pools


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_CHILDREN = []  # the subprocesses this script started (spawn)


def spawn(args: list, env: dict, log) -> subprocess.Popen:
    """This script in a subprocess (`args` after its path; output to
    `log`), which main kills at its exit if it still runs."""
    proc = subprocess.Popen([sys.executable, "-u", "-X", "faulthandler",
                             str(REPO / "chip_smoke.py"), *args],
                            env=dict(env, CHIP_SMOKE_PID=str(os.getpid())), stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(REPO))
    _CHILDREN.append(proc)
    return proc


def kill_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- kernel phase -------------------------------------------------------------

def times_in_turns(kernel, plain, library) -> dict:
    """CUDA-event ms of the kernel, its plain version and the library
    yardstick, taken in turns (k, p, l, l, p, k) and averaged per version."""
    from aod_meh_hua_torch.tools.pallas_probe import cuda_time_ms

    fns = {"ms": kernel, "plain_ms": plain, "library_ms": library}
    t = {key: 0.0 for key in fns}
    for key in ("ms", "plain_ms", "library_ms", "library_ms", "plain_ms", "ms"):
        t[key] += cuda_time_ms(fns[key]) / 2
    return t


def random_block(cin, p, cout, downsample, gen, device):
    """Folded weights with unit-scale activations (std 1/sqrt(fan_in))."""
    import torch
    from aod_meh_hua_torch.ops.fused_block import FoldedBlock

    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device) * fan_in ** -0.5)

    def b(n):
        return torch.randn((1, n), generator=gen, device=device) * 0.1

    return FoldedBlock(w(cin, p, fan_in=cin), b(p), w(9, p, p, fan_in=9 * p), b(p),
                       w(p, cout, fan_in=p), b(cout),
                       w(cin, cout, fan_in=cin) if downsample else None,
                       b(cout) if downsample else None)


def unfused_chain(x_nchw, fb):
    """The library yardstick: the same block as cuDNN convolutions on the
    folded weights in x's dtype, channels_last."""
    import torch
    import torch.nn.functional as F

    dt = x_nchw.dtype
    p = fb.w1.shape[1]

    def k1(w):
        return w.t()[:, :, None, None].to(dt).contiguous(memory_format=torch.channels_last)

    w1, w3 = k1(fb.w1), k1(fb.w3)
    w2 = fb.w2.reshape(3, 3, p, p).permute(3, 2, 0, 1).to(dt).contiguous(
        memory_format=torch.channels_last)
    wd = None if fb.wd is None else k1(fb.wd)
    b1, b2, b3 = (t.reshape(-1).to(dt) for t in (fb.b1, fb.b2, fb.b3))
    bd = None if fb.bd is None else fb.bd.reshape(-1).to(dt)

    def run():
        y = torch.relu(F.conv2d(x_nchw, w1, b1))
        y = torch.relu(F.conv2d(y, w2, b2, padding=1))
        y = F.conv2d(y, w3, b3)
        res = x_nchw if wd is None else F.conv2d(x_nchw, wd, bd)
        return torch.relu(y + res)

    return run


def block_bound_ms(b, h, w, cin, p, cout, down, dtype):
    """Least time for one launch: x read once, out written once, weights
    once, against the HBM rate; FLOPs against the type's peak. For float32
    that is the least time for f32-accurate work on the tensor cores:
    3xTF32, three TF32 products per product at 495 TFLOP/s (the kernel's
    route). Returns (ms, bound_by, ms on the CUDA cores' 67 TFLOP/s or None)."""
    import torch
    from aod_meh_hua_torch.tools.pallas_probe import HBM_BYTES_PER_S, bound_ms

    elt = dtype.itemsize
    weights = cin * p + 9 * p * p + p * cout + (cin * cout if down else 0)
    nbytes = elt * (b * h * w * (cin + cout) + weights) + 4 * (2 * p + cout * (2 if down else 1))
    flops = 2 * b * h * w * weights
    bound, bound_by = bound_ms(nbytes, flops, dtype)
    if dtype != torch.float32:
        return bound, bound_by, None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_PEAK_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), bound


def kernel_phase(device):
    import torch
    from aod_meh_hua_torch.engine.tta import canvas_for_scale
    from aod_meh_hua_torch.ops.fused_block import (_check_and_launch, fused_bottleneck,
                                                   fused_bottleneck_reference)
    from aod_meh_hua_torch.tools.pallas_probe import cuda_time_ms

    gen = torch.Generator(device=device).manual_seed(0)
    both, f32 = (torch.float32, torch.bfloat16), (torch.float32,)
    # (label, B, H, W, Cin, P, Cout, downsample, dtypes): C2/C3 are the main
    # path's landscape shapes at the smoke batch, C2p/C3p its portrait ones;
    # the next two are edge cases (1x1 downsample; H, W not multiples of 8);
    # last the serving phase's TTA shapes: batch 1 on each TTA_SCALES
    # canvas in both orientations (C2 at stride 4, C3 at stride 8)
    cases = [("C2", BATCH, 152, 256, 256, 64, 256, False, both),
             ("C3", BATCH, 76, 128, 512, 128, 512, False, both),
             ("C2p", BATCH, 256, 152, 256, 64, 256, False, f32),
             ("C3p", BATCH, 128, 76, 512, 128, 512, False, f32),
             ("down", 2, 20, 12, 128, 64, 256, True, both),
             ("ragged", 2, 37, 29, 256, 64, 256, False, both)]
    for scale in TTA_SCALES:
        ch, cw = canvas_for_scale(scale)
        for o, (h, w) in (("", (ch, cw)), ("p", (cw, ch))):
            cases += [(f"tta{max(scale)} C2{o}", 1, h // 4, w // 4, 256, 64, 256, False, f32),
                      (f"tta{max(scale)} C3{o}", 1, h // 8, w // 8, 512, 128, 512, False, f32)]
    results = []
    for label, b, h, w, cin, p, cout, down, dtypes in cases:
        fb = random_block(cin, p, cout, down, gen, device)
        x32 = torch.randn((b, h, w, cin), generator=gen, device=device)
        for dt in dtypes:
            dname = str(dt).split(".")[1]
            x = x32.to(dt)
            got = fused_bottleneck(x, fb)
            torch.cuda.synchronize()
            ref = fused_bottleneck_reference(x, fb)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * scale
            if not (err <= tol) or not torch.isfinite(got.float()).all():
                fail(f"fused_bottleneck {label} {dname}: max abs err {err} > {tol}")
            row = dict(case=label, dtype=dname, shape=[b, h, w, cin, p, cout],
                       downsample=down, max_abs_err=err, tol=tol)
            if label.startswith(("C2", "C3")):
                x_nchw = x.permute(0, 3, 1, 2)  # channels_last view
                lib = unfused_chain(x_nchw, fb)
                libout = lib()
                torch.cuda.synchronize()
                lib_err = (libout.permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
                row.update(times_in_turns(lambda: fused_bottleneck(x, fb),
                                          lambda: fused_bottleneck_reference(x, fb), lib))
                # the operator's dispatch: the same launch called directly,
                # in turns with the operator (op, direct, direct, op)
                turns = {"op_ms": lambda: fused_bottleneck(x, fb),
                         "direct_ms": lambda: _check_and_launch(x, *fb)}
                dispatch = {key: 0.0 for key in turns}
                for key in ("op_ms", "direct_ms", "direct_ms", "op_ms"):
                    dispatch[key] += cuda_time_ms(turns[key]) / 2
                row.update(dispatch=dispatch)
                bound, bound_by, cuda_cores = block_bound_ms(b, h, w, cin, p, cout, down, dt)
                row.update(library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by)
                if cuda_cores is not None:
                    row.update(bound_ms_cuda_cores=cuda_cores)
            results.append(row)
            del got, ref
    return results


def matmul_kernel_phase(device):
    """transposed_matmul against its plain version at the probe's batch-8
    shape and at a ragged M; at the batch-8 shape, CUDA-event times of
    the kernel, the plain version and torch.matmul, in turns."""
    import torch
    from aod_meh_hua_torch.ops.transposed_matmul import (transposed_matmul,
                                                         transposed_matmul_reference)
    from aod_meh_hua_torch.tools.pallas_probe import bound_ms

    gen = torch.Generator(device=device).manual_seed(1)
    n, k = 64, 256
    rows = []
    # the C2 1x1 conv of the probe at batch 8 (M = 8*152*256), an M that
    # ends inside a 128-wide tile, and one smaller than a tile
    for label, m in (("C2", BATCH * 152 * 256), ("ragged", 1000), ("small", 40)):
        wt = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(torch.bfloat16)
        xt = (torch.randn((k, m), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        got = transposed_matmul(wt, xt)
        ref = transposed_matmul_reference(wt, xt)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = MATMUL_TOL * ref.float().abs().max().item()
        if got.shape != (n, m) or not torch.isfinite(got.float()).all() or not err <= tol:
            fail(f"transposed_matmul {label}: max abs err {err} > {tol}")
        row = dict(case=label, dtype="bfloat16", shape=[n, k, m], max_abs_err=err, tol=tol)
        if label == "C2":
            row.update(times_in_turns(lambda: transposed_matmul(wt, xt),
                                      lambda: transposed_matmul_reference(wt, xt),
                                      lambda: torch.matmul(wt, xt)))
            bound, bound_by = bound_ms(2 * (n * k + k * m + n * m), 2 * n * k * m, torch.bfloat16)
            row.update(bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        del wt, xt, got, ref
    return rows


def kernel_wrappers():
    """Each kernel's wrapper by name; `.launches` is its launch count."""
    from aod_meh_hua_torch.ops.fused_block import fused_bottleneck
    from aod_meh_hua_torch.ops.transposed_matmul import transposed_matmul

    return {"fused_bottleneck": fused_bottleneck, "transposed_matmul": transposed_matmul}


def add_launches(*counts: dict) -> dict:
    """Launch counts of several runs added up, kernel by kernel."""
    return {name: sum(c[name] for c in counts) for name in kernel_wrappers()}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# --- scoring path -------------------------------------------------------------

def count_path(out: dict, launches: dict, name: str, fn) -> None:
    """out[name] = fn() (a dict, given its seconds as path_s), the kernels'
    launch counts reset just before it and read just after into
    launches[name]: for a path on which neither kernel lies, so each must
    read 0."""
    import torch

    t0 = time.time()
    reset_launches()
    out[name] = fn()
    launches[name] = read_launches()
    if any(launches[name].values()):
        fail(f"{name}: a hand-written kernel launched: {launches[name]}")
    torch.cuda.empty_cache()
    out[name]["path_s"] = time.time() - t0


def synthetic_pool(cfg, seed: int = 0, pool=None, batch: int = BATCH):
    """(orientation, EvalBatch, indices) triples of seeded uint8 canvases:
    32-pixel cells of random colour plus noise, varied img_shapes and
    scale_factors, the last batch of each orientation padded. pool: the
    images per orientation (POOL by default). Made once per canvas, seed,
    pool and batch (drawing them took 1-2 s of host time per family): the
    callers read the arrays and never write them."""
    pool = pool or POOL
    canvases = tuple(cfg.for_orientation(o).canvas for o in pool)
    triples, n = _synthetic_pool(canvases, seed, tuple(pool.items()), batch)
    return list(triples), n


@functools.lru_cache(maxsize=8)
def _synthetic_pool(canvases, seed, pool, batch):
    from aod_meh_hua_torch.engine.batch import EvalBatch

    rng = np.random.RandomState(seed)
    triples, start = [], 0
    for (orientation, n), (h, w) in zip(pool, canvases):
        coarse = rng.randint(0, 256, (n, h // 32, w // 32, 3)).astype(np.uint8)
        imgs = coarse.repeat(32, axis=1).repeat(32, axis=2)
        imgs = np.clip(imgs.astype(np.int16) + rng.randint(-20, 21, imgs.shape), 0, 255)
        imgs = imgs.astype(np.uint8)
        shapes = np.array([[rng.randint(h * 3 // 4, h + 1), rng.randint(w * 3 // 4, w + 1)]
                           for _ in range(n)], np.int32)
        sfs = np.repeat(rng.uniform(0.8, 1.7, (n, 1)), 4, axis=1).astype(np.float32)
        for i in range(0, n, batch):
            k = min(batch, n - i)
            rows = np.r_[np.arange(i, i + k), np.full(batch - k, i + k - 1)]
            triples.append((orientation,
                            EvalBatch(imgs[rows], shapes[rows], sfs[rows], np.arange(batch) < k),
                            np.arange(start + i, start + i + k)))
        start += n
    return triples, start


def cpu_twin(model):
    """The card model's copy on the CPU, in eval mode, for a reference
    check (a copy: a fresh build's seeded init, which the weights would
    replace, took about a second of host time)."""
    import copy

    return copy.deepcopy(model).cpu().eval()


_SEEDED = {}  # repr(cfg) -> its seed-0 two-stage model on the CPU (the last three)


def seeded_two_stage(cfg, device):
    """build_two_stage(cfg, device, seed=0), copied from the CPU model of an
    earlier build of the same config while one is kept: a family's train,
    eval and export paths build the same model, and its seeded init took a
    second or more of host time."""
    import copy

    from aod_meh_hua_torch.models.two_stage import build_two_stage

    key = repr(cfg)
    model = _SEEDED.pop(key, None)
    if model is None:
        model = build_two_stage(cfg, device="cpu", seed=0)
    _SEEDED[key] = model  # the newest last
    while len(_SEEDED) > 3:
        _SEEDED.pop(next(iter(_SEEDED)))
    return copy.deepcopy(model).to(device)


def upload(batch, device):
    """An EvalBatch of host arrays -> one of device tensors (valid stays)."""
    import torch
    from aod_meh_hua_torch.engine.batch import EvalBatch

    return EvalBatch(*(torch.from_numpy(a).to(device) for a in batch[:3]), batch.valid)


CLS_LOGIT_STD = 1.5


def sharpen_cls_head(model, images) -> None:
    """Scale the cls head's weight so that its logits on `images` have a
    std of CLS_LOGIT_STD, a stand-in for a trained head: random weights
    give a ~uniform softmax (0.05) under the 0.3 object and FG gates, and
    every pool score would be 0."""
    import torch

    with torch.no_grad():
        logits = model(images)[0]
        model.head.retina_cls.weight.mul_(CLS_LOGIT_STD / logits.std().item())


def main_path(device, cfg, per_forward: int):
    """Score the synthetic pool with `cfg` (fused_blocks on); the fused
    kernel must launch `per_forward` times in each forward. Returns the
    result, a profile of one step, the model, the pool and its scores."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.al.uncertainty import score_pool
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.postprocess import make_candidate_selector
    from aod_meh_hua_torch.engine.score import make_score_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.ops.nms import batched_multiclass_nms

    t0 = time.time()
    model = build_retinanet(cfg, device=device, seed=0)
    triples, n_images = synthetic_pool(cfg)
    first = triples[0][1]
    shapes0 = torch.from_numpy(first.img_shapes).to(device)
    images0 = prepare_images(torch.from_numpy(first.images).to(device), shapes0, cfg)
    sharpen_cls_head(model, images0)
    setup_s = time.time() - t0

    # warm-up on one batch (cuDNN handles, allocator), outside the count
    score_pool(model, cfg, triples[:1], n_images, device=device)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    unc, mconf = score_pool(model, cfg, triples, n_images, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()["fused_bottleneck"]
    peak = torch.cuda.max_memory_allocated(device)

    forwards = len(triples)
    if launches != per_forward * forwards:
        fail(f"fused_bottleneck launched {launches} times for {forwards} forwards, "
             f"expected {per_forward * forwards}")
    if unc.shape != (n_images,) or not np.isfinite(unc).all() or not np.isfinite(mconf).all():
        fail("scores are not finite or have the wrong shape")
    n_nonzero = int((unc > 0).sum())
    if n_nonzero == 0:
        fail("every image scored 0: no object passed the gates")

    # the fused model's head outputs against the unfused model's, one batch
    plain = build_retinanet(dataclasses.replace(cfg, fused_blocks=False), device=device)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(images0)
        want = plain(images0)
    torch.cuda.synchronize()
    head_err = {}
    for name, g, w in zip(("cls_scores", "bbox_preds", "lambdas"), got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: bad shape or non-finite values")
        err = (g - w).abs().max().item()
        tol = F32_TOL * w.abs().max().item()
        head_err[name] = err
        if err > tol:
            fail(f"{name}: fused vs unfused max abs err {err} > {tol}")
    select, anchors = make_candidate_selector(cfg)
    with torch.no_grad():
        cand = select(torch.from_numpy(anchors).to(device), got[0], got[1], got[2], shapes0)
        dets = batched_multiclass_nms(cand.boxes, cand.scores, cfg.test.score_thr,
                                      cfg.test.nms_iou_thr, cfg.test.max_per_img,
                                      cfg.test.pre_nms_cands)
    survivors = int((dets.valid & (dets.scores > cfg.hua.obj_score_thr)).sum())
    if survivors == 0:
        fail("no NMS survivor above the 0.3 object gate in the first batch")
    # the first batch's scores through the unfused model: the same zero set,
    # and rtol 1e-3 (head outputs differ by ~1e-5 of their scale)
    orientation, batch0, idx0 = triples[0]
    step = make_score_step(plain, cfg.for_orientation(orientation), device=device)
    unc_plain = step(upload(batch0, device))[0].cpu().numpy()[: len(idx0)]
    unc_fused = unc[idx0]
    score_rel_err = float(np.max(np.abs(unc_fused - unc_plain) / np.maximum(np.abs(unc_plain), 1e-6)))
    if not (np.array_equal(unc_fused == 0, unc_plain == 0)
            and np.allclose(unc_fused, unc_plain, rtol=1e-3, atol=1e-6)):
        fail(f"first-batch scores: fused {unc_fused} vs unfused {unc_plain}")

    del plain
    result = dict(images=n_images, forwards=forwards, launches=launches,
                  nonzero_scores=n_nonzero, survivors_over_0_3_first_batch=survivors,
                  head_max_abs_err_fused_vs_unfused=head_err,
                  score_max_rel_err_fused_vs_unfused=score_rel_err, score_pool_s=wall,
                  img_per_s=n_images / wall, peak_mem_bytes=peak, setup_s=setup_s,
                  unc_min=float(unc.min()), unc_max=float(unc.max()))
    return result, profile_step(model, cfg, triples[0], device), model, triples, unc


KERNEL_GROUPS = (  # substring of a CUDA kernel's name -> group, first match wins
    ("fused_bottleneck", "fused_bottleneck"),
    ("conv", "convolution"), ("gemm", "convolution"), ("xmma", "convolution"),
    ("sm90", "convolution"), ("cudnn", "convolution"), ("fft", "convolution"),
    ("winograd", "convolution"), ("sort", "sort"), ("radix", "sort"),
    ("multi_tensor_apply", "optimizer (foreach)"),
)


def profile_device(fn) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler; `fn`
    must end in a host read), grouped, with the device's busy share of
    the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        wall_us = (time.time() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    groups = {}
    for name, t, _ in kernels:
        g = next((grp for key, grp in KERNEL_GROUPS if key in name.lower()), "other")
        groups[g] = groups.get(g, 0.0) + t
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "group_ms": {g: t / 1e3 for g, t in sorted(groups.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in top]}


def profile_step(model, cfg, triple, device):
    """profile_device over one score step, after one unprofiled step."""
    from aod_meh_hua_torch.engine.score import make_score_step

    orientation, batch, _ = triple
    step = make_score_step(model, cfg.for_orientation(orientation), device=device)
    up = upload(batch, device)
    step(up)[0].cpu()
    return {"batch": len(batch.valid), "orientation": orientation,
            **profile_device(lambda: step(up)[0].cpu())}


# --- the other pools ------------------------------------------------------------

def timed_pool(model, cfg, triples, device, per_forward, generator=None):
    """score_pool over `triples` with the launch counts reset just before
    and read just after; the fused kernel must launch `per_forward` times
    per forward. Returns (scores, max-confidences, seconds, launches)."""
    import torch
    from aod_meh_hua_torch.al.uncertainty import score_pool

    n = int(max(idx.max() for *_, idx in triples)) + 1
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    unc, mconf = score_pool(model, cfg, triples, n, device=device, generator=generator)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()["fused_bottleneck"]
    if launches != per_forward * len(triples):
        fail(f"{cfg.hua.pool}/{cfg.hua.mi_mode}: fused_bottleneck launched {launches} times "
             f"for {len(triples)} forwards")
    idx = np.concatenate([i for *_, i in triples])
    if not (np.isfinite(unc[idx]).all() and np.isfinite(mconf[idx]).all()):
        fail(f"{cfg.hua.pool}/{cfg.hua.mi_mode}: scores are not finite")
    return unc[idx], mconf[idx], wall, launches


def pools_path(device, model, cfg, triples, closed_unc, per_forward):
    """Entropy_ALL and Entropy_NoNMS (closed form), and Entropy_NMS with
    the sampled MI, over one batch of each orientation, through
    score_pool on the fused scoring model."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.engine.score import make_score_step

    two = [next(t for t in triples if t[0] == o) for o in ("landscape", "portrait")]
    idx = np.concatenate([i for *_, i in two])
    n_img = len(idx)
    out, launches = {}, 0
    for pool in ("Entropy_ALL", "Entropy_NoNMS"):
        pcfg = dataclasses.replace(cfg, hua=dataclasses.replace(cfg.hua, pool=pool,
                                                                agg=SCALE_AGG))
        timed_pool(model, pcfg, two[:1], device, per_forward)  # warm-up
        unc, _, wall, k = timed_pool(model, pcfg, two, device, per_forward)
        launches += k
        if not (unc > 0).any():
            fail(f"{pool}: every image scored 0")
        out[pool] = dict(img_per_s=n_img / wall, nonzero=int((unc > 0).sum()),
                         unc_min=float(unc.min()), unc_max=float(unc.max()), launches=k)

    scfg = dataclasses.replace(cfg, hua=dataclasses.replace(cfg.hua, mi_mode="sampled"))
    runs, walls = [], []
    for seed in range(SAMPLED_SEEDS):
        gen = torch.Generator(device=device).manual_seed(seed)
        unc, _, wall, k = timed_pool(model, scfg, two, device, per_forward, generator=gen)
        runs.append(unc)
        walls.append(wall)
        launches += k
    runs = np.stack(runs)
    closed = closed_unc[idx]
    if not np.array_equal(runs[0] == 0, closed == 0):
        fail(f"sampled MI: zero set {runs[0] == 0} differs from the closed form's {closed == 0}")
    mean, sd = runs.mean(axis=0), runs.std(axis=0, ddof=1)
    tol = SAMPLED_K * sd / np.sqrt(SAMPLED_SEEDS) + SAMPLED_BIAS * np.abs(closed)
    err = np.abs(mean - closed)
    if not (err <= tol).all():
        fail(f"sampled MI: |mean - closed| {err} over the tolerance {tol}")
    nz = closed > 0

    # the sampled MI's time per batch: a sampled step less a closed one, same batch
    _, batch0, _ = two[0]
    steps = {mode: make_score_step(model, c.for_orientation("landscape"), device=device)
             for mode, c in (("closed", cfg), ("sampled", scfg))}
    up = upload(batch0, device)
    gen = torch.Generator(device=device).manual_seed(99)
    step_ms = {}
    for mode in ("closed", "sampled", "sampled", "closed"):
        torch.cuda.synchronize()
        t0 = time.time()
        steps[mode](up, gen)[0].cpu()
        step_ms.setdefault(mode, []).append((time.time() - t0) * 1e3)
    step_ms = {m: min(v) for m, v in step_ms.items()}
    out["Entropy_NMS_sampled"] = dict(
        img_per_s=n_img / float(np.mean(walls)), seeds=SAMPLED_SEEDS,
        max_rel_err_of_mean=float(np.max(err[nz] / closed[nz])),
        max_err_over_tol=float(np.max(err / np.maximum(tol, 1e-30))),
        # a uniform bias of this share of the score fails some image, and
        # what a sampler 3% off (either way) would read against the limit
        least_rel_tol=float(np.min(tol[nz] / closed[nz])),
        err_over_tol_if_3pct_off=min(
            float(np.max(np.abs(mean * f - closed)[nz] / tol[nz])) for f in (0.97, 1.03)),
        mean_rel_err_of_mean=float(np.mean((mean[nz] - closed[nz]) / closed[nz])),
        max_rel_sd_one_seed=float(np.max(sd[nz] / closed[nz])),
        step_ms_closed=step_ms["closed"], step_ms_sampled=step_ms["sampled"],
        sampled_mi_ms_per_batch=step_ms["sampled"] - step_ms["closed"])
    return dict(images=n_img, forwards=len(two), pools=out), launches


# --- eval path -----------------------------------------------------------------

def synthetic_gts(triples, num_classes, seed=3):
    """Per pool image: 1..5 random boxes in original-image coordinates (the
    resized shape over the scale factor) with random labels."""
    rng = np.random.RandomState(seed)
    anns = []
    for _, batch, idx in triples:
        for r in range(len(idx)):
            h, w = batch.img_shapes[r] / batch.scale_factors[r][[1, 0]]
            n = rng.randint(1, 6)
            xy = rng.uniform(0, 1, (n, 2)) * [w * 0.7, h * 0.7]
            wh = rng.uniform(0.05, 0.3, (n, 2)) * [w, h]
            anns.append({"bboxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                         "labels": rng.randint(0, num_classes, n)})
    return anns


def eval_path(device, model, cfg, triples, per_forward):
    """make_eval_step over the pool (fused), the detections per class and
    the VOC mAP (voc07, 11 points) against synthetic ground truth; with
    the detections themselves as ground truth the mAP must be 1."""
    import torch
    from aod_meh_hua_torch.engine.eval import detections_to_per_class, make_eval_step
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    steps = {o: make_eval_step(model, cfg.for_orientation(o), device=device)
             for o in ("landscape", "portrait")}
    steps["landscape"](upload(triples[0][1], device))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    dets = [steps[o](upload(b, device)) for o, b, _ in triples]
    results = []
    for (_, b, _), d in zip(triples, dets):
        results += detections_to_per_class(d, cfg.num_classes, batch_valid=b.valid)
    wall = time.time() - t0
    launches = read_launches()["fused_bottleneck"]
    if launches != per_forward * len(triples):
        fail(f"eval: fused_bottleneck launched {launches} times for {len(triples)} forwards")
    n_dets = sum(len(a) for img in results for a in img)
    if n_dets == 0:
        fail("eval: no detection in the pool")
    if not all(np.isfinite(a).all() for img in results for a in img):
        fail("eval: detections are not finite")
    m = eval_map(results, synthetic_gts(triples, cfg.num_classes))["mAP"]
    if not (np.isfinite(m) and 0.0 <= m <= 1.0):
        fail(f"eval: mAP {m} is not in [0, 1]")
    # boxes clipped to zero area at the border match nothing, not even themselves
    kept = [[a[(a[:, 2] > a[:, 0]) & (a[:, 3] > a[:, 1])] for a in img] for img in results]
    as_gt = [{"bboxes": np.concatenate([a[:, :4] for a in img]),
              "labels": np.concatenate([np.full(len(a), c) for c, a in enumerate(img)])}
             for img in kept]
    m_self = eval_map(kept, as_gt)["mAP"]
    if m_self != 1.0:
        fail(f"eval: mAP with the detections as ground truth is {m_self}, not 1")
    n_img = len(results)
    return dict(images=n_img, forwards=len(triples), launches=launches, detections=n_dets,
                mAP_synthetic_gt=m, mAP_detections_as_gt=m_self, eval_s=wall,
                img_per_s=n_img / wall), launches


# --- training path ---------------------------------------------------------------

def synthetic_train_batch(cfg, orientation, b, seed, noise: int = 0):
    """A Batch of seeded uint8 canvases (as synthetic_pool draws them),
    1..5 boxes per image in resized-image coordinates padded to
    cfg.max_gt, and the pad-region anchor flags of each image's shape.
    noise: each pixel moved by up to that much (synthetic_pool's 20), from
    a generator of its own, so that the rest is the same."""
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.ops.anchors import anchor_valid_flags

    ocfg = cfg.for_orientation(orientation)
    rng = np.random.RandomState(seed)
    h, w = ocfg.canvas
    cell = 32
    coarse = rng.randint(0, 256, (b, h // cell, w // cell, 3)).astype(np.uint8)
    imgs = coarse.repeat(cell, axis=1).repeat(cell, axis=2)
    shapes = np.array([[rng.randint(h * 3 // 4, h + 1), rng.randint(w * 3 // 4, w + 1)]
                       for _ in range(b)], np.int32)
    g = ocfg.max_gt
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int64)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        ih, iw = shapes[i]
        for j in range(rng.randint(1, 6)):
            bw, bh = rng.uniform(0.08, 0.5) * iw, rng.uniform(0.08, 0.5) * ih
            x1, y1 = rng.uniform(0, iw - bw), rng.uniform(0, ih - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, j] = rng.randint(0, ocfg.num_classes)
            valid[i, j] = True
    av = anchor_valid_flags(ocfg.build_anchor_generator(), ocfg.featmap_sizes(), shapes)
    if noise:
        jitter = np.random.RandomState(seed + 1).randint(-noise, noise + 1, imgs.shape)
        imgs = np.clip(imgs.astype(np.int16) + jitter, 0, 255).astype(np.uint8)
    return ocfg, Batch(imgs, boxes, labels, valid, av, shapes)


LOSS_KEYS = ("loss", "loss_cls", "loss_bbox", "loss_meh")


def train_path(device):
    """TrainConfig() on a full-width model (fused_blocks off): 2 warm-up
    and 10 timed steps on one landscape batch, then one portrait step."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state, frozen_mask, make_train_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import RetinaNetConfig, TrainConfig

    cfg, tcfg = RetinaNetConfig(), TrainConfig()
    model = build_retinanet(cfg, device=device, seed=0)
    opt = create_train_state(model, tcfg)
    mask = frozen_mask(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lcfg, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, seed=5)
    batch = type(batch)(*(torch.from_numpy(a).to(device) for a in batch))
    step = make_train_step(model, lcfg, opt, device=device)

    auxes = [step(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    auxes += [step(batch) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(device)
    traj = {k: [float(a[k]) for a in auxes] for k in LOSS_KEYS}
    for k, v in traj.items():
        if not np.isfinite(v).all():
            fail(f"training: {k} is not finite: {v}")
    if not traj["loss"][-1] < traj["loss"][0]:
        fail(f"training: the loss did not fall: {traj['loss']}")
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        if mask[name] and moved:
            fail(f"training: frozen parameter {name} moved")
        if name.startswith(("head.L_convs", "head.retina_L", "head.cls_convs", "head.retina_cls",
                            "head.reg_convs", "head.retina_reg")) and not moved:
            fail(f"training: {name} did not move")

    # one more landscape step, profiled (after the checks: it updates the weights)
    prof = profile_device(lambda: float(step(batch)["loss"]))

    pcfg, pbatch = synthetic_train_batch(cfg, "portrait", tcfg.batch_size, seed=6)
    pstep = make_train_step(model, pcfg, opt, device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    paux = pstep(pbatch)
    torch.cuda.synchronize()
    portrait_ms = (time.time() - t0) * 1e3
    if not all(np.isfinite(float(paux[k])) for k in LOSS_KEYS):
        fail(f"training: a portrait loss is not finite: {paux}")
    return dict(batch=tcfg.batch_size, canvas=list(lcfg.canvas), warmup=TRAIN_WARMUP,
                steps=TRAIN_STEPS, ms_per_step=ms, img_per_s=tcfg.batch_size * 1e3 / ms,
                peak_mem_bytes=peak, loss_trajectory=traj,
                num_pos=[float(a["num_pos"]) for a in auxes],
                frozen_params=sum(mask.values()), portrait_step_ms_first_call=portrait_ms,
                portrait_loss={k: float(paux[k]) for k in LOSS_KEYS},
                profile_of_one_step=prof)


def train_card_vs_cpu(device, make_step=None):
    """Two steps of tiny_test_config() from the same weights and batch on
    the card and on the CPU: losses to TRAIN_RTOL (exactly where the
    CPU's is 0), parameters to TRAIN_RTOL of each tensor's max|p|, and the
    updates (new - old) to UPDATE_RTOL of each tensor's max|update| plus
    two ulps of max|p|. make_step: make_train_step's signature
    (make_train_step by default)."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import TrainConfig, tiny_test_config

    make_step = make_step or make_train_step
    cfg, tcfg = tiny_test_config(), TrainConfig()
    _, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, seed=7)

    def two_steps(dev):
        model = build_retinanet(cfg, device=dev, seed=1)
        initial = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        step = make_step(model, cfg, create_train_state(model, tcfg), device=dev)
        losses = [{k: float(v) for k, v in step(batch).items()} for _ in range(2)]
        return losses, {n: (initial[n], p.detach().cpu()) for n, p in model.named_parameters()}

    return steps_card_vs_cpu("training", LOSS_KEYS, two_steps("cpu"), two_steps(device))


def steps_card_vs_cpu(what, keys, cpu, gpu, limits=(1.0, 1.0, 1.0), check: bool = True) -> dict:
    """The rules of train_card_vs_cpu on two runs of steps, each (losses
    per step, {name: (initial, final) parameter on the host}). `limits`:
    the losses', parameters' and updates' limits in units of their
    tolerances (1: the tolerances); with check False the readings only."""
    (cpu_l, cpu_p), (gpu_l, gpu_p) = cpu, gpu
    loss_err = max(abs(g[k] - c[k]) / abs(c[k]) if c[k] else (0.0 if g[k] == 0 else np.inf)
                   for c, g in zip(cpu_l, gpu_l) for k in keys)
    if check and not loss_err <= TRAIN_RTOL * limits[0]:
        fail(f"{what} card vs CPU: losses {gpu_l} vs {cpu_l}")
    param_err = update_err = 0.0
    # what each check would read of a tensor that the card left unchanged
    missing_param, missing_update = [], []
    for name, (c0, c) in cpu_p.items():
        g0, g = gpu_p[name]
        scale = max(c.abs().max().item(), 1e-30)
        err = (g - c).abs().max().item() / scale
        param_err = max(param_err, err)
        if check and err > TRAIN_RTOL * limits[1]:
            fail(f"{what} card vs CPU: {name} differs by {err} of its max")
        dc, dg = c - c0, g - g0
        tol = UPDATE_RTOL * dc.abs().max().item() + 2 * float(np.finfo(np.float32).eps) * scale
        uerr = (dg - dc).abs().max().item() / tol
        update_err = max(update_err, uerr)
        if check and uerr > limits[2]:
            fail(f"{what} card vs CPU: the update of {name} is {uerr} of its tolerance off")
        if dc.abs().max().item() > 0:
            missing_param.append(dc.abs().max().item() / scale / TRAIN_RTOL)
            missing_update.append(dc.abs().max().item() / tol)
    return dict(steps=len(cpu_l), max_rel_loss_err=loss_err, max_param_err_of_max=param_err,
                max_update_err_over_tol=update_err, tensors_moved=len(missing_update),
                # readings over each check's limit; a tensor reading <= 1 would pass unmoved
                if_unmoved_param_check_min=min(missing_param),
                if_unmoved_param_check_passes=sum(int(r <= 1) for r in missing_param),
                if_unmoved_update_check_min=min(missing_update),
                if_unmoved_update_check_passes=sum(int(r <= 1) for r in missing_update),
                losses_card=gpu_l, losses_cpu=cpu_l)


# --- probe path ---------------------------------------------------------------

def probe_path(device, card):
    """The backbone probe at batch 8, through its entry points: the 1x1
    conv four ways, the census in bf16 and in f32 (TF32 off), the fused
    block against the unfused one. Each kernel must launch exactly once
    per call the probe made of it."""
    import torch
    from aod_meh_hua_torch.tools import pallas_probe as probe

    reset_launches()
    mm = probe.matmul_probe(BATCH, PROBE_ITERS, device)
    census = {str(dt).split(".")[1]: probe.census(BATCH, PROBE_ITERS, dt, device)
              for dt in (torch.bfloat16, torch.float32)}
    block = probe.block_probe(BATCH, PROBE_ITERS, device)
    launches = read_launches()
    for name, calls in (("transposed_matmul", mm["kernel_calls"]),
                        ("fused_bottleneck", block["kernel_calls"])):
        if launches[name] != calls:
            fail(f"{name} launched {launches[name]} times for {calls} calls of the probe")
    print("probe matmul:", json.dumps(mm), f"[{card}]", flush=True)
    for dname, rows in census.items():
        print(f"probe census {dname}:", json.dumps(rows), f"[{card}]", flush=True)
    print("probe block:", json.dumps(block), f"[{card}]", flush=True)
    return launches


def conv1x1_matmul_check(device, cfg):
    """One landscape batch through the full-width model with the 1x1 convs
    as matrix products and through the same weights without: head outputs
    within F32_TOL of their scale, and both forwards timed in turns."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.tools.pallas_probe import cuda_time_ms

    as_mm = build_retinanet(dataclasses.replace(cfg, conv1x1_matmul=True), device=device)
    as_conv = build_retinanet(cfg, device=device)
    as_conv.load_state_dict(as_mm.state_dict())
    h, w = cfg.for_orientation("landscape").canvas
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.randint(0, 256, (BATCH, h, w, 3)).astype(np.uint8)).to(device)
    shapes = torch.tensor([[h, w]] * BATCH, dtype=torch.int32, device=device)
    images = prepare_images(imgs, shapes, cfg)
    err = {}
    with torch.no_grad():
        got, want = as_mm(images), as_conv(images)
        torch.cuda.synchronize()
        for name, g, r in zip(("cls_scores", "bbox_preds", "lambdas"), got, want):
            err[name] = (g - r).abs().max().item()
            if g.shape != r.shape or not torch.isfinite(g).all() \
                    or err[name] > F32_TOL * r.abs().max().item():
                fail(f"conv1x1_matmul {name}: max abs err {err[name]} or bad values")
        del got, want
        t = {"matmul": [], "conv": []}
        for key in ("matmul", "conv", "conv", "matmul"):
            model = as_mm if key == "matmul" else as_conv
            t[key].append(cuda_time_ms(lambda: model(images), iters=3, warmup=1))
    return dict(batch=BATCH, head_max_abs_err=err, forward_ms_conv1x1_matmul=sum(t["matmul"]) / 2,
                forward_ms_conv=sum(t["conv"]) / 2)

# --- AL phase: the CLI on a VOC tree of JPEGs ---------------------------------------

FIXTURES = REPO / "aod_meh_hua_torch" / "data" / "fixtures"
AL_TRAINVAL, AL_TEST = 32, 8
# the CLI's configs, but for the cuts of the data size (the JAX CLI reads
# these from --config, which the port does not have yet)
AL_TRAIN = dict(outer_epoch=1, epoch_ratio=(1,), ckpt_interval=1)
AL_AL = dict(cycles=(0, 1), x_l_0_size=8, x_s_size=4, x_l_repeat=1, score_batch_size=8,
             zero_rate=0.15)


def with_cuts(cls, cuts):
    """cls(...) with `cuts` applied over whatever the caller passed."""
    import dataclasses

    return lambda *a, **k: dataclasses.replace(cls(*a, **k), **cuts)


VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>"""
VOC_OBJ = """<object>
  <name>{name}</name><difficult>{difficult}</difficult>
  <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
</object>"""


def decoder_check() -> dict:
    """The port's decode and resize of each fixture against the hashes
    OpenCV gave (tests/make_jpeg_fixtures.py); host ms per decode."""
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import resize_linear_u8

    with open(FIXTURES / "fixtures.json") as f:
        table = json.load(f)["files"]
    if len(table) < 6:
        fail(f"only {len(table)} JPEG fixtures")
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    decode_ms = {}
    for name, e in sorted(table.items()):
        t0 = time.perf_counter()
        img = imread(str(FIXTURES / name))
        decode_ms[name] = (time.perf_counter() - t0) * 1e3
        if list(img.shape) != e["shape"] or sha(img) != e["decode_sha256"]:
            fail(f"decoder: {name} does not decode as OpenCV does")
        if sha(resize_linear_u8(img, *e["resize"])) != e["resize_sha256"]:
            fail(f"resize: {name} does not resize as OpenCV does")
    return {"fixtures": len(table), "decode_ms": decode_ms,
            "decode_ms_mean": float(np.mean(list(decode_ms.values())))}


def synthetic_voc(root: Path, n_trainval: int = AL_TRAINVAL, n_test: int = AL_TEST,
                  seed: int = 0) -> Path:
    """A VOC2007 tree of the fixture JPEGs (copied: the machine with the
    card has no JPEG encoder) with seeded annotations of 1-4 objects
    each; trainval and test id lists."""
    from aod_meh_hua_torch.data.jpeg import jpeg_size
    from aod_meh_hua_torch.data.voc import VOC_CLASSES

    rng = np.random.RandomState(seed)
    base = root / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True, exist_ok=True)
    files = sorted(FIXTURES.glob("*.jpg"))
    ids = []
    for i in range(n_trainval + n_test):
        src = files[i % len(files)]
        img_id = f"{i:06d}"
        shutil.copyfile(src, base / "JPEGImages" / f"{img_id}.jpg")
        w, h = jpeg_size(str(src))
        objs = []
        for _ in range(rng.randint(1, 5)):
            bw, bh = int(rng.randint(40, w // 2)), int(rng.randint(40, h // 2))
            x1, y1 = int(rng.randint(1, w - bw)), int(rng.randint(1, h - bh))
            objs.append(VOC_OBJ.format(name=VOC_CLASSES[rng.randint(0, 20)],
                                       difficult=int(rng.rand() < 0.2),
                                       x1=x1, y1=y1, x2=x1 + bw, y2=y1 + bh))
        (base / "Annotations" / f"{img_id}.xml").write_text(
            VOC_XML.format(w=w, h=h, objects="\n".join(objs)))
        ids.append(img_id)
    (base / "ImageSets/Main/trainval.txt").write_text("\n".join(ids[:n_trainval]))
    (base / "ImageSets/Main/test.txt").write_text("\n".join(ids[n_trainval:]))
    return base


# the cache sweep scores the same uint8 canvases with the same weights
# as the driver's sweep; the card's convolutions may pick other algorithms
AL_CACHE_RTOL = 1e-4
# the pool's unlabeled images whose score must be non-zero, so that every
# acquisition of cycle 0 is by score and none by the zeroRate draw
AL_MIN_NONZERO = AL_AL["x_s_size"]


TORCH_DEFAULT_FLAGS = {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False,
                       "cudnn.deterministic": False, "cudnn.benchmark": False}
PINNED = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
          "cudnn.deterministic": True, "cudnn.benchmark": False}


def numerics_flags() -> dict:
    import torch

    b = torch.backends
    return {"cudnn.allow_tf32": b.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": b.cuda.matmul.allow_tf32,
            "cudnn.deterministic": b.cudnn.deterministic, "cudnn.benchmark": b.cudnn.benchmark}


def set_numerics_flags(flags: dict) -> None:
    import torch

    b = torch.backends
    b.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    b.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    b.cudnn.deterministic = flags["cudnn.deterministic"]
    b.cudnn.benchmark = flags["cudnn.benchmark"]


def run_cli(main, argv) -> tuple:
    """main(argv) with torch's default numerics flags set just before;
    fails unless the CLI pinned them (PINNED). Returns (driver, the
    flags it left)."""
    set_numerics_flags(TORCH_DEFAULT_FLAGS)
    driver = main(argv)
    flags = numerics_flags()
    if flags != PINNED:
        fail(f"the CLI left the numerics flags at {flags}, not {PINNED}")
    return driver, flags


# the extra epochs' deterministic cuDNN setting, in order (one of each: the
# script's time limit)
DETERMINISM_EPOCHS = (False, True)


def epoch_rate_by_determinism(driver, x_l) -> dict:
    """One more training epoch of the driver's model over x_l per entry of
    DETERMINISM_EPOCHS (deterministic cuDNN off or on; TF32 off
    throughout): img/s through the loader of each, the mean per setting."""
    import torch

    rates = {False: [], True: []}
    for det in DETERMINISM_EPOCHS:
        torch.backends.cudnn.deterministic = det
        torch.cuda.synchronize()
        t0 = time.time()
        driver._train_run(x_l, 777, False, cycle=9, run_idx=0)
        torch.cuda.synchronize()
        rates[det].append(len(x_l) * driver.al.x_l_repeat / (time.time() - t0))
    torch.backends.cudnn.deterministic = True
    return {"deterministic_off_img_per_s": rates[False], "deterministic_on_img_per_s": rates[True],
            "on_over_off": float(np.mean(rates[True]) / np.mean(rates[False]))}


def al_path(device, bare_img_per_s: float) -> dict:
    """The port's CLI (`main`, in process, on the card, no --mini) on the
    synthetic tree: RetinaNetConfig() at 608x1024, the default pipeline,
    TrainConfig() and ALConfig() but for AL_TRAIN and AL_AL, two cycles.
    Just before the pool sweep, the scoring model's cls head is sharpened
    on the pool's first canvas (sharpen_cls_head, through the driver's
    score_pool), so that the sweep meets objects; training runs from the
    plain random weights (a sharpened head makes their few SGD steps
    diverge).
    The launch counts are reset just before the run and read just after.
    bare_img_per_s: the training path's rate, beside the loader's."""
    import torch
    from aod_meh_hua_torch.al import loop as loop_module
    from aod_meh_hua_torch.al.uncertainty import score_pool
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.engine import checkpoint
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.tools import train_retinanet
    from aod_meh_hua_torch.utils import config as config_module

    root = REPO / "build" / "chip_smoke_al"
    shutil.rmtree(root, ignore_errors=True)
    voc07 = synthetic_voc(root)
    work = root / "work"
    argv = ["--voc07", str(voc07), "--work-dir", str(work), "--cycles", "2",
            "--ckpt-interval", "1", "--score-batch-size", "8", "--zero-rate", "0.15"]
    real_score_pool, sharpened = loop_module.score_pool, []

    def first_canvas(loader, cfg):
        _, batch, _ = next(iter(EvalLoader(loader.dataset, loader.indices[:1], loader.pipeline,
                                           batch_size=1, prefetch=False)))
        return prepare_images(torch.from_numpy(batch.images).to(device),
                              torch.from_numpy(batch.img_shapes), cfg)

    def sharpened_score_pool(model, cfg, loader, n_images, **kwargs):
        sharpen_cls_head(model, first_canvas(loader, cfg))
        sharpened.append(n_images)
        return real_score_pool(model, cfg, loader, n_images, **kwargs)

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    with mock.patch.object(config_module, "TrainConfig",
                           with_cuts(config_module.TrainConfig, AL_TRAIN)), \
            mock.patch.object(config_module, "ALConfig",
                              with_cuts(config_module.ALConfig, AL_AL)), \
            mock.patch.object(loop_module, "score_pool", sharpened_score_pool):
        driver, flags = run_cli(train_retinanet.main, argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device)

    # checks; first that the cuts and the sharpening reached the driver
    if driver.cfg.canvas != (608, 1024) or driver.cfg.block_counts != (3, 4, 6, 3):
        fail(f"AL: not the full-width config: {driver.cfg.canvas}, {driver.cfg.block_counts}")
    cuts = {k: getattr(driver.tcfg, k) for k in AL_TRAIN}, {k: getattr(driver.al, k) for k in AL_AL}
    if cuts != (AL_TRAIN, AL_AL):
        fail(f"AL: the driver ran with {cuts}, not the cuts {AL_TRAIN}, {AL_AL}")
    if sharpened != [AL_TRAINVAL]:
        fail(f"AL: the pool sweeps that went through the sharpened head: {sharpened}")
    metrics = driver.metrics
    if [m["cycle"] for m in metrics] != [0, 1]:
        fail(f"AL: the cycles that ran: {metrics}")
    log = [json.loads(line) for line in (work / "train_log.jsonl").read_text().splitlines()]
    losses = [e["mean_loss"] for e in log]
    if not losses or not np.isfinite(losses).all() or \
            not np.isfinite([m["mAP"] for m in metrics]).all():
        fail(f"AL: a loss or mAP is not finite: {losses}, {metrics}")
    x_l0, x_l1 = np.load(work / "X_L_0.npy"), np.load(work / "X_L_1.npy")
    if not (set(x_l0) <= set(x_l1) and len(x_l1) == len(x_l0) + AL_AL["x_s_size"]):
        fail(f"AL: X_L_0 {x_l0} -> X_L_1 {x_l1}")
    unc = np.load(work / "Unc_1.npy")
    if unc.shape != (AL_TRAINVAL,) or not np.isfinite(unc).all():
        fail(f"AL: Unc_1 has shape {unc.shape} or is not finite")
    unlabeled = np.setdiff1d(np.arange(AL_TRAINVAL), x_l0)
    nonzero = int((unc[unlabeled] > 0).sum())
    if nonzero < AL_MIN_NONZERO:
        fail(f"AL: {nonzero} unlabeled images scored above 0, fewer than {AL_MIN_NONZERO}")
    # zero_rate 0.15 of 4 rounds to no zero draw: the picks are the top 4 by score
    picked = np.sort(unc[np.setdiff1d(x_l1, x_l0)])
    if not np.array_equal(picked, np.sort(unc[unlabeled])[-AL_AL["x_s_size"]:]):
        fail(f"AL: acquired scores {picked} are not the top of {np.sort(unc[unlabeled])}")
    ckpts = [f for f in (work / "model_save").iterdir() if "_mycode" in f.name]
    if len(ckpts) != 2 or not (work / "metrics.json").exists():
        fail(f"AL: checkpoints {ckpts}, metrics.json missing")
    if any(launches.values()):
        fail(f"AL: a hand-written kernel launched on the AL path: {launches}")

    def rate(phase, cycle=None):
        rows = [t for t in driver.timings if t["phase"] == phase
                and (cycle is None or t["cycle"] == cycle)]
        n, sec = sum(t["images"] for t in rows), sum(t["seconds"] for t in rows)
        return {"images": n, "seconds": sec, "img_per_s": n / sec if sec else None}

    result = dict(
        argv=argv, configs={"train": AL_TRAIN, "al": AL_AL}, wall_s=wall, numerics_flags=flags,
        cycles=[{"cycle": t["cycle"], "seconds": t["seconds"]} for t in driver.timings
                if t["phase"] == "cycle"],
        metrics=metrics, mean_losses=losses, x_l_0=x_l0.tolist(), x_l_1=x_l1.tolist(),
        unc_1_nonzero=int((unc > 0).sum()), unc_1_nonzero_unlabeled=nonzero,
        unc_1_top=np.sort(unc)[-AL_AL["x_s_size"]:].tolist(),
        train_through_loader=rate("train_epoch"),
        train_epochs_img_per_s=[e["img_per_s"] for e in log],
        bare_step_img_per_s=bare_img_per_s,
        eval_from_jpeg=rate("eval", 0), eval_from_cache=rate("eval", 1),
        pool_from_jpeg=rate("score", 0), peak_mem_bytes=peak, launches=launches)

    # one more training epoch of the cycle-1 model over X_L_1, profiled
    result["profile_of_one_train_epoch"] = profile_device(
        lambda: driver._train_run(x_l1, 12345, False, cycle=9, run_idx=0))
    result["train_epoch_by_determinism"] = epoch_rate_by_determinism(driver, x_l1)

    # a second sweep of the pool by cycle 0's model, sharpened as before,
    # from the canvas cache the first one filled: the same scores
    driver.model.load_state_dict(checkpoint.load_checkpoint(checkpoint.cycle_ckpt_path(
        driver.paths.save_dir, driver.name, 0, driver.tcfg.epoch_ratio[0])))
    loader = EvalLoader(driver.pool, np.arange(len(driver.pool)), driver.pipeline,
                        batch_size=driver.al.score_batch_size,
                        cache=driver._canvas_cache("pool", driver.pool))
    sharpen_cls_head(driver.model, first_canvas(loader, driver.cfg))
    torch.cuda.synchronize()
    t1 = time.time()
    unc_cached, _ = score_pool(driver.model, driver.cfg, loader, len(driver.pool), device=device)
    torch.cuda.synchronize()
    pool_cached_s = time.time() - t1
    if not (np.array_equal(unc_cached > 0, unc > 0)
            and np.allclose(unc_cached, unc, rtol=AL_CACHE_RTOL, atol=0)):
        fail(f"AL: the sweep from the canvas cache gave {unc_cached}, the first one {unc}")
    result["pool_from_cache"] = {"images": len(driver.pool), "seconds": pool_cached_s,
                                 "img_per_s": len(driver.pool) / pool_cached_s,
                                 "max_rel_diff": float(np.max(np.abs(unc_cached - unc)
                                                              / np.maximum(unc, 1e-30)))}
    return result


# --- SSD AL phase: the SSD CLI on the fixture tree ------------------------------------

# the SSD CLI's configs (tools/train_ssd.py) but for the cuts of the data size
SSD_AL_TRAIN = dict(outer_epoch=1, epoch_ratio=(1,), ckpt_interval=1)
SSD_AL_AL = dict(cycles=(0, 1), x_l_0_size=8, x_s_size=4, x_l_repeat=2, zero_rate=0.15)


def augment_check() -> dict:
    """Host ms per image of the SSD train chain (ssd_train_augment +
    prepare_sample, float resize) on the decoded fixtures."""
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import PipelineConfig, prepare_sample
    from aod_meh_hua_torch.data.ssd_augment import ssd_train_augment

    pipe = PipelineConfig(img_scale=(300, 300), canvas=(300, 300), std=(1.0, 1.0, 1.0),
                          keep_ratio=False, device_normalize=True)
    ms = []
    for i, path in enumerate(sorted(FIXTURES.glob("*.jpg")) * 4):
        img = imread(str(path))
        ann = {"bboxes": np.array([[20, 30, 200, 250]], np.float32),
               "labels": np.array([3])}
        rng = np.random.RandomState(i)
        t0 = time.perf_counter()
        aug, ann2 = ssd_train_augment(img, ann, rng)
        s = prepare_sample(aug, ann2, pipe, rng=rng)
        ms.append((time.perf_counter() - t0) * 1e3)
        if s["image"].shape != (300, 300, 3) or s["image"].dtype != np.float32:
            fail(f"SSD augment: canvas {s['image'].shape} {s['image'].dtype}")
    return {"images": len(ms), "ms_per_image_mean": float(np.mean(ms)),
            "ms_per_image_max": float(np.max(ms))}


def ssd_al_path(device, bare_img_per_s: float) -> dict:
    """The SSD CLI (`tools/train_ssd.py` main, in process, on the card, no
    --mini) on the fixture tree: SSDConfig() at 300x300, its pipeline and
    augment chain, the CLI's TrainConfig and ALConfig but for SSD_AL_TRAIN
    and SSD_AL_AL, the sweeps at the CLI's batch of 64. The pool sweep's
    model has its foreground logits sharpened (sharpen_ssd_fg); training
    runs from the random weights."""
    import torch
    from aod_meh_hua_torch.al import loop as loop_module
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.tools import train_ssd
    from aod_meh_hua_torch.utils import config as config_module

    root = REPO / "build" / "chip_smoke_ssd_al"
    shutil.rmtree(root, ignore_errors=True)
    voc07 = synthetic_voc(root)
    work = root / "work"
    argv = ["--voc07", str(voc07), "--work-dir", str(work), "--cycles", "2"]
    real_score_pool, sharpened = loop_module.score_pool, []

    def sharpened_score_pool(model, cfg, loader, n_images, **kwargs):
        _, batch, _ = next(iter(EvalLoader(loader.dataset, loader.indices[:8], loader.pipeline,
                                           batch_size=8, prefetch=False)))
        sharpen_ssd_fg(model, prepare_images(torch.from_numpy(batch.images).to(device),
                                             torch.from_numpy(batch.img_shapes), cfg))
        sharpened.append(n_images)
        return real_score_pool(model, cfg, loader, n_images, **kwargs)

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    with mock.patch.object(config_module, "TrainConfig",
                           with_cuts(config_module.TrainConfig, SSD_AL_TRAIN)), \
            mock.patch.object(config_module, "ALConfig",
                              with_cuts(config_module.ALConfig, SSD_AL_AL)), \
            mock.patch.object(loop_module, "score_pool", sharpened_score_pool):
        driver, flags = run_cli(train_ssd.main, argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device)

    if driver.cfg.family != "ssd" or driver.cfg.width_mult != 1.0 or driver.cfg.canvas != (300, 300):
        fail(f"SSD AL: not the full-width SSD300: {driver.cfg}")
    cuts = ({k: getattr(driver.tcfg, k) for k in SSD_AL_TRAIN},
            {k: getattr(driver.al, k) for k in SSD_AL_AL})
    if cuts != (SSD_AL_TRAIN, SSD_AL_AL):
        fail(f"SSD AL: the driver ran with {cuts}, not the cuts")
    if (driver.tcfg.batch_size, driver.tcfg.warmup_iters, driver.al.score_batch_size) != (8, 500, 64):
        fail(f"SSD AL: not the SSD CLI's batch/warmup/sweep batch: {driver.tcfg}, {driver.al}")
    if sharpened != [AL_TRAINVAL]:
        fail(f"SSD AL: the pool sweeps that went through the sharpened head: {sharpened}")
    metrics = driver.metrics
    if [m["cycle"] for m in metrics] != [0, 1]:
        fail(f"SSD AL: the cycles that ran: {metrics}")
    log = [json.loads(line) for line in (work / "train_log.jsonl").read_text().splitlines()]
    losses = [e["mean_loss"] for e in log]
    if not losses or not np.isfinite(losses).all() or \
            not np.isfinite([m["mAP"] for m in metrics]).all():
        fail(f"SSD AL: a loss or mAP is not finite: {losses}, {metrics}")
    x_l0, x_l1 = np.load(work / "X_L_0.npy"), np.load(work / "X_L_1.npy")
    if not (set(x_l0) <= set(x_l1) and len(x_l1) == len(x_l0) + SSD_AL_AL["x_s_size"]):
        fail(f"SSD AL: X_L_0 {x_l0} -> X_L_1 {x_l1}")
    unc = np.load(work / "Unc_1.npy")
    if unc.shape != (AL_TRAINVAL,) or not np.isfinite(unc).all():
        fail(f"SSD AL: Unc_1 has shape {unc.shape} or is not finite")
    unlabeled = np.setdiff1d(np.arange(AL_TRAINVAL), x_l0)
    nonzero = int((unc[unlabeled] > 0).sum())
    if nonzero < SSD_AL_AL["x_s_size"]:
        fail(f"SSD AL: {nonzero} unlabeled images scored above 0")
    picked = np.sort(unc[np.setdiff1d(x_l1, x_l0)])
    if not np.array_equal(picked, np.sort(unc[unlabeled])[-SSD_AL_AL["x_s_size"]:]):
        fail(f"SSD AL: acquired scores {picked} are not the top of {np.sort(unc[unlabeled])}")
    ckpts = [f for f in (work / "model_save").iterdir() if "_mycode" in f.name]
    if len(ckpts) != 2:
        fail(f"SSD AL: checkpoints {ckpts}")
    if any(launches.values()):
        fail(f"SSD AL: a hand-written kernel launched on the SSD AL path: {launches}")
    rows = [t for t in driver.timings if t["phase"] == "train_epoch"]
    n_img, sec = sum(t["images"] for t in rows), sum(t["seconds"] for t in rows)
    result = dict(argv=argv, configs={"train": SSD_AL_TRAIN, "al": SSD_AL_AL}, wall_s=wall,
                  numerics_flags=flags,
                  cycles=[{"cycle": t["cycle"], "seconds": t["seconds"]}
                          for t in driver.timings if t["phase"] == "cycle"],
                  metrics=metrics, mean_losses=losses, x_l_0=x_l0.tolist(),
                  x_l_1=x_l1.tolist(), unc_1_nonzero_unlabeled=nonzero,
                  train_through_loader_img_per_s=n_img / sec, bare_step_img_per_s=bare_img_per_s,
                  sweeps={p: [t["images"] / t["seconds"] for t in driver.timings
                              if t["phase"] == p] for p in ("eval", "score")},
                  peak_mem_bytes=peak, launches=launches)
    result["train_epoch_by_determinism"] = epoch_rate_by_determinism(driver, x_l1)
    return result


# --- batch 64: the CLIs' default sweep batch (ALConfig.score_batch_size) ----------

B64 = 64
B64_POOL = {"landscape": 64, "portrait": 64}
B64_RTOL = 1e-4  # batch-64 scores against batch-8 scores of the same canvases
# ... but for images where one of the score's discrete decisions (the top-k
# candidates, an NMS survivor, an object member, an anchor past the FG
# gate) flips between the two batch sizes, whose cuDNN algorithms differ:
# a score is discontinuous there, and the head outputs that feed it must
# still agree to F32_TOL of their scale. At most this many such images.
B64_MAX_FLIPS = 2


def decision_flip(model, cfg, t8, t64, image, device, what="batch 64") -> dict:
    """Why `image`'s batch-64 score is off its batch-8 score (or, per
    `what`, another pair of batchings): its head outputs in either batch
    (within F32_TOL of their scale, or fail) and the discrete decisions
    of the Entropy_NMS core on each (or fail when none differs)."""
    import torch
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.postprocess import make_candidate_selector
    from aod_meh_hua_torch.ops.hua import object_membership
    from aod_meh_hua_torch.ops.nms import batched_multiclass_nms

    def outputs(triples):
        o, batch, idx = next(t for t in triples if image in t[2])
        r = int(np.nonzero(idx == image)[0][0])
        ocfg = cfg.for_orientation(o)
        shapes = torch.from_numpy(batch.img_shapes).to(device)
        with torch.no_grad():
            heads = model(prepare_images(torch.from_numpy(batch.images).to(device), shapes, ocfg))
        return ocfg, [h[r:r + 1] for h in heads], shapes[r:r + 1], \
            torch.from_numpy(batch.scale_factors[r:r + 1]).to(device)

    def decisions(ocfg, heads, shapes, sfs):
        select, anchors = make_candidate_selector(ocfg)
        t, h = ocfg.test, ocfg.hua
        with torch.no_grad():
            cand = select(torch.from_numpy(anchors).to(device), *heads, shapes)
            boxes = cand.boxes / sfs[:, None, :]
            dets = batched_multiclass_nms(boxes, cand.scores[..., :ocfg.num_fg_classes],
                                          t.score_thr, t.nms_iou_thr, t.max_per_img,
                                          t.pre_nms_cands)
            member = object_membership(boxes, dets.boxes, dets.scores, dets.valid,
                                       score_thr=h.obj_score_thr, iou_thr=h.memb_iou_thr)
            fg = cand.scores[..., :ocfg.num_fg_classes].amax(dim=-1) > h.fg_score_thr
        return {"candidates": cand.boxes, "survivors": dets.anchor_idx[dets.valid],
                "members": member, "fg_gate": fg}

    (ocfg, h8, s8, f8), (_, h64, s64, f64) = outputs(t8), outputs(t64)
    head_err = {}
    for name, x, y in zip(("cls", "reg", "lambda"), h8, h64):
        head_err[name] = (x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
        if head_err[name] > F32_TOL:
            fail(f"{what}: image {image}'s {name} head output is {head_err[name]} of its "
                 f"scale off the other batching's")
    d8, d64 = decisions(ocfg, h8, s8, f8), decisions(ocfg, h64, s64, f64)
    flipped = []
    for k, x in d8.items():
        y = d64[k]
        same = x.shape == y.shape and (torch.allclose(x, y, rtol=1e-4, atol=1e-2)
                                       if k == "candidates" else torch.equal(x, y))
        if not same:
            flipped.append(k)
    if not flipped:
        fail(f"{what}: image {image}'s result is off with no decision flipped")
    return {"image": image, "flipped": flipped, "head_err_of_scale": head_err}


def rebatch(triples, b):
    """The same canvases in batches of b (padding rows dropped, the last
    batch of each orientation padded again)."""
    from aod_meh_hua_torch.engine.batch import EvalBatch

    out = []
    for orientation in ("landscape", "portrait"):
        rows = [(t[1], r, int(t[2][r])) for t in triples if t[0] == orientation
                for r in range(len(t[2]))]
        for i in range(0, len(rows), b):
            chunk = rows[i:i + b]
            k = len(chunk)
            chunk = chunk + [chunk[-1]] * (b - k)
            arrays = [np.stack([bt[f][r] for bt, r, _ in chunk]) for f in range(3)]
            out.append((orientation, EvalBatch(*arrays, np.arange(b) < k),
                        np.array([j for *_, j in chunk[:k]])))
    return out


def batch64_path(device, card):
    """The full-width RetinaNet Entropy_NMS sweep and eval step at batch 64
    and at batch 8 over the same 128 canvases, fused_blocks on and off:
    img/s and peak memory of each; the batch-64 scores held to the
    batch-8 scores (B64_RTOL, the same zero set), and the detections'
    count and mAP to batch 8's."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.al.uncertainty import score_pool
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.eval import detections_to_per_class, make_eval_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import RetinaNetConfig
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    cfg = RetinaNetConfig(fused_blocks=True)
    t64, n = synthetic_pool(cfg, seed=11, pool=B64_POOL, batch=B64)
    t8 = rebatch(t64, BATCH)
    gts = synthetic_gts(t8, cfg.num_classes)
    out, launches = {}, 0
    for fused in (True, False):
        fcfg = dataclasses.replace(cfg, fused_blocks=fused)
        model = build_retinanet(fcfg, device=device, seed=0)
        first = t8[0][1]
        sharpen_cls_head(model, prepare_images(torch.from_numpy(first.images).to(device),
                                               torch.from_numpy(first.img_shapes), fcfg))
        scores, row = {}, {}
        for b, triples in ((BATCH, t8), (B64, t64)):
            score_pool(model, fcfg, triples[:1], n, device=device)  # warm-up at this shape
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launches()
            t0 = time.time()
            unc, _ = score_pool(model, fcfg, triples, n, device=device)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches += read_launches()["fused_bottleneck"]
            peak = torch.cuda.max_memory_allocated(device)
            if not np.isfinite(unc).all() or not (unc > 0).any():
                fail(f"batch {b}, fused {fused}: scores not finite or all 0")
            scores[b] = unc
            steps = {o: make_eval_step(model, fcfg.for_orientation(o), device=device)
                     for o in ("landscape", "portrait")}
            steps["landscape"](upload(triples[0][1], device))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launches()
            t0 = time.time()
            results = []
            for o, bt, _ in triples:
                results += detections_to_per_class(steps[o](upload(bt, device)),
                                                   cfg.num_classes, batch_valid=bt.valid)
            ewall = time.time() - t0
            launches += read_launches()["fused_bottleneck"]
            epeak = torch.cuda.max_memory_allocated(device)
            order = np.concatenate([i for *_, i in triples])
            by_image = [results[j] for j in np.argsort(order)]
            row[b] = dict(pool_img_per_s=n / wall, pool_peak_mem_bytes=peak,
                          eval_img_per_s=n / ewall, eval_peak_mem_bytes=epeak,
                          detections=sum(len(a) for img in by_image for a in img),
                          mAP_synthetic_gt=eval_map(by_image, gts)["mAP"])
            print(f"batch {b}, fused {fused}:", json.dumps(row[b]), f"[{card}]", flush=True)
        a, b8 = scores[B64], scores[BATCH]
        off = np.nonzero(((a == 0) != (b8 == 0)) | ~np.isclose(a, b8, rtol=B64_RTOL, atol=0))[0]
        flips = [decision_flip(model, fcfg, t8, t64, int(i), device) for i in off]
        if len(flips) > B64_MAX_FLIPS:
            fail(f"fused {fused}: {len(flips)} images off batch 8's scores by more than "
                 f"rtol {B64_RTOL}: {flips}")
        out["fused" if fused else "unfused"] = dict(
            batch_8=row[BATCH], batch_64=row[B64], nonzero=int((a > 0).sum()),
            max_rel_diff_b64_vs_b8=float(np.max(np.abs(a - b8) / np.maximum(b8, 1e-30))),
            mAP_diff_b64_vs_b8=row[B64]["mAP_synthetic_gt"] - row[BATCH]["mAP_synthetic_gt"],
            images_off_by_a_decision_flip=flips)
        del model
        torch.cuda.empty_cache()
    return dict(images=n, **out), launches


# --- the NMS fixpoint's host syncs (ops/nms.py CHECK_INTERVAL) -----------------------

def nms_sync_path(model, cfg, triple, device):
    """One landscape Entropy_NMS score step, profiled, with the fixpoint
    checked after every map application (the loop before CHECK_INTERVAL)
    and every CHECK_INTERVAL applications: wall against device time, and
    the host syncs the loop made; the two steps' scores must be equal."""
    from aod_meh_hua_torch.engine.score import make_score_step
    from aod_meh_hua_torch.ops import nms

    orientation, batch, _ = triple
    step = make_score_step(model, cfg.for_orientation(orientation), device=device)
    up = upload(batch, device)
    real_check, interval = nms._converged, nms.CHECK_INTERVAL
    out, scores = {}, {}
    for name, k in (("every_application", 1), ("interval", interval),
                    ("interval_again", interval), ("every_application_again", 1)):
        checks = []

        def counted(prev, keep):
            checks.append(1)
            return real_check(prev, keep)

        nms.CHECK_INTERVAL = k
        with mock.patch.object(nms, "_converged", counted):
            step(up)[0].cpu()
            checks.clear()
            scores[name] = step(up)[0].cpu().numpy()
            syncs = len(checks)
            prof = profile_device(lambda: step(up)[0].cpu())
        nms.CHECK_INTERVAL = interval
        out[name] = dict(check_interval=k, host_syncs_in_the_fixpoint=syncs,
                         wall_ms=prof.get("wall_ms"), device_busy_ms=prof.get("device_busy_ms"),
                         device_busy_share=prof.get("device_busy_share"))
    if not all(np.array_equal(v, scores["interval"]) for v in scores.values()):
        fail(f"NMS: the scores depend on the check interval: {scores}")
    return out


# --- SSD300: training, scoring, eval at full width -------------------------------

SSD_POOL, SSD_BATCH = 128, 64
SSD_FG_LOGIT_STD = 3.0


def sharpen_ssd_fg(model, images) -> None:
    """Scale the foreground rows of every level's cls conv (channel
    a * (C + 1) + c, c < C) so that the foreground logits on `images`
    have a std of SSD_FG_LOGIT_STD; the background column stays as it
    is. Random weights give a near-uniform softmax over the 21 columns
    (0.048), under the 0.3 gates; scaling every column alike would leave
    the background's share as it is."""
    import torch

    c1 = model.cfg.num_classes + 1
    with torch.no_grad():
        cls = model(images)[0]
        scale = SSD_FG_LOGIT_STD / cls[..., :-1].std().item()
        for seq in model.bbox_head.cls_convs:
            conv = seq[0]
            fg = (torch.arange(conv.out_channels, device=conv.weight.device) % c1) < c1 - 1
            conv.weight[fg] *= scale
            conv.bias[fg] *= scale


def synthetic_ssd_pool(n, b, seed=0):
    """(orientation, EvalBatch, indices) triples of n seeded uint8 300x300
    canvases (30-pixel cells of random colour plus noise; the exact warp
    fills the canvas) with the scale factors of 500x375 and 375x500
    originals, in batches of b, the last one padded."""
    from aod_meh_hua_torch.engine.batch import EvalBatch

    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (n, 10, 10, 3)).astype(np.uint8)
    imgs = coarse.repeat(30, axis=1).repeat(30, axis=2)
    imgs = np.clip(imgs.astype(np.int16) + rng.randint(-20, 21, imgs.shape), 0, 255)
    imgs = imgs.astype(np.uint8)
    shapes = np.full((n, 2), 300, np.int32)
    sfs = np.array([[0.6, 0.8, 0.6, 0.8] if i % 2 else [0.8, 0.6, 0.8, 0.6] for i in range(n)],
                   np.float32)
    triples = []
    for i in range(0, n, b):
        k = min(b, n - i)
        rows = np.r_[np.arange(i, i + k), np.full(b - k, i + k - 1)]
        triples.append(("landscape", EvalBatch(imgs[rows], shapes[rows], sfs[rows],
                                               np.arange(b) < k), np.arange(i, i + k)))
    return triples


def ssd_train_batch(cfg, b, seed):
    """A Batch of b seeded normalised float 300x300 images (as the augment
    chain's output reaches the step) with 1..5 boxes each."""
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.ops.anchors import anchor_valid_flags

    rng = np.random.RandomState(seed)
    s = cfg.input_size
    coarse = rng.uniform(-120, 130, (b, 10, 10, 3)).astype(np.float32)
    imgs = coarse.repeat(s // 10, axis=1).repeat(s // 10, axis=2)
    g = cfg.max_gt
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int64)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, 6)):
            bw, bh = rng.uniform(0.1, 0.6, 2) * s
            x1, y1 = rng.uniform(0, s - bw), rng.uniform(0, s - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, j] = rng.randint(0, cfg.num_classes)
            valid[i, j] = True
    shapes = np.full((b, 2), s, np.int32)
    av = anchor_valid_flags(cfg.build_anchor_generator(), cfg.featmap_sizes(), shapes)
    return Batch(imgs, boxes, labels, valid, av, shapes)


def ssd_tcfg():
    """The SSD CLI's TrainConfig (tools/train_ssd.py)."""
    from aod_meh_hua_torch.utils.config import TrainConfig

    return TrainConfig(batch_size=8, outer_epoch=2, epoch_ratio=(5, 1), lr_step_epoch=1,
                       warmup_iters=500, warmup_ratio=1e-3)


def warmup_lr(tcfg, k):
    """The driver's linear warmup at iteration k (al/loop.py)."""
    if k >= tcfg.warmup_iters:
        return tcfg.lr
    return tcfg.lr * (1 - (1 - k / tcfg.warmup_iters) * (1 - tcfg.warmup_ratio))


def ssd_train_path(device):
    """SSDConfig() (VGG16, 8732 anchors) with the SSD CLI's TrainConfig:
    2 warm-up and 10 timed steps at batch 8 on one seeded batch, the lr
    following the CLI's warmup; losses finite and falling, and some
    parameter of the backbone, the neck and each head branch moved (SSD
    freezes nothing; a level without a positive anchor or with its ReLUs
    all off gets no gradient, and the warmup's small steps may round
    away)."""
    import torch
    from aod_meh_hua_torch.engine.train import (create_train_state, make_train_step,
                                                set_learning_rate)
    from aod_meh_hua_torch.models.ssd_detector import build_ssd
    from aod_meh_hua_torch.utils.config import SSDConfig

    cfg, tcfg = SSDConfig(), ssd_tcfg()
    model = build_ssd(cfg, device=device, seed=0)
    opt = create_train_state(model, tcfg, frozen_stages=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = ssd_train_batch(cfg, tcfg.batch_size, seed=5)
    batch = type(batch)(*(torch.from_numpy(a).to(device) for a in batch))
    step = make_train_step(model, cfg, opt, device=device)

    def run(k):
        set_learning_rate(opt, warmup_lr(tcfg, k))
        return step(batch)

    auxes = [run(k) for k in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    auxes += [run(TRAIN_WARMUP + k) for k in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(device)
    traj = {k: [float(a[k]) for a in auxes] for k in LOSS_KEYS}
    for k, v in traj.items():
        if not np.isfinite(v).all():
            fail(f"SSD training: {k} is not finite: {v}")
    if not traj["loss"][-1] < traj["loss"][0]:
        fail(f"SSD training: the loss did not fall: {traj['loss']}")
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    groups = ("backbone.", "neck.", "bbox_head.cls_convs", "bbox_head.reg_convs",
              "bbox_head.L_convs")
    still = [g for g in groups if all(n in unmoved for n in before if n.startswith(g))]
    if still:
        fail(f"SSD training: no parameter of {still} moved")
    prof = profile_device(lambda: float(run(TRAIN_WARMUP + TRAIN_STEPS)["loss"]))
    return dict(batch=tcfg.batch_size, input=cfg.input_size, warmup=TRAIN_WARMUP,
                steps=TRAIN_STEPS, ms_per_step=ms, img_per_s=tcfg.batch_size * 1e3 / ms,
                peak_mem_bytes=peak, loss_trajectory=traj,
                num_pos=[float(a["num_pos"]) for a in auxes], unmoved_params=unmoved,
                profile_of_one_step=prof)


def ssd_card_vs_cpu(device):
    """Two steps of SSDConfig(width_mult=0.125, max_gt=8) from the same
    weights and batch on the card and on the CPU, held together as
    train_card_vs_cpu holds the RetinaNet's. The conv biases start small
    but not zero (as tests/torch_parity.py jax_ssd draws them): from
    zero, a bias's max after two steps is its update alone, and the
    parameter check would read the first conv's bias gradient, a sum
    over 360,000 pixels of +-128, at 1e-4 instead of the update
    check's 1e-3."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
    from aod_meh_hua_torch.models.ssd_detector import build_ssd
    from aod_meh_hua_torch.utils.config import SSDConfig

    cfg, tcfg = SSDConfig(width_mult=0.125, max_gt=8), ssd_tcfg()
    batch = ssd_train_batch(cfg, 4, seed=7)
    gen = torch.Generator().manual_seed(2)
    biases = {n: torch.randn(p.shape, generator=gen) * 0.02
              for n, p in build_ssd(cfg, device="cpu").named_parameters() if n.endswith("bias")}

    def two_steps(dev):
        model = build_ssd(cfg, device=dev, seed=1)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in biases:
                    p.copy_(biases[n])
        initial = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        step = make_train_step(model, cfg, create_train_state(model, tcfg, frozen_stages=0),
                               device=dev)
        losses = [{k: float(v) for k, v in step(batch).items()} for _ in range(2)]
        return losses, {n: (initial[n], p.detach().cpu()) for n, p in model.named_parameters()}

    (cpu_l, cpu_p), (gpu_l, gpu_p) = two_steps("cpu"), two_steps(device)
    loss_err = max(abs(g[k] - c[k]) / abs(c[k]) for c, g in zip(cpu_l, gpu_l) for k in LOSS_KEYS)
    if not loss_err <= TRAIN_RTOL:
        fail(f"SSD training card vs CPU: losses {gpu_l} vs {cpu_l}")
    param_err = update_err = 0.0
    for name, (c0, c) in cpu_p.items():
        g0, g = gpu_p[name]
        scale = max(c.abs().max().item(), 1e-30)
        err = (g - c).abs().max().item() / scale
        param_err = max(param_err, err)
        if err > TRAIN_RTOL:
            fail(f"SSD training card vs CPU: {name} differs by {err} of its max")
        dc, dg = c - c0, g - g0
        tol = UPDATE_RTOL * dc.abs().max().item() + 2 * float(np.finfo(np.float32).eps) * scale
        uerr = (dg - dc).abs().max().item() / tol
        update_err = max(update_err, uerr)
        if uerr > 1.0:
            fail(f"SSD training card vs CPU: the update of {name} is {uerr} of its tolerance off")
    return dict(steps=len(cpu_l), max_rel_loss_err=loss_err, max_param_err_of_max=param_err,
                max_update_err_over_tol=update_err, losses_card=gpu_l, losses_cpu=cpu_l)


def ssd_score_path(device):
    """SSDConfig() with its cls head's foreground sharpened: Entropy_NMS
    through score_pool at batch 64 over SSD_POOL canvases (most must score
    above 0), Entropy_ALL and Entropy_NoNMS on one batch each, and the
    eval step over the pool with its VOC mAP."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.al.uncertainty import score_pool
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.eval import detections_to_per_class, make_eval_step
    from aod_meh_hua_torch.models.ssd_detector import build_ssd
    from aod_meh_hua_torch.utils.config import SSDConfig
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    cfg = SSDConfig()
    model = build_ssd(cfg, device=device, seed=0)
    triples = synthetic_ssd_pool(SSD_POOL, SSD_BATCH)
    first = triples[0][1]
    sharpen_ssd_fg(model, prepare_images(torch.from_numpy(first.images[:8]).to(device),
                                         torch.from_numpy(first.img_shapes[:8]), cfg))
    out = {}
    reset_launches()
    score_pool(model, cfg, triples[:1], SSD_POOL, device=device)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    unc, mconf = score_pool(model, cfg, triples, SSD_POOL, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if not (np.isfinite(unc).all() and np.isfinite(mconf).all()):
        fail("SSD Entropy_NMS: scores not finite")
    nonzero = int((unc > 0).sum())
    if nonzero < SSD_POOL // 2:
        fail(f"SSD Entropy_NMS: only {nonzero} of {SSD_POOL} images scored above 0")
    out["Entropy_NMS"] = dict(batch=SSD_BATCH, images=SSD_POOL, img_per_s=SSD_POOL / wall,
                              peak_mem_bytes=torch.cuda.max_memory_allocated(device),
                              nonzero=nonzero, unc_min=float(unc.min()),
                              unc_max=float(unc.max()))
    for pool in ("Entropy_ALL", "Entropy_NoNMS"):
        pcfg = dataclasses.replace(cfg, hua=dataclasses.replace(cfg.hua, pool=pool,
                                                                agg=SCALE_AGG))
        score_pool(model, pcfg, triples[:1], SSD_POOL, device=device)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        u, _ = score_pool(model, pcfg, triples[:1], SSD_POOL, device=device)
        torch.cuda.synchronize()
        pwall = time.time() - t0
        u = u[triples[0][2]]
        if not np.isfinite(u).all() or not (u > 0).any():
            fail(f"SSD {pool}: scores not finite or all 0")
        out[pool] = dict(batch=SSD_BATCH, img_per_s=len(u) / pwall,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(device),
                         nonzero=int((u > 0).sum()))

    step = make_eval_step(model, cfg, device=device)
    step(upload(triples[0][1], device))  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    results = []
    for _, b, _ in triples:
        results += detections_to_per_class(step(upload(b, device)), cfg.num_classes,
                                           batch_valid=b.valid)
    ewall = time.time() - t0
    launches = read_launches()
    if any(launches.values()):
        fail(f"SSD scoring and eval: a hand-written kernel launched: {launches}")
    n_dets = sum(len(a) for img in results for a in img)
    if n_dets == 0 or not all(np.isfinite(a).all() for img in results for a in img):
        fail(f"SSD eval: {n_dets} detections, or not finite")
    gts = []
    rng = np.random.RandomState(3)
    for _ in results:
        k = rng.randint(1, 6)
        xy = rng.uniform(0, 300, (k, 2))
        gts.append({"bboxes": np.concatenate([xy, xy + rng.uniform(20, 150, (k, 2))], 1)
                    .astype(np.float32), "labels": rng.randint(0, cfg.num_classes, k)})
    m = eval_map(results, gts)["mAP"]
    kept = [[a[(a[:, 2] > a[:, 0]) & (a[:, 3] > a[:, 1])] for a in img] for img in results]
    as_gt = [{"bboxes": np.concatenate([a[:, :4] for a in img]),
              "labels": np.concatenate([np.full(len(a), c) for c, a in enumerate(img)])}
             for img in kept]
    m_self = eval_map(kept, as_gt)["mAP"]
    if not (0.0 <= m <= 1.0) or m_self != 1.0:
        fail(f"SSD eval: mAP {m}, with the detections as ground truth {m_self}")
    out["eval"] = dict(batch=SSD_BATCH, img_per_s=SSD_POOL / ewall, detections=n_dets,
                       mAP_synthetic_gt=m, mAP_detections_as_gt=m_self)
    return out, launches


# --- baselines: the deep ensemble and MC dropout (al/baselines.py) --------------------

ENSEMBLE_SEEDS = (0, 1, 2)
ENS_RTOL = 1e-4  # fused members against unfused ones; the card against the CPU
MC_RATE, MC_PASSES = 0.1, 25
FUSED_PER_FORWARD = 5  # R50: layer1_1, layer1_2 (C2) and layer2_1..layer2_3 (C3) fuse


def baselines_path(device):
    """Three full-width RetinaNetConfig(fused_blocks=True) members, seeded
    0, 1 and 2, their cls heads sharpened, score the synthetic pool through
    score_pool_ensemble at batch 8 (FUSED_PER_FORWARD launches per member
    forward); one batch through the same members unfused gives the same
    scores to ENS_RTOL. Then score_pool_mc_dropout (MC_RATE, MC_PASSES) on
    one batch of each orientation: no block fuses (a block with dropout
    is not eligible, the JAX model's rule), the same CUDA generator seed
    gives the same scores bit for bit (deterministic cuDNN), and rate 0
    gives 0. Returns (result, ensemble launches, MC launches)."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.al.baselines import (make_ensemble_score_step,
                                                make_mc_dropout_score_step,
                                                score_pool_ensemble, score_pool_mc_dropout)
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    cfg = RetinaNetConfig(fused_blocks=True)
    triples, n = synthetic_pool(cfg)
    o0, b0, idx0 = triples[0]
    images0 = prepare_images(torch.from_numpy(b0.images).to(device),
                             torch.from_numpy(b0.img_shapes).to(device), cfg)
    members = []
    for seed in ENSEMBLE_SEEDS:
        m = build_retinanet(cfg, device=device, seed=seed)
        sharpen_cls_head(m, images0)
        members.append(m)
    score_pool_ensemble(members, cfg, triples[:1], n, device=device)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    unc = score_pool_ensemble(members, cfg, triples, n, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    ens_launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device)
    forwards = len(triples) * len(members)
    if ens_launches != {"fused_bottleneck": FUSED_PER_FORWARD * forwards, "transposed_matmul": 0}:
        fail(f"ensemble: launches {ens_launches} for {forwards} member forwards")
    if unc.shape != (n,) or not np.isfinite(unc).all() or not (unc > 0).all():
        fail(f"ensemble: scores not finite and positive: {unc}")

    plain_cfg = dataclasses.replace(cfg, fused_blocks=False)
    plain = []
    for m in members:
        p = build_retinanet(plain_cfg, device=device)
        p.load_state_dict(m.state_dict())
        plain.append(p)
    want = make_ensemble_score_step(plain, plain_cfg.for_orientation(o0), device=device)(
        upload(b0, device)).cpu().numpy()[: len(idx0)]
    del plain
    got = unc[idx0]
    ens_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not np.allclose(got, want, rtol=ENS_RTOL, atol=0):
        fail(f"ensemble: fused scores {got} vs unfused {want}")

    # rate 0: identical passes, MI 0
    gen = torch.Generator(device=device).manual_seed(0)
    zero = make_mc_dropout_score_step(members[0], cfg.for_orientation(o0), 4, device=device)(
        upload(b0, device), gen).cpu().numpy()
    if not np.abs(zero).max() <= 1e-5:
        fail(f"MC dropout at rate 0 scored {zero}, not 0")

    mc_cfg = dataclasses.replace(cfg, mc_dropout=MC_RATE)
    mc = build_retinanet(mc_cfg, device=device)
    mc.load_state_dict(members[0].state_dict())
    del members
    torch.cuda.empty_cache()
    two = [next(t for t in triples if t[0] == o) for o in ("landscape", "portrait")]
    idx = np.concatenate([i for *_, i in two])
    runs, walls, mc_launches = [], [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            gen = torch.Generator(device=device).manual_seed(0)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            u = score_pool_mc_dropout(mc, mc_cfg, two, n, gen, MC_PASSES, device=device)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            mc_launches.append(read_launches())
            runs.append(u[idx])
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    mc_launches = add_launches(*mc_launches)
    if any(mc_launches.values()):
        fail(f"MC dropout: launches {mc_launches}; no block with dropout fuses")
    if not np.array_equal(runs[0], runs[1]):
        fail(f"MC dropout: one generator seed gave {runs[0]} and {runs[1]}")
    if not (np.isfinite(runs[0]).all() and (runs[0] > 0).all()):
        fail(f"MC dropout: scores not finite and positive: {runs[0]}")
    del mc
    torch.cuda.empty_cache()
    result = dict(
        ensemble=dict(members=len(ENSEMBLE_SEEDS), images=n, batch=BATCH,
                      member_forwards=forwards, launches=ens_launches, seconds=wall,
                      img_per_s=n / wall, peak_mem_bytes=peak, unc_min=float(unc.min()),
                      unc_max=float(unc.max()),
                      max_rel_err_fused_vs_unfused_first_batch=ens_rel),
        mc_dropout=dict(rate=MC_RATE, passes=MC_PASSES, images=len(idx), batches=len(two),
                        forwards=len(two) * MC_PASSES, launches=mc_launches,
                        seconds=walls, img_per_s=len(idx) / min(walls),
                        unc_min=float(runs[0].min()), unc_max=float(runs[0].max()),
                        bit_reproducible=True, rate_0_max_abs=float(np.abs(zero).max())))
    return result, ens_launches, mc_launches


def baselines_card_vs_cpu(device):
    """tiny_test_config()'s ensemble step (three seeded members, heads
    sharpened on the CPU) and MC step at rate 0, on the card and on the
    CPU from the same weights and batch: the ensemble to ENS_RTOL, the MC
    step (0 up to rounding) to 1e-6."""
    import torch
    from aod_meh_hua_torch.al.baselines import make_ensemble_score_step, make_mc_dropout_score_step
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import tiny_test_config

    cfg = tiny_test_config()
    triples, _ = synthetic_pool(cfg, seed=5, pool={"landscape": 2}, batch=2)
    batch = triples[0][1]
    cpu_members = [build_retinanet(cfg, device="cpu", seed=s) for s in (1, 2, 3)]
    images = prepare_images(torch.from_numpy(batch.images), torch.from_numpy(batch.img_shapes),
                            cfg)
    for m in cpu_members:
        sharpen_cls_head(m, images)
    out = {}
    for dev in ("cpu", device):
        members = cpu_members if dev == "cpu" else [
            build_retinanet(cfg, device=dev).requires_grad_(False) for _ in cpu_members]
        if dev != "cpu":
            for m, src in zip(members, cpu_members):
                m.load_state_dict(src.state_dict())
        ens = make_ensemble_score_step(members, cfg, device=dev)(upload(batch, dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        mc0 = make_mc_dropout_score_step(members[0], cfg, 3, device=dev)(upload(batch, dev), gen)
        out[str(dev)] = (ens.cpu().numpy(), mc0.cpu().numpy())
    (e_cpu, m_cpu), (e_gpu, m_gpu) = out["cpu"], out[str(device)]
    if not (e_cpu > 0).all() or not np.allclose(e_gpu, e_cpu, rtol=ENS_RTOL, atol=0):
        fail(f"ensemble card vs CPU: {e_gpu} vs {e_cpu}")
    if not np.allclose(m_gpu, m_cpu, rtol=0, atol=1e-6):
        fail(f"MC step at rate 0, card vs CPU: {m_gpu} vs {m_cpu}")
    return dict(ensemble_cpu=e_cpu.tolist(), ensemble_card=e_gpu.tolist(),
                ensemble_max_rel_err=float(np.max(np.abs(e_gpu - e_cpu) / e_cpu)),
                mc_rate_0_cpu=m_cpu.tolist(), mc_rate_0_card=m_gpu.tolist())


# --- the semi-supervised steps (engine/ssl.py, engine/self_ssl.py) -------------------

SSL_WARMUP, SSL_STEPS = 2, 5
SSL_R1_RTOL = 1e-5  # the step's loss_cls against the levels' cR1-pinned values


def ssl_path(device):
    """make_pseudo_train_step on a full-width RetinaNetConfig() (unfused, as
    training needs) at batch 2, its cls head sharpened so that anchors pass
    the 0.5 softmax gate and propose pseudo boxes: the cR1 check first
    (the loss's loss_cls is the sum over levels of loss_bbox's value where
    both terms are > 0, of the cls value elsewhere, and loss_bbox the sum
    of the levels'), then 2 + SSL_STEPS timed steps with finite losses,
    each from the sharpened weights (restored before it: one SGD step
    takes the head below the gate, and the steps are timed with pseudo
    boxes in play; the restore, a device copy of the weights, is inside
    the timing); then one make_self_ssl_loss_fn forward and backward,
    timed. Returns (result, launches)."""
    import torch
    from aod_meh_hua_torch.engine.batch import Batch, prepare_images
    from aod_meh_hua_torch.engine.self_ssl import make_self_ssl_loss_fn
    from aod_meh_hua_torch.engine.ssl import (make_pseudo_loss_fn, make_pseudo_train_step,
                                             pseudo_level_loss)
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import RetinaNetConfig, TrainConfig

    cfg, tcfg = RetinaNetConfig(), TrainConfig()
    model = build_retinanet(cfg, device=device, seed=0)
    lcfg, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, seed=5)
    batch = train_batch_for(cfg, batch)
    batch = type(batch)(*(torch.from_numpy(a).to(device) for a in batch))
    images = prepare_images(batch.images, batch.img_shapes, lcfg)
    sharpen_cls_head(model, images)

    loss_fn, anchors_host = make_pseudo_loss_fn(model, lcfg)
    anchors = torch.from_numpy(anchors_host).to(device)
    with torch.no_grad():
        _, aux = loss_fn(batch, anchors)
        cls, reg, _ = model(images)
        num = aux["num_pos"]
        levels = []
        for s0, s1 in lcfg.level_bounds():
            lc, lb, _ = pseudo_level_loss(lcfg, cls[:, s0:s1], reg[:, s0:s1], anchors[s0:s1],
                                          batch.anchor_valid[:, s0:s1], 0.5, 0.5, 100)
            levels.append((float(lc / num), float(lb / num)))
    pinned = [c > 0 and b > 0 for c, b in levels]
    want_cls = sum(b if p else c for (c, b), p in zip(levels, pinned))
    want_bbox = sum(b for _, b in levels)
    got_cls, got_bbox = float(aux["loss_cls"]), float(aux["loss_bbox"])
    if not any(pinned):
        fail(f"SSL: no level has both pseudo terms > 0: {levels}")
    if not (abs(got_cls - want_cls) <= SSL_R1_RTOL * want_cls
            and abs(got_bbox - want_bbox) <= SSL_R1_RTOL * want_bbox):
        fail(f"SSL cR1: loss_cls {got_cls} / loss_bbox {got_bbox} against the levels' "
             f"{want_cls} / {want_bbox} ({levels})")

    step = make_pseudo_train_step(model, lcfg, create_train_state(model, tcfg), device=device)
    sharpened = {k: v.clone() for k, v in model.state_dict().items()}

    def restored_step():
        model.load_state_dict(sharpened)
        return step(batch)

    reset_launches()
    auxes = [restored_step() for _ in range(SSL_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    auxes += [restored_step() for _ in range(SSL_STEPS)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SSL_STEPS
    peak = torch.cuda.max_memory_allocated(device)
    traj = {k: [float(a[k]) for a in auxes] for k in LOSS_KEYS}
    for k, v in traj.items():
        if not np.isfinite(v).all():
            fail(f"SSL: {k} is not finite: {v}")
    if not all(b > 0 for b in traj["loss_bbox"]):
        fail(f"SSL: a timed step had no pseudo box: {traj['loss_bbox']}")

    model.zero_grad(set_to_none=True)
    self_loss = make_self_ssl_loss_fn(model, lcfg)
    self_loss(images[:1]).backward()  # warm-up
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.time()
    value = self_loss(images[:1])
    value.backward()
    torch.cuda.synchronize()
    self_ms = (time.time() - t0) * 1e3
    grad = model.head.retina_cls.weight.grad
    if not (torch.isfinite(value) and grad is not None and torch.isfinite(grad).all()
            and grad.abs().max() > 0):
        fail(f"self-SSL: loss {float(value)} or its gradient is not finite and non-zero")
    launches = read_launches()
    if any(launches.values()):
        fail(f"SSL: a hand-written kernel launched on the training path: {launches}")
    result = dict(batch=tcfg.batch_size, canvas=list(lcfg.canvas), warmup=SSL_WARMUP,
                  steps=SSL_STEPS, ms_per_step=ms, peak_mem_bytes=peak, loss_trajectory=traj,
                  levels_cls_bbox=levels, levels_pinned=pinned,
                  self_ssl=dict(batch=1, loss=float(value), forward_backward_ms=self_ms),
                  launches=launches)
    del model, step
    return result, launches


# --- the inference API (api.py) on the fixture JPEGs ------------------------------

API_RTOL = 1e-4  # predict_batch against single calls, but for a flipped decision


def _chunks(samples, max_batch):
    """Detector.predict_batch's chunks: (orientation, input indices)."""
    by_orient = {}
    for i, s in enumerate(samples):
        by_orient.setdefault(s["orientation"], []).append(i)
    return [(o, idxs[lo:lo + max_batch]) for o, idxs in by_orient.items()
            for lo in range(0, len(idxs), max_batch)]


def _same(a, b, rtol, atol=1e-4) -> bool:
    return len(a) == len(b) and all(x.shape == y.shape and np.allclose(x, y, rtol=rtol, atol=atol)
                                    for x, y in zip(a, b))


def api_path(device):
    """init_detector(RetinaNetConfig(fused_blocks=True)) and a Detector, its
    cls head sharpened, on the fixture JPEGs decoded by the port's decoder:
    __call__ per image, predict_batch(max_batch=8) held to the single calls
    (API_RTOL, or a flipped decision as the batch-64 check allows), and the
    six columns of with_uncertainty, whose first five are the five-column
    results. Launches: FUSED_PER_FORWARD per forward of each run."""
    import torch
    from aod_meh_hua_torch.api import Detector, init_detector, inference_detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import prepare_sample
    from aod_meh_hua_torch.engine.batch import EvalBatch, prepare_images
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    cfg = RetinaNetConfig(fused_blocks=True)
    model = init_detector(cfg, seed=0, device=device)
    det = Detector(cfg, model)
    imgs = [imread(str(p)) for p in sorted(FIXTURES.glob("*.jpg"))]
    samples = [prepare_sample(i, None, det.pipeline, flip=False) for i in imgs]
    s0 = samples[0]
    ocfg = cfg.for_orientation(s0["orientation"])
    sharpen_cls_head(model, prepare_images(torch.from_numpy(s0["image"][None]).to(device),
                                           torch.from_numpy(s0["img_shape"][None]).to(device),
                                           ocfg))
    for o in {s["orientation"] for s in samples}:  # warm-up per orientation
        det(imgs[next(i for i, s in enumerate(samples) if s["orientation"] == o)])
    torch.cuda.synchronize()
    reset_launches()
    singles, ms = [], []
    for img in imgs:
        t0 = time.time()
        singles.append(det(img))  # host arrays: the call waits for the card
        ms.append((time.time() - t0) * 1e3)
    single_launches = read_launches()
    if inference_detector(det, imgs[:1])[0][0].shape != singles[0][0].shape:
        fail("inference_detector on a list differs from the single call")

    chunks = _chunks(samples, 8)
    det.predict_batch(imgs, max_batch=8)  # warm-up at batch 8
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    batched = det.predict_batch(imgs, max_batch=8)
    batch_s = time.time() - t0
    batch_launches = read_launches()
    flips = []
    for i, (a, b) in enumerate(zip(batched, singles)):
        if _same(a, b, API_RTOL):
            continue
        o, chunk = next(c for c in chunks if i in c[1])
        rows = chunk + [chunk[0]] * (8 - len(chunk))

        def triple(ids, b):
            st = lambda k: np.stack([samples[j][k] for j in ids])  # noqa: E731
            return [(o, EvalBatch(st("image"), st("img_shape"), st("scale_factor"),
                                  np.arange(len(ids)) < b), np.array(ids[:b]))]

        flips.append(decision_flip(model, cfg, triple([i], 1), triple(rows, len(chunk)), i,
                                   device, what="predict_batch"))
    if len(flips) > B64_MAX_FLIPS:
        fail(f"predict_batch: {len(flips)} images off the single calls: {flips}")

    udet = Detector(cfg, model, with_uncertainty=True)
    for o in {s["orientation"] for s in samples}:
        udet(imgs[next(i for i, s in enumerate(samples) if s["orientation"] == o)])
    torch.cuda.synchronize()
    reset_launches()
    unc = [udet(img) for img in imgs]
    unc_launches = read_launches()
    for u, s in zip(unc, singles):
        if not all(x.shape[1] == 6 and np.isfinite(x).all() for x in u):
            fail("with_uncertainty: not six finite columns")
        if not _same([x[:, :5] for x in u], s, rtol=1e-5, atol=1e-5):
            fail("with_uncertainty: the first five columns differ from the plain results")
    n_dets = sum(len(a) for r in singles for a in r)
    if n_dets == 0 or not all(np.isfinite(a).all() for r in singles for a in r):
        fail(f"Detector: {n_dets} detections, or not finite")
    forwards = {"call": len(imgs), "predict_batch": len(chunks), "with_uncertainty": len(imgs)}
    for name, k in (("call", single_launches), ("predict_batch", batch_launches),
                    ("with_uncertainty", unc_launches)):
        if k != {"fused_bottleneck": FUSED_PER_FORWARD * forwards[name], "transposed_matmul": 0}:
            fail(f"Detector {name}: launches {k} for {forwards[name]} forwards")
    launches = add_launches(single_launches, batch_launches, unc_launches)
    result = dict(images=len(imgs), orientations=sorted({s["orientation"] for s in samples}),
                  call_ms=ms, call_ms_mean=float(np.mean(ms)),
                  predict_batch=dict(max_batch=8, forwards=len(chunks), seconds=batch_s,
                                     img_per_s=len(imgs) / batch_s),
                  detections=n_dets, off_by_a_decision_flip=flips,
                  unc_max=float(max((x[:, 5].max() for u in unc for x in u if len(x)),
                                    default=0.0)),
                  forwards=forwards, launches=launches)
    del model, det, udet
    return result, launches


# --- the pool-scoring CLI and the ensemble AL CLI ---------------------------------

SCORE_POOL_METHODS = ("hua", "random", "numobj", "ensemble", "mcdropout")


def voc_object_counts(voc07: Path) -> np.ndarray:
    """Non-difficult objects per trainval image, read from the XML (the
    dataset puts difficult ones among the ignored)."""
    import xml.etree.ElementTree as ET

    ids = (voc07 / "ImageSets/Main/trainval.txt").read_text().split()
    counts = []
    for img_id in ids:
        root = ET.parse(voc07 / "Annotations" / f"{img_id}.xml").getroot()
        counts.append(sum(int(o.findtext("difficult", "0")) == 0 for o in root.iter("object")))
    return np.array(counts, np.float64)


def score_pool_cli_path(device, voc07: Path) -> dict:
    """python -m aod_meh_hua_torch.tools.score_pool's main, in process, on
    the AL phase's tree, with each method: three checkpoints written from
    seeded full-width inits (cls heads sharpened) for ensemble, one for the
    others, --passes MC_PASSES for mcdropout. numobj must equal the tree's
    object counts and random the seeded permutation; the score sweeps must
    be finite and not all 0. The CLI's numerics flags are checked as the
    AL phases check them. No block fuses (the CLI's config, as JAX's, has
    fused_blocks off)."""
    import contextlib
    import io
    import re

    import torch
    from aod_meh_hua_torch.api import _default_pipeline
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import prepare_sample
    from aod_meh_hua_torch.engine import checkpoint
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.tools import score_pool
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    root = REPO / "build" / "chip_smoke_score_pool"
    shutil.rmtree(root, ignore_errors=True)
    cfg = RetinaNetConfig()
    first = sorted((voc07 / "JPEGImages").glob("*.jpg"))[0]
    s = prepare_sample(imread(str(first)), None, _default_pipeline(cfg), flip=False)
    images = prepare_images(torch.from_numpy(s["image"][None]).to(device),
                            torch.from_numpy(s["img_shape"][None]).to(device),
                            cfg.for_orientation(s["orientation"]))
    ckpts = []
    for seed in ENSEMBLE_SEEDS:
        m = build_retinanet(cfg, device=device, seed=seed)
        sharpen_cls_head(m, images)
        ckpts.append(checkpoint.save_checkpoint(str(root / f"member{seed}.pt"), m.state_dict()))
    del m
    counts = voc_object_counts(voc07)
    n = len(counts)
    out, launches = {}, []
    for method in SCORE_POOL_METHODS:
        argv = ["--voc07", str(voc07), "--method", method, "--out", str(root / f"{method}.npy"),
                "--checkpoint", *(ckpts if method == "ensemble" else ckpts[:1]),
                "--passes", str(MC_PASSES)]
        printed = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            unc, flags = run_cli(score_pool.main, argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        k = read_launches()
        launches.append(k)
        lines = printed.getvalue().splitlines()
        rate = re.search(r"\(([0-9.]+) img/s\)", lines[-2])
        if not (lines[-2].startswith(f"scored {n} images with {method}") and rate
                and lines[-1].startswith("stats: zeros=")):
            fail(f"score_pool {method}: printed {lines[-2:]}")
        if unc.shape != (n,) or not np.isfinite(unc).all():
            fail(f"score_pool {method}: scores of shape {unc.shape}, or not finite")
        if method == "numobj" and not np.array_equal(unc, counts):
            fail(f"score_pool numobj: {unc} against the tree's counts {counts}")
        if method == "random" and not np.array_equal(unc, np.random.RandomState(20).permutation(n)):
            fail(f"score_pool random: {unc} is not the seeded permutation")
        if method in ("hua", "ensemble", "mcdropout") and not (unc > 0).any():
            fail(f"score_pool {method}: every image scored 0")
        if any(k.values()):
            fail(f"score_pool {method}: a hand-written kernel launched: {k}")
        out[method] = dict(images=n, sweep_img_per_s=float(rate.group(1)), wall_s=wall,
                           nonzero=int((unc > 0).sum()), launches=k)
    return dict(argv_common=["--voc07", str(voc07)], passes=MC_PASSES, numerics_flags=flags,
                methods=out), add_launches(*launches)


def al_ensemble_path(device, voc07: Path) -> dict:
    """The RetinaNet CLI with --baseline ensemble --ensemble-size 3, in
    process, at full width, on the AL phase's tree and under its cuts, for
    two cycles: the members train on the card, the pool is scored by their
    MI, X_L grows by x_s_size and Unc_1 is finite and not all 0. Training
    runs unfused: no kernel launches."""
    import torch
    from aod_meh_hua_torch.tools import train_retinanet
    from aod_meh_hua_torch.utils import config as config_module
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    root = REPO / "build" / "chip_smoke_al_ensemble"
    shutil.rmtree(root, ignore_errors=True)
    work = root / "work"
    argv = ["--voc07", str(voc07), "--work-dir", str(work), "--cycles", "2",
            "--ckpt-interval", "1", "--score-batch-size", "8", "--zero-rate", "0.15",
            "--baseline", "ensemble", "--ensemble-size", "3"]
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    with mock.patch.object(config_module, "TrainConfig",
                           with_cuts(config_module.TrainConfig, AL_TRAIN)), \
            mock.patch.object(config_module, "ALConfig",
                              with_cuts(config_module.ALConfig, AL_AL)):
        driver, flags = run_cli(train_retinanet.main, argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device)
    if (driver.baseline, driver.ensemble_size) != ("ensemble", 3):
        fail(f"ensemble AL: the driver ran baseline {driver.baseline}, {driver.ensemble_size}")
    full = RetinaNetConfig()
    if (driver.cfg.canvas, driver.cfg.block_counts) != (full.canvas, full.block_counts) or \
            [m["cycle"] for m in driver.metrics] != [0, 1]:
        fail(f"ensemble AL: canvas {driver.cfg.canvas}, cycles {driver.metrics}")
    x_l0, x_l1 = np.load(work / "X_L_0.npy"), np.load(work / "X_L_1.npy")
    if not (set(x_l0) <= set(x_l1) and len(x_l1) == len(x_l0) + AL_AL["x_s_size"]):
        fail(f"ensemble AL: X_L_0 {x_l0} -> X_L_1 {x_l1}")
    unc = np.load(work / "Unc_1.npy")
    if unc.shape != (AL_TRAINVAL,) or not np.isfinite(unc).all() or not (unc > 0).any():
        fail(f"ensemble AL: Unc_1 {unc}")
    members = [t for t in driver.timings if t["phase"] == "ensemble_member"]
    if [(t["cycle"], t["member"]) for t in members] != [(0, 1), (0, 2)]:
        fail(f"ensemble AL: members trained {members}")
    if any(launches.values()):
        fail(f"ensemble AL: a hand-written kernel launched: {launches}")
    return dict(argv=argv, configs={"train": AL_TRAIN, "al": AL_AL}, wall_s=wall,
                numerics_flags=flags,
                cycles=[{"cycle": t["cycle"], "seconds": t["seconds"]}
                        for t in driver.timings if t["phase"] == "cycle"],
                member_train_s=[t["seconds"] for t in members],
                score_phase_s=[t["seconds"] for t in driver.timings if t["phase"] == "score"],
                metrics=driver.metrics, x_l_0=x_l0.tolist(), x_l_1=x_l1.tolist(),
                unc_1_nonzero=int((unc > 0).sum()), peak_mem_bytes=peak, launches=launches)


# --- serving phase: TTA, the exported program and its archive, the server ----------

SERVE = REPO / "build" / "chip_smoke_serve"
TTA_SCALES = [(1000, 600), (800, 480)]  # the default resize and a smaller one
SERVE_REQUESTS, SERVE_CLIENTS = 32, 16  # two requests per client: the script's time limit
SERVE_SCORE_THR = 0.3
SERVE_MAX_FLIPS = B64_MAX_FLIPS  # replies or images off by a flipped decision
FPS_ITERS, FPS_WARMUP = 10, 2


def _agree(got, want, rtol) -> str:
    """"exact", "close" (to rtol, the same shapes) or "flip" (another count
    of rows in some class: a decision flipped) for two per-class lists."""
    if len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want)):
        return "exact"
    if _same(got, want, rtol):
        return "close"
    return "flip"


def _rows(per_class, classes, thr):
    """The server's reply rows for per-class results (make_handler's rule)."""
    return [{"class_name": classes[c], "bbox": [float(v) for v in r[:4]], "score": float(r[4])}
            for c, dets in enumerate(per_class) for r in dets if float(r[4]) >= thr]


def _rows_agree(got, want, rtol) -> str:
    if got == want:
        return "exact"
    if [r["class_name"] for r in got] == [r["class_name"] for r in want] and all(
            np.allclose(g["bbox"] + [g["score"]], w["bbox"] + [w["score"]], rtol=rtol, atol=1e-4)
            for g, w in zip(got, want)):
        return "close"
    return "flip"


class _Forwards:
    """A detector whose predict_batch calls are counted in forwards (one
    per orientation group of up to max_batch images, as predict_batch and
    ArchiveDetector split them); `sizes` holds each call's image count,
    the Batcher's coalesced batches."""

    def __init__(self, det):
        self.det, self.forwards, self.sizes = det, 0, []
        self.device = det.device

    def predict_batch(self, images, max_batch=8):
        self.sizes.append(len(images))
        per_o = {}
        for im in images:
            o = "landscape" if im.shape[1] / im.shape[0] > 1 else "portrait"
            per_o[o] = per_o.get(o, 0) + 1
        self.forwards += sum(-(-n // max_batch) for n in per_o.values())
        return self.det.predict_batch(images, max_batch=max_batch)


def serve_load(det, payloads, expected, what, per_forward: int = FUSED_PER_FORWARD,
               score_thr: float = SERVE_SCORE_THR, requests: int = SERVE_REQUESTS):
    """`requests` POSTs from SERVE_CLIENTS threads to a server on
    127.0.0.1:0 around `det` (its rows at or above score_thr), raw and
    base64 in turns; each reply held to expected[i % len]. The fused
    kernel must launch per_forward times a forward. Returns latency, rate,
    batches, launches, agreement."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch
    from aod_meh_hua_torch.data.voc import VOC_CLASSES
    from aod_meh_hua_torch.tools.deployment.serve import Batcher, make_handler

    counted = _Forwards(det)
    batcher = Batcher(counted, max_batch=BATCH, delay_ms=5.0)
    handler = make_handler(batcher, VOC_CLASSES, score_thr)
    handler.log_message = lambda *a: None
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predictions"
    lat, agree, errors = [0.0] * requests, [None] * requests, []
    lock = threading.Lock()
    next_req = [0]

    def client():
        while True:
            with lock:
                i = next_req[0]
                next_req[0] += 1
            if i >= requests:
                return
            raw = payloads[i % len(payloads)]
            body = raw if i % 2 == 0 else base64.b64encode(raw)
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(urllib.request.Request(url, data=body,
                                                                   method="POST"),
                                            timeout=300) as r:
                    reply = json.load(r)
            except Exception as e:  # recorded, and the phase fails below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
                continue
            lat[i] = (time.perf_counter() - t0) * 1e3
            agree[i] = _rows_agree(reply, expected[i % len(payloads)], API_RTOL)

    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = read_launches()
        if any(t.is_alive() for t in clients):
            fail(f"{what}: a client did not return within 600 s")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(60)
    if errors:
        fail(f"{what}: {len(errors)} requests failed: {errors[:3]}")
    flips = [i for i, a in enumerate(agree) if a == "flip"]
    if len(flips) > SERVE_MAX_FLIPS:
        fail(f"{what}: {len(flips)} replies differ from the Detector's rows: {flips}")
    if launches["fused_bottleneck"] != per_forward * counted.forwards or \
            counted.forwards == 0:
        fail(f"{what}: launches {launches} for {counted.forwards} forwards")
    return dict(requests=requests, clients=SERVE_CLIENTS, wall_s=wall,
                req_per_s=requests / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), mean_ms=float(np.mean(lat)),
                batches=len(counted.sizes),
                mean_batch=float(np.mean(counted.sizes)), forwards=counted.forwards,
                replies={k: agree.count(k) for k in ("exact", "close", "flip")},
                flipped_requests=flips, rows=sum(len(expected[i % len(payloads)])
                                                 for i in range(requests)),
                launches=launches)


def start_serving_export(device) -> tuple:
    """The serving phase's model, a full-width fused RetinaNet
    (init_detector, seed 0, its cls head sharpened on the first fixture),
    and the subprocess that exports its eval step (start_export_program),
    started before the score_pool CLI phase so that the tracing runs beside
    the CLI phases: (cfg, model, process)."""
    import torch
    from aod_meh_hua_torch.api import Detector, init_detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import prepare_sample
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    shutil.rmtree(SERVE, ignore_errors=True)
    SERVE.mkdir(parents=True)
    cfg = RetinaNetConfig(fused_blocks=True)
    model = init_detector(cfg, seed=0, device=device)
    s0 = prepare_sample(imread(str(sorted(FIXTURES.glob("*.jpg"))[0])), None,
                        Detector(cfg, model).pipeline, flip=False)
    sharpen_cls_head(model, prepare_images(torch.from_numpy(s0["image"][None]).to(device),
                                           torch.from_numpy(s0["img_shape"][None]).to(device),
                                           cfg.for_orientation(s0["orientation"])))
    return cfg, model, start_export_program("retinanet", model, SERVE)


def serving_path(device, voc07: Path, started: tuple) -> tuple:
    """The serving phase (see the module docstring) on start_serving_export's
    model and programs. Returns (result, launches by path)."""
    import dataclasses

    import torch
    from aod_meh_hua_torch.api import Detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.data.pipeline import PipelineConfig, prepare_sample
    from aod_meh_hua_torch.data.voc import VOC_CLASSES, VOCDataset
    from aod_meh_hua_torch.engine.batch import EvalBatch, prepare_images
    from aod_meh_hua_torch.engine.eval import detections_to_per_class, make_eval_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.tools import benchmark
    from aod_meh_hua_torch.tools.deployment import export_model, package_model, test_exported
    from aod_meh_hua_torch.tools.deployment.serve import ArchiveDetector
    from aod_meh_hua_torch.utils.voc_eval import eval_map

    t_phase = time.time()
    cfg, model, export_proc = started
    det = Detector(cfg, model)
    files = sorted(FIXTURES.glob("*.jpg"))
    imgs = [imread(str(p)) for p in files]
    samples = [prepare_sample(i, None, det.pipeline, flip=False) for i in imgs]
    result, launches = {}, {}

    # TTA: identity against __call__, then two scales and the flip
    singles = [det(i) for i in imgs]
    identity = [_agree(det.tta(i, scales=[det.pipeline.img_scale], flip=False), s, 1e-5)
                for i, s in zip(imgs, singles)]
    if "flip" in identity or "close" in identity:
        fail(f"TTA: identity TTA differs from __call__: {identity}")
    for o in ("landscape", "portrait"):  # warm-up of each (scale, orientation)
        det.tta(imgs[next(k for k, s in enumerate(samples) if s["orientation"] == o)],
                scales=TTA_SCALES)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tta = [det.tta(i, scales=TTA_SCALES, flip=True) for i in imgs]
    tta_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    launches["tta"] = read_launches()
    augs = len(TTA_SCALES) * 2
    if launches["tta"]["fused_bottleneck"] != FUSED_PER_FORWARD * augs * len(imgs):
        fail(f"TTA: launches {launches['tta']} for {augs * len(imgs)} forwards")
    if not all(np.isfinite(a).all() for r in tta for a in r) or \
            sum(len(a) for r in tta for a in r) == 0:
        fail("TTA: no detection, or not finite")
    # the same TTA through an unfused twin with the same weights: the
    # kernel at the TTA's shapes, the flips and the merge at full width
    plain = build_retinanet(dataclasses.replace(cfg, fused_blocks=False), device=device)
    plain.load_state_dict(model.state_dict())
    twin = Detector(dataclasses.replace(cfg, fused_blocks=False), plain)
    tta_agree = [_agree(got, twin.tta(i, scales=TTA_SCALES, flip=True), API_RTOL)
                 for i, got in zip(imgs, tta)]
    del twin, plain
    tta_flips = [k for k, a in enumerate(tta_agree) if a == "flip"]
    if len(tta_flips) > SERVE_MAX_FLIPS:
        fail(f"TTA: {len(tta_flips)} images off the unfused twin's TTA: {tta_agree}")
    result["tta"] = dict(scales=TTA_SCALES, flip=True, images=len(imgs), ms_per_image=tta_ms,
                         identity=identity, detections=sum(len(a) for r in tta for a in r),
                         forwards_per_image=augs,
                         against_unfused={k: tta_agree.count(k) for k in ("exact", "close",
                                                                           "flip")},
                         flipped_images=tta_flips)

    # the fused eval step exported at batch 8 in both orientations and saved
    # (start_serving_export's subprocess), packaged and loaded; on the
    # synthetic canvases against the eager step
    exported = finish_export_program(export_proc, "retinanet", SERVE)
    for o, nodes in exported["fused_nodes"].items():
        if nodes != FUSED_PER_FORWARD:
            fail(f"export ({o}): {nodes} fused operator nodes")
    export_s = exported["export_s"]
    paths = {o: str(SERVE / f"retinanet_{o}.pt2") for o in ("landscape", "portrait")}
    t0 = time.time()
    archive = package_model.package(paths["landscape"], str(SERVE), "retinanet_fused",
                                    artifact_portrait=paths["portrait"],
                                    classes=VOC_CLASSES,
                                    geometry=package_model.geometry_for(cfg, BATCH))
    adet = ArchiveDetector(archive)  # its programs here, and behind the server below
    manifest, modules = adet.manifest, adet.programs
    load_s = time.time() - t0
    triples, n_pool = synthetic_pool(cfg)

    def float_batch(o, b):
        up = upload(b, device)
        return EvalBatch(prepare_images(up.images, up.img_shapes, cfg.for_orientation(o)),
                         up.img_shapes, up.scale_factors, b.valid)

    floats = [(o, float_batch(o, b), idx) for o, b, idx in triples]
    steps = {o: make_eval_step(model, cfg.for_orientation(o), device=device)
             for o in modules}
    eager = [steps[o](b) for o, b, _ in floats]
    torch.cuda.synchronize()
    reset_launches()
    exported = [export_model.run_program(modules[o], b) for o, b, _ in floats]
    torch.cuda.synchronize()
    launches["exported"] = read_launches()
    if launches["exported"]["fused_bottleneck"] != FUSED_PER_FORWARD * len(floats):
        fail(f"exported: launches {launches['exported']} for {len(floats)} batches")
    agree = []
    for (o, b, idx), e, x in zip(floats, eager, exported):
        pe = detections_to_per_class(e, cfg.num_classes, batch_valid=b.valid)
        px = detections_to_per_class(x, cfg.num_classes, batch_valid=b.valid)
        agree += [(int(i), _agree(g, w, 1e-4)) for i, g, w in zip(idx, px, pe)]
    flips = [i for i, a in agree if a == "flip"]
    if len(flips) > SERVE_MAX_FLIPS:
        fail(f"exported: {len(flips)} images off the eager step: {flips}")
    timing = {"eager": [], "exported": []}
    for name in ("eager", "exported", "exported", "eager"):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for o, b, _ in floats:
            (steps[o](b) if name == "eager" else export_model.run_program(modules[o], b))
        torch.cuda.synchronize()
        timing[name].append((time.perf_counter() - t0) * 1e3 / len(floats))
    n_dets = sum(int(e.valid.sum()) for e in eager)
    if n_dets == 0:
        fail("exported: the eager step found no detection on the synthetic pool")

    # test_exported's sweep of the AL tree's test split through the loaded
    # programs only, against the eager eval of the same canvases
    reset_launches()
    t0 = time.time()
    swept = test_exported.run([paths["landscape"], "--artifact-portrait", paths["portrait"],
                               "--voc07", str(voc07), "--split", "test", "--batch", str(BATCH)])
    test_exported_s = time.time() - t0
    launches["test_exported"] = read_launches()
    m_exported = swept["mAP"]
    ds = VOCDataset(str(voc07 / "ImageSets" / "Main" / "test.txt"), str(voc07),
                    test_mode=True)
    results, order = [], []
    for o, b, bidx in EvalLoader(ds, np.arange(len(ds)), PipelineConfig(canvas=cfg.canvas),
                                 batch_size=BATCH):
        results += detections_to_per_class(steps[o](b), cfg.num_classes,
                                           batch_valid=np.asarray(b.valid))
        order += bidx.tolist()
    m_eager = eval_map(results, [ds.get_ann_info(i) for i in order], iou_thr=0.5,
                       mode="11points")["mAP"]
    # the sweep's own per-image detections against the eager step's: with
    # random weights both mAPs are near 0, so the mAP alone would not see
    # a dropped image, a swapped orientation or a wrong class count
    if swept["order"] != order:
        fail(f"test_exported: swept images {swept['order']}, the eager loader's {order}")
    swept_agree = [_agree(g, w, 1e-4) for g, w in zip(swept["results"], results)]
    swept_flips = [order[k] for k, a in enumerate(swept_agree) if a == "flip"]
    if len(swept_flips) > SERVE_MAX_FLIPS or sum(len(r) for p in results for r in p) == 0:
        fail(f"test_exported: per image against the eager step {swept_agree}")
    if launches["test_exported"]["fused_bottleneck"] == 0 or not np.isfinite(m_exported) or \
            (not swept_flips and abs(m_exported - m_eager) > 1e-6):
        fail(f"test_exported: mAP {m_exported} against the eager {m_eager}, launches "
             f"{launches['test_exported']}")
    result["exported"] = dict(
        batch=BATCH, fused_nodes=FUSED_PER_FORWARD, export_s=export_s, package_and_load_s=load_s,
        archive_mb=os.path.getsize(archive) / 1e6, manifest_keys=sorted(manifest),
        canvases=n_pool, batches=len(floats), detections=n_dets,
        images={k: [a for _, a in agree].count(k) for k in ("exact", "close", "flip")},
        flipped_images=flips, ms_per_batch=timing, test_exported=dict(
            mAP=m_exported, mAP_eager=m_eager, images=len(ds), seconds=test_exported_s,
            against_eager={k: swept_agree.count(k) for k in ("exact", "close", "flip")},
            flipped_images=swept_flips))

    # the server around the fused Detector, then around the archive
    payloads = [p.read_bytes() for p in files]
    expected = [_rows(r, VOC_CLASSES, SERVE_SCORE_THR)
                for r in (det.predict_batch([i], max_batch=BATCH)[0] for i in imgs)]
    if not any(expected):
        fail(f"serve: no row at or above {SERVE_SCORE_THR} on the fixtures")
    det.predict_batch(imgs, max_batch=BATCH)  # warm-up
    result["serve"] = serve_load(det, payloads, expected, "serve")
    launches["serve"] = result["serve"]["launches"]
    adet.predict_batch(imgs)  # warm-up
    result["serve_archive"] = serve_load(adet, payloads, expected, "serve_archive")
    launches["serve_archive"] = result["serve_archive"]["launches"]
    del adet, modules, steps
    model = det = None
    torch.cuda.empty_cache()

    # the FPS tool at batch 8, fused and unfused (seeded random weights)
    result["benchmark"] = {}
    for name, fused in (("fused", True), ("unfused", False)):
        reset_launches()
        out = benchmark.benchmark(dataclasses.replace(cfg, fused_blocks=fused), batch=BATCH,
                                  iters=FPS_ITERS, warmup=FPS_WARMUP, device=device)
        counts = read_launches()
        want = FUSED_PER_FORWARD * (FPS_ITERS + FPS_WARMUP) if fused else 0
        if counts["fused_bottleneck"] != want:
            fail(f"benchmark ({name}): launches {counts}, not {want}")
        result["benchmark"][name] = out
        if fused:
            launches["benchmark"] = counts
        torch.cuda.empty_cache()
    result["phase_s"] = time.time() - t_phase
    result["launches"] = launches
    return result, launches


# --- Faster R-CNN R50-FPN: the two-stage core of the model zoo -----------------------

FRCNN = REPO / "build" / "chip_smoke_frcnn"
FRCNN_RTOL = 1e-4       # card against CPU detections; the Detector against the eval step
RPN_LOGIT_STD = 1.5     # the sharpened objectness logits, as CLS_LOGIT_STD for the classes
# the eval step's profiler ranges (engine/two_stage.py STAGES) -> the split's groups
FRCNN_GROUPS = {"empirical_attention.gen_attention": "backbone attention blocks",
                "carafe.upsample": "CARAFE kernel prediction and reassembly",
                "libra_rcnn.bfp": "BFP (pools, resizes, non-local block)",
                "groie.fuse": "GRoIE pre-conv and attention",
                "hrnet.hrfpn": "HRFPN resizes, reduction, pools and convs",
                "fpg.neck": "FPG neck (laterals, 9 stages, last convs)",
                "pisa.score_hlr": "PISA no-grad RoI pass and ScoreHLR sampler",
                "cascade_rpn.deform": "Cascade RPN deform conv gathers",
                "cascade_rpn.refine": "Cascade RPN anchor refinement and offsets",
                "trident.branches": "TridentNet stage 3 (three dilations)",
                "grid_rcnn.grid_head": "Grid R-CNN grid head",
                "grid_rcnn.targets": "Grid R-CNN jitter and targets",
                "grid_rcnn.refine": "Grid R-CNN boundary voting",
                "faster_rcnn.stage1": "convolutions (backbone, FPN, RPN head)",
                "faster_rcnn.proposals": "proposal top-k, decode and NMS",
                "faster_rcnn.roi_align": "RoIAlign gathers",
                "faster_rcnn.roi_head": "RoI-head matmuls",
                "cascade_rcnn.refine": "cascade refinement decode",
                "dynamic_rcnn.statistics": "Dynamic R-CNN statistics",
                "double_head_rcnn.roi_align_reg": "RoIAlign gathers, 1.3x regression RoIs",
                "double_head_rcnn.conv_branch": "double head conv branch",
                # prefixes of the autograd engine's and torch.optim's host ops
                "autograd::engine": "backward", "Optimizer.step": "optimizer"}
# proposals of one image the card may keep and the CPU not, or the other way
# round, each named with its largest IoU with a higher one; one of a step's
# must sit within 1e-4 of the RPN's 0.7
FRCNN_MAX_PROPOSAL_FLIPS = 4


def class_logits(model, cfg, feats, props, head: int):
    """The class logits of the model's RoI head `head` on props: the
    cascade's stage `head`, the double head with its rescaled regression
    extraction, Faster (and Dynamic) R-CNN's one head on the features of
    the config's extractor (GRoIE's for that family)."""
    from aod_meh_hua_torch.engine.two_stage import extract_rois, roi_features, scale_rois

    f = roi_features(model, cfg, feats, props)
    if cfg.family == "cascade_rcnn":
        return model.roi_forward(f, head)[0]
    if cfg.family == "grid_rcnn":  # the cls-only head
        return model.roi_forward(f)
    if cfg.family == "double_head_rcnn":
        reg = extract_rois(cfg, feats, scale_rois(props, cfg.reg_roi_scale_factor),
                           routing_rois=props)
        return model.roi_forward(f, reg)[0]
    return model.roi_forward(f)[0]


# Parameters of the Faster R-CNN variants that start at zero where the
# phase reads them: GeneralizedAttention's gamma, key_bias and geom_bias
# (the block is then the identity), drawn from N(0, ATTENTION_STD) (gamma
# from U(0.5, 1) times ATTENTION_STD) so that the attention's arithmetic
# runs on the card; and the BFP's conv biases, from N(0, BFP_BIAS_STD):
# its non-local block's phi bias has no gradient in exact arithmetic (the
# softmax over the keys cancels it), so from zero it holds rounding alone,
# which no tolerance of its own scale can compare; and GN+WS's GroupNorm
# biases, likewise (the stem's gn1.bias after two tiny steps is a sum over
# every stem position of gradients that cancel: 8.3e-4 of its max apart,
# card against CPU, from zero, on an H100)
ATTENTION_STD = 0.5
BFP_BIAS_STD = 0.05


def seed_zero_starts(model, seed: int) -> int:
    """The zero-start parameters of `model`'s attention blocks, BFP,
    GroupNorms and grid head drawn from a CPU generator seeded `seed`, in
    module order; returns the number of attention blocks."""
    import torch
    from aod_meh_hua_torch.models.attention import GeneralizedAttention

    gen = torch.Generator().manual_seed(seed)
    blocks = [m for m in model.modules() if isinstance(m, GeneralizedAttention)]
    with torch.no_grad():
        for m in blocks:
            for name in ("gamma", "key_bias", "geom_bias"):
                p = getattr(m, name, None)
                if p is None:
                    continue
                draw = (torch.rand(p.shape, generator=gen) * 0.5 + 0.5 if name == "gamma"
                        else torch.randn(p.shape, generator=gen))
                p.copy_(draw * ATTENTION_STD)
        for m in (model.bfp.modules() if getattr(model, "bfp", None) is not None else ()):
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * BFP_BIAS_STD)
        for m in model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * BFP_BIAS_STD)
        # Grid R-CNN's conv and deconv biases, zero at init: the GroupNorm
        # after each subtracts most of their gradient (deconv1_4's bias 1.26
        # tolerances apart, card from CPU, after one tiny step from zero on
        # an H100)
        grid = getattr(model, "grid_head", None)
        for m in (grid.modules() if grid is not None else ()):
            if (isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                    and m.bias is not None and not m.bias.any()):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * BFP_BIAS_STD)
    return len(blocks)


def calibrate_frozen_bn(model, cfg, images, img_shapes) -> None:
    """Every frozen BN of the backbone takes its running mean and (biased)
    variance from one forward of `images`, in forward order, each layer
    seeing the calibrated ones before it: the statistics a trained model's
    frozen BN holds, where the identity's let a random HRNet's features
    grow through its 36 blocks and exchange sums until the first train
    step diverges (loss 548.5, then 4.4e11 and NaN, on an H100).
    TridentNet's res5 box head, whose frozen BN follows the backbone's,
    also takes them, from one forward on the test proposals' RoIs: at
    identity statistics its first train step's loss was 77.1, then 3432
    (on an H100)."""
    import torch
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.models.resnet import FrozenBatchNorm2d

    def take(m, args):
        x = args[0]
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    trident = cfg.family == "tridentnet"
    frozen = (model.modules() if trident else model.backbone.modules())
    hooks = [m.register_forward_pre_hook(take) for m in frozen
             if isinstance(m, FrozenBatchNorm2d)]
    try:
        with torch.no_grad():
            feat, cls, reg = model(prepare_images(images, img_shapes, cfg))
            if trident:
                from aod_meh_hua_torch.engine.trident import extract_c4_rois
                from aod_meh_hua_torch.engine.two_stage import anchor_table, make_proposal_fn

                props = make_proposal_fn(cfg)(
                    cls, reg, torch.from_numpy(anchor_table(cfg)).to(cls.device), img_shapes,
                    cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)[0]
                model.roi_forward(extract_c4_rois(cfg, feat, props))
    finally:
        for h in hooks:
            h.remove()


def sharpen_frcnn(model, cfg, images, img_shapes, classes: bool = True) -> None:
    """Scale rpn_cls so that the objectness logits on `images` have a std
    of RPN_LOGIT_STD, and (classes) zero each RoI head's fc_cls bias and
    background row and scale its weight so that the class logits on the
    eval proposals' RoIs have a std of CLS_LOGIT_STD: random heads put
    every objectness near 0.5 (near-ties in the top-k) and every class
    score near 1/21, under the 0.05 score gate, and a head trained a few
    steps from random weights scores the background alone. Any two-stage
    family (the cascade's three heads each)."""
    import torch
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.two_stage import anchor_table, make_proposal_fn

    with torch.no_grad():
        x = prepare_images(images, img_shapes, cfg)
        conv = objectness_conv(model)
        if conv is not None:
            conv.weight.mul_(RPN_LOGIT_STD / model(x)[1].std().item())
        if not classes:
            return
        feats, rpn_cls, rpn_reg = model(x)
        anchors = torch.from_numpy(anchor_table(cfg)).to(rpn_cls.device)
        props = make_proposal_fn(cfg)(rpn_cls, rpn_reg, anchors, img_shapes,
                                      cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)[0]
        for i, head in enumerate(model._roi_heads()):
            head.fc_cls.bias.zero_()
            head.fc_cls.weight[-1].zero_()
            cls = class_logits(model, cfg, feats, props, i)
            head.fc_cls.weight.mul_(CLS_LOGIT_STD / cls.std().item())


def objectness_conv(model):
    """The conv whose output is the model's objectness, the second output of
    its forward (the RPN head's rpn_cls; Cascade RPN's stage-1 s1_cls), or
    None (Fast R-CNN has no RPN)."""
    head = getattr(model, "rpn_head", None)
    return head.rpn_cls if head is not None else getattr(model, "s1_cls", None)


# TridentNet's train gts: its best proposals at least this share of the
# canvas's short side wide and tall (50 px at 608 x 1024)
TRIDENT_GT_SIDE = 1 / 12


def gts_near_proposals(model, cfg, batch):
    """TridentNet's batch (of tensors) with each image's gts its three best
    proposals of branch 0 (the model on the batch) at least TRIDENT_GT_SIDE
    of the canvas wide and tall, each moved by a twentieth of its size:
    its RoI sampler takes no gt as a candidate, and at random weights the
    500 proposals of a step missed every random box at IoU 0.5, and the
    best ones, thin boxes clipped at a border, every box moved by pixels
    (on an H100), where the step's positives are checked."""
    import torch
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.engine.two_stage import anchor_table, make_proposal_fn

    b = batch.images.shape[0]
    with torch.no_grad():
        feat = model.features(prepare_images(batch.images, batch.img_shapes, cfg))
        cls, reg = model.rpn(feat)
        props, _, valid = make_proposal_fn(cfg)(
            cls[:b], reg[:b], torch.from_numpy(anchor_table(cfg)).to(cls.device),
            batch.img_shapes, cfg.rpn.train_nms_pre, cfg.rpn.train_max_per_img)
    gt_boxes, gt_valid = torch.zeros_like(batch.gt_boxes), torch.zeros_like(batch.gt_valid)
    side = min(cfg.canvas) * TRIDENT_GT_SIDE
    for i in range(b):
        wh = props[i, :, 2:] - props[i, :, :2]
        big = valid[i] & (wh >= side).all(-1)
        pick = big.nonzero().flatten()[:3]
        if len(pick) == 0:
            fail(f"tridentnet training: no proposal of {side} px on image {i}")
        box = props[i, pick]
        size = (box[:, 2:] - box[:, :2]).repeat(1, 2)
        gt_boxes[i, :len(pick)] = box + size * torch.tensor([0.05, 0.025, 0.075, 0.05],
                                                            device=box.device)
        gt_valid[i, :len(pick)] = True
    limit = torch.stack([batch.img_shapes[:, 1], batch.img_shapes[:, 0]] * 2, -1)[:, None]
    gt_boxes = torch.minimum(gt_boxes, limit.to(gt_boxes.dtype))
    return batch._replace(gt_boxes=gt_boxes, gt_valid=gt_valid)


def train_batch_for(cfg, batch, seed: int = 0):
    """synthetic_train_batch's Batch as the family's train batch: for Fast
    R-CNN a ProposalBatch whose cfg.num_proposals slots hold four jittered
    copies of each gt, then seeded random boxes inside the image (the last
    eight slots of the last image invalid)."""
    if cfg.family != "fast_rcnn":
        return batch
    from aod_meh_hua_torch.engine.rpn_only import ProposalBatch

    rng = np.random.RandomState(seed + 100)
    b, p = batch.images.shape[0], cfg.num_proposals
    props = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        h, w = batch.img_shapes[i]
        rows = [g + rng.randn(4) * 0.05 * (g[2:] - g[:2]).repeat(2)
                for g in batch.gt_boxes[i][batch.gt_valid[i]] for _ in range(4)]
        while len(rows) < p:
            bw, bh = rng.uniform(0.05, 0.5) * w, rng.uniform(0.05, 0.5) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            rows.append([x1, y1, x1 + bw, y1 + bh])
        props[i] = np.asarray(rows[:p], np.float32)
        props[i, :, 0::2] = np.clip(props[i, :, 0::2], 0, w)
        props[i, :, 1::2] = np.clip(props[i, :, 1::2], 0, h)
    valid = np.ones((b, p), bool)
    valid[-1, -8:] = False
    return ProposalBatch(batch.images, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                         batch.img_shapes, props, valid)


@contextlib.contextmanager
def fixpoint_depths():
    """Record each NMS fixpoint's candidate count and depth (the map
    applications that changed the mask) while inside: the convergence is
    checked after every application (CHECK_INTERVAL 1), which gives the
    same masks (tests/test_torch_ops.py)."""
    from aod_meh_hua_torch.ops import nms

    real_keep, real_check, interval = nms._greedy_keep_sorted, nms._converged, nms.CHECK_INTERVAL
    calls = []

    def keep(off_boxes, cand_ok, iou_thr, device_loop=False):
        checks = []

        def counted(prev, k):
            checks.append(1)
            return real_check(prev, k)

        with mock.patch.object(nms, "_converged", counted):
            out = real_keep(off_boxes, cand_ok, iou_thr, device_loop)
        calls.append({"batch": int(off_boxes.shape[0]), "k": int(off_boxes.shape[1]),
                      "depth": len(checks) - 1})
        return out

    nms.CHECK_INTERVAL = 1
    try:
        with mock.patch.object(nms, "_greedy_keep_sorted", keep):
            yield calls
    finally:
        nms.CHECK_INTERVAL = interval


def profile_stages(fn, groups: dict) -> dict:
    """Device time of one call of `fn` (ending in a host read) split by the
    profiler range each kernel was launched in (the ranges' names ->
    groups, the rest "other"), with profile_device's split by kernel name
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        wall_us = (time.time() - t0) * 1e6
    def group_of(name):
        return next((g for key, g in groups.items() if name.startswith(key)), None)

    by_group = {}
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels or getattr(e, "is_user_annotation", False):
            continue
        parent, group = e, None
        while parent is not None and group is None:
            group = group_of(parent.name)
            parent = parent.cpu_parent
        group = group or "other"
        by_group[group] = by_group.get(group, 0.0) + sum(k.duration for k in kernels)
    busy = sum(by_group.values())
    if busy == 0:
        return {"device_time": "not measured (no kernel was linked to a host op)"}
    names = {}
    for e in prof.key_averages():  # kernels only: not the ranges' spans on the device
        if (str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
                and group_of(e.key) is None):
            g = next((grp for key, grp in KERNEL_GROUPS if key in e.key.lower()), "other")
            names[g] = names.get(g, 0.0) + e.self_device_time_total / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "by_stage_ms": {g: t / 1e3 for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])},
            "by_kernel_name_ms": dict(sorted(names.items(), key=lambda kv: -kv[1]))}


def frcnn_train_path(device, family: str = "faster_rcnn", over: dict = None,
                     steps: int = TRAIN_STEPS, calibrate: bool = False,
                     profile: bool = True) -> dict:
    """The family's full-width config (FasterRCNNConfig(): R50-FPN,
    frozen_stages 1, 3 anchors, RoIAlign 7, 2-fc 1024 head, 20 classes;
    or the cascade's, Dynamic R-CNN's, the double head's, a Faster R-CNN
    variant's), seed 0, its zero-start parameters drawn (seed_zero_starts),
    its RPN cls head sharpened, TrainConfig() (batch 2): 2 warm-up and
    `steps` timed steps on one seeded landscape batch (losses finite, the
    last below the first, positives every step, the frozen stages unmoved),
    then one step profiled by stage, one under the fixpoint-depth
    recorder and one portrait step. `over`: fields of the full config
    replaced (a canvas, a backbone_type); `calibrate`: the frozen BN's
    statistics from the batch first (calibrate_frozen_bn); `profile`
    False: no profiled step."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state, frozen_mask
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES, TrainConfig

    cfg, tcfg = dataclasses.replace(ZOO_FAMILIES[family][0](), **(over or {})), TrainConfig()
    what = f"{family} training"
    model = seeded_two_stage(cfg, device)
    seed_zero_starts(model, seed=0)
    lcfg, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, seed=5)
    batch = train_batch_for(cfg, batch)
    batch = type(batch)(*(torch.from_numpy(a).to(device) for a in batch))
    if calibrate:
        calibrate_frozen_bn(model, lcfg, batch.images, batch.img_shapes)
    sharpen_frcnn(model, lcfg, batch.images, batch.img_shapes, classes=False)
    if family == "tridentnet":
        batch = gts_near_proposals(model, lcfg, batch)
    opt = create_train_state(model, tcfg, frozen_stages=cfg.frozen_stages)
    mask = frozen_mask(model, cfg.frozen_stages)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_two_stage_train_step(model, lcfg, opt, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    auxes = [step(batch, gen) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    auxes += [step(batch, gen) for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated(device)
    traj = {k: [float(a[k]) for a in auxes] for k in auxes[0]}
    for k, v in traj.items():
        if not np.isfinite(v).all():
            fail(f"{what}: {k} is not finite: {v}")
    # TridentNet samples no gt as a candidate: its first step's positives
    # are the gts near its proposals (gts_near_proposals); each SGD step of
    # a random RPN moves its 500 proposals off them (0 positives by the
    # third step at a 192 x 320 canvas on the CPU)
    pos = traj["num_pos"][:1] if family == "tridentnet" else traj["num_pos"]
    if not min(pos) > 0 or (family == "tridentnet" and not traj["loss_bbox"][0] > 0):
        fail(f"{what}: a step sampled no positive RoI: {traj['num_pos']}")
    if not traj["loss"][-1] < traj["loss"][0]:
        fail(f"{what}: the loss did not fall: {traj['loss']}")
    for name, p in model.named_parameters():  # weight decay moves every trained weight
        moved = not torch.equal(p.detach(), before[name])
        if moved if mask[name] else (name.endswith("weight") and not moved):
            fail(f"{what}: {name} (frozen: {mask[name]}) moved: {moved}")
    prof = (profile_stages(lambda: float(step(batch, gen)["loss"]), FRCNN_GROUPS) if profile
            else "not taken")
    with fixpoint_depths() as depths:
        float(step(batch, gen)["loss"])
    pcfg, pbatch = synthetic_train_batch(cfg, "portrait", tcfg.batch_size, seed=6)
    paux = make_two_stage_train_step(model, pcfg, opt, device=device)(
        train_batch_for(cfg, pbatch), gen)
    if not all(np.isfinite(float(v)) for v in paux.values()):
        fail(f"{what}: a portrait loss is not finite: {paux}")
    out = dict(batch=tcfg.batch_size, canvas=list(lcfg.canvas), warmup=TRAIN_WARMUP,
               steps=steps, ms_per_step=ms, img_per_s=tcfg.batch_size * 1e3 / ms,
               rows=batch.images.shape[0] * len(getattr(cfg, "trident_dilations", (1,))),
               peak_mem_bytes=peak, proposal_nms_iou=cfg.rpn.nms_iou_thr,
               numerics=numerics_flags(), trajectory=traj, proposal_fixpoints=depths,
               portrait=(pcfg.canvas, {k: float(v) for k, v in paux.items()}),
               profile_of_one_step=prof)
    if family == "dynamic_rcnn":
        out["dynamic_state"] = {k: v.tolist() for k, v in model.dynamic.state_dict().items()
                                if k != "iou_hist" and k != "beta_hist"}
    return out


def proposal_flips(got, want, iou_thr: float) -> list:
    """The proposals (boxes [B, P, 4], scores, valid) one device kept and
    the other did not, per image, each named with its largest IoU with a
    higher-scored proposal of the other device's set (the decision that
    flipped, near iou_thr). Boxes match within 1e-3 px."""
    from aod_meh_hua_torch.ops.bbox import bbox_overlaps

    flips = []
    for i in range(got[0].shape[0]):
        sets = [(b[i][v[i]], sc[i][v[i]]) for b, sc, v in (got, want)]
        for (name, (boxes, scores)), (other, oscores) in zip(
                (("card only", sets[0]), ("cpu only", sets[1])), (sets[1], sets[0])):
            close = (boxes[:, None, :] - other[None, :, :]).abs().amax(-1) <= 1e-3
            for j in (~close.any(1)).nonzero().flatten().tolist():
                higher = other[oscores > scores[j]]
                iou = bbox_overlaps(boxes[j:j + 1], higher).max().item() if len(higher) else 0.0
                flips.append({"image": i, "which": name, "score": scores[j].item(),
                              "box": [round(c, 3) for c in boxes[j].tolist()],
                              "max_iou_with_a_higher_one": iou, "iou_thr": iou_thr})
    return flips


# the card-vs-CPU steps of each family's tiny config: Dynamic R-CNN's five
# cross its refresh at update_iter_interval 4
CARD_VS_CPU_STEPS = {"faster_rcnn": 2, "cascade_rcnn": 2, "dynamic_rcnn": 5,
                     "double_head_rcnn": 2, "libra_rcnn": 2, "pafpn": 2, "carafe": 2,
                     "groie": 2, "empirical_attention": 2}  # 2 for the families after them
DYNAMIC_TOL = 1e-6  # Dynamic R-CNN's threshold and beta, card against CPU
# the families whose train step takes no proposals of its own RPN
NO_TRAIN_PROPOSALS = ("rpn", "cascade_rpn", "fast_rcnn")


def frcnn_card_vs_cpu(device, family: str = "faster_rcnn", tiny_over: dict = None,
                      from_cpu_state: bool = False, noise: int = 0) -> dict:
    """CARD_VS_CPU_STEPS[family] steps of the family's tiny config from the
    same weights (its RPN cls head sharpened on the CPU), batch and
    uniforms (drawn once on the CPU, the cascade's per stage) on the card
    and on the CPU, held by train_card_vs_cpu's rules; the double head's
    BN running statistics with the parameters. Greedy NMS decides at a
    threshold, so the card's proposals are first held to the CPU's with
    every difference named (proposal_flips, at most
    FRCNN_MAX_PROPOSAL_FLIPS, one of each step's at the threshold), and
    then the card's step carries on from the CPU's proposals: the rest of
    the step (sampling, RoIAlign, the head, the losses, backward, SGD) is
    compared on the same input. Dynamic R-CNN's threshold and beta after
    every step, across the refresh, to DYNAMIC_TOL. `tiny_over`: the tiny
    config factory's overrides. `from_cpu_state` (the families of
    BACKBONE_RUNS): the card takes each step from the CPU's state before
    it (weights and momentum), and each step is held alone, as
    two_stage_ranks_path holds the ranks: a random-weight first step
    moves the tiny models' weights by up to a tenth, and its rounding
    grows in the next (Res2Net's 3-channel splits, the GN stem's trained
    scale, on an H100). `noise`: synthetic_train_batch's."""
    import torch
    from aod_meh_hua_torch.engine import two_stage
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES, TrainConfig

    cfg, tcfg = ZOO_FAMILIES[family][1](**(tiny_over or {})), TrainConfig()
    what = f"{family} training"
    _, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, seed=7, noise=noise)
    batch = train_batch_for(cfg, batch)
    seed_model = build_two_stage(cfg, device="cpu", seed=1)
    seed_zero_starts(seed_model, seed=1)
    sharpen_frcnn(seed_model, cfg, torch.from_numpy(batch.images),
                  torch.from_numpy(batch.img_shapes), classes=False)
    if family == "tridentnet":  # as its full-width training (gts_near_proposals)
        batch = type(batch)(*(t.numpy() for t in gts_near_proposals(
            seed_model, cfg, type(batch)(*(torch.from_numpy(a) for a in batch)))))
    weights = seed_model.state_dict()
    gen = torch.Generator().manual_seed(3)
    draws = [{k: tuple(torch.rand((tcfg.batch_size, m), generator=gen) for _ in range(k_draws))
              for k, (m, k_draws) in two_stage.step_draws(cfg).items()}
             for _ in range(CARD_VS_CPU_STEPS.get(family, 2))]

    real_proposals = two_stage.make_proposal_fn
    cpu_props, flips = [], []

    def pinned(cfg_, reference):
        fn = real_proposals(cfg_)

        def proposals(*args):
            out = [t.detach() for t in fn(*args)]
            if reference:
                cpu_props.append([t.cpu().clone() for t in out])
                return tuple(out)
            want = cpu_props[len(flips)]
            flips.append(proposal_flips([t.cpu() for t in out], want, cfg_.rpn.nms_iou_thr))
            return tuple(t.to(out[0].device) for t in want)

        return proposals

    def tracked(model):  # the parameters and the head BN's running statistics
        return {**dict(model.named_parameters()),
                **{k: b for k, b in model.named_buffers() if k.startswith("bbox_head")}}

    def host(model):
        return {k: p.detach().cpu().clone() for k, p in tracked(model).items()}

    def steps(dev, states=None):
        """The draws' steps on dev, in turn, or (states) each from the
        CPU's state before it; with the CPU's states before each step."""
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(weights)
        initial = host(model)
        by_param = {p: name for name, p in model.named_parameters()}
        with mock.patch.object(two_stage, "make_proposal_fn",
                               lambda c: pinned(c, reference=not cpu_props)):
            opt = create_train_state(model, tcfg)
            step = make_two_stage_train_step(model, cfg, opt, dev)
        losses, dyn, before, after = [], [], [], []
        for i, d in enumerate(draws):
            if states is not None:
                model.load_state_dict(states[i]["weights"])
                for p, name in by_param.items():
                    opt.state[p].pop("momentum_buffer", None)
                    if name in states[i]["momentum"]:
                        opt.state[p]["momentum_buffer"] = states[i]["momentum"][name].to(dev)
            before.append({"weights": {k: v.detach().cpu().clone()
                                       for k, v in model.state_dict().items()},
                           "momentum": {by_param[p]: s["momentum_buffer"].detach().cpu().clone()
                                        for p, s in opt.state.items() if "momentum_buffer" in s},
                           "tracked": host(model)})
            aux = step(batch, uniforms=lambda stage, m, k, d=d: tuple(u.to(dev) for u in d[stage]))
            losses.append({k: float(v) for k, v in aux.items()})
            after.append(host(model))
            if family == "dynamic_rcnn":
                dyn.append((float(model.dynamic.iou_thr), float(model.dynamic.beta),
                            int(model.dynamic.step)))
        return (losses, {k: (initial[k], v) for k, v in after[-1].items()}, dyn, before, after)

    cpu = steps("cpu")
    gpu = steps(device, cpu[3] if from_cpu_state else None)
    if from_cpu_state:  # each step alone, from the CPU's state before it
        def held(i, run, **kw):
            return steps_card_vs_cpu(f"{what} step {i + 1}", list(cpu[0][0]), (
                [cpu[0][i]], {k: (cpu[3][i]["tracked"][k], cpu[4][i][k]) for k in cpu[4][i]}), (
                [run[0][i]], {k: (cpu[3][i]["tracked"][k], run[4][i][k]) for k in run[4][i]}),
                **kw)

        # the CPU's own spread: each step again from its state with the batch's
        # rows (and their draws) in the other order, which reorders the sums
        # over the images; a tensor is held to the larger of the tolerance and
        # the largest spread of any tensor, in units of the tolerance
        swapped = row_swapped_steps(cfg, tcfg, batch, draws, cpu[3])
        spread = [held(i, swapped, check=False) for i in range(len(draws))]
        limits = [(max(1.0, r["max_rel_loss_err"] / TRAIN_RTOL),
                   max(1.0, r["max_param_err_of_max"] / TRAIN_RTOL),
                   max(1.0, r["max_update_err_over_tol"])) for r in spread]
        per_step = [held(i, gpu, limits=limits[i]) for i in range(len(draws))]
        out = {k: (max(r[k] for r in per_step) if k.startswith("max") else
                   [r[k] for r in per_step]) for k in per_step[0]}
        out["each_step_from_the_cpu_state"] = True
        out["limits_of_tolerance_by_step (loss, param, update)"] = limits
    else:
        out = steps_card_vs_cpu(what, list(cpu[0][0]), cpu[:2], gpu[:2])
    # each step's differences must start at a decision at the threshold
    # (the rest follow from it: a box suppressed no longer suppresses); the
    # families whose step makes no proposals (RPN-only, Cascade RPN, Fast
    # R-CNN) record none
    at_thr = [any(abs(f["max_iou_with_a_higher_one"] - f["iou_thr"]) < 1e-4 for f in step)
              for step in flips if step]
    makes = family not in NO_TRAIN_PROPOSALS
    if (len(flips) != (len(draws) if makes else 0)
            or max((len(f) for f in flips), default=0) > FRCNN_MAX_PROPOSAL_FLIPS
            or not all(at_thr)):
        fail(f"{what} card vs CPU: the proposals differ: {flips}")
    out["proposal_flips_per_step"] = flips
    if family == "dynamic_rcnn":
        err = max(max(abs(g[0] - c[0]), abs(g[1] - c[1])) for c, g in zip(cpu[2], gpu[2]))
        refreshed = cpu[2][-1][0] != cfg.rcnn.pos_iou_thr
        if err > DYNAMIC_TOL or [c[2] for c in cpu[2]] != [g[2] for g in gpu[2]] or \
                not refreshed:
            fail(f"{what} card vs CPU: iou_thr, beta, step {gpu[2]} vs {cpu[2]}")
        out["dynamic_card"], out["dynamic_cpu"], out["dynamic_max_err"] = gpu[2], cpu[2], err
    return out


def row_swapped_steps(cfg, tcfg, batch, draws, states):
    """The CPU's train step of each draw from `states` (the CPU's state
    before it) on the batch with its rows, and the draws' rows, in the
    other order: (losses, None, None, None, the tracked tensors after each
    step), frcnn_card_vs_cpu's layout."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage

    rows = type(batch)(*(np.ascontiguousarray(a[::-1]) for a in batch))
    model = build_two_stage(cfg, device="cpu")
    losses, after = [], []
    for d, state in zip(draws, states):
        model.load_state_dict(state["weights"])
        opt = create_train_state(model, tcfg)
        for name, p in model.named_parameters():
            if name in state["momentum"]:
                opt.state[p]["momentum_buffer"] = state["momentum"][name].clone()
        step = make_two_stage_train_step(model, cfg, opt, "cpu")
        aux = step(rows, uniforms=lambda stage, m, k, d=d: tuple(u.flip(0) for u in d[stage]))
        losses.append({k: float(v) for k, v in aux.items()})
        after.append({k: p.detach().clone() for k, p in model.named_parameters()})
        after[-1].update({k: b.detach().clone() for k, b in model.named_buffers()
                          if k.startswith("bbox_head")})
    return losses, None, None, None, after


def _dets_agree(a, b, i, rtol) -> bool:
    """Image i's detections of two NMSResults (host arrays) agree: the same
    valid slots, labels and source indices, boxes and scores to rtol."""
    if not (np.array_equal(a.valid[i], b.valid[i]) and np.array_equal(a.labels[i], b.labels[i])
            and np.array_equal(a.anchor_idx[i], b.anchor_idx[i])):
        return False
    return bool(np.allclose(a.scores[i], b.scores[i], rtol=rtol, atol=0)
                and np.allclose(a.boxes[i], b.boxes[i], rtol=rtol, atol=1e-3))


def _host_dets(d):
    return type(d)(*(t.cpu().numpy() for t in d))


def frcnn_eval_path(device, family: str = "faster_rcnn", named_ties: bool = False,
                    over: dict = None, nms_inputs: bool = False, calibrate: bool = False,
                    pool: dict = None, cpu_canvases: int = 2,
                    profile: bool = True, against_cpu: bool = True,
                    first_batches: bool = False) -> dict:
    """The family's eval step over the 26 synthetic canvases at batch 8,
    both orientations: the family's full-width config, seed 0, its RPN
    and class heads sharpened on the first batch. img/s and peak memory
    over a sweep that also reads the detections to the host per class,
    after a warm-up sweep; the split of one batch's device time by stage;
    each NMS fixpoint's depth; the first `cpu_canvases` canvases of the
    timed sweep's first batch held to the CPU's eval step on them: the
    same valid slots, labels and sources, boxes and scores to
    FRCNN_RTOL, with no difference allowed; or, `named_ties` (the
    Faster R-CNN variants), where they differ, the proposals behind them
    compared stage by stage (eval_ties): every proposal that one device
    keeps and the other not named as a near-tie, and the detections
    from the CPU's proposals with no difference allowed, or with
    `nms_inputs` (the families of BACKBONE_RUNS), any difference left
    traced to the detection NMS's inputs (eval_ties). `over`: fields of
    the full config replaced; `calibrate`: the frozen BN's statistics from
    the first batch (calibrate_frozen_bn); `profile` False: no profiled
    batch; `against_cpu` False: no CPU comparison (the backbone_type
    switches, whose modules the tiny steps hold to the CPU's); `pool`:
    synthetic_pool's images per orientation (POOL by default);
    `cpu_canvases`: the canvases held to the CPU's (2 by default);
    `first_batches`: the pool's first batch of each orientation only (16
    of the 26 canvases, the same first canvases)."""
    import torch
    from aod_meh_hua_torch.engine.eval import detections_to_per_class
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    cfg = dataclasses.replace(ZOO_FAMILIES[family][0](), **(over or {}))
    what = f"{family} eval"
    model = seeded_two_stage(cfg, device)
    seed_zero_starts(model, seed=0)
    triples, n = synthetic_pool(cfg, pool=pool)
    if first_batches:
        seen = set()
        triples = [t for t in triples if not (t[0] in seen or seen.add(t[0]))]
        n = sum(len(idx) for _, _, idx in triples)
    first = upload(triples[0][1], device)
    if calibrate:
        calibrate_frozen_bn(model, cfg.for_orientation(triples[0][0]), first.images,
                            first.img_shapes)
    sharpen_frcnn(model, cfg.for_orientation(triples[0][0]), first.images, first.img_shapes)
    steps = {o: make_two_stage_eval_step(model, cfg.for_orientation(o), device=device)
             for o in ("landscape", "portrait")}
    batches = [(o, upload(b, device)) for o, b, _ in triples]

    def sweep():
        rows, outs = [], []
        for o, b in batches:
            outs.append(steps[o](b))
            rows += detections_to_per_class(outs[-1], cfg.num_classes, batch_valid=b.valid)
        return rows, outs[0]

    for o in ("landscape", "portrait"):  # warm-up: one batch of each canvas
        steps[o](next(b for bo, b in batches if bo == o)).valid.cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    rows, timed_first = sweep()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device)
    if len(rows) != n or not all(np.isfinite(a).all() for r in rows for a in r):
        fail(f"{what}: {len(rows)} images of {n}, or a detection not finite")
    n_dets = sum(len(a) for r in rows for a in r)
    if n_dets == 0:
        fail(f"{what}: no detection in the pool")
    o0, b0 = batches[0]
    prof = (profile_stages(lambda: steps[o0](b0).valid.cpu(), FRCNN_GROUPS) if profile
            else "not taken")
    with fixpoint_depths() as depths:
        steps[o0](b0).valid.cpu()

    if not against_cpu:
        return dict(batch=BATCH, images=n, sweep_s=wall, img_per_s=n / wall,
                    peak_mem_bytes=peak, detections=n_dets, fixpoints=depths,
                    profile_of_one_batch=prof, card_vs_cpu="not taken")
    # the timed sweep's first two canvases against the CPU's eval step on
    # those canvases, with the same weights
    cpu_model = cpu_twin(model)
    k = cpu_canvases
    two = type(triples[0][1])(*(a[:k] for a in triples[0][1]))
    want = _host_dets(make_two_stage_eval_step(cpu_model, cfg.for_orientation(o0),
                                               device="cpu")(two))
    got = _host_dets(type(timed_first)(*(t[:k] for t in timed_first)))
    flips = [{"image": i, "card_valid": int(got.valid[i].sum()),
              "cpu_valid": int(want.valid[i].sum()),
              "first_slot_off": int(np.argmax(~(np.isclose(got.scores[i], want.scores[i],
                                                           rtol=FRCNN_RTOL)
                                                & (got.labels[i] == want.labels[i]))))}
             for i in range(k) if not _dets_agree(got, want, i, FRCNN_RTOL)]
    ties = None
    if flips and named_ties:
        ties = eval_ties(model, cpu_model, cfg.for_orientation(o0), two, want, device,
                         nms_inputs)
    elif flips:
        fail(f"{what} card vs CPU: {flips}")
    return dict(batch=BATCH, images=n, sweep_s=wall, img_per_s=n / wall, peak_mem_bytes=peak,
                detections=n_dets, fixpoints=depths, profile_of_one_batch=prof,
                card_vs_cpu={"images": k, "flips": flips, "named_ties": ties,
                             "detections": int(got.valid.sum())})


# a proposal one device keeps and the other not is a near-tie when the other
# device keeps its twin (IoU at least TIE_IOU, the score within TIE_SCORE_RTOL):
# a near-duplicate pair (anchors decoded and clipped to nearly one box, their
# sigmoid scores saturated) whose order rounding decides; or when its
# deciding IoU lies within TIE_THR_ATOL of the NMS threshold
TIE_IOU, TIE_SCORE_RTOL, TIE_THR_ATOL = 0.999, 1e-5, 1e-4


def eval_ties(model, cpu_model, cfg, two, want, device, nms_inputs: bool = False) -> dict:
    """Where the card's detections on two canvases differ from the CPU's
    (`want`), the stage that parts them: the features of every level and
    the RPN outputs within FRCNN_RTOL of their max-abs; every proposal
    that one device keeps and the other not named (proposal_flips) and a
    near-tie (TIE_*), and the proposals' order aside; then the card's
    eval step from the CPU's proposals, whose detections must agree with
    the CPU's with no difference, or, `nms_inputs`, where they differ,
    must come from the detection NMS's inputs (nms_input_ties). Fails
    otherwise."""
    import torch
    from aod_meh_hua_torch.engine import two_stage
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.ops.bbox import bbox_overlaps

    stage1 = {}
    with torch.no_grad():
        for name, m, dev in (("cpu", cpu_model, "cpu"), ("card", model, device)):
            b = upload(two, dev)
            feats, rpn_cls, rpn_reg = m(prepare_images(b.images, b.img_shapes, cfg))
            props = two_stage.make_proposal_fn(cfg)(
                rpn_cls, rpn_reg, torch.from_numpy(two_stage.anchor_table(cfg)).to(rpn_cls.device),
                b.img_shapes, cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)
            stage1[name] = ([f.cpu() for f in feats] + [rpn_cls.cpu(), rpn_reg.cpu()],
                            [t.cpu() for t in props])
    errs = [((g - c).abs().max() / c.abs().max().clamp(min=1e-30)).item()
            for c, g in zip(stage1["cpu"][0], stage1["card"][0])]
    if max(errs) > FRCNN_RTOL and nms_inputs:
        return stage1_f64_ties(model, cpu_model, cfg, two, stage1, max(errs), device)
    if max(errs) > FRCNN_RTOL:
        fail(f"eval card vs CPU: the features or the RPN differ by {max(errs)} of their max")
    flips = proposal_flips(stage1["card"][1], stage1["cpu"][1], cfg.rpn.nms_iou_thr)
    replayed = None
    if flips and nms_inputs:  # the card's RPN outputs through the CPU's proposals
        replayed = proposals_from_card_rpn(cfg, stage1, two)
        flips = []
    untied = []
    for f in flips:
        twins = [g for g in flips if g["image"] == f["image"] and g["which"] != f["which"]
                 and abs(g["score"] - f["score"]) <= TIE_SCORE_RTOL * abs(f["score"])
                 and bbox_overlaps(torch.tensor([f["box"]]), torch.tensor([g["box"]])).item()
                 >= TIE_IOU]
        if not twins and abs(f["max_iou_with_a_higher_one"] - f["iou_thr"]) > TIE_THR_ATOL:
            untied.append(f)
    if untied:
        fail(f"eval card vs CPU: proposals differ beyond near-ties: {untied}")
    pinned = [t.to(device) for t in stage1["cpu"][1]]
    with mock.patch.object(two_stage, "make_proposal_fn",
                           lambda c, device_loop=False: lambda *a: tuple(pinned)):
        got = _host_dets(two_stage.make_two_stage_eval_step(model, cfg, device=device)(two))
    off = [i for i in range(len(two.valid)) if not _dets_agree(got, want, i, FRCNN_RTOL)]
    nms = None
    if off and nms_inputs:
        nms = nms_input_ties(model, cpu_model, cfg, two, pinned, stage1["cpu"][1], got, device)
    elif off:
        fail(f"eval card vs CPU: images {off} differ from the CPU's proposals")
    return {"stage1_err_of_max": max(errs), "proposal_flips": flips,
            "card_rpn_through_cpu_proposals": replayed,
            "from_cpu_proposals": "agree" if not off else f"images {off} differ",
            "nms_inputs": nms, "detections": int(got.valid.sum())}


def stage1_f64_ties(model, cpu_model, cfg, two, stage1, err: float, device) -> dict:
    """Where the card's stage 1 (the FPN levels and the RPN outputs) on two
    canvases differs from the CPU's beyond FRCNN_RTOL of max-abs (GN+WS:
    53 GroupNorms, each dividing by its group's spread, lose about 1e-4
    in f32 on an H100 and 1.4e-3 on the CPU): the
    same stage 1 on the CPU in float64, against which the card's f32 must
    be no farther than the CPU's f32 is (or FRCNN_RTOL); then the rest of
    the eval step on the CPU from the card's stage 1, whose detections
    must be the card's, or differ from them only where the detection
    NMS's inputs agree and the card's inputs through the CPU's NMS give
    the card's detections (nms_input_ties' rule). Fails otherwise."""
    import copy

    import torch
    from aod_meh_hua_torch.engine import two_stage
    from aod_meh_hua_torch.engine.batch import prepare_images

    b = upload(two, "cpu")
    with torch.no_grad():
        f64 = copy.deepcopy(cpu_model).double()(
            prepare_images(b.images, b.img_shapes, cfg).double())
    ref = [t.double() for t in list(f64[0]) + [f64[1], f64[2]]]

    def err_of(outs):
        return max(((a.double() - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                   for a, r in zip(outs, ref))

    card_err, cpu_err = err_of(stage1["card"][0]), err_of(stage1["cpu"][0])
    if card_err > max(FRCNN_RTOL, cpu_err):
        fail(f"eval card vs CPU: the card's stage 1 is {card_err} of its max from the f64 "
             f"one, the CPU's {cpu_err}")
    got = _host_dets(two_stage.make_two_stage_eval_step(model, cfg, device=device)(two))
    outs = stage1["card"][0]
    n = len(outs) - 2
    inputs = {}
    real_nms = two_stage.TwoStageEvalStep._nms

    def capture(name):
        def nms(self, boxes, fg):
            inputs[name] = (boxes.detach().cpu(), fg.detach().cpu())
            return real_nms(self, boxes, fg)
        return nms

    with mock.patch.object(cpu_model, "forward",
                           lambda images: (tuple(outs[:n]), outs[n], outs[n + 1])), \
            mock.patch.object(two_stage.TwoStageEvalStep, "_nms", capture("cpu")):
        replay = _host_dets(two_stage.make_two_stage_eval_step(cpu_model, cfg, device="cpu")(two))
    off = [i for i in range(len(two.valid)) if not _dets_agree(replay, got, i, FRCNN_RTOL)]
    nms = None
    if off:
        with mock.patch.object(two_stage.TwoStageEvalStep, "_nms", capture("card")):
            two_stage.make_two_stage_eval_step(model, cfg, device=device)(two)
        (cb, cf), (gb, gf) = inputs["cpu"], inputs["card"]
        score_err = ((gf - cf).abs().max() / cf.abs().max().clamp(min=1e-30)).item()
        box_err = (gb - cb).abs().max().item()
        through = _host_dets(two_stage.TwoStageEvalStep(cpu_model, cfg)._nms(gb, gf))
        if score_err > FRCNN_RTOL or box_err > 1e-3 or any(
                not _dets_agree(through, got, i, FRCNN_RTOL) for i in range(len(two.valid))):
            fail(f"eval card vs CPU from the card's stage 1: images {off} differ, the NMS "
                 f"inputs by {score_err} of their max and {box_err} px")
        nms = {"score_err_of_max": score_err, "box_err_px": box_err,
               "card_inputs_through_cpu_nms": "the card's detections"}
    return {"stage1_err_of_max": err, "stage1_err_of_the_f64_max": {"card": card_err,
                                                                   "cpu": cpu_err},
            "from_the_card_stage1_on_the_cpu": "agree" if not off else f"images {off} differ",
            "nms_inputs": nms, "detections": int(got.valid.sum())}


def proposals_from_card_rpn(cfg, stage1, two) -> str:
    """Where the card's proposals differ from the CPU's although the RPN
    outputs agree (FRCNN_RTOL of max-abs, checked before): the card's RPN
    outputs through the proposal function on the CPU must give the card's
    proposals (the same valid slots, boxes within 1e-3 px, scores rtol
    FRCNN_RTOL). Then the proposal NMS is one function on both devices,
    and the proposals part by the rounding of its inputs alone (scores of
    HRNet's saturated objectness, 0.976, swapping order between two boxes
    at IoU 0.77, on an H100). Fails otherwise."""
    import torch
    from aod_meh_hua_torch.engine import two_stage

    rpn_cls, rpn_reg = stage1["card"][0][-2:]
    img_shapes = torch.from_numpy(np.asarray(two.img_shapes))
    replay = two_stage.make_proposal_fn(cfg)(
        rpn_cls, rpn_reg, torch.from_numpy(two_stage.anchor_table(cfg)), img_shapes,
        cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)
    boxes, scores, valid = stage1["card"][1]
    if not (torch.equal(replay[2], valid)
            and torch.allclose(replay[0], boxes, rtol=0, atol=1e-3)
            and torch.allclose(replay[1], scores, rtol=FRCNN_RTOL, atol=0)):
        fail("eval card vs CPU: the card's RPN outputs through the CPU's proposal function "
             "differ from the card's proposals")
    return "the card's proposals"


def nms_input_ties(model, cpu_model, cfg, two, pinned, cpu_props, got, device) -> dict:
    """Where the card's detections from the CPU's proposals (`got`) still
    differ from the CPU's: the detection NMS's inputs (each proposal's
    class-specific boxes and scores) of the card and of the CPU, within
    FRCNN_RTOL of the scores' max-abs and 1e-3 px; and the card's inputs
    through the NMS on the CPU, which must give the card's detections
    with no difference. Then the NMS is one function on both devices, and
    the detections part by the rounding of its inputs at its decisions
    alone (with random weights and 2000 proposals, near-duplicate boxes
    of near-equal scores meet at its threshold and at its
    max_per_img cut). Fails otherwise."""
    import torch
    from aod_meh_hua_torch.engine import two_stage

    inputs = {}

    def capture(name):
        real = two_stage.TwoStageEvalStep._nms

        def nms(self, boxes, fg):
            inputs[name] = (boxes.detach().cpu(), fg.detach().cpu())
            return real(self, boxes, fg)

        return nms

    for name, m, dev, props in (("cpu", cpu_model, "cpu", cpu_props),
                                ("card", model, device, pinned)):
        with mock.patch.object(two_stage, "make_proposal_fn",
                               lambda c, device_loop=False, p=props: lambda *a: tuple(p)), \
                mock.patch.object(two_stage.TwoStageEvalStep, "_nms", capture(name)):
            two_stage.make_two_stage_eval_step(m, cfg, device=dev)(upload(two, dev))
    (cb, cf), (gb, gf) = inputs["cpu"], inputs["card"]
    score_err = ((gf - cf).abs().max() / cf.abs().max().clamp(min=1e-30)).item()
    box_err = (gb - cb).abs().max().item()
    if score_err > FRCNN_RTOL or box_err > 1e-3:
        fail(f"eval card vs CPU: the detection NMS's inputs differ: scores {score_err} of "
             f"their max, boxes {box_err} px")
    step = two_stage.TwoStageEvalStep(cpu_model, cfg)
    replay = _host_dets(step._nms(gb, gf))
    off = [i for i in range(len(two.valid)) if not _dets_agree(replay, got, i, FRCNN_RTOL)]
    if off:
        fail(f"eval card vs CPU: the card's NMS inputs through the CPU's NMS differ from the "
             f"card's detections on images {off}")
    return {"score_err_of_max": score_err, "box_err_px": box_err,
            "card_inputs_through_cpu_nms": "the card's detections",
            "detections_card": int(got.valid.sum())}


# the two-stage trainers' fixture trees: 8 trainval images, 4 steps at batch 2 in
# their epoch (the AL phase's tree holds 32), for the script's time limit
TWO_STAGE_CLI_TRAINVAL = 8


def frcnn_cli_path(device, family: str = "faster_rcnn", root: Path = None) -> dict:
    """The trainer's CLI (python -m aod_meh_hua_torch.tools.train_detector,
    in process) with --family at full width for one epoch with eval on a
    VOC07 tree of the fixture JPEGs (TWO_STAGE_CLI_TRAINVAL trainval, 8
    test) under `root`;
    its checkpoint back through init_detector (equal to the CLI's
    model), then, its heads sharpened, a Detector's predict_batch on the
    8 test JPEGs against the eval step's rows on the same canvases; last
    the FPS tool."""
    import torch
    from aod_meh_hua_torch.api import Detector, init_detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import prepare_sample
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.engine.eval import detections_to_per_class
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.tools import benchmark, train_detector

    root = root or FRCNN
    shutil.rmtree(root, ignore_errors=True)
    voc07 = synthetic_voc(root, n_trainval=TWO_STAGE_CLI_TRAINVAL)
    work = root / "work"
    t0 = time.time()
    (model, cfg, metrics), flags = run_cli(train_detector.main, [
        "--family", family, "--voc07", str(voc07), "--work-dir", str(work),
        "--epochs", "1"])
    cli_s = time.time() - t0
    if len(metrics) != 1 or not np.isfinite(metrics[0]["loss"]) or "mAP" not in metrics[0]:
        fail(f"train_detector CLI: {metrics}")
    log = [json.loads(line) for line in (work / "train_log.jsonl").read_text().splitlines()]
    if log != metrics:
        fail(f"train_detector CLI: train_log.jsonl {log} against {metrics}")
    loaded = init_detector(cfg, checkpoint=str(work / f"{family}_final.ckpt"), device=device)
    loaded_sd = loaded.state_dict()
    for k, v in model.state_dict().items():
        if not torch.equal(loaded_sd[k], v):
            fail(f"train_detector CLI: the checkpoint's {k} is not the model's")
    det = Detector(cfg, loaded)
    ids = (voc07 / "ImageSets/Main/test.txt").read_text().split()
    imgs = [imread(str(voc07 / "JPEGImages" / f"{i}.jpg")) for i in ids]
    samples = [prepare_sample(im, None, det.pipeline, flip=False) for im in imgs]
    s0 = samples[0]
    ocfg = cfg.for_orientation(s0["orientation"])
    sharpen_frcnn(loaded, ocfg, torch.from_numpy(s0["image"][None]).to(device),
                  torch.from_numpy(s0["img_shape"][None]).to(device))
    rows = det.predict_batch(imgs, max_batch=8)
    want = [None] * len(samples)
    for o in ("landscape", "portrait"):  # predict_batch's batches: the group, padded by its first
        idx = [i for i, s in enumerate(samples) if s["orientation"] == o]
        if not idx:
            continue
        pad = idx + [idx[0]] * (8 - len(idx))
        stack = lambda k: np.stack([samples[i][k] for i in pad])  # noqa: E731
        valid = np.arange(8) < len(idx)
        out = make_two_stage_eval_step(loaded, cfg.for_orientation(o), device=device)(
            EvalBatch(stack("image"), stack("img_shape"), stack("scale_factor"), valid))
        for i, per in zip(idx, detections_to_per_class(out, cfg.num_classes, batch_valid=valid)):
            want[i] = per
    off = [i for i, (g, w) in enumerate(zip(rows, want))
           if not all(a.shape == b.shape and np.allclose(a, b, rtol=FRCNN_RTOL, atol=1e-3)
                      for a, b in zip(g, w))]
    if off:
        fail(f"Detector.predict_batch against the eval step: images {off} differ")
    empty = [i for i, r in enumerate(rows) if sum(len(a) for a in r) == 0]
    if empty:  # two empty answers agree: each image must give detections
        fail(f"Detector.predict_batch: no detection on images {empty}")
    fps = benchmark.main(["--family", family, "--batch", str(BATCH), "--iters", "10",
                          "--warmup", "2"])
    return dict(cli_s=cli_s, metrics=metrics, flags_after=flags,
                detector_images=len(rows), detector_detections=sum(len(a) for r in rows
                                                                   for a in r),
                fps_tool=fps)


def frcnn_path(device, card: str) -> tuple:
    """The Faster R-CNN phase (zoo_family_path with the eval, then the
    trainer's CLI), with the kernels' launch counts reset just before and
    read just after: neither kernel lies on this path, so both must read
    0. Returns (result, launches)."""
    t0 = time.time()
    reset_launches()
    out = zoo_family_path(device, card, "faster_rcnn", True)
    out["cli"] = frcnn_cli_path(device)
    print("Faster R-CNN CLI, Detector and FPS tool:", json.dumps(out["cli"]), f"[{card}]",
          flush=True)
    launches = read_launches()
    if any(launches.values()):
        fail(f"Faster R-CNN: a hand-written kernel launched: {launches}")
    out["phase_s"] = time.time() - t0
    return out, launches


# --- the other two-stage families, their TTA, server and trainer ----------------

ZOO = REPO / "build" / "chip_smoke_zoo"
ZOO_SERVE_THR = 0.05    # the tiny heads' scores sit near 1/7: rows above this gate
ZOO_REQUESTS, ZOO_CLIENTS = 12, 4
TTA_REPS = 1            # timed TTA calls per family, after one warm-up


def zoo_family_path(device, card: str, family: str, with_eval: bool, run: dict = None) -> dict:
    """One family at full width: its training (frcnn_train_path), its tiny
    config's steps card against CPU (frcnn_card_vs_cpu) and, with_eval,
    its eval over the synthetic pool (frcnn_eval_path). `run` (a
    BACKBONE_RUNS entry): its name, the full and tiny configs' overrides
    and the timed train steps. Each reading is printed as it comes."""
    import torch

    # the families after Faster R-CNN: 2 + TWO_STAGE_STEPS steps, no profiled step or batch,
    # the script's time limit (the fuller readings of earlier runs: PERF.md)
    run = run or {"name": family, "full": {}, "tiny": {},
                  "steps": TRAIN_STEPS if family == "faster_rcnn" else TWO_STAGE_STEPS,
                  "profile_train": family == "faster_rcnn"}
    name = run["name"]
    calibrate, profile = run.get("calibrate_bn", False), run.get("profile_train", True)
    t0 = time.time()
    out = {"train": frcnn_train_path(device, family, run["full"], run["steps"], calibrate,
                                     profile)}
    out["train"]["path_s"] = time.time() - t0
    torch.cuda.empty_cache()
    print(f"{name} training:", json.dumps(out["train"]), f"[{card}]", flush=True)
    t0 = time.time()
    out["card_vs_cpu"] = frcnn_card_vs_cpu(device, family, run["tiny"],
                                           from_cpu_state=run.get("from_cpu_state", False),
                                           noise=run.get("noise", 0))
    out["card_vs_cpu"]["path_s"] = time.time() - t0
    print(f"{name} training card vs CPU:", json.dumps(out["card_vs_cpu"]), f"[{card}]",
          flush=True)
    if with_eval:
        backbone = name != family or family in BACKBONE_FAMILIES
        t0 = time.time()
        out["eval"] = frcnn_eval_path(device, family, named_ties=family in VARIANT_FAMILIES
                                      or backbone, over=run["full"], nms_inputs=backbone,
                                      calibrate=calibrate, profile=run.get("profile_eval",
                                                                           profile),
                                      against_cpu=run.get("eval_against_cpu", True),
                                      pool=run.get("pool"),
                                      cpu_canvases=2 if name == "faster_rcnn"
                                      else LATER_CPU_CANVASES,
                                      first_batches=name != "faster_rcnn")
        out["eval"]["path_s"] = time.time() - t0
        torch.cuda.empty_cache()
        print(f"{name} eval:", json.dumps(out["eval"]), f"[{card}]", flush=True)
    return out


def two_stage_tta_path(device) -> dict:
    """Detector.tta of Faster and Cascade R-CNN at full width, seed 0, the
    heads sharpened on the image's canvas, at TTA_SCALES with the flip
    (four augmentations) on a fixture JPEG: ms per image over TTA_REPS
    calls after a warm-up, and the image's detections against the same
    TTA on the CPU with the same weights (the same rows per class, boxes
    and scores to FRCNN_RTOL; no flipped decision allowed)."""
    import torch
    from aod_meh_hua_torch.api import Detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import PipelineConfig, prepare_sample
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    img = imread(str(sorted(FIXTURES.glob("*.jpg"))[3]))
    out = {}
    for family in ("faster_rcnn", "cascade_rcnn"):
        cfg = ZOO_FAMILIES[family][0]()
        model = seeded_two_stage(cfg, device)
        # the default pipeline: the first scale into the config's canvas
        det = Detector(cfg, model, pipeline=PipelineConfig(
            img_scale=TTA_SCALES[0], canvas=cfg.canvas, device_normalize=True))
        s = prepare_sample(img, None, det.pipeline, flip=False)
        sharpen_frcnn(model, cfg.for_orientation(s["orientation"]),
                      torch.from_numpy(s["image"][None]).to(device),
                      torch.from_numpy(s["img_shape"][None]).to(device))
        det.tta(img, scales=TTA_SCALES, flip=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TTA_REPS):
            got = det.tta(img, scales=TTA_SCALES, flip=True)
        ms = (time.perf_counter() - t0) * 1e3 / TTA_REPS
        cpu_model = cpu_twin(model)
        want = Detector(cfg, cpu_model, pipeline=det.pipeline).tta(img, scales=TTA_SCALES,
                                                                    flip=True)
        agree = _agree(got, want, FRCNN_RTOL)
        n_dets = sum(len(a) for a in got)
        if agree == "flip" or n_dets == 0:
            fail(f"{family} TTA card vs CPU: {agree}, {n_dets} detections on the card, "
                 f"{sum(len(a) for a in want)} on the CPU")
        out[family] = dict(scales=TTA_SCALES, flip=True, augmentations=2 * len(TTA_SCALES),
                           image=list(img.shape), ms_per_image=ms, reps=TTA_REPS,
                           detections=n_dets, card_vs_cpu=agree)
        del model, det, cpu_model
        torch.cuda.empty_cache()
    return out


def zoo_server_path(device) -> dict:
    """serve.py's build_detector for --family cascade_rcnn --mini on the
    card (its heads sharpened), behind the Batcher and the HTTP handler
    on 127.0.0.1:0: ZOO_REQUESTS POSTs of the fixture JPEGs from
    ZOO_CLIENTS threads, raw and base64 in turns, each reply held to the
    Detector's rows for that image."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.pipeline import prepare_sample
    from aod_meh_hua_torch.data.voc import VOC_CLASSES
    from aod_meh_hua_torch.tools.deployment import serve

    det = serve.build_detector(serve.parse_args(["--family", "cascade_rcnn", "--mini"]))
    if det.device.type != torch.device(device).type:
        fail(f"serve --family cascade_rcnn --mini: the Detector is on {det.device}")
    files = sorted(FIXTURES.glob("*.jpg"))
    imgs = [imread(str(f)) for f in files]
    s = prepare_sample(imgs[0], None, det.pipeline, flip=False)
    sharpen_frcnn(det.model, det.cfg.for_orientation(s["orientation"]),
                  torch.from_numpy(s["image"][None]).to(device),
                  torch.from_numpy(s["img_shape"][None]).to(device))
    classes = VOC_CLASSES[:det.cfg.num_fg_classes]
    expected = [_rows(det(im), classes, ZOO_SERVE_THR) for im in imgs]
    payloads = [f.read_bytes() for f in files]
    batcher = serve.Batcher(det, max_batch=BATCH, delay_ms=5.0)
    handler = serve.make_handler(batcher, classes, ZOO_SERVE_THR)
    handler.log_message = lambda *a: None
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predictions"
    agree, errors = [None] * ZOO_REQUESTS, []

    def client(k):
        for i in range(k, ZOO_REQUESTS, ZOO_CLIENTS):
            raw = payloads[i % len(payloads)]
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url, data=raw if i % 2 == 0 else base64.b64encode(raw)),
                        timeout=300) as r:
                    agree[i] = _rows_agree(json.load(r), expected[i % len(payloads)], API_RTOL)
            except Exception as e:  # recorded, and the phase fails below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(ZOO_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(60)
    rows = sum(len(expected[i % len(payloads)]) for i in range(ZOO_REQUESTS))
    if errors or any(a not in ("exact", "close") for a in agree) or rows == 0:
        fail(f"serve --family cascade_rcnn: {errors[:3]}, replies {agree}, {rows} rows")
    return dict(requests=ZOO_REQUESTS, clients=ZOO_CLIENTS, wall_s=wall, rows=rows,
                score_thr=ZOO_SERVE_THR,
                replies={k: agree.count(k) for k in ("exact", "close")})


def zoo_path(device, card: str) -> tuple:
    """The phase of Cascade, Dynamic and Double-Head R-CNN, the two-stage
    TTA, and the zoo's server and trainer, each path's kernel launch
    counts reset just before it and read just after: neither kernel lies
    on these paths, so each must read 0. Returns (result, launches by
    path)."""
    t0 = time.time()
    out, launches = {}, {}

    def counted(name, fn):
        count_path(out, launches, name, fn)

    counted("cascade_rcnn", lambda: zoo_family_path(device, card, "cascade_rcnn", True))
    counted("dynamic_rcnn", lambda: zoo_family_path(device, card, "dynamic_rcnn", False))
    counted("double_head_rcnn", lambda: zoo_family_path(device, card, "double_head_rcnn",
                                                        True))
    counted("two_stage_tta", lambda: two_stage_tta_path(device))
    print("two-stage TTA:", json.dumps(out["two_stage_tta"]), f"[{card}]", flush=True)
    counted("zoo_server", lambda: zoo_server_path(device))
    print("serve --family cascade_rcnn --mini:", json.dumps(out["zoo_server"]), f"[{card}]",
          flush=True)
    counted("cascade_rcnn_cli", lambda: frcnn_cli_path(device, "cascade_rcnn", ZOO / "cli"))
    print("train_detector --family cascade_rcnn, Detector and FPS tool:",
          json.dumps(out["cascade_rcnn_cli"]), f"[{card}]", flush=True)
    out["phase_s"] = time.time() - t0
    return out, launches


# --- the Faster R-CNN variants on the trunk -----------------------------------------

VARIANTS = REPO / "build" / "chip_smoke_variants"
VARIANT_FAMILIES = ("libra_rcnn", "pafpn", "carafe", "groie", "empirical_attention")


def variants_path(device, card: str) -> tuple:
    """The phase of the Faster R-CNN variants: each of VARIANT_FAMILIES at
    full width through zoo_family_path with its eval (training, the tiny
    steps on the card against the CPU, eval over the 26 canvases), its
    zero-start parameters drawn first (seed_zero_starts); then the trainer's
    CLI with --family libra_rcnn, its Detector and the FPS tool
    (frcnn_cli_path). Each path's kernel launch counts reset just before
    it and read just after: neither kernel lies on these paths, so each
    must read 0. Returns (result, launches by path)."""
    t0 = time.time()
    out, launches = {}, {}

    def counted(name, fn):
        count_path(out, launches, name, fn)

    for family in VARIANT_FAMILIES:
        counted(family, lambda family=family: zoo_family_path(device, card, family, True))
    counted("libra_rcnn_cli", lambda: frcnn_cli_path(device, "libra_rcnn", VARIANTS / "cli"))
    print("train_detector --family libra_rcnn, Detector and FPS tool:",
          json.dumps(out["libra_rcnn_cli"]), f"[{card}]", flush=True)
    shutil.rmtree(VARIANTS, ignore_errors=True)
    out["phase_s"] = time.time() - t0
    return out, launches


# --- the rest of Faster R-CNN's config variants ---------------------------------------

BACKBONES = REPO / "build" / "chip_smoke_backbones"
BACKBONE_FAMILIES = ("pisa_faster_rcnn", "gn_ws", "resnest", "hrnet", "fpg")
# HRNet's and FPG's canvas: their pyramids need sides that divide by 64
# (models/two_stage.py check_canvas), so 640 x 1024 where the others take 608
EXACT_CANVAS = (640, 1024)
BACKBONE_TRAIN_STEPS = 2  # timed steps at batch 2 after the 2 warm-up ones
# GN+WS's tiny card-vs-CPU batch carries the eval canvases' pixel noise: on
# the cells of one colour alone each GroupNorm normalises near-constant maps,
# whose variance cancels, and the card's and the CPU's gradients part by
# 2e-5 of their max at layer4 (1e-6 with the noise; ResNet's 8e-7 either
# way), so that the stem's gn1.weight update lands 10.7 tolerances off
# (on an H100; ROADMAP Queue 3)
GN_NOISE = 20
# the backbone_type switches' eval pool: one batch of each orientation, where
# the other families take POOL's 26 canvases (for the script's time limit)
SWITCH_POOL = {"landscape": BATCH, "portrait": BATCH}
# each run: its name, family, the full config's overrides, the tiny config's
# (the card-vs-CPU steps; RegNetX-400MF, the smallest arch, at the tiny canvas)
BACKBONE_RUNS = tuple(
    {"name": name, "family": family, "full": full, "tiny": tiny, "steps": BACKBONE_TRAIN_STEPS,
     "from_cpu_state": True, "calibrate_bn": name == "hrnet",
     # a profiled step or batch where a module of its own has a range there
     "profile_train": name == "pisa_faster_rcnn", "profile_eval": name in ("hrnet", "fpg"),
     # the switches' eval is Faster R-CNN's on another backbone, whose
     # modules the tiny steps hold to the CPU's: the phase's time limit
     "eval_against_cpu": family != "faster_rcnn",
     "pool": SWITCH_POOL if family == "faster_rcnn" else None,
     "noise": GN_NOISE if name == "gn_ws" else 0}
    for name, family, full, tiny in (
        ("pisa_faster_rcnn", "pisa_faster_rcnn", {}, {}),
        ("gn_ws", "gn_ws", {}, {}),
        ("resnest", "resnest", {}, {}),
        ("hrnet", "hrnet", {"canvas": EXACT_CANVAS}, {}),
        ("fpg", "fpg", {"canvas": EXACT_CANVAS}, {}),
        ("resnext", "faster_rcnn", {"backbone_type": "resnext"}, {"backbone_type": "resnext"}),
        ("res2net", "faster_rcnn", {"backbone_type": "res2net"}, {"backbone_type": "res2net"}),
        ("regnet", "faster_rcnn", {"backbone_type": "regnet"},
         {"backbone_type": "regnet", "regnet_arch": "regnetx_400mf"})))
BACKBONE_EXPORT = "gn_ws"  # the family exported at batch 8 (a subprocess traces it)


def backbones_path(device, card: str) -> tuple:
    """The phase of the rest of Faster R-CNN's config variants: PISA,
    GN+WS and ResNeSt at 608 x 1024, HRNet-w32 and FPG at EXACT_CANVAS (and
    its portrait), ResNeXt-50 32x4d, Res2Net-50 and RegNetX-3.2GF as
    backbone_type on Faster R-CNN, each through zoo_family_path with its
    eval (training at batch 2, the tiny steps on the card against the
    CPU, the eval over the 26 canvases at batch 8); the trainer's CLI with
    --family pisa_faster_rcnn (frcnn_cli_path); BACKBONE_EXPORT's eval step
    exported at batch 8 in both orientations by a subprocess while the
    families run, loaded from its archive and held to the eager step,
    every image bit for bit (PISA's train step on two gloo ranks runs in
    the deploy phase, RANK_FAMILIES). Each
    path's kernel launch counts reset just before it and read just after:
    neither kernel lies on these paths, so each must read 0. Returns
    (result, launches by path)."""
    import torch

    t0 = time.time()
    shutil.rmtree(DEPLOY, ignore_errors=True)
    DEPLOY.mkdir(parents=True)
    out, launches = {}, {}

    def counted(name, fn):
        count_path(out, launches, name, fn)

    cfg, model, triples, n = sharpened_two_stage(device, BACKBONE_EXPORT)
    proc = start_export_program(BACKBONE_EXPORT, model)
    for run in BACKBONE_RUNS:
        counted(run["name"], lambda run=run: zoo_family_path(device, card, run["family"], True,
                                                             run))
    counted("pisa_faster_rcnn_cli", lambda: frcnn_cli_path(device, "pisa_faster_rcnn",
                                                           BACKBONES / "cli"))
    print("train_detector --family pisa_faster_rcnn, Detector and FPS tool:",
          json.dumps(out["pisa_faster_rcnn_cli"]), f"[{card}]", flush=True)
    shutil.rmtree(BACKBONES, ignore_errors=True)

    def export():
        reading, _ = exported_against_eager(
            device, cfg, model, triples, n,
            finish_export_program(proc, BACKBONE_EXPORT)["export_s"])
        if reading["images_bit_equal"] != n:
            fail(f"{BACKBONE_EXPORT} export: {reading['images_bit_equal']} of {n} images "
                 "bit-equal to the eager step")
        return reading

    counted(f"{BACKBONE_EXPORT}_export", export)
    print(f"{BACKBONE_EXPORT} export:", json.dumps(out[f"{BACKBONE_EXPORT}_export"]),
          f"[{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(DEPLOY, ignore_errors=True)
    out["phase_s"] = time.time() - t0
    return out, launches


# --- the proposal families: RPN-only, Fast R-CNN, Cascade RPN, TridentNet, Grid R-CNN --

PROPOSALS = REPO / "build" / "chip_smoke_proposals"
# in this order: Fast R-CNN's eval takes the RPN's proposals of the pool
PROPOSAL_FAMILIES = ("rpn", "fast_rcnn", "cascade_rpn", "tridentnet", "grid_rcnn")
PROPOSAL_TRAIN_STEPS = 2  # timed steps at batch 2 after the 2 warm-up ones
# the families whose eval gives proposals, scored by AR@100 (fast_eval_recall)
RECALL_FAMILIES = ("rpn", "cascade_rpn")


def sharpen_classes(model, run) -> None:
    """Zero the box head's fc_cls bias and background row and scale its
    weight so that the class logits of one call of `run` (an eval step)
    have a std of CLS_LOGIT_STD (sharpen_frcnn's rule, read through a
    hook: TridentNet's head on C4, Grid R-CNN's cls-only one, Fast
    R-CNN's on given proposals)."""
    import torch

    fc = model.bbox_head.fc_cls
    outs = []
    with torch.no_grad():
        fc.bias.zero_()
        fc.weight[-1].zero_()
        hook = fc.register_forward_hook(lambda m, i, o: outs.append(o))
        try:
            run()
        finally:
            hook.remove()
        fc.weight.mul_(CLS_LOGIT_STD / outs[0].std().item())


def proposal_eval_path(device, family: str, pool_proposals: dict) -> dict:
    """The family's eval at full width (seed 0, zero starts drawn, its
    objectness and class heads sharpened on the first batch) over the 26
    synthetic canvases at batch 8, both orientations: img/s and peak
    memory of a sweep that reads the detections per class to the host,
    after a warm-up sweep; one batch's device time by stage; the first
    LATER_CPU_CANVASES canvases against the CPU's eval step on them (the
    same valid slots, labels and sources, boxes and scores to FRCNN_RTOL,
    any difference traced to near-ties by proposal_eval_ties). RPN-only
    and Cascade RPN: their proposals' AR@100 against synthetic_gts, and
    the RPN's proposals of the pool (original coordinates, score-ordered)
    kept in `pool_proposals` by pool index;
    Fast R-CNN's eval runs on them (tools/train_detector.py
    fast_rcnn_proposals: scaled to each canvas, num_proposals slots)."""
    import torch
    from aod_meh_hua_torch.engine.eval import detections_to_per_class
    from aod_meh_hua_torch.engine.rpn_only import make_fast_rcnn_eval_step, proposal_recall
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.tools.train_detector import fast_rcnn_proposals
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    cfg = ZOO_FAMILIES[family][0]()
    what = f"{family} eval"
    model = seeded_two_stage(cfg, device)
    seed_zero_starts(model, seed=0)
    triples, n = synthetic_pool(cfg)
    fast = family == "fast_rcnn"

    def make(m, ocfg, dev):
        if fast:
            return make_fast_rcnn_eval_step(m, ocfg, dev)
        return make_two_stage_eval_step(m, ocfg, device=dev)

    def args(batch, host, idx):
        """The step's arguments: the batch, and for Fast R-CNN the pool's
        proposals of its images (from the host batch's scale factors)."""
        if not fast:
            return (batch,)
        props, valid = fast_rcnn_proposals(pool_proposals, host, idx, cfg.num_proposals)
        return batch, torch.from_numpy(props).to(device), torch.from_numpy(valid).to(device)

    steps = {o: make(model, cfg.for_orientation(o), device) for o in ("landscape", "portrait")}
    batches = [(o, upload(b, device), b, idx) for o, b, idx in triples]
    o0, b0, h0, i0 = batches[0]
    if family == "tridentnet":  # as its training (calibrate_frozen_bn)
        calibrate_frozen_bn(model, cfg.for_orientation(o0), b0.images, b0.img_shapes)
    if objectness_conv(model) is not None:
        sharpen_frcnn(model, cfg.for_orientation(o0), b0.images, b0.img_shapes, classes=False)
    if family not in RECALL_FAMILIES:
        sharpen_classes(model, lambda: steps[o0](*args(b0, h0, i0)))
    nc = cfg.num_fg_classes

    def sweep():
        rows, outs = [], []
        for o, b, h, idx in batches:
            outs.append(steps[o](*args(b, h, idx)))
            rows += detections_to_per_class(outs[-1], nc, batch_valid=b.valid)
        return rows, outs[0]

    for o in ("landscape", "portrait"):  # warm-up: one batch of each canvas
        steps[o](*args(*next(x[1:] for x in batches if x[0] == o))).valid.cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    rows, timed_first = sweep()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device)
    if len(rows) != n or not all(np.isfinite(a).all() for r in rows for a in r):
        fail(f"{what}: {len(rows)} images of {n}, or a detection not finite")
    n_dets = sum(len(a) for r in rows for a in r)
    if n_dets == 0:
        fail(f"{what}: no detection in the pool")
    prof = profile_stages(lambda: steps[o0](*args(b0, h0, i0)).valid.cpu(), FRCNN_GROUPS)
    out = dict(batch=BATCH, images=n, sweep_s=wall, img_per_s=n / wall, peak_mem_bytes=peak,
               detections=n_dets, profile_of_one_batch=prof)
    if family in RECALL_FAMILIES:
        anns = synthetic_gts(triples, 1)
        ar = proposal_recall([r[0][:, :4] for r in rows], [np.ones(len(r[0]), bool) for r in rows],
                             [a["bboxes"] for a in anns])
        if not 0.0 <= ar <= 1.0:
            fail(f"{what}: AR@100 {ar}")
        out["AR@100_synthetic_gt"] = ar
        if family == "rpn":
            order = [i for _, _, idx in triples for i in idx]
            pool_proposals.update({str(int(i)): r[0] for i, r in zip(order, rows)})
    # the timed sweep's first two canvases against the CPU's eval step on them
    cpu_model = cpu_twin(model)
    k = LATER_CPU_CANVASES
    two = type(triples[0][1])(*(a[:k] for a in triples[0][1]))
    cpu_args = (two,) if not fast else (two,) + fast_rcnn_proposals(
        pool_proposals, two, i0[:k], cfg.num_proposals)
    rec = {}  # the CPU's proposals and NMS inputs, for proposal_eval_ties
    with recording(rec, "cpu"):
        want = _host_dets(make(cpu_model, cfg.for_orientation(o0), "cpu")(*cpu_args))
    got = _host_dets(type(timed_first)(*(t[:k] for t in timed_first)))
    ties = None
    if family in RECALL_FAMILIES:
        # proposals as sets: their slots follow the scores, whose near-ties
        # (about 1e-7 apart) trade places between the devices
        flips = proposals_agree(got, want, cfg.rpn.nms_iou_thr)
        if flips:
            fail(f"{what} card vs CPU: {flips}")
    else:
        flips = [i for i in range(k) if not _dets_agree(got, want, i, FRCNN_RTOL)]
        if flips:
            ties = proposal_eval_ties(model, cpu_model, cfg.for_orientation(o0), make, rec,
                                      args(upload(two, device), two, i0[:k]), want, device)
    out["card_vs_cpu"] = {"images": k, "flips": flips, "ties": ties,
                          "detections": int(got.valid.sum())}
    return out


@contextlib.contextmanager
def recording(rec: dict, name: str, pinned=None):
    """Within the block, every two-stage eval step records into `rec` its
    RPN's outputs (name.rpn), its proposals (name.props) and its
    detection NMS's inputs and output (name); with `pinned`, proposals,
    the step takes those in place of its own."""
    from aod_meh_hua_torch.engine import two_stage

    real_nms, real_props = two_stage.TwoStageEvalStep._nms, two_stage.make_proposal_fn

    def nms(self, boxes, fg):
        res = real_nms(self, boxes, fg)
        rec[name] = (boxes.detach().cpu(), fg.detach().cpu(), _host_dets(res))
        return res

    def make_fn(c, device_loop=False):
        fn = real_props(c, device_loop)

        def run(*a):
            res = tuple(t.detach() for t in fn(*a))
            rec[name + ".rpn"] = [t.detach().cpu() for t in a[:2]]
            rec[name + ".props"] = [t.cpu() for t in res]
            return res if pinned is None else tuple(t.to(res[0].device) for t in pinned)
        return run

    with mock.patch.object(two_stage, "make_proposal_fn", make_fn), \
            mock.patch.object(two_stage.TwoStageEvalStep, "_nms", nms):
        yield rec


def proposal_eval_ties(model, cpu_model, cfg, make, rec, card_args, want, device) -> dict:
    """Where a family's detections on the compared canvases (TridentNet's, Grid
    R-CNN's, Fast R-CNN's) differ from the CPU's (`want`), the stage that
    parts them, as eval_ties and nms_input_ties trace Faster R-CNN's:
    every proposal that the card keeps and the CPU not, or the other way
    round, decided at the NMS threshold (TIE_THR_ATOL) or the twin of one
    the other device keeps, once the RPN's outputs agree within
    FRCNN_RTOL of their max-abs: its score within FRCNN_RTOL and its box
    at IoU TIE_IOU or within FRCNN_RTOL of its largest coordinate plus
    1e-3 px (a random C4 trunk's proposals part by 1e-5 of their scores
    and 2-6e-3 px, beyond proposal_flips' 1e-3 px, on an H100); from the
    CPU's proposals, the detection
    NMS's inputs within FRCNN_RTOL of the scores' max-abs and 1e-3 px, and
    the card's inputs through the NMS on the CPU giving the card's NMS
    output; for Grid R-CNN, whose boxes the grid then refines, each box
    that still differs named with its heatmap's argmax near-tie. Fails
    otherwise. `rec`: the CPU's run, recorded (recording)."""
    import torch
    from aod_meh_hua_torch.engine import two_stage
    from aod_meh_hua_torch.ops.bbox import bbox_overlaps

    for name, pin in (("card_own", None), ("card", rec.get("cpu.props"))):
        with recording(rec, name, pin), torch.no_grad():
            rec[name + ".out"] = _host_dets(make(model, cfg, device)(*card_args))
    out = {}
    if "cpu.props" in rec:
        err = max(((g - c).abs().max() / c.abs().max().clamp(min=1e-30)).item()
                  for c, g in zip(rec["cpu.rpn"], rec["card_own.rpn"]))
        out["rpn_err_of_max"] = err
        if err > FRCNN_RTOL:
            fail(f"{cfg.family} eval card vs CPU: the RPN's outputs differ by {err} of their max")
        flips = proposal_flips(rec["card_own.props"], rec["cpu.props"], cfg.rpn.nms_iou_thr)
        untied = []
        for f in flips:
            box = np.asarray(f["box"])

            def twin(g):
                other = np.asarray(g["box"])
                return (g["image"] == f["image"] and g["which"] != f["which"]
                        and abs(g["score"] - f["score"]) <= FRCNN_RTOL * abs(f["score"])
                        and (bbox_overlaps(torch.tensor([f["box"]]), torch.tensor([g["box"]]))
                             .item() >= TIE_IOU
                             or np.abs(other - box).max() <= FRCNN_RTOL * np.abs(box).max()
                             + 1e-3))

            twins = [g for g in flips if twin(g)]
            if not twins and abs(f["max_iou_with_a_higher_one"] - f["iou_thr"]) > TIE_THR_ATOL:
                untied.append(f)
        if untied:
            fail(f"{cfg.family} eval card vs CPU: proposals differ beyond near-ties: {untied}")
        out["proposal_flips"] = flips
    got = rec["card.out"]
    n = got.valid.shape[0]
    off = [i for i in range(n) if not _dets_agree(got, want, i, FRCNN_RTOL)]
    out["from_cpu_proposals"] = "agree" if not off else f"images {off} differ"
    if not off:
        return out
    (cb, cf, cres), (gb, gf, gres) = rec["cpu"], rec["card"]
    score_err = ((gf - cf).abs().max() / cf.abs().max().clamp(min=1e-30)).item()
    box_err = (gb - cb).abs().max().item()
    replay = _host_dets(two_stage.TwoStageEvalStep(cpu_model, cfg)._nms(gb, gf))
    replay_off = [i for i in range(n) if not _dets_agree(replay, gres, i, FRCNN_RTOL)]
    out.update(nms_score_err_of_max=score_err, nms_box_err_px=box_err,
               card_inputs_through_cpu_nms="the card's NMS output" if not replay_off
               else f"images {replay_off} differ")
    if score_err > FRCNN_RTOL or box_err > 1e-3 or replay_off:
        fail(f"{cfg.family} eval card vs CPU: {out}")
    if cfg.family == "grid_rcnn":
        out["grid_refine"] = grid_refine_ties(got, want, gres, cres)
    return out


def grid_refine_ties(got, want, card_nms, cpu_nms) -> dict:
    """Grid R-CNN's refined boxes where the NMS outputs agree: the same
    valid slots, labels and scores, and each box that differs beyond
    FRCNN_RTOL named (the grid heatmaps' argmax near-ties move a point by
    a heatmap cell, 1 / 28 of its expanded box). Fails when the NMS outputs
    differ, or a box moves by more than a cell's width of its box."""
    off = []
    for i in range(got.valid.shape[0]):
        if not _dets_agree(card_nms, cpu_nms, i, FRCNN_RTOL):
            fail(f"grid_rcnn eval card vs CPU: image {i}'s NMS outputs differ")
        v = got.valid[i]
        if not (np.array_equal(v, want.valid[i]) and np.array_equal(got.labels[i], want.labels[i])
                and np.allclose(got.scores[i], want.scores[i], rtol=FRCNN_RTOL, atol=0)):
            fail(f"grid_rcnn eval card vs CPU: image {i}'s slots, labels or scores differ")
        gb, wb, nb = got.boxes[i][v], want.boxes[i][v], card_nms.boxes[i][v]
        cell = 2.0 * np.maximum(nb[:, 2] - nb[:, 0], nb[:, 3] - nb[:, 1]) / 28.0
        for j in np.nonzero(~np.isclose(gb, wb, rtol=FRCNN_RTOL, atol=1e-3).all(1))[0]:
            moved = float(np.abs(gb[j] - wb[j]).max())
            if moved > cell[j]:
                fail(f"grid_rcnn eval card vs CPU: box {j} of image {i} moved {moved} px, "
                     f"beyond a heatmap cell ({cell[j]} px)")
            off.append({"image": i, "slot": int(j), "moved_px": moved, "cell_px": float(cell[j])})
    return {"boxes_moved_by_a_cell_or_less": off}


def proposals_agree(got, want, iou_thr: float) -> list:
    """Two devices' proposals of the same images (host ProposalResults) as
    sets: every proposal one keeps and the other not (proposal_flips,
    boxes within 1e-3 px), and every kept one whose twin's score is not
    within FRCNN_RTOL; [] when they agree."""
    import torch

    out = proposal_flips([torch.from_numpy(a) for a in (got.boxes, got.scores, got.valid)],
                         [torch.from_numpy(a) for a in (want.boxes, want.scores, want.valid)],
                         iou_thr)
    for i in range(got.boxes.shape[0]):
        gb, gs = got.boxes[i][got.valid[i]], got.scores[i][got.valid[i]]
        wb, ws = want.boxes[i][want.valid[i]], want.scores[i][want.valid[i]]
        close = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1) <= 1e-3
        for j in np.nonzero(close.any(1))[0]:
            twin = ws[close[j]]
            if not np.isclose(twin, gs[j], rtol=FRCNN_RTOL, atol=0).any():
                out.append({"image": i, "score_off": [float(gs[j]), twin.tolist()]})
    return out


def proposal_family_path(device, card: str, family: str, pool_proposals: dict) -> dict:
    """One proposal family at full width: training (frcnn_train_path, 2 +
    PROPOSAL_TRAIN_STEPS steps at batch 2, no profiled step), its tiny
    config's steps on the card against the CPU, each from the CPU's
    state (frcnn_card_vs_cpu), and its eval (proposal_eval_path). Each
    reading is printed as it comes."""
    import torch

    out = {}
    for name, fn in (
            ("train", lambda: frcnn_train_path(device, family, None, PROPOSAL_TRAIN_STEPS,
                                               calibrate=family == "tridentnet",
                                               profile=False)),
            ("card_vs_cpu", lambda: frcnn_card_vs_cpu(device, family, from_cpu_state=True)),
            ("eval", lambda: proposal_eval_path(device, family, pool_proposals))):
        t0 = time.time()
        out[name] = fn()
        out[name]["path_s"] = time.time() - t0
        torch.cuda.empty_cache()
        print(f"{family} {name}:", json.dumps(out[name]), f"[{card}]", flush=True)
    return out


def proposal_cli_path(device, root: Path) -> dict:
    """The RPN -> gen_proposals -> Fast R-CNN workflow through the port's
    CLIs, in process, at full width on a VOC07 tree of the fixture JPEGs
    (TWO_STAGE_CLI_TRAINVAL trainval, 8 test) under `root`: train_detector --family rpn for
    one epoch (its eval AR@100), gen_proposals from its checkpoint for
    each split, train_detector --family fast_rcnn --proposal-file
    --proposal-file-val for one epoch; each CLI must pin the numerics."""
    from aod_meh_hua_torch.tools import gen_proposals, train_detector

    shutil.rmtree(root, ignore_errors=True)
    voc07 = synthetic_voc(root, n_trainval=TWO_STAGE_CLI_TRAINVAL)
    work = root / "work"
    out = {}
    t0 = time.time()
    (_, _, rpn_metrics), _ = run_cli(train_detector.main, [
        "--family", "rpn", "--voc07", str(voc07), "--work-dir", str(work / "rpn"),
        "--epochs", "1"])
    out["rpn_cli_s"] = time.time() - t0
    row = rpn_metrics[-1]
    if not (np.isfinite(row["loss"]) and 0.0 <= row.get("AR@100", -1) <= 1.0):
        fail(f"train_detector --family rpn: {rpn_metrics}")
    files = {}
    for split, n in (("trainval", TWO_STAGE_CLI_TRAINVAL), ("test", AL_TEST)):
        files[split] = str(work / f"{split}.npz")
        t0 = time.time()
        props, _ = run_cli(gen_proposals.main, [
            "--voc07", str(voc07), "--checkpoint", str(work / "rpn" / "rpn_final.ckpt"),
            "--split", f"ImageSets/Main/{split}.txt", "--out", files[split]])
        out[f"gen_proposals_{split}_s"] = time.time() - t0
        counts = [len(v) for v in props.values()]
        if (sorted(props, key=int) != [str(i) for i in range(n)] or min(counts) == 0
                or not all(np.isfinite(v).all() and (np.diff(v[:, 4]) <= 0).all()
                           for v in props.values())):
            fail(f"gen_proposals {split}: {len(props)} images, counts {counts}")
        out[f"proposals_per_image_{split}"] = [min(counts), float(np.mean(counts)), max(counts)]
    t0 = time.time()
    (_, _, fast_metrics), _ = run_cli(train_detector.main, [
        "--family", "fast_rcnn", "--voc07", str(voc07), "--work-dir", str(work / "fast"),
        "--epochs", "1", "--proposal-file", files["trainval"],
        "--proposal-file-val", files["test"]])
    out["fast_rcnn_cli_s"] = time.time() - t0
    if not (np.isfinite(fast_metrics[-1]["loss"]) and "mAP" in fast_metrics[-1]):
        fail(f"train_detector --family fast_rcnn: {fast_metrics}")
    out.update(rpn_metrics=rpn_metrics, fast_rcnn_metrics=fast_metrics)
    return out


def proposals_path(device, card: str) -> tuple:
    """The phase of the proposal families: RPN-only, Fast R-CNN, Cascade
    RPN, TridentNet and Grid R-CNN at full width (608 x 1024) through
    proposal_family_path (training, the tiny steps on the card against the
    CPU, the eval over the 26 canvases, Fast R-CNN's on the RPN's
    proposals); the RPN -> gen_proposals -> Fast R-CNN workflow through
    the CLIs (proposal_cli_path); the trainer's CLI with --family
    grid_rcnn, its Detector and the FPS tool (frcnn_cli_path). No export
    on the card (the tiny exports are CPU tests). Each path's kernel
    launch counts reset just before it and read just after: neither
    kernel lies on these paths, so each must read 0. Returns (result,
    launches by path)."""
    t0 = time.time()
    out, launches = {}, {}

    def counted(name, fn):
        count_path(out, launches, name, fn)

    pool_proposals = {}
    for family in PROPOSAL_FAMILIES:
        counted(family, lambda family=family: proposal_family_path(device, card, family,
                                                                   pool_proposals))
    counted("proposal_cli", lambda: proposal_cli_path(device, PROPOSALS / "cli"))
    print("train_detector --family rpn, gen_proposals, train_detector --family fast_rcnn:",
          json.dumps(out["proposal_cli"]), f"[{card}]", flush=True)
    counted("grid_rcnn_cli", lambda: frcnn_cli_path(device, "grid_rcnn", PROPOSALS / "grid"))
    print("train_detector --family grid_rcnn, Detector and FPS tool:",
          json.dumps(out["grid_rcnn_cli"]), f"[{card}]", flush=True)
    shutil.rmtree(PROPOSALS, ignore_errors=True)
    out["phase_s"] = time.time() - t0
    return out, launches


# --- the two-stage families' export, archive server and train step across ranks -----

DEPLOY = REPO / "build" / "chip_smoke_two_stage_deploy"
# their train steps on two ranks, in one group of rank subprocesses (each group took
# about 25 s to start on the card's host)
RANK_FAMILIES = ("faster_rcnn", "double_head_rcnn", "pisa_faster_rcnn")
RANK_TIMED = 3  # timed steps per rank after the DIST_STEPS compared ones
TWO_STAGE_REQUESTS = 16  # to the two-stage archive's server: two batches of the fixtures


def sharpened_two_stage(device, family: str):
    """The family's full-width config and model (seed 0, its heads
    sharpened on the first synthetic batch, as frcnn_eval_path), and the
    synthetic pool: (cfg, model, triples, n)."""
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    cfg = ZOO_FAMILIES[family][0]()
    model = seeded_two_stage(cfg, device)
    triples, n = synthetic_pool(cfg)
    first = upload(triples[0][1], device)
    sharpen_frcnn(model, cfg.for_orientation(triples[0][0]), first.images, first.img_shapes)
    return cfg, model, triples, n


def export_both_orientations(cfg, model, root: Path) -> dict:
    """The model's eval step exported at batch 8 in both orientations and
    saved under `root` (family_orientation.pt2): the seconds it took and
    each program's fused operator nodes."""
    from aod_meh_hua_torch.tools.deployment import export_model

    t0 = time.time()
    nodes = {}
    for o in ("landscape", "portrait"):
        program = export_model.export_eval_step(cfg.for_orientation(o), model, BATCH)
        nodes[o] = export_model.fused_nodes(program)
        export_model.save_program(program, str(root / f"{cfg.family}_{o}.pt2"))
    return {"export_s": time.time() - t0, "fused_nodes": nodes}


def export_program(spec: dict) -> dict:
    """Subprocess program: export_both_orientations of the family's
    full-width model (RetinaNet's with fused_blocks on) with the weights of
    spec's file. Tracing is host work: it runs beside the main process's
    phases, two families at once in the deploy phase."""
    import torch
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES, RetinaNetConfig

    if spec["family"] == "retinanet":
        cfg = RetinaNetConfig(fused_blocks=True)
        model = build_retinanet(cfg, device="cuda")
    else:
        cfg = ZOO_FAMILIES[spec["family"]][0]()
        model = build_two_stage(cfg, device="cuda")
    model.load_state_dict(torch.load(spec["weights"], map_location="cuda"))
    return export_both_orientations(cfg, model, Path(spec["root"]))


def start_export_program(family: str, model, root: Path = DEPLOY):
    """export_program for `model` in a subprocess of this script
    (--rank-program export, its log, result and programs under `root`):
    the process."""
    import torch

    weights = root / f"{family}_weights.pt"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, weights)
    spec = root / f"{family}_export.json"
    spec.write_text(json.dumps({"family": family, "weights": str(weights), "root": str(root),
                                "result": str(root / f"{family}_export.result.json")}))
    with open(root / f"{family}_export.log", "w") as log:
        return spawn(["--rank-program", "export", str(spec)], dict(os.environ, RANK="0"), log)


def finish_export_program(proc, family: str, root: Path = DEPLOY) -> dict:
    """Wait for start_export_program's process (DIST_WALL_S at most): its
    result (export_both_orientations')."""
    try:
        proc.wait(timeout=DIST_WALL_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
    if proc.returncode != 0:
        fail(f"{family} export subprocess: exit code {proc.returncode}; log tail "
             f"{(root / f'{family}_export.log').read_text()[-3000:]}")
    return json.loads((root / f"{family}_export.result.json").read_text())


def exported_against_eager(device, cfg, model, triples, n: int, export_s: float):
    """The family's saved programs (export_both_orientations) packaged
    into one archive and loaded back by serve.py's ArchiveDetector: load
    s, archive MB; on the 26 synthetic canvases the loaded programs'
    detections against the eager TwoStageEvalStep's (the same valid
    slots, labels and sources, boxes and scores to FRCNN_RTOL; no image
    may differ), and ms per batch of the two in turns. Returns the
    reading and the ArchiveDetector."""
    import torch
    from aod_meh_hua_torch.data.voc import VOC_CLASSES
    from aod_meh_hua_torch.engine.batch import EvalBatch, prepare_images
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.tools.deployment import export_model, package_model
    from aod_meh_hua_torch.tools.deployment.serve import ArchiveDetector

    family = cfg.family
    archive = package_model.package(str(DEPLOY / f"{family}_landscape.pt2"), str(DEPLOY),
                                    family, family=family,
                                    artifact_portrait=str(DEPLOY / f"{family}_portrait.pt2"),
                                    classes=VOC_CLASSES,
                                    geometry=package_model.geometry_for(cfg, BATCH))
    t0 = time.time()
    adet = ArchiveDetector(archive)
    load_s = time.time() - t0
    modules, manifest = adet.programs, adet.manifest
    steps = {o: make_two_stage_eval_step(model, cfg.for_orientation(o), device=device)
             for o in modules}

    def float_batch(o, b):  # the programs take canvases normalised before the call
        up = upload(b, device)
        return EvalBatch(prepare_images(up.images, up.img_shapes, cfg.for_orientation(o)),
                         up.img_shapes, up.scale_factors, b.valid)

    batches = [(o, float_batch(o, b), idx) for o, b, idx in triples]
    eager = [_host_dets(steps[o](b)) for o, b, _ in batches]
    exported = [_host_dets(export_model.run_program(modules[o], b)) for o, b, _ in batches]
    off = [{"image": int(idx[i]), "eager_valid": int(e.valid[i].sum()),
            "exported_valid": int(x.valid[i].sum())}
           for (_, _, idx), e, x in zip(batches, eager, exported) for i in range(len(idx))
           if not _dets_agree(x, e, i, FRCNN_RTOL)]
    bit_equal = sum(all(np.array_equal(a[i], b[i]) for a, b in zip(x, e))
                    for (_, _, idx), e, x in zip(batches, eager, exported)
                    for i in range(len(idx)))
    n_dets = sum(int(e.valid.sum()) for e in eager)
    if off or n_dets == 0:
        fail(f"{family} export: the loaded programs against the eager step: {off}, "
             f"{n_dets} detections")
    timing = {"eager": [], "exported": []}
    for name in ("eager", "exported", "exported", "eager"):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for o, b, _ in batches:
            (steps[o](b) if name == "eager" else export_model.run_program(modules[o], b))
        torch.cuda.synchronize()
        timing[name].append((time.perf_counter() - t0) * 1e3 / len(batches))
    out = dict(batch=BATCH, canvases=n, batches=len(batches), export_s=export_s, load_s=load_s,
               archive_mb=os.path.getsize(archive) / 1e6, manifest_family=manifest["family"],
               detections=n_dets, images_bit_equal=bit_equal, images_off=off,
               ms_per_batch=timing, stage_ranges="none: torch.export drops them")
    return out, adet


def two_stage_archive_server_path(model, adet) -> dict:
    """An ArchiveDetector behind the Batcher and the HTTP handler
    (serve_load: TWO_STAGE_REQUESTS POSTs of the fixture JPEGs), each
    reply held to a Detector's rows with the same weights and the default
    pipeline; no kernel launch."""
    from aod_meh_hua_torch.api import Detector
    from aod_meh_hua_torch.data.jpeg import imread
    from aod_meh_hua_torch.data.voc import VOC_CLASSES
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    files = sorted(FIXTURES.glob("*.jpg"))
    imgs = [imread(str(f)) for f in files]
    det = Detector(ZOO_FAMILIES[adet.manifest["family"]][0](), model)
    expected = [_rows(r, VOC_CLASSES, ZOO_SERVE_THR)
                for r in (det.predict_batch([i], max_batch=BATCH)[0] for i in imgs)]
    if not any(expected):
        fail(f"serve_archive ({adet.manifest['family']}): no row at or above {ZOO_SERVE_THR}")
    adet.predict_batch(imgs)  # warm-up
    return serve_load(adet, [f.read_bytes() for f in files], expected,
                      f"serve_archive ({adet.manifest['family']})", per_forward=0,
                      score_thr=ZOO_SERVE_THR, requests=TWO_STAGE_REQUESTS)


def rank_step_draws(cfg, steps: int, b: int, seed: int) -> list:
    """Per step, the global batch's sampler uniforms by stage ([b, n], as
    many as the stage's sampler takes: u_pos, u_neg, or Libra R-CNN's
    seven for its RoIs), drawn on the host from one seeded generator."""
    import torch
    from aod_meh_hua_torch.engine.two_stage import roi_draws

    gen = torch.Generator().manual_seed(seed)
    sizes = {"rpn": (cfg.level_bounds()[-1][1], 2),
             "roi": (cfg.max_gt + cfg.rpn.train_max_per_img, roi_draws(cfg))}
    return [{k: tuple(torch.rand((b, n), generator=gen) for _ in range(k_draws))
             for k, (n, k_draws) in sizes.items()} for _ in range(steps)]


def _train_state(model, opt) -> dict:
    """A step's starting state on the host: the state dict and each
    parameter's SGD momentum by name."""
    from aod_meh_hua_torch.parallel import gather_to_host

    by_param = {p: n for n, p in model.named_parameters()}
    return {"weights": gather_to_host(model),
            "momentum": {by_param[p]: s["momentum_buffer"].detach().cpu().clone()
                         for p, s in opt.state.items() if "momentum_buffer" in s}}


def _one_step_from(model, cfg, state: dict, batch, draw, device, mesh=None):
    """From `state` (_train_state's; the momentum may be empty), one step of
    the family's train step on `batch` (a Batch of tensors on `device`)
    under the draw `draw` (stage -> its uniforms, of its rows): the aux,
    and the model and its optimizer after it."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.utils.config import TrainConfig

    model.load_state_dict(state["weights"])
    opt = create_train_state(model, TrainConfig(), frozen_stages=cfg.frozen_stages)
    for name, p in model.named_parameters():
        if name in state["momentum"]:
            opt.state[p]["momentum_buffer"] = state["momentum"][name].to(device).clone()
    step = make_two_stage_train_step(model, cfg, opt, device=device, mesh=mesh)
    aux = step(batch, uniforms=lambda stage, n, k: tuple(u.to(device) for u in draw[stage]))
    return {k: float(v) for k, v in aux.items()}, opt


class _AxisReplay:
    """The data axis of one image of a one-process batch: recording
    (values=None), each sum passes the whole batch's value through and
    keeps it; replaying, each sum returns the kept value of its call."""

    group, size, index = None, 1, 0

    def __init__(self, values=None):
        self.record = values is None
        self.values = [] if values is None else list(values)

    def sum(self, t):
        if self.record:
            self.values.append(t.detach().clone())
            return t
        return self.values.pop(0)


class _Accumulate:
    """The optimizer that the steps of one image at a time see: none moves
    the weights, so their gradients add up."""

    defaults = {"grad_clip": None}

    def step(self):
        pass


def faster_rcnn_one_image_at_a_time(model, cfg, state, batch, draw, device) -> dict:
    """One Faster R-CNN step from `state` computed one image at a time in
    one process: each image's forward and backward alone, its losses over
    the whole batch's normalisers (recorded by a pass over the batch), the
    gradients summed by autograd, then the optimizer's step: the step's
    function with every gradient a sum of per-image sums, as two ranks
    sum them. The weights after it."""
    import torch
    from aod_meh_hua_torch.engine import two_stage
    from aod_meh_hua_torch.parallel import gather_to_host

    b = type(batch)(*(torch.from_numpy(a).to(device) for a in batch))
    _, opt = _one_step_from(model, cfg, {"weights": gather_to_host(model), "momentum": {}},
                            b, draw, device)  # builds opt; the weights are reset below
    model.load_state_dict(state["weights"])
    for name, p in model.named_parameters():
        if name in state["momentum"]:
            opt.state[p]["momentum_buffer"] = state["momentum"][name].to(device).clone()
        else:
            opt.state[p].pop("momentum_buffer", None)
    on_device = {k: tuple(u.to(device) for u in v) for k, v in draw.items()}
    recorded = _AxisReplay()
    with mock.patch.object(two_stage, "DataAxis", lambda: recorded):
        two_stage.make_two_stage_train_step(model, cfg, _Accumulate(), device)(
            b, uniforms=lambda stage, n, k: on_device[stage])
    model.zero_grad(set_to_none=True)
    with mock.patch.object(model, "zero_grad", lambda **kw: None):
        for i in range(len(batch.images)):
            with mock.patch.object(two_stage, "DataAxis",
                                   lambda: _AxisReplay(recorded.values)):
                step = two_stage.make_two_stage_train_step(model, cfg, _Accumulate(), device)
            step(type(b)(*(t[i:i + 1] for t in b)),
                 uniforms=lambda stage, n, k, i=i: tuple(u[i:i + 1] for u in on_device[stage]))
    opt.step()
    return gather_to_host(model)


def two_stage_plain_steps(model, cfg, init, batch, draws, device) -> dict:
    """DIST_STEPS of the family's one-process step, each from the state the
    rows in order reached (init first), on the batch's rows in each of
    DIST_ROW_ORDERS (the rows and their draws reordered or repeated) and,
    for Faster R-CNN, one image at a time: per step, the starting state
    and, per run, the aux (not of one image at a time) and the weights
    after the step. Swapping or repeating whole images keeps the sums over
    each image's rows; one image at a time splits them, as ranks do."""
    import torch
    from aod_meh_hua_torch.parallel import gather_to_host

    state = {"weights": init, "momentum": {}}
    steps = []
    for draw in draws[:DIST_STEPS]:
        runs = []
        for rows in DIST_ROW_ORDERS:
            rows = list(rows)
            b = type(batch)(*(torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                              for a in batch))
            aux, opt = _one_step_from(model, cfg, state, b, {k: tuple(u[rows] for u in v)
                                                             for k, v in draw.items()}, device)
            runs.append({"aux": aux, "weights": gather_to_host(model)})
            if rows == list(DIST_ROW_ORDERS[0]):
                after = _train_state(model, opt)
        if cfg.family == "faster_rcnn":
            runs.append({"aux": None, "weights": faster_rcnn_one_image_at_a_time(
                model, cfg, state, batch, draw, device)})
        steps.append({"state": state, "runs": runs})
        state = after
    return steps


def rank_two_stage_steps(spec: dict) -> dict:
    """Rank program: each of spec's families' train steps at full width, data
    parallel over gloo on the global batch of 2 (one image per rank),
    each of DIST_STEPS steps from the state the one process reached
    before it (spec's file: states and global draws), rank 0 saving the
    weights after each; then RANK_TIMED steps under a generator seeded
    alike on every rank, timed with CUDA events."""
    import torch
    import torch.distributed as dist
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.parallel import (barrier, gather_to_host, make_mesh, replicate,
                                            shard_batch)
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES, TrainConfig

    rank, world, device = rank_setup()
    out = {"rank": rank, "world": world, "device": str(device), "backend": dist.get_backend()}
    reset_launches()
    for family in spec["families"]:
        lcfg, batch = synthetic_train_batch(ZOO_FAMILIES[family][0](), "landscape",
                                            TrainConfig().batch_size, DIST_BATCH_SEED)
        saved = torch.load(spec[family], map_location="cpu")
        model = build_two_stage(lcfg, device=device)
        mesh = make_mesh(world, device_type=device.type)
        replicate(model, mesh)
        rows = shard_batch(Batch(*(torch.from_numpy(a).to(device) for a in batch)), mesh)
        barrier(family)
        torch.cuda.reset_peak_memory_stats(device)
        auxes, weights = [], []
        for state, draw in zip(saved["states"], saved["draws"]):
            aux, opt = _one_step_from(model, lcfg, state, rows, draw, device, mesh)
            auxes.append(aux)
            weights.append(gather_to_host(model))
        if rank == 0:
            torch.save(weights, DIST / f"two_stage_{family}_weights.pt")
        step = make_two_stage_train_step(model, lcfg, opt, device=device, mesh=mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RANK_TIMED):
            step(rows, gen)
        end.record()
        torch.cuda.synchronize()
        out[family] = {"aux": auxes, "ms_per_step": start.elapsed_time(end) / RANK_TIMED,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(device)}
        del model, step, weights, opt
        torch.cuda.empty_cache()
    out["launches"] = read_launches()
    dist.destroy_process_group()
    return out


def two_stage_ranks_path(device, families=RANK_FAMILIES) -> dict:
    """The families' full-width train steps (TrainConfig(), batch 2, the
    RPN head sharpened) on two gloo ranks sharing cuda:0 (subprocesses,
    rank_two_stage_steps) against the one-process step on the same batch
    under the same draws, each of DIST_STEPS steps taken by both from the
    same state (the one process's before it: a random-weight first step
    moves the class loss by a factor of four, and the rounding that one
    step leaves grows in the next). Per step, PR 8's rule: every tensor
    within DIST_RTOL of its max-abs or, where larger, within the largest
    spread of the one-process runs (two_stage_plain_steps) on any tensor
    of its kind (starting the training at zero, or not), the tensors that
    start at zero after the first step only; the losses alike, num_pos
    equal. No kernel launch on either rank; ms per step per rank. Every
    reading is made before a failure is raised."""
    import torch
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES, TrainConfig

    started = start_rank_programs("two_stage_steps")  # they start while the plain steps run
    tb = TrainConfig().batch_size
    spec, plain = {"families": list(families)}, {}
    for family in families:
        lcfg, batch = synthetic_train_batch(ZOO_FAMILIES[family][0](), "landscape", tb,
                                            DIST_BATCH_SEED)
        model = seeded_two_stage(lcfg, device)
        sharpen_frcnn(model, lcfg, torch.from_numpy(batch.images).to(device),
                      torch.from_numpy(batch.img_shapes).to(device), classes=False)
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        draws = rank_step_draws(lcfg, DIST_STEPS, tb, seed=17)
        plain[family] = two_stage_plain_steps(model, lcfg, init, batch, draws, device)
        spec[family] = str(DIST / f"two_stage_{family}_spec.pt")
        torch.save({"states": [s["state"] for s in plain[family]], "draws": draws},
                   spec[family])
        del model
        torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_rank_programs(started, spec)
    ranks_s = time.time() - t0
    if [(r["rank"], r["backend"], r["device"]) for r in ranks] != \
            [(i, "gloo", str(device)) for i in range(DIST_RANKS)]:
        fail(f"two-stage ranks: {[(r['rank'], r['backend'], r['device']) for r in ranks]}")
    if any(v for r in ranks for v in r["launches"].values()):
        fail(f"two-stage ranks: a hand-written kernel launched: {[r['launches'] for r in ranks]}")
    out, off = {"ranks_wall_s": ranks_s, "launches_per_rank": [r["launches"] for r in ranks]}, []
    for family in families:
        if ranks[0][family]["aux"] != ranks[1][family]["aux"]:
            off.append(f"{family}: the ranks report different aux")
        got_w = torch.load(DIST / f"two_stage_{family}_weights.pt", map_location="cpu")
        readings = []
        init = plain[family][0]["state"]["weights"]
        zero = {k for k, v in init.items() if v.is_floating_point() and not v.any()}
        for i, step in enumerate(plain[family]):
            ref, others = step["runs"][0], step["runs"][1:]
            spread = errs_of_scale_max([r["weights"] for r in others], ref["weights"])
            limit = {kind: max([DIST_RTOL] + [e for k, e in spread.items()
                                              if (k in zero) == kind]) for kind in (True, False)}
            errs = errs_of_scale(got_w[i], ref["weights"])
            # after the first step a tensor from zero is updates of gradients
            # that cancel: its scale is their rounding, which moves from call
            # to call (PERF.md section 6), so only the first step holds it
            held = {k: e for k, e in errs.items() if i == 0 or k not in zero}
            past = [{"tensor": k, "err_of_scale": e, "own_spread": spread.get(k),
                     "from_zero": k in zero} for k, e in held.items() if e > limit[k in zero]]
            # the losses (a repeated row doubles num_pos, not a loss)
            aux_err = lambda a: max(abs(a[k] - v) / max(abs(v), 1e-30)  # noqa: E731
                                    for k, v in ref["aux"].items() if "loss" in k)
            aux_limit = max([DIST_RTOL] + [aux_err(r["aux"]) for r in others if r["aux"]])
            got_aux = ranks[0][family]["aux"][i]
            if past or aux_err(got_aux) > aux_limit or got_aux["num_pos"] != ref["aux"]["num_pos"]:
                off.append(f"{family}, step {i + 1}: past the limits {limit} (from zero: True): "
                           f"{past[:6]}; loss rel err {aux_err(got_aux)} against {aux_limit}; "
                           f"aux {got_aux} against {ref['aux']}")
            readings.append({
                "max_err_of_scale": {kind: max([0.0] + [e for k, e in errs.items()
                                                        if (k in zero) == kind])
                                     for kind in (True, False)},
                "limit_of_scale": limit, "past_rtol": sorted(
                    ((k, e) for k, e in errs.items() if e > DIST_RTOL), key=lambda kv: -kv[1]),
                "loss_max_rel_err": aux_err(got_aux), "loss_limit": aux_limit,
                "aux": ref["aux"]})
        out[family] = {
            "batch": tb, "timed_steps": RANK_TIMED, "plain_runs": len(plain[family][0]["runs"]),
            "by_step (from zero: true/false)": readings,
            "ms_per_step_per_rank": [r[family]["ms_per_step"] for r in ranks],
            "peak_mem_bytes_per_rank": [r[family]["peak_mem_bytes"] for r in ranks]}
    if off:
        print("two-stage train steps on two ranks:", json.dumps(out), flush=True)
        fail(f"two-stage ranks: {off}")
    return out


def errs_of_scale_max(runs: list, want: dict) -> dict:
    """Per float tensor, the largest errs_of_scale over several runs."""
    out = {}
    for run in runs:
        for k, e in errs_of_scale(run, want).items():
            if want[k].is_floating_point():
                out[k] = max(out.get(k, 0.0), e)
    return out


EXPORT_FAMILIES = ("faster_rcnn", "cascade_rcnn")  # exported at full width, deploy phase


def start_two_stage_exports(device) -> dict:
    """EXPORT_FAMILIES' sharpened full-width models (sharpened_two_stage),
    each exported by a subprocess of its own (start_export_program), started
    before the Faster R-CNN phase so that the tracing, host work, runs
    beside it and the zoo phase: family -> (cfg, model, triples, n,
    process)."""
    shutil.rmtree(DEPLOY, ignore_errors=True)
    DEPLOY.mkdir(parents=True)
    started = {}
    for family in EXPORT_FAMILIES:
        cfg, model, triples, n = sharpened_two_stage(device, family)
        started[family] = (cfg, model, triples, n, start_export_program(family, model))
    return started


def two_stage_deploy_path(device, card: str, started: dict) -> tuple:
    """The phase of the two-stage families' export (the programs of
    start_two_stage_exports), archive server and train step across ranks,
    each path's kernel launch counts reset just before it and read just
    after: neither kernel lies on these paths, so each must read 0.
    Returns (result, launches by path)."""
    import torch

    t0 = time.time()
    out, launches = {}, {}

    def counted(name, fn):
        count_path(out, launches, name, fn)

    built = {f: v[:4] for f, v in started.items()}
    detectors = {}

    def export(family):
        cfg, model, triples, n = built[family]
        reading, detectors[family] = exported_against_eager(
            device, cfg, model, triples, n,
            finish_export_program(started[family][4], family)["export_s"])
        return reading

    for family in ("cascade_rcnn", "faster_rcnn"):
        counted(f"{family}_export", lambda family=family: export(family))
        print(f"{family} export:", json.dumps(out[f"{family}_export"]), f"[{card}]", flush=True)
    counted("two_stage_serve_archive", lambda: two_stage_archive_server_path(
        built["cascade_rcnn"][1], detectors["cascade_rcnn"]))
    detectors.clear()
    print("serve --archive (cascade_rcnn):", json.dumps(out["two_stage_serve_archive"]),
          f"[{card}]", flush=True)
    del built
    started.clear()
    torch.cuda.empty_cache()
    counted("two_stage_ranks", lambda: two_stage_ranks_path(device))
    print("two-stage train steps on two ranks:", json.dumps(out["two_stage_ranks"]),
          f"[{card}]", flush=True)
    shutil.rmtree(DEPLOY, ignore_errors=True)
    out["phase_s"] = time.time() - t0
    return out, launches


# --- distributed phase: parallel/ on one card ---------------------------------------

DIST = REPO / "build" / "chip_smoke_dist"
DIST_RANKS = 2           # gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card)
DIST_PG_TIMEOUT_S = 180  # the ranks' process-group timeout: a lost rank fails the others
DIST_WALL_S = 600        # each group of rank subprocesses' wall limit
DIST_STEPS = 2           # the steps held to the plain step's, then DIST_TIMED timed ones
DIST_TIMED = 5
DIST_BATCH_SEED = 5      # the training path's landscape batch
FSDP_TOL = 1e-6          # FSDP at world size 1 against the plain step, of each tensor's max-abs
DIST_RTOL = 1e-4         # the ranks' steps and sweeps against the single process's
# A rank's step sums one image's gradient where the single process sums two
# in one kernel. Every tensor whose initial value is not all zero is held to
# DIST_RTOL of its max-abs. A tensor that starts at zero (the BN, FPN and
# head biases) is all update after two steps, and the cancellation in its
# gradient sums carries float32 rounding far past DIST_RTOL of its small
# scale. A tensor's spread is the largest difference between any two
# single-process runs that compute the plain step's function in other
# orders: the rows as given and in the other DIST_ROW_ORDERS (swapped, or
# each row twice, which leaves every loss term's ratio to the global
# positive count as it was), and one image at a time (one_image_at_a_time),
# all under deterministic cuDNN (autotuned algorithms are not reproducible
# from run to run). One such run alone moves a tensor by a few times to
# more than ten times what another moves it, so one tensor's spread is no
# limit for it; a tensor that starts at zero is held to DIST_RTOL or to the
# largest spread of any tensor that starts at zero.
DIST_ROW_ORDERS = ((0, 1), (1, 0), (0, 1, 0, 1), (1, 0, 1, 0), (0, 0, 1, 1))


def dist_train_setup(cfg):
    """The distributed steps' inputs: the training path's landscape batch
    of TrainConfig().batch_size (one image per rank) and seed-0 weights."""
    from aod_meh_hua_torch.utils.config import TrainConfig

    tcfg = TrainConfig()
    lcfg, batch = synthetic_train_batch(cfg, "landscape", tcfg.batch_size, DIST_BATCH_SEED)
    return tcfg, lcfg, batch


def dist_steps(model, lcfg, tcfg, batch, device, mesh=None, timed: int = DIST_TIMED) -> dict:
    """DIST_STEPS steps of `model` (placed on `mesh`, or plain), their aux
    and the gathered weights after them, then `timed` timed steps (CUDA
    events): ms per step."""
    import torch
    from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
    from aod_meh_hua_torch.parallel import gather_to_host, shard_batch

    opt = create_train_state(model, tcfg)
    step = make_train_step(model, lcfg, opt, device=device, mesh=mesh)
    rows = batch if mesh is None else shard_batch(batch, mesh)
    rows = type(rows)(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in rows))
    auxes = [{k: float(v) for k, v in step(rows).items()} for _ in range(DIST_STEPS)]
    weights = gather_to_host(model)
    if not timed:
        return {"aux": auxes, "weights": weights}
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        step(rows)
    end.record()
    torch.cuda.synchronize()
    return {"aux": auxes, "weights": weights, "ms_per_step": start.elapsed_time(end) / timed}


def one_image_at_a_time(model, lcfg, tcfg, batch, device) -> dict:
    """The plain step's function, computed one image at a time in one
    process: each row's forward and backward alone (batch 1, the plain
    loss, no data axis), its cls and bbox terms moved from its own positive
    count to the batch's and its MEH mean divided by the rows, the
    gradients summed by autograd; then the plain step's clip and SGD step.
    The weights after DIST_STEPS steps."""
    import torch
    from aod_meh_hua_torch.engine.batch import Batch, as_tensor
    from aod_meh_hua_torch.engine.train import (_clip_by_global_norm, create_train_state,
                                                make_loss_fn)
    from aod_meh_hua_torch.parallel import gather_to_host

    opt = create_train_state(model, tcfg)
    loss_fn, anchors_host = make_loss_fn(model, lcfg)
    anchors = torch.from_numpy(anchors_host).to(device)
    n = len(batch.images)
    rows = [Batch(images=as_tensor(batch.images[i:i + 1], device),
                  gt_boxes=as_tensor(batch.gt_boxes[i:i + 1], device, torch.float32),
                  gt_labels=as_tensor(batch.gt_labels[i:i + 1], device, torch.long),
                  gt_valid=as_tensor(batch.gt_valid[i:i + 1], device, torch.bool),
                  anchor_valid=as_tensor(batch.anchor_valid[i:i + 1], device, torch.bool),
                  img_shapes=as_tensor(batch.img_shapes[i:i + 1], device)) for i in range(n)]
    for _ in range(DIST_STEPS):
        model.zero_grad(set_to_none=True)
        auxes = [loss_fn(r, anchors)[1] for r in rows]
        num_pos = sum(a["num_pos"] for a in auxes)
        if not all(a["num_pos"] > 0 for a in auxes):
            fail(f"one image at a time: an image without positives, "
                 f"{[a['num_pos'] for a in auxes]}")
        for a in auxes:
            ((a["loss_cls"] + a["loss_bbox"]) * (a["num_pos"] / num_pos)
             + a["loss_meh"] / n).backward()
        if opt.defaults.get("grad_clip"):
            _clip_by_global_norm(model.parameters(), opt.defaults["grad_clip"])
        opt.step()
    return gather_to_host(model)


def errs_of_scale(got: dict, want: dict) -> dict:
    """Per tensor, max|got - want| / max|want| (inf where an integer
    tensor differs), largest first."""
    errs = {}
    for k, w in want.items():
        if w.is_floating_point():
            scale = max(w.abs().max().item(), 1e-30)
            errs[k] = (got[k].float() - w.float()).abs().max().item() / scale
        else:
            errs[k] = 0.0 if torch_equal(got[k], w) else float("inf")
    return dict(sorted(errs.items(), key=lambda kv: -kv[1]))


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a, b)


def nccl_world1_path(device) -> tuple:
    """NCCL at world size 1 on the card: the full-width RetinaNet's
    data-parallel step (replicated, gradients all-reduced) and FSDP2 step
    (a (1, 1) (data, fsdp) mesh) against the plain step from the same
    weights on the same batch: DP bit for bit after DIST_STEPS steps,
    FSDP within FSDP_TOL of each tensor's max-abs; ms per step of each.
    Then the plain step's function in the other DIST_ROW_ORDERS and one
    image at a time. Returns the result, the initial weights, the plain
    run (the ranks' reference), each float tensor's spread over those
    runs, of its max-abs, and the one-image-at-a-time run's weights."""
    import torch
    import torch.distributed as dist
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.parallel import (init_distributed, make_mesh, make_mesh_2d,
                                            replicate, shard_params_fsdp)
    from aod_meh_hua_torch.parallel.launch import free_port
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    cfg = RetinaNetConfig()
    tcfg, lcfg, batch = dist_train_setup(cfg)
    init = {k: v.clone() for k, v in build_retinanet(cfg, device=device, seed=0)
            .state_dict().items()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the plain step repeats bit for bit
    info = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=device,
                            timeout=DIST_PG_TIMEOUT_S)
    if dist.get_backend() != "nccl" or info["process_count"] != 1:
        fail(f"NCCL world 1: the group is {dist.get_backend()}, {info}")
    runs = {}
    try:
        for kind in ("plain", "dp", "fsdp"):
            model = build_retinanet(cfg, device=device, seed=0)
            model.load_state_dict(init)
            mesh = None
            if kind == "dp":
                mesh = make_mesh(1, device_type="cuda")
                replicate(model, mesh)
            elif kind == "fsdp":
                mesh = make_mesh_2d(1, 1, device_type="cuda")
                shard_params_fsdp(model, mesh)
            runs[kind] = dist_steps(model, lcfg, tcfg, batch, device, mesh)
            del model
            torch.cuda.empty_cache()
        # the plain step's spread: each float tensor's least and largest
        # value over the runs of its function, from the reference run
        lo = {k: v.clone() for k, v in runs["plain"]["weights"].items() if v.is_floating_point()}
        hi = {k: v.clone() for k, v in lo.items()}
        for order in DIST_ROW_ORDERS[1:] + ("one image at a time",):
            model = build_retinanet(cfg, device=device, seed=0)
            model.load_state_dict(init)
            if order == "one image at a time":
                weights = runs["one_image"] = one_image_at_a_time(model, lcfg, tcfg, batch, device)
            else:
                rows = type(batch)(*(a[list(order)] for a in batch))
                weights = dist_steps(model, lcfg, tcfg, rows, device, timed=0)["weights"]
            for k in lo:
                torch.minimum(lo[k], weights[k], out=lo[k])
                torch.maximum(hi[k], weights[k], out=hi[k])
            del model, weights
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    plain, dp, fsdp = runs["plain"], runs["dp"], runs["fsdp"]
    if dp["aux"] != plain["aux"] or dp["weights"].keys() != plain["weights"].keys() or \
            not all(torch_equal(dp["weights"][k], v) for k, v in plain["weights"].items()):
        fail(f"NCCL world 1: the DP step is not the plain step bit for bit: {dp['aux']} "
             f"against {plain['aux']}")
    errs = errs_of_scale(fsdp["weights"], plain["weights"])
    fsdp_err = next(iter(errs.values()))
    if fsdp_err > FSDP_TOL or not np.allclose(
            [a[k] for a in fsdp["aux"] for k in LOSS_KEYS],
            [a[k] for a in plain["aux"] for k in LOSS_KEYS], rtol=FSDP_TOL, atol=0):
        fail(f"NCCL world 1: FSDP is {fsdp_err} of max-abs off the plain step "
             f"(worst {list(errs.items())[:6]}; aux {fsdp['aux']} against {plain['aux']})")
    spread = {k: (hi[k] - lo[k]).max().item()
              / max(plain["weights"][k].abs().max().item(), 1e-30) for k in lo}
    spread = dict(sorted(spread.items(), key=lambda kv: -kv[1]))
    result = {"batch": tcfg.batch_size, "steps": DIST_STEPS, "timed_steps": DIST_TIMED,
              "dp_bit_equal": True, "fsdp_max_err_of_scale": fsdp_err,
              "plain_ms_per_step": plain["ms_per_step"], "dp_ms_per_step": dp["ms_per_step"],
              "fsdp_ms_per_step": fsdp["ms_per_step"], "aux": plain["aux"],
              "plain_runs": len(DIST_ROW_ORDERS) + 1,
              "plain_spread_of_scale": list(spread.items())[:4]}
    return result, init, plain, spread, runs["one_image"]


def rank_triples(triples, rank: int, world: int, b: int = BATCH):
    """This rank's parallel.rank_indices slice of a pool of triples, in
    batches of b per orientation (the last padded)."""
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.parallel import rank_indices

    n = sum(len(t[2]) for t in triples)
    mine = set(rank_indices(n, rank, world).tolist())
    out = []
    for orientation in ("landscape", "portrait"):
        rows = [(t[1], r, int(t[2][r])) for t in triples if t[0] == orientation
                for r in range(len(t[2])) if int(t[2][r]) in mine]
        for i in range(0, len(rows), b):
            chunk = rows[i:i + b]
            k = len(chunk)
            chunk = chunk + [chunk[-1]] * (b - k)
            arrays = [np.stack([bt[f][r] for bt, r, _ in chunk]) for f in range(3)]
            out.append((orientation, EvalBatch(*arrays, np.arange(b) < k),
                        np.array([j for *_, j in chunk[:k]])))
    return out


def start_rank_programs(program: str) -> tuple:
    """`program` in DIST_RANKS subprocesses of this script (--rank-program),
    with torchrun's variables, every rank on cuda:0 (LOCAL_RANK 0, as two
    hosts of one card each) over gloo, started before their spec exists:
    each imports the port and reaches the card, then waits for the spec
    (rank_main), so that the main process makes it meanwhile. Returns
    (program, processes, logs) for run_rank_programs."""
    from aod_meh_hua_torch.parallel.launch import free_port

    DIST.mkdir(parents=True, exist_ok=True)
    spec_path = DIST / f"{program}.json"
    spec_path.unlink(missing_ok=True)
    port = free_port()
    procs, logs = [], []
    for r in range(DIST_RANKS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DIST_RANKS), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(DIST / f"{program}_r{r}.log", "w")
        logs.append(log)
        procs.append(spawn(["--rank-program", program, str(spec_path)], env, log))
    return program, procs, logs


def run_rank_programs(started: tuple, spec: dict) -> list:
    """start_rank_programs' processes given `spec`: their JSON results in
    rank order. Fails when a rank fails or outlives DIST_WALL_S after its
    spec (then it is killed)."""
    program, procs, logs = started
    spec_path = DIST / f"{program}.json"
    tmp = spec_path.with_suffix(".tmp")
    tmp.write_text(json.dumps(spec))
    os.replace(tmp, spec_path)  # whole, or not yet, to the waiting ranks
    deadline = time.time() + DIST_WALL_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * DIST_RANKS:
        tails = {r: (DIST / f"{program}_r{r}.log").read_text()[-3000:] for r in range(DIST_RANKS)}
        fail(f"{program}: rank exit codes {codes} (killed past {DIST_WALL_S} s where "
             f"negative); log tails {tails}")
    return [json.loads((DIST / f"{program}_r{r}.result.json").read_text())
            for r in range(DIST_RANKS)]


def rank_setup():
    """A rank subprocess: join the group from the launcher's variables
    (gloo; its card from LOCAL_RANK), the numerics the CLIs pin."""
    from aod_meh_hua_torch.parallel import init_distributed
    from aod_meh_hua_torch.parallel.launch import rank_device
    from aod_meh_hua_torch.utils.device import pin_numerics

    pin_numerics()
    info = init_distributed(backend="gloo", timeout=DIST_PG_TIMEOUT_S, device="cuda")
    return info["process_index"], info["process_count"], rank_device("cuda")


def rank_train_and_sweep(spec: dict) -> dict:
    """Rank program: the full-width DP step over gloo on the global batch
    (one image per rank), FSDP2 on a (1, 2) mesh where gloo carries it,
    then the fused Entropy_NMS sweep of this rank's slice of the
    synthetic pool, merged with allgather_sum."""
    import torch
    import torch.distributed as dist
    from aod_meh_hua_torch.al.uncertainty import score_pool
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.parallel import (allgather_sum, barrier, make_mesh, make_mesh_2d,
                                            replicate, shard_params_fsdp)
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    rank, world, device = rank_setup()
    out = {"rank": rank, "world": world, "device": str(device),
           "backend": dist.get_backend()}
    cfg = RetinaNetConfig()
    tcfg, lcfg, batch = dist_train_setup(cfg)
    init = torch.load(spec["train_init"], map_location="cpu")
    # gloo carries FSDP2's all_gather_into_tensor and reduce_scatter_tensor
    # on CUDA tensors through the host
    meshes = [("dp", lambda: make_mesh(world, device_type="cuda"), replicate),
              ("fsdp", lambda: make_mesh_2d(1, world, device_type="cuda"), shard_params_fsdp)]
    for kind, make, place in meshes:
        model = build_retinanet(cfg, device=device, seed=0)
        model.load_state_dict(init)
        mesh = make()
        place(model, mesh)
        barrier(kind)
        torch.cuda.reset_peak_memory_stats(device)
        run = dist_steps(model, lcfg, tcfg, batch, device, mesh)
        out[kind] = {"aux": run["aux"], "ms_per_step": run["ms_per_step"],
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(device)}
        if rank == 0:
            torch.save(run["weights"], DIST / f"{kind}_weights.pt")
        del model, run
        torch.cuda.empty_cache()

    scfg = RetinaNetConfig(fused_blocks=True)
    model = build_retinanet(scfg, device=device, seed=0)
    model.load_state_dict(torch.load(spec["score_model"], map_location="cpu"))
    triples, n = synthetic_pool(scfg)
    mine = rank_triples(triples, rank, world)
    score_pool(model, scfg, mine[:1], n, device=device)  # warm-up, outside the count
    torch.cuda.synchronize()
    barrier("sweep")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.time()
    unc, _ = score_pool(model, scfg, mine, n, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    images = sum(int(t[1].valid.sum()) for t in mine)
    out["sweep"] = {"images": images, "forwards": len(mine), "seconds": wall,
                    "img_per_s": images / wall, "launches": read_launches(),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(device)}
    merged = allgather_sum(unc)
    if rank == 0:
        np.save(DIST / "merged_unc.npy", merged)
    dist.destroy_process_group()
    return out


def rank_al_cli(spec: dict) -> dict:
    """Rank program: the RetinaNet CLI (main, in process) under the AL
    phase's cuts on its tree, its sweep's cls head sharpened on the pool's
    first canvas, as al_path does; the driver joins the group over gloo
    (NCCL refuses two ranks on one card) with DIST_PG_TIMEOUT_S."""
    import functools

    import torch
    from aod_meh_hua_torch.al import loop as loop_module
    from aod_meh_hua_torch.data.loader import EvalLoader
    from aod_meh_hua_torch.engine.batch import prepare_images
    from aod_meh_hua_torch.tools import train_retinanet
    from aod_meh_hua_torch.utils import config as config_module
    from aod_meh_hua_torch.utils.device import resolve_device

    real_score_pool = loop_module.score_pool

    def sharpened_score_pool(model, cfg, loader, n_images, **kwargs):
        _, b, _ = next(iter(EvalLoader(loader.dataset, [0], loader.pipeline, batch_size=1,
                                       prefetch=False)))
        dev = next(model.parameters()).device
        sharpen_cls_head(model, prepare_images(torch.from_numpy(b.images).to(dev),
                                               torch.from_numpy(b.img_shapes), cfg))
        return real_score_pool(model, cfg, loader, n_images, **kwargs)

    reset_launches()
    with mock.patch.object(config_module, "TrainConfig",
                           with_cuts(config_module.TrainConfig, AL_TRAIN)), \
            mock.patch.object(config_module, "ALConfig",
                              with_cuts(config_module.ALConfig, AL_AL)), \
            mock.patch.object(loop_module, "score_pool", sharpened_score_pool), \
            mock.patch.object(loop_module, "init_distributed", functools.partial(
                loop_module.init_distributed, backend="gloo", timeout=DIST_PG_TIMEOUT_S)):
        driver = train_retinanet.main(spec["argv"])
    device = resolve_device(driver.device)
    torch.cuda.synchronize(device)
    return {"rank": driver.proc_id, "world": driver.proc_count, "device": str(device),
            "launches": read_launches(),
            "cycles": [{"cycle": t["cycle"], "seconds": t["seconds"]}
                       for t in driver.timings if t["phase"] == "cycle"],
            "train_epochs": sum(t["phase"] == "train_epoch" for t in driver.timings),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "metrics": driver.metrics}


RANK_PROGRAMS = {"train_and_sweep": rank_train_and_sweep, "al_cli": rank_al_cli,
                 "two_stage_steps": rank_two_stage_steps, "export": export_program}


def rank_main(argv) -> int:
    """`chip_smoke.py --rank-program NAME SPEC`: one rank of a distributed
    phase (start_rank_programs starts them; it waits for SPEC), or an
    export program (start_export_program); writes its result under DIST,
    or to the spec's "result" file."""
    import torch

    from aod_meh_hua_torch.kernels.build import build_all

    name, spec_path = argv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()  # the main process built them: this loads the libraries
    # reach the card and import the programs' modules while the spec is made
    torch.zeros(1, device="cuda")
    import aod_meh_hua_torch.engine.two_stage  # noqa: F401
    import aod_meh_hua_torch.parallel  # noqa: F401
    import aod_meh_hua_torch.tools.train_retinanet  # noqa: F401
    spec = wait_for_spec(Path(spec_path))
    result = RANK_PROGRAMS[name](spec)
    rank = int(os.environ["RANK"])
    Path(spec.get("result", DIST / f"{name}_r{rank}.result.json")).write_text(json.dumps(result))
    return 0


def wait_for_spec(path: Path) -> dict:
    """A rank's spec, once the main process has written it
    (run_rank_programs); exits when the main process has gone or past
    DIST_WALL_S."""
    deadline = time.time() + DIST_WALL_S
    while not path.exists():
        if os.getppid() != int(os.environ["CHIP_SMOKE_PID"]) or time.time() > deadline:
            raise SystemExit(f"chip_smoke rank: no spec at {path}, or the main process is gone")
        time.sleep(0.05)
    return json.loads(path.read_text())


def acquisition_flips(single: np.ndarray, ranks: np.ndarray, x_l0: np.ndarray,
                      x_l1: np.ndarray, x_l1_ranks: np.ndarray, k: int) -> list:
    """The images on which two runs' acquisitions part, each named with
    both runs' scores; fails unless each lies at a near-tie of the cut (its
    score within 1e-3 of the k-th largest unlabeled score)."""
    differ = sorted(set(x_l1.tolist()) ^ set(x_l1_ranks.tolist()))
    unlabeled = np.setdiff1d(np.arange(len(single)), x_l0)
    cut = np.sort(single[unlabeled])[-k]
    named = []
    for i in differ:
        near = abs(single[i] - cut) <= 1e-3 * max(abs(cut), 1e-30)
        named.append({"image": int(i), "single": float(single[i]), "ranks": float(ranks[i]),
                      "cut": float(cut), "near_tie": bool(near)})
        if not near:
            fail(f"2-rank AL CLI: image {i} acquired by one run only, and not at a near-tie "
                 f"of the cut: {named[-1]}")
    return named


def distributed_path(device, card: str, score_sd: dict, unc_single: np.ndarray,
                     al: dict, voc07: Path) -> tuple:
    """The distributed phase (see the module docstring). Returns its result
    and the fused kernel's launches on the ranks' sweep (rank order)."""
    import torch
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    shutil.rmtree(DIST, ignore_errors=True)
    DIST.mkdir(parents=True)
    t0 = time.time()
    # both groups of ranks start while NCCL at world 1 runs, and wait for their specs
    started = {p: start_rank_programs(p) for p in ("train_and_sweep", "al_cli")}
    world1, init, plain, spread, one_image = nccl_world1_path(device)
    print("NCCL world 1:", json.dumps(world1), f"[{card}]", flush=True)
    from_zero = {k for k, v in init.items() if v.is_floating_point() and not v.any()}
    zero_spread = max(v for k, v in spread.items() if k in from_zero)
    torch.save({k: v.cpu() for k, v in init.items()}, DIST / "train_init.pt")
    torch.save(score_sd, DIST / "score_model.pt")
    del init
    torch.cuda.empty_cache()

    t1 = time.time()
    ranks = run_rank_programs(started["train_and_sweep"],
                              {"train_init": str(DIST / "train_init.pt"),
                               "score_model": str(DIST / "score_model.pt")})
    ranks_s = time.time() - t1
    if [(r["rank"], r["backend"], r["device"]) for r in ranks] != \
            [(i, "gloo", "cuda:0") for i in range(DIST_RANKS)]:
        fail(f"2 ranks: {[(r['rank'], r['backend'], r['device']) for r in ranks]}")
    steps = {}
    for kind in ("dp", "fsdp"):
        if ranks[0][kind]["aux"] != ranks[1][kind]["aux"]:
            fail(f"2 ranks, {kind}: the ranks report different aux")
        weights = torch.load(DIST / f"{kind}_weights.pt", map_location="cpu")
        errs = errs_of_scale(weights, plain["weights"])
        # past DIST_RTOL: each tensor with its own spread (see DIST_RTOL)
        named = [{"tensor": k, "err_of_scale": e, "plain_spread": spread.get(k),
                  "from_zero": k in from_zero} for k, e in errs.items() if e > DIST_RTOL]
        off = [n for n in named if not n["from_zero"] or n["err_of_scale"] > zero_spread]
        aux_ok = np.allclose([a[k] for a in ranks[0][kind]["aux"] for k in LOSS_KEYS],
                             [a[k] for a in plain["aux"] for k in LOSS_KEYS],
                             rtol=DIST_RTOL, atol=0)
        if off or not aux_ok or [a["num_pos"] for a in ranks[0][kind]["aux"]] != \
                [a["num_pos"] for a in plain["aux"]]:
            fail(f"2 ranks, {kind}: off the single-process step past {DIST_RTOL} of max-abs "
                 f"(a tensor from zero: past the spread {zero_spread}): {off[:6]}; aux "
                 f"{ranks[0][kind]['aux']} against {plain['aux']}")
        err = max((e for k, e in errs.items() if e <= DIST_RTOL), default=0.0)
        steps[kind] = {"max_err_of_scale_unnamed": err, "named_past_rtol": named,
                       "from_zero_spread": zero_spread,
                       "max_err_over_own_spread": max(
                           (n["err_of_scale"] / max(n["plain_spread"], 1e-30) for n in named),
                           default=0.0),
                       "max_err_of_scale_against_one_image_at_a_time":
                           next(iter(errs_of_scale(weights, one_image).values())),
                       "ms_per_step_per_rank": [r[kind]["ms_per_step"] for r in ranks],
                       "peak_mem_bytes_per_rank": [r[kind]["peak_mem_bytes"] for r in ranks]}

    # the rank-sliced sweep against the single-process one
    merged = np.load(DIST / "merged_unc.npy")
    sweeps = [r["sweep"] for r in ranks]
    per_forward = FUSED_PER_FORWARD
    for s in sweeps:
        if s["launches"]["fused_bottleneck"] != per_forward * s["forwards"] or \
                s["launches"]["transposed_matmul"]:
            fail(f"rank-sliced sweep: launches {s['launches']} for {s['forwards']} forwards")
    if sum(s["images"] for s in sweeps) != len(unc_single):
        fail(f"rank-sliced sweep: {[s['images'] for s in sweeps]} images of {len(unc_single)}")
    off = np.nonzero(~np.isclose(merged, unc_single, rtol=DIST_RTOL, atol=0))[0]
    flips = []
    if len(off):
        scfg = RetinaNetConfig(fused_blocks=True)
        model = build_retinanet(scfg, device=device, seed=0)
        model.load_state_dict(score_sd)
        triples, _ = synthetic_pool(scfg)
        for i in off:
            mine = rank_triples(triples, int(i) % DIST_RANKS, DIST_RANKS)
            flips.append(decision_flip(model, scfg, triples, mine, int(i), device,
                                       what="rank-sliced sweep"))
        del model
    wall = max(s["seconds"] for s in sweeps)
    sweep = {"images": len(unc_single), "max_rel_diff": float(np.max(
                 np.abs(merged - unc_single) / np.maximum(np.abs(unc_single), 1e-30))),
             "flips": flips, "img_per_s_per_rank": [s["img_per_s"] for s in sweeps],
             "img_per_s_total": len(unc_single) / wall,
             "fused_launches_per_rank": [s["launches"]["fused_bottleneck"] for s in sweeps],
             "forwards_per_rank": [s["forwards"] for s in sweeps],
             "peak_mem_bytes_per_rank": [s["peak_mem_bytes"] for s in sweeps],
             "peak_mem_bytes_total": sum(s["peak_mem_bytes"] for s in sweeps)}

    # the AL CLI on two ranks against the AL phase's single-process run
    work = DIST / "al_work"
    argv = ["--voc07", str(voc07), "--work-dir", str(work), "--cycles", "2",
            "--ckpt-interval", "1", "--score-batch-size", "8", "--zero-rate", "0.15"]
    t1 = time.time()
    cli = run_rank_programs(started["al_cli"], {"argv": argv})
    cli_s = time.time() - t1
    if [(c["rank"], c["world"]) for c in cli] != [(i, DIST_RANKS) for i in range(DIST_RANKS)]:
        fail(f"2-rank AL CLI: ranks {[(c['rank'], c['world']) for c in cli]}")
    x_l0, x_l1 = np.load(work / "X_L_0.npy"), np.load(work / "X_L_1.npy")
    unc = np.load(work / "Unc_1.npy")
    single_unc = np.load(REPO / "build" / "chip_smoke_al" / "work" / "Unc_1.npy")
    if not np.array_equal(x_l0, np.asarray(al["x_l_0"])):
        fail(f"2-rank AL CLI: X_L_0 {x_l0} against {al['x_l_0']}")
    al_flips = acquisition_flips(single_unc, unc, x_l0, np.asarray(al["x_l_1"]), x_l1,
                                 AL_AL["x_s_size"])
    lines = len((work / "train_log.jsonl").read_text().splitlines())
    if lines != cli[0]["train_epochs"]:
        fail(f"2-rank AL CLI: {lines} train-log lines for {cli[0]['train_epochs']} epochs "
             "(only rank 0 writes)")
    caches = sorted(p.name for p in (work / "canvas_cache").iterdir())
    if caches != ["pool_r0", "pool_r1", "val_r0", "val_r1"]:
        fail(f"2-rank AL CLI: canvas caches {caches}")
    if any(v for c in cli for v in c["launches"].values()):
        fail(f"2-rank AL CLI: a hand-written kernel launched: {[c['launches'] for c in cli]}")
    al_cli = {"argv": argv, "x_l_1": x_l1.tolist(), "x_l_1_single": al["x_l_1"],
              "flips": al_flips, "unc_1_max_rel_diff": float(np.max(
                  np.abs(unc - single_unc) / np.maximum(np.abs(single_unc), 1e-30))),
              "cycles_per_rank": [c["cycles"] for c in cli],
              "cycles_single": al["cycles"], "metrics": cli[0]["metrics"],
              "peak_mem_bytes_per_rank": [c["peak_mem_bytes"] for c in cli],
              "wall_s": cli_s}
    result = {"nccl_world1": world1, "gloo_2_ranks_steps": steps, "rank_sliced_sweep": sweep,
              "al_cli_2_ranks": al_cli, "ranks_wall_s": ranks_s,
              "phase_s": time.time() - t0}
    return result, [s["launches"] for s in sweeps], [c["launches"] for c in cli]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 1
    if not (REPO / "aod_meh_hua_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--rank-program"]:
        return rank_main(sys.argv[2:])
    t_script = time.time()
    atexit.register(kill_children)  # a failed check leaves no subprocess behind
    from aod_meh_hua_torch.kernels.build import finish_build, start_build
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} (TF32 off for every comparison)", flush=True)
    t0 = time.time()
    building = start_build()
    # the SSD paths, on which no hand-written kernel lies, run while nvcc builds
    reset_launches()
    ssd_train = ssd_train_path(device)
    ssd_train_launches = read_launches()
    if any(ssd_train_launches.values()):
        fail(f"SSD training: a hand-written kernel launched: {ssd_train_launches}")
    print("SSD training path:", json.dumps(ssd_train), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    print("SSD training card vs CPU:", json.dumps(ssd_card_vs_cpu(device)), f"[{card}]",
          flush=True)
    ssd_score, ssd_score_launches = ssd_score_path(device)
    print("SSD scoring and eval path:", json.dumps(ssd_score), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    t1 = time.time()
    finish_build(building)
    print(f"build: {time.time() - t0:.1f} s from its start, beside the SSD paths; "
          f"{time.time() - t1:.1f} s waited after them", flush=True)

    cases = kernel_phase(device)
    mm_cases = matmul_kernel_phase(device)
    for row in cases + mm_cases:
        print("kernel case:", json.dumps(row), flush=True)
    # R50-FPN: layer1_1, layer1_2 (C2) and layer2_1..layer2_3 (C3) fuse
    cfg = RetinaNetConfig(fused_blocks=True)
    path, prof, model, triples, unc = main_path(device, cfg, per_forward=5)
    print("main path:", json.dumps(path), f"[{card}]", flush=True)
    print("profile of one score step:", json.dumps(prof), f"[{card}]", flush=True)
    # the scoring model and its sweep, for the rank-sliced sweep at the end
    score_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    reset_launches()
    nms_sync = nms_sync_path(model, cfg, triples[0], device)
    nms_launches = read_launches()["fused_bottleneck"]
    print("NMS fixpoint syncs:", json.dumps(nms_sync), f"[{card}]", flush=True)
    pools, pool_launches = pools_path(device, model, cfg, triples, unc, per_forward=5)
    print("pools path:", json.dumps(pools), f"[{card}]", flush=True)
    ev, eval_launches = eval_path(device, model, cfg, triples, per_forward=5)
    print("eval path:", json.dumps(ev), f"[{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    b64, b64_launches = batch64_path(device, card)
    print("batch 64:", json.dumps(b64), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    train = train_path(device)
    print("training path:", json.dumps(train), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    print("training card vs CPU:", json.dumps(train_card_vs_cpu(device)), f"[{card}]",
          flush=True)
    probe_launches = probe_path(device, card)
    c11 = conv1x1_matmul_check(device, RetinaNetConfig())
    print("conv1x1_matmul:", json.dumps(c11), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    from aod_meh_hua_torch.engine.ssl import make_pseudo_train_step

    base, ens_launches, mc_launches = baselines_path(device)
    print("baselines path:", json.dumps(base), f"[{card}]", flush=True)
    print("baselines card vs CPU:", json.dumps(baselines_card_vs_cpu(device)), f"[{card}]",
          flush=True)
    torch.cuda.empty_cache()
    ssl, ssl_launches = ssl_path(device)
    print("SSL path:", json.dumps(ssl), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    print("SSL card vs CPU:", json.dumps(train_card_vs_cpu(device, make_pseudo_train_step)),
          f"[{card}]", flush=True)
    api, api_launches = api_path(device)
    print("API path:", json.dumps(api), f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    dec = decoder_check()
    print("decoder (host):", json.dumps(dec), f"[{card}]", flush=True)
    print("SSD augment chain (host):", json.dumps(augment_check()), f"[{card}]", flush=True)
    # the CLI phases last: each pins deterministic cuDNN process-wide
    t0 = time.time()
    al = al_path(device, train["img_per_s"])
    print("AL path:", json.dumps(al), f"[{card}]", flush=True)
    print(f"AL phase: {time.time() - t0:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    t0 = time.time()
    ssd_al = ssd_al_path(device, ssd_train["img_per_s"])
    print("SSD AL path:", json.dumps(ssd_al), f"[{card}]", flush=True)
    print(f"SSD AL phase: {time.time() - t0:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    voc07 = REPO / "build" / "chip_smoke_al" / "VOC2007"  # the AL phase's tree
    serving_model = start_serving_export(device)
    t0 = time.time()
    sp, sp_launches = score_pool_cli_path(device, voc07)
    print("score_pool CLI:", json.dumps(sp), f"[{card}]", flush=True)
    print(f"score_pool CLI phase: {time.time() - t0:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    t0 = time.time()
    al_ens = al_ensemble_path(device, voc07)
    print("ensemble AL path:", json.dumps(al_ens), f"[{card}]", flush=True)
    print(f"ensemble AL phase: {time.time() - t0:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    serving, serving_launches = serving_path(device, voc07, serving_model)
    print("serving path:", json.dumps(serving), f"[{card}]", flush=True)
    print(f"serving phase: {serving['phase_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    exports = start_two_stage_exports(device)  # they trace beside the next two phases
    frcnn, frcnn_launches = frcnn_path(device, card)
    print(f"Faster R-CNN phase: {frcnn['phase_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    zoo, zoo_launches = zoo_path(device, card)
    print(f"Cascade, Dynamic and Double-Head R-CNN, two-stage TTA, server and trainer phase: "
          f"{zoo['phase_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    deploy, deploy_launches = two_stage_deploy_path(device, card, exports)
    print(f"two-stage export, archive server and ranks phase: {deploy['phase_s']:.1f} s "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    variants, variants_launches = variants_path(device, card)
    print("Faster R-CNN variants phase, s by path:",
          json.dumps({k: v["path_s"] for k, v in variants.items() if k != "phase_s"}),
          f"[{card}]", flush=True)
    print(f"Faster R-CNN variants phase: {variants['phase_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    backbones, backbones_launches = backbones_path(device, card)
    print("Faster R-CNN backbones, necks, GN+WS and PISA phase, s by path:",
          json.dumps({k: v["path_s"] for k, v in backbones.items() if k != "phase_s"}),
          f"[{card}]", flush=True)
    print(f"Faster R-CNN backbones, necks, GN+WS and PISA phase: {backbones['phase_s']:.1f} s "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    proposals, proposals_launches = proposals_path(device, card)
    print("proposal families phase, s by path:",
          json.dumps({k: v["path_s"] for k, v in proposals.items() if k != "phase_s"}),
          f"[{card}]", flush=True)
    print(f"proposal families phase: {proposals['phase_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    dist_result, dist_sweep, dist_al = distributed_path(device, card, score_sd, unc, al, voc07)
    print("distributed path:", json.dumps(dist_result), f"[{card}]", flush=True)
    print(f"distributed phase: {dist_result['phase_s']:.1f} s [{card}]", flush=True)

    new_paths = {"ensemble_sweep": ens_launches, "mc_dropout": mc_launches,
                 "detector": api_launches, "ssl": ssl_launches, "score_pool_cli": sp_launches,
                 "al_ensemble_cli": al_ens["launches"],
                 **{f"dist_sweep_rank{r}": c for r, c in enumerate(dist_sweep)},
                 "dist_al_cli_2_ranks": add_launches(*dist_al), **serving_launches,
                 "faster_rcnn": frcnn_launches, **zoo_launches, **deploy_launches,
                 **variants_launches, **backbones_launches, **proposals_launches}
    main_rows = [r for r in cases if r["case"] in ("C2", "C3") and r["dtype"] == "float32"]
    per_fwd = {"C2": 2, "C3": 3}  # launches per forward at each shape
    total = lambda key: sum(per_fwd[r["case"]] * r[key] for r in main_rows)  # noqa: E731
    c2 = next(r for r in main_rows if r["case"] == "C2")
    # the bf16 kernel per launch (the probe's dtype; not on the f32 scoring path)
    bf16 = {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "max_abs_err")}
            for r in cases if r["case"] in ("C2", "C3") and r["dtype"] == "bfloat16"}
    kernels = [{
        "name": "fused_bottleneck", "route": "cuda",
        "source": "aod_meh_hua_torch/csrc/fused_bottleneck.cu",
        "replaces": "aod_meh_hua_tpu/ops/fused_block.py:221",
        # the scoring, extra-pool, eval, ensemble, Detector and serving runs, each counted
        # from 0
        "launches": path["launches"] + pool_launches + eval_launches
        + ens_launches["fused_bottleneck"] + api_launches["fused_bottleneck"]
        + sum(c["fused_bottleneck"] for c in serving_launches.values()),
        "launches_by_path": {"score_pool": path["launches"], "other_pools": pool_launches,
                             "eval": eval_launches, "nms_sync_check": nms_launches,
                             "batch64_pool_and_eval": b64_launches,
                             "al_cli": al["launches"]["fused_bottleneck"],
                             "ssd_train": ssd_train_launches["fused_bottleneck"],
                             "ssd_score": ssd_score_launches["fused_bottleneck"],
                             "ssd_al_cli": ssd_al["launches"]["fused_bottleneck"],
                             **{path_name: counts["fused_bottleneck"]
                                for path_name, counts in new_paths.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": c2["bound_by"], "library_ms": total("library_ms"),
        "bound_ms_cuda_cores": total("bound_ms_cuda_cores"),
        "per_launch_f32": {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms")}
                           for r in main_rows},
        "bf16": bf16,
    }]
    mm = next(r for r in mm_cases if r["case"] == "C2")
    kernels.append({
        "name": "transposed_matmul", "route": "cuda",
        "source": "aod_meh_hua_torch/csrc/transposed_matmul.cu",
        "replaces": "tools/analysis/pallas_probe.py:232",
        "launches": probe_launches["transposed_matmul"],
        "launches_by_path": {"probe": probe_launches["transposed_matmul"],
                             "al_cli": al["launches"]["transposed_matmul"],
                             "ssd_train": ssd_train_launches["transposed_matmul"],
                             "ssd_score": ssd_score_launches["transposed_matmul"],
                             "ssd_al_cli": ssd_al["launches"]["transposed_matmul"],
                             **{path_name: counts["transposed_matmul"]
                                for path_name, counts in new_paths.items()}},
        "max_abs_err": mm["max_abs_err"], "ms": mm["ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
    })
    print(f"chip_smoke: {time.time() - t_script:.1f} s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
