#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every CUDA kernel
   of the port from the sources in this checkout (one nvcc per source,
   all started together, timed).
2. Kernel phase, TF32 off: each kernel against its plain PyTorch version
   at its path's shapes and at small edge cases, and CUDA-event times of
   the kernel, the plain version and the library yardstick (for the
   fused bottleneck the unfused cuDNN chain of the same block, for the
   transposed matmul one torch.matmul).
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
6. Prints a per-case line, a `{"kernels": [...]}` line, the card line
   and, last, `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, without a card or outside a checkout
of the repository. Every failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

BATCH = 8
POOL = {"landscape": 14, "portrait": 12}   # 4 batches of 8, two of them padded
F32_TOL = 1e-4    # of max|ref|: the same f32 sums in another order
BF16_TOL = 0.06   # of max|ref|: bf16 rounding of intermediates (tests/test_fused_block.py)
MATMUL_TOL = 2.0 ** -7  # of max|ref|: one bf16 ulp; kernel and plain version round one f32 sum
TF32_PEAK_OPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)
PROBE_ITERS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    from aod_meh_hua_torch.ops.fused_block import fused_bottleneck, fused_bottleneck_reference

    gen = torch.Generator(device=device).manual_seed(0)
    both, f32 = (torch.float32, torch.bfloat16), (torch.float32,)
    # (label, B, H, W, Cin, P, Cout, downsample, dtypes): C2/C3 are the main
    # path's landscape shapes at the smoke batch, C2p/C3p its portrait ones;
    # the last two are edge cases (1x1 downsample; H, W not multiples of 8)
    cases = [("C2", BATCH, 152, 256, 256, 64, 256, False, both),
             ("C3", BATCH, 76, 128, 512, 128, 512, False, both),
             ("C2p", BATCH, 256, 152, 256, 64, 256, False, f32),
             ("C3p", BATCH, 128, 76, 512, 128, 512, False, f32),
             ("down", 2, 20, 12, 128, 64, 256, True, both),
             ("ragged", 2, 37, 29, 256, 64, 256, False, both)]
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


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# --- scoring path -------------------------------------------------------------

def synthetic_pool(cfg, seed: int = 0):
    """(orientation, EvalBatch, indices) triples of seeded uint8 canvases:
    32-pixel cells of random colour plus noise, varied img_shapes and
    scale_factors, the last batch of each orientation padded."""
    import numpy as np
    from aod_meh_hua_torch.engine.batch import EvalBatch

    rng = np.random.RandomState(seed)
    triples, start = [], 0
    for orientation, n in POOL.items():
        h, w = cfg.for_orientation(orientation).canvas
        coarse = rng.randint(0, 256, (n, h // 32, w // 32, 3)).astype(np.uint8)
        imgs = coarse.repeat(32, axis=1).repeat(32, axis=2)
        imgs = np.clip(imgs.astype(np.int16) + rng.randint(-20, 21, imgs.shape), 0, 255)
        imgs = imgs.astype(np.uint8)
        shapes = np.array([[rng.randint(h * 3 // 4, h + 1), rng.randint(w * 3 // 4, w + 1)]
                           for _ in range(n)], np.int32)
        sfs = np.repeat(rng.uniform(0.8, 1.7, (n, 1)), 4, axis=1).astype(np.float32)
        for i in range(0, n, BATCH):
            k = min(BATCH, n - i)
            rows = np.r_[np.arange(i, i + k), np.full(BATCH - k, i + k - 1)]
            triples.append((orientation,
                            EvalBatch(imgs[rows], shapes[rows], sfs[rows], np.arange(BATCH) < k),
                            np.arange(start + i, start + i + k)))
        start += n
    return triples, start


def upload(batch, device):
    """An EvalBatch of host arrays -> one of device tensors (valid stays)."""
    import torch
    from aod_meh_hua_torch.engine.batch import EvalBatch

    return EvalBatch(*(torch.from_numpy(a).to(device) for a in batch[:3]), batch.valid)


def main_path(device, cfg, per_forward: int):
    """Score the synthetic pool with `cfg` (fused_blocks on); the fused
    kernel must launch `per_forward` times in each forward."""
    import dataclasses

    import numpy as np
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
    # random weights give a ~uniform softmax (0.05) under the 0.3 object
    # and FG gates; sharpen the cls head to logit std 1.5
    with torch.no_grad():
        logits = model(images0)[0]
        model.head.retina_cls.weight.mul_(1.5 / logits.std().item())
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
    return result, profile_step(model, cfg, triples[0], device)


KERNEL_GROUPS = (  # substring of a CUDA kernel's name -> group, first match wins
    ("fused_bottleneck", "fused_bottleneck"),
    ("conv", "convolution"), ("gemm", "convolution"), ("xmma", "convolution"),
    ("sm90", "convolution"), ("cudnn", "convolution"), ("fft", "convolution"),
    ("winograd", "convolution"), ("sort", "sort"), ("radix", "sort"),
)


def profile_step(model, cfg, triple, device):
    """Device time by kernel over one score step (torch.profiler), grouped,
    with the device's busy share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aod_meh_hua_torch.engine.score import make_score_step

    orientation, batch, _ = triple
    step = make_score_step(model, cfg.for_orientation(orientation), device=device)
    up = upload(batch, device)
    step(up)[0].cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(up)[0].cpu()
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
    return {"batch": len(batch.valid), "orientation": orientation, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / wall_us,
            "group_ms": {g: t / 1e3 for g, t in sorted(groups.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in top]}


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

    import numpy as np
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
    from aod_meh_hua_torch.kernels.build import build_all
    from aod_meh_hua_torch.utils.config import RetinaNetConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} (TF32 off for every comparison)", flush=True)
    t0 = time.time()
    build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    cases = kernel_phase(device)
    mm_cases = matmul_kernel_phase(device)
    for row in cases + mm_cases:
        print("kernel case:", json.dumps(row), flush=True)
    # R50-FPN: layer1_1, layer1_2 (C2) and layer2_1..layer2_3 (C3) fuse
    path, prof = main_path(device, RetinaNetConfig(fused_blocks=True), per_forward=5)
    print("main path:", json.dumps(path), f"[{card}]", flush=True)
    print("profile of one score step:", json.dumps(prof), f"[{card}]", flush=True)
    probe_launches = probe_path(device, card)
    c11 = conv1x1_matmul_check(device, RetinaNetConfig())
    print("conv1x1_matmul:", json.dumps(c11), f"[{card}]", flush=True)

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
        "launches": path["launches"],
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
        "max_abs_err": mm["max_abs_err"], "ms": mm["ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
