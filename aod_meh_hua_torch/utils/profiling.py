"""Profiling utilities.

Port of aod_meh_hua_tpu/utils/profiling.py (`profile_time` :24, `trace`
:42, `compiled_cost` :51), after the reference's mmdet/utils/
profiling.py:10-39 (profile_time with CUDA events) and its get_flops
tool. The FPS harness that builds on them is
aod_meh_hua_torch/tools/benchmark.py.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode


def span(name: str):
    """A profiler range named `name` (torch.profiler.record_function, a
    no-op unless the profiler records), or none while torch.export traces:
    an exported program holds no ranges, so its time cannot be split by
    them (torch 2.13's export drops them; the guard makes every version
    do so)."""
    if torch.compiler.is_exporting():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_time(name: str, stream=None, enabled: bool = True, device="cuda"):
    """Time a region and print "name: t ms" (to `stream`, else stdout).

    On a CUDA device: CUDA events recorded on the current stream before
    and after the region, the end event synchronised, so the time is the
    device's for the work the region enqueued (the reference's
    profile_time). device="cpu" times the region on the host clock,
    where torch's CPU ops finish before they return."""
    if not enabled:
        yield
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000
    msg = f"{name}: {dt:.2f} ms"
    print(msg, file=stream) if stream else print(msg)


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = True):
    """Capture a torch.profiler trace of the region (CPU and, with
    `cuda`, the card's kernels) and write it as log_dir/trace.json, a
    Chrome trace that Perfetto opens. Yields the profiler, whose
    key_averages() sums the time by operator and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def compiled_cost(fn, *args) -> dict:
    """The operation count of fn(*args) (the reference's get_flops; the
    JAX package reads XLA's cost analysis of the compiled program).

    Counted by torch.utils.flop_counter.FlopCounterMode while fn runs
    once: 2 per multiply-add of the matrix products and convolutions
    (and attention) only, from their shapes. XLA's "flops" also counts
    elementwise ops, reductions and transcendentals, so it reads higher
    on the same model; neither counts bytes here: "bytes_accessed" is
    NaN, where XLA gives its estimate of the program's memory traffic."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}
