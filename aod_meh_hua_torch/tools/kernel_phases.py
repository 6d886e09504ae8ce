"""Per-phase cycle counts of the fused-bottleneck kernel on the card.

    python -m aod_meh_hua_torch.tools.kernel_phases [--ablate NAME] [--batch 8]

Builds an instrumented copy of `csrc/fused_bottleneck.cu` with nvcc for
sm_90a: thread 0 of every block reads `clock64()` at the phase
boundaries and around each pipeline step's wait and barrier, and adds
the differences into a device array. It then runs R50's C2 and C3
blocks at a 608x1024 canvas, f32 and bf16, and prints one JSON line per
case: the kernel's time (CUDA events), and per block the cycles of
conv1, conv2 and conv3 and the cycles of each spent waiting for the copy
rings. The last line is the card's name, power limit and SM clock.

An ablation removes one piece of the kernel's work, so that its share
shows as the difference from a run without it (its output is then wrong;
the error printed says by how much):
  wgmma  f32's tensor-core products;
  split  f32's split of each step's weights into tf32 halves.

Needs a CUDA card and nvcc, and raises without them. A measuring tool:
nothing in the package calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc, _source
from ..ops.fused_block import FoldedBlock, fused_bottleneck_reference
from .pallas_probe import cuda_time_ms

# (anchor in the kernel's source, what replaces it); each anchor must occur once
_PROBES = [
    ("using bf16 = __nv_bfloat16;",
     "using bf16 = __nv_bfloat16;\n__device__ unsigned long long g_phase[8];"),
    ("  auto advance = [&](int s) {\n",
     "  long long waited = 0;\n  auto advance = [&](int s) {\n    const long long w0 = clock64();\n"),
    ("    __syncthreads();\n    if constexpr (SZ == 2)",
     "    __syncthreads();\n    waited += clock64() - w0;\n    if constexpr (SZ == 2)"),
    ("  int s = 0;\n", "  int s = 0;\n  const long long t0 = clock64();\n"),
    ("  // ---- 2. conv2", "  const long long t1 = clock64(), waited1 = waited;\n  // ---- 2. conv2"),
    ("  // ---- 3. conv3", "  const long long t2 = clock64(), waited2 = waited;\n  // ---- 3. conv3"),
    ("  tc::cp_async_wait<0>();\n}",
     "  if (threadIdx.x == 0) {\n"
     "    const long long t3 = clock64();\n"
     "    const long long d[7] = {t1 - t0, t2 - t1, t3 - t2, waited1, waited2 - waited1,\n"
     "                            waited - waited2, 1};\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&g_phase[i], (unsigned long long)d[i]);\n"
     "  }\n  tc::cp_async_wait<0>();\n}"),
]
_READ = '''
extern "C" int phases_read(void* host) {
  return int(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
extern "C" int phases_reset() {
  unsigned long long zero[8] = {0};
  return int(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
'''
ABLATIONS = {
    "wgmma": [("        tc::wgmma_tf32_m64n32k8(acc[i], as[h][i], db);\n"
               "        tc::wgmma_tf32_m64n32k8(acc[i], ab[h][i], dsm);\n"
               "        tc::wgmma_tf32_m64n32k8(acc[i], ab[h][i], db);\n", "")],
    "split": [("      tc::split_tf32(__float_as_uint(wreg[l]), big[idx], big[idx + KC * P]);\n",
               "")],
}
CASES = [("C2", 152, 256, 256, 64, 256), ("C3", 76, 128, 512, 128, 512)]


def _replace(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_phases: anchor not found once in the kernel: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(ablate: str = "") -> ctypes.CDLL:
    """The instrumented kernel (with one ablation), built and loaded."""
    src = _replace(_source("fused_bottleneck").read_text(), _PROBES + ABLATIONS.get(ablate, []))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / f"fused_bottleneck_phases{'_' + ablate if ablate else ''}.cu"
    cu.write_text(src + _READ)
    lib = cu.with_suffix(".so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(_source("fused_bottleneck").parent),
                    "-o", str(lib), str(cu)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.fused_bottleneck_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                                            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    dll.phases_read.argtypes = [ctypes.c_void_p]
    return dll


def run(dll: ctypes.CDLL, batch: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(0)
    for label, h, w, cin, p, cout in CASES:
        def rnd(*shape, scale):
            return torch.randn(shape, generator=gen, device=device) * scale

        fb = FoldedBlock(rnd(cin, p, scale=cin ** -0.5), rnd(1, p, scale=0.1),
                         rnd(9, p, p, scale=(9 * p) ** -0.5), rnd(1, p, scale=0.1),
                         rnd(p, cout, scale=p ** -0.5), rnd(1, cout, scale=0.1), None, None)
        x32 = rnd(batch, h, w, cin, scale=1.0)
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            x = x32.to(dt)
            args = [fb.w1.to(dt), fb.b1, fb.w2.to(dt), fb.b2, fb.w3.to(dt), fb.b3]
            out = torch.empty((batch, h, w, cout), dtype=dt, device=device)

            def launch():
                rc = dll.fused_bottleneck_launch(code, x.data_ptr(), *[a.data_ptr() for a in args],
                                                 None, None, out.data_ptr(), batch, h, w, cin, p,
                                                 cout, None)
                if rc:
                    raise RuntimeError(f"kernel_phases: launch failed, CUDA error {rc}")

            ms = cuda_time_ms(launch)
            dll.phases_reset()
            launch()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * 8)()
            dll.phases_read(raw)
            n = raw[6]
            ref = fused_bottleneck_reference(x, fb).float()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            yield dict(case=label, dtype=str(dt).split(".")[1], ms=ms, blocks=n,
                       conv1_cycles=raw[0] / n, conv2_cycles=raw[1] / n, conv3_cycles=raw[2] / n,
                       conv1_wait=raw[3] / n, conv2_wait=raw[4] / n, conv3_wait=raw[5] / n,
                       rel_err=err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ablate", choices=sorted(ABLATIONS), default="")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for row in run(build(args.ablate), args.batch, device):
        print(json.dumps(dict(ablate=args.ablate or None, **row)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
