// Transposed matrix product for Hopper (sm_90a), bf16 in and out:
//
//   out[n, m] = bf16( sum_k f32(wt[n, k]) * f32(xt[k, m]) )
//
// wt [N, K] and xt [K, M] row-major contiguous bf16, out [N, M] bf16,
// the sum in f32, rounded to bf16 once (round to nearest even).
//
// Replaces the Pallas kernel `pallas_t` (body `pallas_kernel`) of
// tools/analysis/pallas_probe.py:232-252: the C2 1x1 conv of R50
// (K=256 -> N=64) as [N, K] @ [K, M] over the M = B*152*256 sites. The
// TPU kernel walks 512-wide M tiles in VMEM; here blocks run in any order
// and share nothing.
//
// What bounds it. At batch 8 (N=64, K=256, M=311,296) it must move
// 199.3 MB (xt 159.4 MB read, out 39.8 MB written, wt 32 KB): 0.0595 ms
// at 3.35 TB/s. Its 10.2 GFLOP take 0.010 ms at the bf16 tensor-core
// peak of 989 TFLOP/s, so on tensor cores it is bound by bytes. This
// first kernel runs on the CUDA cores, whose f32 peak is 67 TFLOP/s:
// 10.2 GFLOP there take 0.15 ms, so it is expected at 2.5x its bound or
// worse: on an H100 SXM at 700 W it takes about 0.29 ms, against 0.08 ms
// for torch.matmul on the tensor cores (chip_smoke.py; PERF.md). Tensor
// cores (mma.sync / wgmma), TMA and a pipeline of stages are later work.
//
// Design.
//   - One block of 256 threads per 128-column tile of M, all N rows
//     (the grid runs over M tiles: 2,432 blocks at batch 8).
//   - wt is staged in shared memory once per block, as f32 in [K][N]
//     order, so a thread reads its N/16 weights of one k in one vector
//     load (64 KB for N=64, K=256).
//   - xt streams through shared memory as f32 in chunks of 32 rows.
//     Each thread fetches 16 bytes (8 bf16) at a time, neighbouring
//     threads on neighbouring addresses along M. The next chunk is
//     fetched into registers while the current one is multiplied.
//   - Each thread keeps N/16 x 8 f32 sums in registers: rows
//     ty*N/16 .. +N/16, columns tx*4 .. +3 and 64 + tx*4 .. +3, so that
//     the shared-memory reads of a quarter warp are consecutive.
//   - The ragged M edge is masked on the load (zeros) and on the store.
//     Vector loads and stores need M % 8 == 0 and 16-byte aligned xt and
//     out; otherwise the kernel takes element-wise accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128;                      // columns of M per block
constexpr int KC = 32;                       // rows of xt per chunk
constexpr int TX = 16;                       // threads along M
constexpr int TY = THREADS / TX;             // threads along N
constexpr int KMAX = 256;
constexpr int VEC = 8;                       // bf16 in one 16-byte access
constexpr int LOADS = KC * TM / VEC / THREADS;  // 16-byte loads per thread per chunk (2)
constexpr int SEGS = TM / VEC;               // 16-byte segments in a chunk row (16)

// bf16 is the top half of an f32: widening is exact.
__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Two floats -> two bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// Fetch this thread's share of chunk rows [k0, k0 + KC) of the block's
// M tile into registers; columns at or beyond M read as zero.
__device__ __forceinline__ void fetch_chunk(uint4* pre, const __nv_bfloat16* __restrict__ xt,
                                            int k0, long long m0, long long M, bool vec) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = l * THREADS + threadIdx.x;
    const int kk = idx / SEGS;
    const long long m = m0 + (idx % SEGS) * VEC;
    const __nv_bfloat16* src = xt + (long long)(k0 + kk) * M + m;
    if (vec && m + VEC <= M) {
      pre[l] = __ldcs(reinterpret_cast<const uint4*>(src));  // read once: stream past L2
    } else {
      uint32_t h[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) h[j] = (m + j < M) ? __bfloat16_as_ushort(src[j]) : 0u;
      pre[l] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                          h[6] | (h[7] << 16));
    }
  }
}

__device__ __forceinline__ void store_chunk(const uint4* pre, float* xs) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = l * THREADS + threadIdx.x;
    float f[VEC];
    unpack8(pre[l], f);
    float4* dst = reinterpret_cast<float4*>(xs + (idx / SEGS) * TM + (idx % SEGS) * VEC);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
transposed_matmul_kernel(const __nv_bfloat16* __restrict__ wt, const __nv_bfloat16* __restrict__ xt,
                         __nv_bfloat16* __restrict__ out, int K, long long M, bool vec) {
  constexpr int RN = N / TY;                 // rows of out per thread
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [K][N]
  float* xs = ws + K * N;                       // [KC][TM]

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const long long m0 = (long long)blockIdx.x * TM;

  uint4 pre[LOADS];
  fetch_chunk(pre, xt, 0, m0, M, vec);

  // wt -> ws, transposed: thread t takes 8 consecutive k of row n = t % N,
  // so the shared-memory stores of a warp hit 32 consecutive n.
  for (int idx = threadIdx.x; idx < N * K / VEC; idx += THREADS) {
    const int n = idx % N;
    const int k = (idx / N) * VEC;
    float f[VEC];
    unpack8(*reinterpret_cast<const uint4*>(wt + (long long)n * K + k), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ws[(k + j) * N + n] = f[j];
  }

  float acc[RN][8];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                         // the last chunk has been read (and ws is ready)
    store_chunk(pre, xs);
    __syncthreads();
    if (k0 + KC < K) fetch_chunk(pre, xt, k0 + KC, m0, M, vec);  // in flight during the sums
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[RN];
      const float* wrow = ws + (k0 + kk) * N + ty * RN;
      if constexpr (RN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(wrow);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(wrow);
        a[0] = v.x; a[1] = v.y;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(xs + kk * TM + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(xs + kk * TM + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    __nv_bfloat16* row = out + (long long)(ty * RN + i) * M;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + half * 64 + tx * 4;
      const float* v = &acc[i][half * 4];
      if (vec && m + 4 <= M) {
        *reinterpret_cast<uint2*>(row + m) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (m + j < M) row[m + j] = __float2bfloat16(v[j]);
      }
    }
  }
}

template <int N>
int launch(const __nv_bfloat16* wt, const __nv_bfloat16* xt, __nv_bfloat16* out, int K,
           long long M, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(K) * N + size_t(KC) * TM);
  cudaError_t err = cudaFuncSetAttribute(transposed_matmul_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const bool vec = M % VEC == 0 && reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = (M + TM - 1) / TM;
  transposed_matmul_kernel<N><<<dim3(unsigned(blocks)), THREADS, smem, stream>>>(wt, xt, out, K, M, vec);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code (0 on success). wt [n, k], xt [k, m],
// out [n, m], all bf16 row-major contiguous; wt 16-byte aligned.
// n is 32 or 64; k a multiple of 32 in [32, 256]; 0 < m < 2^31 * 128.
extern "C" int transposed_matmul_launch(const void* wt, const void* xt, void* out, int n, int k,
                                        long long m, void* stream) {
  if (k % KC != 0 || k < KC || k > KMAX || m <= 0 || (m + TM - 1) / TM > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return int(cudaErrorInvalidValue);
  auto w = static_cast<const __nv_bfloat16*>(wt);
  auto x = static_cast<const __nv_bfloat16*>(xt);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32: return launch<32>(w, x, o, k, m, s);
    case 64: return launch<64>(w, x, o, k, m, s);
    default: return int(cudaErrorInvalidValue);
  }
}
