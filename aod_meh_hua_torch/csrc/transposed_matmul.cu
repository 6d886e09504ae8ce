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
// peak of 989 TFLOP/s, so it is bound by bytes, and the design is about
// keeping enough of xt in flight. PERF.md has its measured time beside
// torch.matmul's (chip_smoke.py).
//
// Design.
//   - A persistent grid: two blocks of 256 threads per SM walk the
//     128-column tiles of M (tile = blockIdx.x + i * gridDim.x), all N
//     rows. wt is staged in shared memory once per block (rows padded to
//     528 bytes, so ldmatrix is free of bank conflicts).
//   - xt streams through a 3-stage ring of 64-row chunks per block with
//     cp.async 16-byte copies (L2 evict-first: read once), neighbouring
//     threads on neighbouring addresses along M; the ring runs on across
//     tiles, so the next tile's chunks are in flight while this one's
//     output is stored (4 chunks, 70 KB, in flight per SM; one block's
//     epilogue overlaps the other's loads). Producer and consumer walk
//     (tile, chunk) by increments: a 64-bit division per chunk costs more
//     than the chunk's sums.
//   - The sums run on mma.sync m16n8k16 (bf16 in, f32 sums). A = wt comes
//     with ldmatrix, B = xt ([K, M], M contiguous) with ldmatrix.trans.
//     8 warps: 2 along N (N/2 rows each) x 4 along M (32 columns each).
//   - Each tile's sums are rounded once to bf16 and staged through shared
//     memory for 16-byte coalesced stores.
//   - The ragged M edge reads zeros (cp.async zero fill) and skips its
//     stores. cp.async and vector stores need M % 8 == 0 and 16-byte
//     aligned xt and out; otherwise chunks and stores go element-wise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TM = 128;                  // columns of M per tile
constexpr int KC = 64;                   // rows of xt per chunk (the last may have 32)
constexpr int KMAX = 256;
constexpr int STAGES = 3;                // chunks in the ring
constexpr int BLOCKS_PER_SM = 2;         // resident blocks of the persistent grid
constexpr int VEC = 8;                   // bf16 in one 16-byte access
constexpr int WLD = KMAX + 8;            // wt row stride in shared memory (528 bytes)
constexpr int XLD = TM + 8;              // chunk and output row stride (272 bytes)
constexpr int SEGS = TM / VEC;           // 16-byte segments in a row of a tile

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t(N) * WLD + size_t(STAGES) * KC * XLD + size_t(N) * XLD);
}

// Rows [k0, min(k0 + KC, K)) of xt, columns [m0, m0 + TM), into one ring
// slot; columns at or beyond M read as zero.
__device__ __forceinline__ void load_chunk(bf16* xs, const bf16* __restrict__ xt, int k0, int K,
                                           long long m0, long long M, bool vec) {
#pragma unroll
  for (int l = 0; l < KC * SEGS / THREADS; ++l) {
    const int idx = l * THREADS + threadIdx.x;
    const int r = idx / SEGS, s = idx % SEGS;
    if (k0 + r >= K) break;  // rows go up with l
    const long long m = m0 + s * VEC;
    bf16* dst = xs + r * XLD + s * VEC;
    const bf16* src = xt + (long long)(k0 + r) * M + m;
    if (vec) {
      const bool ok = m < M;
      tc::cp_async16_stream(tc::smem_u32(dst), ok ? src : xt, ok);  // read once
    } else {
      uint32_t h[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) h[j] = (m + j < M) ? __bfloat16_as_ushort(src[j]) : 0u;
      *reinterpret_cast<uint4*>(dst) = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                                  h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
transposed_matmul_kernel(const bf16* __restrict__ wt, const bf16* __restrict__ xt,
                         bf16* __restrict__ out, int K, long long M, long long tiles, bool vec) {
  constexpr int MT = N / 32;             // m16 tiles of rows per warp
  extern __shared__ uint4 smem4[];
  bf16* ws = reinterpret_cast<bf16*>(smem4);   // [N][WLD]
  bf16* ring = ws + N * WLD;                   // [STAGES][KC][XLD]
  bf16* os = ring + STAGES * KC * XLD;         // [N][XLD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wn = warp / 4, wm = warp % 4;
  const int kch = (K + KC - 1) / KC;
  const long long my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = my_tiles * kch;    // chunks this block consumes
  const long long m_step = (long long)gridDim.x * TM;

  // wt -> ws; the copies join the first chunk's group
  for (int idx = threadIdx.x; idx < N * K / VEC; idx += THREADS) {
    const int n = idx / (K / VEC), k = (idx % (K / VEC)) * VEC;
    tc::cp_async16(tc::smem_u32(ws + n * WLD + k), wt + (long long)n * K + k, true);
  }
  // the producer's place: chunk p_kc of the tile at p_m0, into slot p_slot
  long long produced = 0, p_m0 = (long long)blockIdx.x * TM;
  int p_kc = 0, p_slot = 0;
  auto produce = [&]() {  // one group per call, empty past the last chunk
    if (produced < total) {
      load_chunk(ring + p_slot * KC * XLD, xt, p_kc * KC, K, p_m0, M, vec);
      ++produced;
      if (++p_kc == kch) {
        p_kc = 0;
        p_m0 += m_step;
      }
    }
    p_slot = p_slot + 1 == STAGES ? 0 : p_slot + 1;
    tc::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) produce();

  // lane l: A row l % 16 at byte (l / 16) * 16; B (trans) k row
  // l % 8 + 8 * ((l / 8) % 2), column (l / 16) * 8
  uint32_t a_addr[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    a_addr[i] = tc::smem_u32(ws + (wn * (N / 2) + i * 16 + lane % 16) * WLD + (lane / 16) * 8);
  const uint32_t b_off =
      sizeof(bf16) * ((lane % 8 + ((lane / 8) % 2) * 8) * XLD + wm * 32 + (lane / 16) * 8);
  const int g = lane / 4, t = lane % 4;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  long long m0 = (long long)blockIdx.x * TM;   // the consumer's tile
  int kc = 0, slot = 0;
  for (long long c = 0; c < total; ++c) {
    tc::cp_async_wait<STAGES - 2>();     // chunk c has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; the slot of chunk c - 1 is free
    produce();

    const uint32_t xs = tc::smem_u32(ring + slot * KC * XLD) + b_off;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (kc * KC + ks * 16 >= K) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tc::ldmatrix_x4(a[i], a_addr[i] + sizeof(bf16) * (kc * KC + ks * 16));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, xs + sizeof(bf16) * (ks * 16 * XLD + jp * 16));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tc::mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          tc::mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (++kc < kch) continue;

    // the tile is summed: round, stage, store
    kc = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wn * (N / 2) + i * 16 + g + h * 8;
          const int col = wm * 32 + j * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(os + row * XLD + col) =
              tc::pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * SEGS; idx += THREADS) {
      const int r = idx / SEGS, s = idx % SEGS;
      const long long m = m0 + s * VEC;
      const uint4 v = *reinterpret_cast<const uint4*>(os + r * XLD + s * VEC);
      bf16* dst = out + (long long)r * M + m;
      if (vec) {
        if (m < M) __stcs(reinterpret_cast<uint4*>(dst), v);
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (m + j < M) dst[j] = e[j];
      }
    }
    m0 += m_step;
  }
  tc::cp_async_wait<0>();
}

template <int N>
int launch(const bf16* wt, const bf16* xt, bf16* out, int K, long long M, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(transposed_matmul_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  const bool vec = M % VEC == 0 && reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long tiles = (M + TM - 1) / TM;
  const long long slots = (long long)sms * BLOCKS_PER_SM;
  const unsigned grid = unsigned(tiles < slots ? tiles : slots);
  transposed_matmul_kernel<N><<<grid, THREADS, smem, stream>>>(wt, xt, out, K, M, tiles, vec);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code (0 on success). wt [n, k], xt [k, m],
// out [n, m], all bf16 row-major contiguous; wt 16-byte aligned.
// n is 32 or 64; k a multiple of 32 in [32, 256]; 0 < m < 2^31 * 128.
extern "C" int transposed_matmul_launch(const void* wt, const void* xt, void* out, int n, int k,
                                        long long m, void* stream) {
  if (k % 32 != 0 || k < 32 || k > KMAX || m <= 0 || (m + TM - 1) / TM > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return int(cudaErrorInvalidValue);
  auto w = static_cast<const bf16*>(wt);
  auto x = static_cast<const bf16*>(xt);
  auto o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32: return launch<32>(w, x, o, k, m, s);
    case 64: return launch<64>(w, x, o, k, m, s);
    default: return int(cudaErrorInvalidValue);
  }
}
