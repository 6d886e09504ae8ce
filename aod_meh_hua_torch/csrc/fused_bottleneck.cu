// Fused stride-1 ResNet bottleneck for Hopper (sm_90a), NHWC.
//
//   out = relu( conv3(relu(conv2_3x3(relu(conv1(x) + b1)) + b2)) + b3
//               + residual(x) )
//
// with the frozen BatchNorms already folded into the weights, and
// residual(x) = x (identity) or x @ wd + bd (1x1 downsample).
//
// Replaces the Pallas kernel `fused_bottleneck` of
// aod_meh_hua_tpu/ops/fused_block.py (body `_kernel`, halo copy
// `_halo_dma`). The TPU kernel streams whole-width row tiles through
// many MB of VMEM; a C2 row of conv1 output alone nearly fills a Hopper
// block's 227 KB of shared memory, so this kernel tiles both H and W:
// one block owns a TH x TW output tile (8x16; 8x8 for f32 at P = 128,
// where shared memory forces it) and works on its (TH+2) x (TW+2) halo.
//
// Three GEMM stages on the tensor cores, every intermediate in shared
// memory:
//   1. conv1: [halo pixels, padded to m16 (bf16) or m64 (f32)] x Cin @
//      w1 [Cin, P], + b1, relu, rounded to T, into y1. Halo pixels outside
//      the image are set to 0: that is conv2's zero padding (conv1 of a
//      zero pixel would give relu(b1), not 0).
//   2. conv2: nine taps of [TH*TW, P] @ w2[tap] [P, P]. ldmatrix takes a
//      row address per lane, so each 3x3 shift of y1 is address
//      arithmetic, with no im2col copy. + b2, relu, rounded, into y2.
//   3. conv3 in chunks of P output channels: y2 @ w3[:, n0:n0+P] (+ the
//      tile's own pixels of x @ wd[:, n0:n0+P] for a downsample) + b3 +
//      residual (fetched before the sums), relu. bf16 is staged through
//      shared memory for 16-byte stores; f32 goes straight from the
//      registers (a quad writes a 32-byte sector).
// The work runs in steps of 32 K rows: a [32, P] weight chunk per step,
// and a [rows, 32] x chunk in the steps of conv1 and the downsample. x
// streams through a 3-step cp.async ring; bf16's weights through a ring of
// 4-12 steps (Geo::WS); f32's through registers (below). The rings run on
// across the stages, so no stage starts cold.
//
// Arithmetic. A (activations) comes from shared memory with ldmatrix, one
// row address per lane, in both types.
//   bf16: mma.sync m16n8k16, f32 sums; B (weights) with ldmatrix.trans. 8
//     warps, two blocks per SM where shared memory allows.
//   f32: 3xTF32 on wgmma m64n32k8 (a_s*b_b + a_b*b_s + a_b*b_b, the small
//     terms first), which keeps the sums at about f32 accuracy; a single
//     TF32 pass would not. A is split into big and small tf32 halves in
//     registers as it is loaded. Each step's weight chunk is fetched into
//     registers two steps ahead and split once into big and small halves,
//     K-major in wgmma's core-matrix layout (tf32 B must be K-major; the
//     weights are [K, N]), into one of two buffers while the step before
//     runs its products. 4 warpgroups; each issues the same number of
//     tiles (surplus ones clamped and dropped), since a wgmma behind a
//     warpgroup-dependent branch is serialised.
//
// What bounds it. f32 at C2/C3 (batch 8): 43.35 GFLOP a launch, three
// tf32 products each, 0.263 ms at 495 TFLOP/s, above the bytes (0.190 ms
// C2, 0.095 ms C3). bf16: bytes, 0.095 / 0.048 ms. wgmma is Hopper's only
// path to the tensor cores' full rate, which is why f32 (the scoring
// path) uses it; what holds it back is the tensor-core issue within each
// step and per-step work off the tensor cores (getting the weights into
// their split halves, the barrier, A splits), not the copies. PERF.md has the measured times
// (chip_smoke.py) and this breakdown (tools/kernel_phases.py).
//
// Intermediates are rounded to the input type before the next conv, as
// the TPU kernel does (`y1.astype(x.dtype)`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 32;                    // K rows per pipeline step
constexpr int WS_MAX = 12;                // most steps in the weight ring
constexpr size_t SMEM_MAX = 232448;       // shared memory one block may use
constexpr size_t SMEM_HALF = 115712;      // ... each of two blocks on one SM

// ring slots of `slot` bytes that fit in `smem` beside `fixed` bytes
constexpr int slots_in(size_t smem, size_t fixed, size_t slot) {
  return smem <= fixed ? 0 : int((smem - fixed) / slot);
}

template <typename T, int P>
struct Geo {
  static constexpr int SZ = sizeof(T);
  // 16 warps for f32, whose split operands and tf32 products need more
  // warps in flight; 8 for bf16, where two blocks share an SM instead
  static constexpr int THREADS = SZ == 4 ? 512 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int E = 16 / SZ;                       // elements in 16 bytes
  static constexpr int TH = 8;
  static constexpr int TW = (SZ == 4 && P == 128) ? 8 : 16;
  static constexpr int HW = TW + 2;                       // halo columns
  static constexpr int NH = (TH + 2) * HW;                // halo pixels (180 or 100)
  // m16 tiles of conv1: whole m64 tiles (4 m16) for f32's wgmma
  static constexpr int MT1 = SZ == 4 ? (NH + 63) / 64 * 4 : (NH + 15) / 16;
  static constexpr int NHP = MT1 * 16;
  static constexpr int ROWS = TH * TW;                    // output pixels
  static constexpr int MT2 = ROWS / 16;
  static constexpr int WN = P / 32;                       // 32-column blocks of P
  // A warp owns 32 columns and the m16 tiles mt0 + i * RSTEP. bf16: warps
  // split the rows. f32: warpgroups split them in m64 tiles, and warp q of
  // a warpgroup holds rows 16q..16q+15 of each.
  static constexpr int RSTEP = SZ == 4 ? 4 * (WARPS / 4 / WN) : WARPS / WN;
  static constexpr int MI1 = (MT1 + RSTEP - 1) / RSTEP;   // m16 tiles per warp
  static constexpr int MI2 = (MT2 + RSTEP - 1) / RSTEP;
  static constexpr int XS = 3;                            // steps in the x ring
  // row strides in elements: activations padded by 16 bytes and weights
  // by 8 elements, so ldmatrix rows and scalar f32 B reads avoid bank conflicts
  static constexpr int XLD = KC + E;
  static constexpr int YLD = P + E;
  static constexpr int WLD = P + 8;
  static constexpr int XSLOT = NHP * XLD;                 // elements per ring slot
  static constexpr int WSLOT = KC * WLD;
  // f32: the weights of two steps (this one and the next) as big and small
  // tf32 halves, K-major in wgmma's core matrices: [2][2][P/8][KC/4][8][4]
  static constexpr int CBUF = SZ == 4 ? 4 * KC * P : 0;
  static constexpr int WREG = SZ == 4 ? KC * P / THREADS : 1;  // f32: a thread's weights per step
  // bf16's weight ring: as deep as lets two blocks share an SM, where at
  // least XS steps fit (the two blocks overlap one's loads with the other's
  // sums, which deeper rings do not); else as deep as one block allows.
  // f32 has none: its weights come through registers into CBUF.
  static constexpr size_t FIXED = size_t(SZ) * (CBUF + XS * XSLOT + NHP * YLD + ROWS * YLD);
  static constexpr int MIN_BLOCKS =
      SZ == 2 && slots_in(SMEM_HALF, FIXED, SZ * WSLOT) >= XS ? 2 : 1;
  static constexpr int WS_FIT =
      SZ == 4 ? 0 : slots_in(MIN_BLOCKS == 2 ? SMEM_HALF : SMEM_MAX, FIXED, SZ * WSLOT);
  static constexpr int WS = WS_FIT < WS_MAX ? WS_FIT : WS_MAX;   // steps in the weight ring
  static_assert(SZ == 4 || WS >= XS, "the weight ring must be at least as deep as the x ring");
  static_assert(FIXED + size_t(SZ) * WS * WSLOT <= SMEM_MAX, "shared memory");
  static constexpr size_t SMEM = FIXED + size_t(SZ) * WS * WSLOT;
};

// two consecutive elements of T, as loaded and as floats
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<bf16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16x2(a, b);
}

// acc[i] += A rows (a_base + a_row[i]) [16 x 32 K] @ one step's weights
// [32 x P], this warp's 32 columns. Tile i is this warp's m16 tile
// mt0 + i * RSTEP; tiles past MT do nothing. bf16 reads the weights from
// their ring slot ws; f32 from the big and small halves at cb. during()
// runs once the step's products are issued.
template <typename T, int P, int MI, int MT, typename F>
__device__ __forceinline__ void mma_step(float (&acc)[MI][4][4], uint32_t a_base,
                                         const uint32_t (&a_row)[MI], const T* ws, uint32_t cb,
                                         int mt0, int wn, int lane, F&& during) {
  using G = Geo<T, P>;
  if constexpr (std::is_same<T, bf16>::value) {
    const uint32_t b_base = tc::smem_u32(ws) + sizeof(T) * ((lane % 8 + ((lane / 8) % 2) * 8) * G::WLD +
                                                            wn * 32 + (lane / 16) * 8);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t b[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        tc::ldmatrix_x4_trans(b[jp], b_base + sizeof(T) * (ks * 16 * G::WLD + jp * 16));
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (mt0 + i * G::RSTEP >= MT) continue;
        uint32_t a[4];
        tc::ldmatrix_x4(a, a_base + a_row[i] + ks * 32);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          tc::mma_bf16(acc[i][2 * jp], a, b[jp][0], b[jp][1]);
          tc::mma_bf16(acc[i][2 * jp + 1], a, b[jp][2], b[jp][3]);
        }
      }
    }
    during();
  } else {
    // 3xTF32 on wgmma: per k8, a_s*b_b, a_b*b_s, a_b*b_b. A is split in
    // registers as it is loaded, double-buffered over k8 steps: a buffer
    // is refilled only once the wgmma that read it has completed.
    constexpr uint32_t LBO = 128, SBO = KC / 4 * 128;
    const uint32_t cb_big = cb + wn * 4 * SBO, cb_small = cb_big + KC * P * 4;
    uint32_t ab[2][MI][4], as[2][MI][4];
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int h = ks & 1;
      if (ks >= 2) {
        tc::wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tc::fence_operand(ab[h][i][e]);
            tc::fence_operand(as[h][i][e]);
          }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, a_base + a_row[i] + ks * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_tf32(a[e], ab[h][i][e], as[h][i][e]);
      }
      tc::wgmma_fence();
      const uint64_t db = tc::smem_desc(cb_big + ks * 2 * LBO, LBO, SBO);
      const uint64_t dsm = tc::smem_desc(cb_small + ks * 2 * LBO, LBO, SBO);
#pragma unroll
      for (int i = 0; i < MI; ++i) {  // every tile, valid or not: no branch
        tc::wgmma_tf32_m64n32k8(acc[i], as[h][i], db);
        tc::wgmma_tf32_m64n32k8(acc[i], ab[h][i], dsm);
        tc::wgmma_tf32_m64n32k8(acc[i], ab[h][i], db);
      }
      tc::wgmma_commit();
    }
    during();  // runs while the products are in flight
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tc::fence_operand(ab[0][i][e]);
        tc::fence_operand(as[0][i][e]);
        tc::fence_operand(ab[1][i][e]);
        tc::fence_operand(as[1][i][e]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::fence_operand(acc[i][j][e]);
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(Geo<T, P>::THREADS, Geo<T, P>::MIN_BLOCKS)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const float* __restrict__ b2, const T* __restrict__ w3,
                        const float* __restrict__ b3, const T* __restrict__ wd,
                        const float* __restrict__ bd, T* __restrict__ out, int H, int W,
                        int Cin, int Cout, int tiles_w) {
  using G = Geo<T, P>;
  constexpr int SZ = G::SZ, E = G::E, TW = G::TW, HW = G::HW, THREADS = G::THREADS;
  constexpr int WS = G::WS, XS = G::XS;
  static_assert(KC == 32, "the f32 weight conversion below assumes 32-row steps");
  extern __shared__ uint4 smem4[];
  T* cbuf = reinterpret_cast<T*>(smem4);              // [CBUF] f32 only: wgmma's B
  T* xring = cbuf + G::CBUF;                          // [XS][NHP][XLD]
  T* wring = xring + XS * G::XSLOT;                   // [WS][KC][WLD]
  T* y1 = wring + WS * G::WSLOT;                      // [NHP][YLD]; conv3's output staging
  T* y2 = y1 + G::NHP * G::YLD;                       // [ROWS][YLD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // this warp's 32 columns (wn) and first m16 tile (mt0); see Geo::RSTEP
  const int wn = SZ == 4 ? (warp / 4) % G::WN : warp % G::WN;
  const int mt0 = SZ == 4 ? (warp / 4 / G::WN) * 4 + warp % 4 : warp / G::WN;
  const uint32_t cb_u = tc::smem_u32(cbuf);
  const int g = lane / 4, t = lane % 4;
  const int y0 = (blockIdx.x / tiles_w) * G::TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const T* xb = x + size_t(blockIdx.y) * H * W * Cin;
  T* ob = out + size_t(blockIdx.y) * H * W * Cout;
  const bool down = wd != nullptr;

  // the steps of the ring, in order: conv1 (Cin/KC), conv2 (9 taps x P/KC),
  // then per P-wide chunk of Cout: conv3 (P/KC) and the downsample (Cin/KC)
  const int n1 = Cin / KC, n2 = 9 * (P / KC);
  const int n3 = P / KC + (down ? Cin / KC : 0);
  const int total = n1 + n2 + (Cout / P) * n3;

  auto load_w = [&](T* slot, const T* src, int ld) {  // [KC, P] at src, row stride ld
    constexpr int SEGR = P / E;
    for (int idx = threadIdx.x; idx < KC * SEGR; idx += THREADS) {
      const int r = idx / SEGR, s = idx % SEGR;
      tc::cp_async16(tc::smem_u32(slot + r * G::WLD + s * E), src + size_t(r) * ld + s * E, true);
    }
  };
  // x chunk (channels c0..c0+KC) of the halo (halo = true) or of the
  // tile's own pixels; pixels outside the image and pad rows read zeros
  auto load_x = [&](T* slot, int c0, bool halo) {
    constexpr int SEGR = KC / E;
    const int rows = halo ? G::NHP : G::ROWS;
    for (int idx = threadIdx.x; idx < rows * SEGR; idx += THREADS) {
      const int r = idx / SEGR, s = idx % SEGR;
      int gy, gx;
      if (halo) {
        gy = y0 - 1 + r / HW;
        gx = x0 - 1 + r % HW;
      } else {
        gy = y0 + r / TW;
        gx = x0 + r % TW;
      }
      const bool ok = (!halo || r < G::NH) && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = ok ? xb + (size_t(gy) * W + gx) * Cin + c0 + s * E : xb;
      tc::cp_async16(tc::smem_u32(slot + r * G::XLD + s * E), src, ok);
    }
  };
  // does the step stream x (conv1's steps and the downsample's)?
  auto has_x = [&](int step) {
    step -= n1 + n2;
    return step < -n2 || (down && step >= 0 && step % n3 >= P / KC);
  };
  // step -> its weight chunk: KC rows of P columns at the result, row stride ld
  auto w_chunk = [&](int step, int& ld) -> const T* {
    ld = P;
    if (step < n1) return w1 + size_t(step) * KC * P;
    step -= n1;
    if (step < n2) {
      const int tap = step / (P / KC), kc = step % (P / KC);
      return w2 + (size_t(tap) * P + kc * KC) * P;
    }
    step -= n2;
    // n3 is P / KC without a downsample: a constant divisor
    const int n0 = (down ? step / n3 : step / (P / KC)) * P;
    const int r = down ? step % n3 : step % (P / KC);
    ld = Cout;
    return r < P / KC ? w3 + size_t(r) * KC * Cout + n0 : wd + size_t(r - P / KC) * KC * Cout + n0;
  };
  constexpr int WS1 = WS > 0 ? WS : 1;  // f32 has no weight ring
  auto issue_w = [&](int step) {
    int ld;
    const T* src = w_chunk(step, ld);
    load_w(wring + (step % WS1) * G::WSLOT, src, ld);
  };
  // f32: a step's weights reach wgmma through registers: fetched from L2
  // two steps ahead, split into big and small halves into the CBUF half of
  // their step while the products of the step before run
  float wreg[G::WREG];
  auto fetch_w = [&](int step) {
    int ld;
    const float* src = reinterpret_cast<const float*>(w_chunk(step, ld));
#pragma unroll
    for (int l = 0; l < G::WREG; ++l) {  // idx = [n/8][k/4][n%8][k%4]
      const int idx = l * THREADS + threadIdx.x;
      const int k = ((idx >> 5) & 7) * 4 + (idx & 3), n = (idx >> 8) * 8 + ((idx >> 2) & 7);
      wreg[l] = __ldg(src + size_t(k) * ld + n);
    }
  };
  auto split_w = [&](int step) {
    uint32_t* big = reinterpret_cast<uint32_t*>(cbuf) + (step & 1) * 2 * KC * P;
#pragma unroll
    for (int l = 0; l < G::WREG; ++l) {
      const int idx = l * THREADS + threadIdx.x;
      tc::split_tf32(__float_as_uint(wreg[l]), big[idx], big[idx + KC * P]);
    }
    tc::fence_proxy_async();
  };
  auto issue_x = [&](int step) {
    T* xs = xring + (step % XS) * G::XSLOT;
    if (step < n1)
      load_x(xs, step * KC, true);
    else
      load_x(xs, ((step - n1 - n2) % n3 - P / KC) * KC, false);
  };
  // One cp.async group per step. bf16: step s commits the weights of
  // step s + WS - 1 and the x of step s + XS - 1, so step s's weights are
  // in group s and its x (s >= XS - 1) in group s + WS - XS: waiting for
  // step s leaves WS - 2 groups in flight, or XS - 2 when it has x. f32:
  // step s commits the x of step s + XS - 1 only.
  auto advance = [&](int s) {
    if constexpr (SZ == 2) {
      if (has_x(s))
        tc::cp_async_wait<XS - 2>();
      else
        tc::cp_async_wait<WS - 2>();
    } else {
      tc::cp_async_wait<XS - 2>();
    }
    // step s is visible to all (its weights and x); step s - 1 is done with
    // its slots and, for f32, with the B halves that step s + 1 will use
    __syncthreads();
    if constexpr (SZ == 2)
      if (s + WS - 1 < total) issue_w(s + WS - 1);
    if (s + XS - 1 < total && has_x(s + XS - 1)) issue_x(s + XS - 1);
    tc::cp_async_commit();
  };
  // f32, while step s's products run: split step s + 1's weights (fetched
  // a step ago) and fetch step s + 2's, which then have a whole step to land
  auto split_next = [&](int s) {
    if constexpr (SZ == 4) {
      if (s + 1 < total) split_w(s + 1);
      if (s + 2 < total) fetch_w(s + 2);
    }
  };
  const uint32_t xring_u = tc::smem_u32(xring);
  auto xslot = [&](int s) { return xring_u + uint32_t(SZ * (s % XS) * G::XSLOT); };
  auto wslot = [&](int s) { return wring + (s % WS1) * G::WSLOT; };
  auto cbs = [&](int s) { return cb_u + uint32_t((s & 1) * 2 * KC * P * SZ); };

  if constexpr (SZ == 2) {
    for (int p = 0; p < WS - 1; ++p) {
      if (p < total) issue_w(p);
      if (p < XS - 1 && p < total && has_x(p)) issue_x(p);
      tc::cp_async_commit();
    }
  } else {
    for (int p = 0; p < XS - 1; ++p) {
      if (p < total && has_x(p)) issue_x(p);
      tc::cp_async_commit();
    }
    fetch_w(0);
    split_w(0);
    if (1 < total) fetch_w(1);
  }
  int s = 0;
  // lane l points its ldmatrix at row l % 16 of an m16 tile, byte (l / 16) * 16
  const int lrow = lane % 16;
  const uint32_t lcol = (lane / 16) * 16;
  // this warp's i-th m16 tile, clamped into [0, mt): f32 computes MI tiles
  // in every warpgroup (a wgmma behind a branch that differs between
  // warpgroups is serialised), and the surplus tiles are not stored
  auto tile = [&](int i, int mt) { return min(mt0 + i * G::RSTEP, mt - 1); };

  // ---- 1. conv1 (1x1) + b1 + relu over the halo
  {
    float acc[G::MI1][4][4] = {};
    uint32_t a_row[G::MI1];
#pragma unroll
    for (int i = 0; i < G::MI1; ++i) a_row[i] = SZ * (tile(i, G::MT1) * 16 + lrow) * G::XLD + lcol;
    for (int kc = 0; kc < n1; ++kc, ++s) {
      advance(s);
      mma_step<T, P, G::MI1, G::MT1>(acc, xslot(s), a_row, wslot(s), cbs(s), mt0, wn, lane,
                                     [&] { split_next(s); });
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn * 32 + j * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + n));
#pragma unroll
      for (int i = 0; i < G::MI1; ++i) {
        if (mt0 + i * G::RSTEP >= G::MT1) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (mt0 + i * G::RSTEP) * 16 + g + 8 * h;
          const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
          const bool inside = r < G::NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
          store2(y1 + r * G::YLD + n, inside ? fmaxf(acc[i][j][2 * h] + bias.x, 0.f) : 0.f,
                 inside ? fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f) : 0.f);
        }
      }
    }
  }

  // ---- 2. conv2 (3x3, zero padded) + b2 + relu
  {
    float acc[G::MI2][4][4] = {};
    const uint32_t y1_u = tc::smem_u32(y1);
    uint32_t q_row[G::MI2];  // this lane's output pixel -> its halo row at tap (0, 0)
#pragma unroll
    for (int i = 0; i < G::MI2; ++i) {
      const int q = tile(i, G::MT2) * 16 + lrow;
      q_row[i] = (q / TW) * HW + q % TW;
    }
    for (int j = 0; j < n2; ++j, ++s) {
      const int tap = j / (P / KC), kc = j % (P / KC);
      const int shift = (tap / 3) * HW + tap % 3;
      uint32_t a_row[G::MI2];
#pragma unroll
      for (int i = 0; i < G::MI2; ++i) a_row[i] = SZ * (q_row[i] + shift) * G::YLD + lcol;
      advance(s);
      mma_step<T, P, G::MI2, G::MT2>(acc, y1_u + SZ * kc * KC, a_row, wslot(s), cbs(s), mt0, wn, lane,
                                     [&] { split_next(s); });
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn * 32 + j * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + n));
#pragma unroll
      for (int i = 0; i < G::MI2; ++i) {
        if (mt0 + i * G::RSTEP >= G::MT2) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (mt0 + i * G::RSTEP) * 16 + g + 8 * h;
          store2(y2 + q * G::YLD + n, fmaxf(acc[i][j][2 * h] + bias.x, 0.f),
                 fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f));
        }
      }
    }
  }

  // ---- 3. conv3 (1x1) + b3 + residual + relu, P output channels at a time
  uint32_t a_row[G::MI2];
#pragma unroll
  for (int i = 0; i < G::MI2; ++i) a_row[i] = SZ * (tile(i, G::MT2) * 16 + lrow) * G::YLD + lcol;
  uint32_t x_row[G::MI2];
#pragma unroll
  for (int i = 0; i < G::MI2; ++i) x_row[i] = SZ * (tile(i, G::MT2) * 16 + lrow) * G::XLD + lcol;
  const uint32_t y2_u = tc::smem_u32(y2);
  for (int n0 = 0; n0 < Cout; n0 += P) {
    // the identity residual of this chunk, fetched now and used after the
    // sums (pixels outside the image fetch pixel (0, 0) and are not stored)
    typename Pair<T>::type res[G::MI2][4][2];
    if (!down) {
#pragma unroll
      for (int i = 0; i < G::MI2; ++i) {
        if (mt0 + i * G::RSTEP >= G::MT2) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (mt0 + i * G::RSTEP) * 16 + g + 8 * h;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          const bool in = gy < H && gx < W;
          const T* src = xb + (in ? size_t(gy) * W + gx : 0) * Cin + n0 + wn * 32 + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            res[i][j][h] = __ldg(reinterpret_cast<const typename Pair<T>::type*>(src + j * 8));
        }
      }
    }
    float2 bias[4];  // b3 (+ bd) of this lane's columns, also fetched now
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      bias[j] = __ldg(reinterpret_cast<const float2*>(b3 + n));
      if (down) {
        const float2 bdn = __ldg(reinterpret_cast<const float2*>(bd + n));
        bias[j].x += bdn.x;
        bias[j].y += bdn.y;
      }
    }
    float acc[G::MI2][4][4] = {};
    for (int kc = 0; kc < P / KC; ++kc, ++s) {
      advance(s);
      mma_step<T, P, G::MI2, G::MT2>(acc, y2_u + SZ * kc * KC, a_row, wslot(s), cbs(s), mt0, wn, lane,
                                     [&] { split_next(s); });
    }
    if (down) {  // 1x1 downsample residual over the tile's own pixels
      for (int kc = 0; kc < Cin / KC; ++kc, ++s) {
        advance(s);
        mma_step<T, P, G::MI2, G::MT2>(acc, xslot(s), x_row, wslot(s), cbs(s), mt0, wn, lane,
                                     [&] { split_next(s); });
      }
    }
    T* stage = y1;  // [ROWS][YLD]: y1 is no longer read
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < G::MI2; ++i) {
        if (mt0 + i * G::RSTEP >= G::MT2) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (mt0 + i * G::RSTEP) * 16 + g + 8 * h;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          if (gy >= H || gx >= W) continue;
          float v0 = acc[i][j][2 * h] + bias[j].x, v1 = acc[i][j][2 * h + 1] + bias[j].y;
          if (!down) {
            const float2 r = to_float2(res[i][j][h]);
            v0 += r.x;
            v1 += r.y;
          }
          if constexpr (SZ == 4)  // a quad writes 32 contiguous bytes: a whole sector
            store2(ob + (size_t(gy) * W + gx) * Cout + n0 + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          else
            store2(stage + q * G::YLD + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    if constexpr (SZ == 2) {  // bf16: 16 bytes a quad; staged for 16-byte stores
      __syncthreads();
      constexpr int SEGR = P / E;
      for (int idx = threadIdx.x; idx < G::ROWS * SEGR; idx += THREADS) {
        const int q = idx / SEGR, sg = idx % SEGR;
        const int gy = y0 + q / TW, gx = x0 + q % TW;
        if (gy < H && gx < W)
          *reinterpret_cast<uint4*>(ob + (size_t(gy) * W + gx) * Cout + n0 + sg * E) =
              *reinterpret_cast<const uint4*>(stage + q * G::YLD + sg * E);
      }
    }
  }
  tc::cp_async_wait<0>();
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, const void* wd,
                   const float* bd, void* out, int B, int H, int W, int Cin, int Cout,
                   cudaStream_t stream) {
  using G = Geo<T, P>;
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(G::SMEM));
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + G::TW - 1) / G::TW;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  dim3 grid(tiles_w * tiles_h, B);
  fused_bottleneck_kernel<T, P><<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(w3), b3, static_cast<const T*>(wd), bd, static_cast<T*>(out), H, W,
      Cin, Cout, tiles_w);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wd/bd are null for an identity
// residual. x, out and the weights 16-byte aligned, the biases 8-byte
// aligned. Returns a cudaError_t (0 on success); the launch does not
// synchronise.
extern "C" int fused_bottleneck_launch(int dtype, const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const void* w3,
                                       const void* b3, const void* wd, const void* bd, void* out,
                                       int B, int H, int W, int Cin, int P, int Cout,
                                       void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin % KC != 0 || Cin <= 0 || Cout % P != 0 ||
      (wd == nullptr) != (bd == nullptr) || (wd == nullptr && Cin != Cout))
    return int(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(out) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) ||
      (wd != nullptr && !aligned16(wd)) || !aligned8(b1) || !aligned8(b2) || !aligned8(b3) ||
      (bd != nullptr && !aligned8(bd)))
    return int(cudaErrorMisalignedAddress);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  const float* fbd = static_cast<const float*>(bd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_LAUNCH(T, PW)                                                                       \
  if (P == PW)                                                                                 \
    return int(launch<T, PW>(x, w1, fb1, w2, fb2, w3, fb3, wd, fbd, out, B, H, W, Cin, Cout, s));
  // P = 64 and 128 are R50's C2 and C3; 32 is the C2 of a half-width test model
  if (dtype == 0) {
    FB_LAUNCH(float, 32)
    FB_LAUNCH(float, 64)
    FB_LAUNCH(float, 128)
  } else if (dtype == 1) {
    FB_LAUNCH(bf16, 32)
    FB_LAUNCH(bf16, 64)
    FB_LAUNCH(bf16, 128)
  }
#undef FB_LAUNCH
  return int(cudaErrorInvalidValue);
}
