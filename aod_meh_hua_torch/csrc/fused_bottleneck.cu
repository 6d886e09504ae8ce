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
// one block owns an 8x8 output tile and works on its 10x10 halo.
//
//   1. conv1 + b1 + relu over the 100 halo pixels into shared memory.
//      Input channels stream through shared memory in chunks of 32.
//      Halo pixels outside the image are set to 0: that is conv2's zero
//      padding (conv1 of a zero pixel would give relu(b1), not 0).
//   2. the nine taps of the 3x3 + b2 + relu into shared memory.
//   3. conv3 + b3 + residual + relu, P output channels at a time,
//      written once to device memory.
//
// x is read from device memory about twice (halo + residual) and the
// output written once; every intermediate stays in shared memory. The
// weights (C3's w2 alone is 590 KB in f32) stay in device memory and are
// served from L2. Each thread owns a few pixels times P/16 channels and
// accumulates in f32 on the CUDA cores, for f32 and bf16 inputs alike.
// At the path's shapes the f32 block is bound by operations (about
// 0.14 MFLOP per C2 pixel against 2 KB of traffic); this first kernel
// uses no tensor cores (wgmma/TMA are later work), so it sits well
// below that bound. Blocks share no state and run in any order.
//
// Intermediates are rounded to the input type before the next conv, as
// the TPU kernel does (`y1.astype(x.dtype)`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                     // output tile rows
constexpr int TW = 8;                     // output tile columns
constexpr int HH = TH + 2;                // halo tile rows
constexpr int HW = TW + 2;                // halo tile columns
constexpr int NH = HH * HW;               // halo pixels (100)
constexpr int M = TH * TW;                // output pixels (64)
constexpr int THREADS = 256;
constexpr int TN = 16;                    // threads along channels
constexpr int TM = THREADS / TN;          // threads along pixels
constexpr int RM1 = (NH + TM - 1) / TM;   // halo pixels per thread (7)
constexpr int RM = M / TM;                // output pixels per thread (4)
constexpr int KC = 32;                    // input-channel chunk in shared memory
constexpr int XS_LD = KC + 1;             // +1: rows fall in different banks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to T's precision and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(RM1 * TM) * XS_LD + size_t(NH) * (P + 1) + size_t(M) * (P + 1));
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const float* __restrict__ b2, const T* __restrict__ w3,
                        const float* __restrict__ b3, const T* __restrict__ wd,
                        const float* __restrict__ bd, T* __restrict__ out, int H, int W,
                        int Cin, int Cout, int tiles_w) {
  constexpr int RN = P / TN;  // channels per thread
  constexpr int Y_LD = P + 1;
  extern __shared__ float smem[];
  float* xs = smem;                     // [RM1 * TM][XS_LD] input chunk
  float* y1s = xs + RM1 * TM * XS_LD;   // [NH][Y_LD]
  float* y2s = y1s + NH * Y_LD;         // [M][Y_LD]

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tm = tid / TN;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const T* xb = x + size_t(blockIdx.y) * H * W * Cin;
  T* ob = out + size_t(blockIdx.y) * H * W * Cout;

  // ---- 1. conv1 (1x1) + b1 + relu over the halo tile
  float acc1[RM1][RN];
#pragma unroll
  for (int i = 0; i < RM1; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc1[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += KC) {
    __syncthreads();  // the previous chunk has been read
    for (int e = tid; e < RM1 * TM * KC; e += THREADS) {
      const int m = e / KC, c = e % KC;
      float v = 0.f;
      if (m < NH) {
        const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f(xb[(size_t(gy) * W + gx) * Cin + k0 + c]);
      }
      xs[m * XS_LD + c] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float bv[RN];
      const T* wrow = w1 + size_t(k0 + k) * P + tn;
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = to_f(wrow[j * TN]);
#pragma unroll
      for (int i = 0; i < RM1; ++i) {
        const float a = xs[(tm + i * TM) * XS_LD + k];
#pragma unroll
        for (int j = 0; j < RN; ++j) acc1[i][j] = fmaf(a, bv[j], acc1[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM1; ++i) {
    const int m = tm + i * TM;
    if (m < NH) {
      const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = tn + j * TN;
        y1s[m * Y_LD + n] = inside ? round_to<T>(fmaxf(acc1[i][j] + b1[n], 0.f)) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- 2. conv2 (3x3, zero padded) + b2 + relu
  float acc2[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc2[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    int hrow[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int q = tm + i * TM;
      hrow[i] = ((q / TW) + dy) * HW + (q % TW) + dx;
    }
    const T* wt = w2 + size_t(tap) * P * P + tn;
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float bv[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = to_f(wt[size_t(k) * P + j * TN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = y1s[hrow[i] * Y_LD + k];
#pragma unroll
        for (int j = 0; j < RN; ++j) acc2[i][j] = fmaf(a, bv[j], acc2[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int q = tm + i * TM;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = tn + j * TN;
      y2s[q * Y_LD + n] = round_to<T>(fmaxf(acc2[i][j] + b2[n], 0.f));
    }
  }
  __syncthreads();

  // ---- 3. conv3 (1x1) + b3 + residual + relu, P output channels at a time
  for (int n0 = 0; n0 < Cout; n0 += P) {
    float acc3[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc3[i][j] = 0.f;

#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float bv[RN];
      const T* wrow = w3 + size_t(k) * Cout + n0 + tn;
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = to_f(wrow[j * TN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = y2s[(tm + i * TM) * Y_LD + k];
#pragma unroll
        for (int j = 0; j < RN; ++j) acc3[i][j] = fmaf(a, bv[j], acc3[i][j]);
      }
    }
    if (wd != nullptr) {  // 1x1 downsample residual over the tile's own pixels
      for (int k0 = 0; k0 < Cin; k0 += KC) {
        __syncthreads();
        for (int e = tid; e < M * KC; e += THREADS) {
          const int q = e / KC, c = e % KC;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          float v = 0.f;
          if (gy < H && gx < W) v = to_f(xb[(size_t(gy) * W + gx) * Cin + k0 + c]);
          xs[q * XS_LD + c] = v;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float bv[RN];
          const T* wrow = wd + size_t(k0 + k) * Cout + n0 + tn;
#pragma unroll
          for (int j = 0; j < RN; ++j) bv[j] = to_f(wrow[j * TN]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float a = xs[(tm + i * TM) * XS_LD + k];
#pragma unroll
            for (int j = 0; j < RN; ++j) acc3[i][j] = fmaf(a, bv[j], acc3[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int q = tm + i * TM;
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      if (gy < H && gx < W) {
        const size_t pix = size_t(gy) * W + gx;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = n0 + tn + j * TN;
          float v = acc3[i][j] + b3[n];
          v += (wd != nullptr) ? bd[n] : to_f(xb[pix * Cin + n]);
          ob[pix * Cout + n] = from_f<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, const void* wd,
                   const float* bd, void* out, int B, int H, int W, int Cin, int Cout,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, B);
  fused_bottleneck_kernel<T, P><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(w3), b3, static_cast<const T*>(wd), bd, static_cast<T*>(out), H, W,
      Cin, Cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wd/bd are null for an identity
// residual. Returns a cudaError_t (0 on success); the launch does not
// synchronise.
extern "C" int fused_bottleneck_launch(int dtype, const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const void* w3,
                                       const void* b3, const void* wd, const void* bd, void* out,
                                       int B, int H, int W, int Cin, int P, int Cout,
                                       void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin % KC != 0 || Cout % P != 0 ||
      (wd == nullptr && Cin != Cout))
    return int(cudaErrorInvalidValue);
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
    FB_LAUNCH(__nv_bfloat16, 32)
    FB_LAUNCH(__nv_bfloat16, 64)
    FB_LAUNCH(__nv_bfloat16, 128)
  }
#undef FB_LAUNCH
  return int(cudaErrorInvalidValue);
}
