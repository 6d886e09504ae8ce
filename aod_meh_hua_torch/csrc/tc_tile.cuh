// Tensor-core building blocks for the port's hand-written kernels (sm_90a):
// thin inline-PTX wrappers, shared by csrc/transposed_matmul.cu and
// csrc/fused_bottleneck.cu.
//
//   - cp.async.cg 16-byte copies from device memory to shared memory, with
//     zero fill, and their commit/wait groups;
//   - ldmatrix .x4 (and .trans for a B operand stored K-major, N contiguous);
//   - mma.sync m16n8k16 bf16, f32 accumulators;
//   - the 3xTF32 split (big = rna(v), small = rna(v - big)), for
//     acc += a_s*b_b + a_b*b_s + a_b*b_b, the small terms first;
//   - wgmma m64n32k8 tf32 with A in registers and B in shared memory, its
//     descriptor, fences and commit/wait groups.
// mma_bf16 is not volatile: it touches registers only, and the compiler may
// interleave independent ones. wgmma is asynchronous and volatile.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   m16n8k16 bf16  A regs {rows g, g+8} x {k 2t..2t+1, k 8+2t..}: a0 (g, k0-7),
//                  a1 (g+8, k0-7), a2 (g, k8-15), a3 (g+8, k8-15);
//                  B regs b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g);
//   m16n8k8 tf32   A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//                  (also each warp's 16 rows of a wgmma m64nNk8 A in registers);
//   C (both, and each warp's 16 rows of a wgmma D): c0, c1 (row g, cols 2t,
//                  2t+1), c2, c3 (row g+8, same cols), per n8 tile.
// An A tile of 16 rows x 32 bytes (16 bf16 or 8 f32) is one ldmatrix.x4 in
// both types when lane l points at row l % 16, byte (l / 16) * 16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared address dst; reads nothing and writes zeros
// when !valid (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The same, with an L2 evict-first hint: for data read once.
__device__ __forceinline__ void cp_async16_stream(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile(
      "{\n .reg .b64 pol;\n createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      " cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, pol;\n}\n" ::"r"(dst),
      "l"(src), "r"(n)
      : "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v (an f32 as its bits) -> big + small, both tf32; big + small carries
// about 21 of v's 24 significant bits.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big, uint32_t& small) {
  const float f = __uint_as_float(v);
  big = to_tf32(f);
  small = to_tf32(f - __uint_as_float(big));
}

// ---- wgmma: one warpgroup (4 warps) issues an asynchronous product of 64 rows.

// Keep a register where it is, live, across an asynchronous wgmma that
// reads or writes it.
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Make this thread's ordinary shared-memory stores visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// x 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along M/N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

// d (64 x 32) += a (64 x 8) * b (8 x 32), tf32 in, f32 sums. a is in
// registers: each warp of the warpgroup holds its 16 rows as the A of
// mma m16n8k8; b is K-major in shared memory (desc). d is each warp's 16
// rows in the C layout of four m16n8 tiles.
__device__ __forceinline__ void wgmma_tf32_m64n32k8(float (&d)[4][4], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));  // p: d += a * b
}

// Two floats -> two bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
