// Tensor-core building blocks of the bf16/fp16 ("tc") flash kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte cp.async tile copies into padded
// shared memory, ldmatrix fragment loads, mma.sync.m16n8k16 with f32
// accumulators, and the hi/lo split of an f32 operand into two 16-bit
// terms.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"): lane = 4 g + t. The f32
// accumulator of a 16x8 tile holds (row g, cols 2t, 2t+1) in c[0..1] and
// (row g + 8, same cols) in c[2..3]. The A operand (16x16, row-major)
// holds (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t+8..),
// (row g + 8, k 2t+8..) in a[0..3] — so the accumulators of two
// neighbouring 16x8 tiles, packed pairwise, are the A operand of the next
// product (P V, P^T dO, dS^T Q) without a trip through shared memory.
//
// Why the split: rounding the probabilities P (and dS) to bf16 before the
// second product, as FlashAttention-2/3 do, puts a relative error of up
// to 2^-9 on every term, and the outputs miss the port's bf16 gate (rtol
// 2^-7 and atol 1e-3 rms against f32 math on the same inputs) by 6-23x.
// P = P_hi + P_lo with both terms bf16 carries 16 bits of P, and the two
// products go into one f32 accumulator: the outputs then sit at ~0.48 of
// the gate, as f32 math does (tests/test_torch_flash_tc_arith.py
// emulates both on the CPU).
#pragma once

#include "flash_common.cuh"

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (src is then
// not read but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, or zeros when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Lane offsets (row, column) into a 16x16 b16 tile for ldsm_x4:
// - a_*: the A operand of rows [0, 16) x k [0, 16) (non-transposed), and
//   with ldsm_x4_t the B operand of k [0, 16) x n [0, 16) stored k-major
//   (row = k), two n8 tiles in r[0..1] and r[2..3];
// - b_*: the B operand of n [0, 16) x k [0, 16) stored n-major
//   (non-transposed: row = n), two n8 tiles in r[0..1] and r[2..3].
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) << 3;
}

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const unsigned (&a)[4],
                                                   unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a packed pair of T (x in the low half).
template <typename T>
__device__ __forceinline__ unsigned pack2(float x, float y);

template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

template <>
__device__ __forceinline__ unsigned pack2<__half>(float x, float y) {
  __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) = hi + lo with hi the pair rounded to T and lo the remainder
// rounded to T; returns hi, writes lo.
template <typename T>
__device__ __forceinline__ unsigned split2(float x, float y, unsigned& lo);

template <>
__device__ __forceinline__ unsigned split2<__nv_bfloat16>(float x, float y,
                                                          unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  lo = pack2<__nv_bfloat16>(x - hf.x, y - hf.y);
  return *reinterpret_cast<unsigned*>(&h);
}

template <>
__device__ __forceinline__ unsigned split2<__half>(float x, float y,
                                                   unsigned& lo) {
  __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  lo = pack2<__half>(x - hf.x, y - hf.y);
  return *reinterpret_cast<unsigned*>(&h);
}

// The A operands (hi and lo) of one 16x16 tile from the f32 accumulators
// of its two 16x8 halves c0 (k 0..7) and c1 (k 8..15).
template <typename T>
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
  hi[0] = split2<T>(c0[0], c0[1], lo[0]);
  hi[1] = split2<T>(c0[2], c0[3], lo[1]);
  hi[2] = split2<T>(c1[0], c1[1], lo[2]);
  hi[3] = split2<T>(c1[2], c1[3], lo[3]);
}

// Start the copy of rows [r0, r0 + kRows) x columns [0, kD) of a
// [rows, D] slice (row stride rs elements, 16-byte aligned rows) into
// shared rows of kLd elements; rows >= nvalid and columns >= D are
// zero-filled. kNT threads take part; the caller commits the group.
template <typename T, int kRows, int kD, int kLd, int kNT>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long rs, int r0, int nvalid,
                                          int D, int tid) {
  constexpr int kC = kD / 8;  // 16-byte chunks per row
  constexpr int kN = kRows * kC;
#pragma unroll
  for (int it = 0; it < (kN + kNT - 1) / kNT; ++it) {
    const int i = tid + it * kNT;
    if (kN % kNT == 0 || i < kN) {
      const int r = i / kC;
      const int c = (i - r * kC) * 8;
      const bool ok = r0 + r < nvalid && c < D;
      cp_async16(dst + r * kLd + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  }
}

// The shapes the tc kernels take: 16-bit inputs, head dim a multiple of 8
// up to 256, and 16-byte aligned rows (every base address 16-byte aligned
// and every batch, sequence and head stride a multiple of 8 elements).
// Everything else goes to the f32 CUDA-core ("simt") kernels. The Python
// wrappers mirror this rule in `flash_route`.
__host__ inline bool route_ok(int dtype, int D, const void* const* ptrs,
                              int n_ptrs, const long long* strides,
                              int n_strides) {
  if (dtype != pt::kBF16 && dtype != pt::kF16) return false;
  if (D % 8 != 0 || D > 256) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// The compile-time head dim a tc kernel is instantiated at for D.
__host__ inline int tile_d(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

}  // namespace tc
