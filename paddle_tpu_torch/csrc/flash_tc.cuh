// Tensor-core building blocks of the flash kernels (flash_fwd.cu,
// flash_bwd.cu): 16-byte cp.async tile copies into padded shared memory,
// ldmatrix fragment loads, mma.sync.m16n8k16 with f32 accumulators and
// the hi/lo split of an f32 operand into two 16-bit terms ("tc" route);
// mma.sync.m16n8k8 on tf32 operands split big + small ("tf32x3" route);
// the route rule the C entries share, and the rule that picks the tc
// route's wgmma kernels; and (namespace `wg`, at the end) the pieces the
// three wgmma kernels share.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"): lane = 4 g + t. The f32
// accumulator of a 16x8 tile holds (row g, cols 2t, 2t+1) in c[0..1] and
// (row g + 8, same cols) in c[2..3]. The A operand (16x16, row-major)
// holds (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t+8..),
// (row g + 8, k 2t+8..) in a[0..3] — so the accumulators of two
// neighbouring 16x8 tiles, packed pairwise, are the A operand of the next
// product (P V, dS K, P^T dO, dS^T Q) without a trip through shared
// memory.
//
// Why the split: rounding the probabilities P (and dS) to bf16 before the
// second product, as FlashAttention-2/3 do, puts a relative error of up
// to 2^-9 on every term, and the outputs miss the port's bf16 gate (rtol
// 2^-7 and atol 1e-3 rms against f32 math on the same inputs) by 6-23x.
// P = P_hi + P_lo with both terms bf16 carries 16 bits of P, and the two
// products go into one f32 accumulator: the outputs then sit at ~0.48 of
// the gate, as f32 math does (tests/test_torch_flash_tc_arith.py
// emulates both on the CPU). fp16 has bf16's 16 bits but not f32's
// exponent range: a dS below 2^-14 loses bits in both terms and one above
// 65504 overflows, so the backward kernels take the tc route for bf16
// only; the forward's P lies in [0, 1] and keeps it for fp16 too.
//
// tf32x3 (f32 operands, CUTLASS's "fast f32"): TF32 keeps 11 significant
// bits, so one TF32 product misses the f32 gate (atol 1e-4 of max(1,
// max |ref|)) 3-5x in a CPU emulation. Each operand x is split into
// big = tf32(x) and small = tf32(x - big), and a b = big big + big small
// + small big into one f32 accumulator, which leaves ~2^-21 relative:
// f32-grade on the tensor cores for 3x the TF32 operations. The m16n8k8
// tf32 A operand holds (row g, k t), (row g + 8, k t), (row g, k t + 4),
// (row g + 8, k t + 4) and B (k t, n g), (k t + 4, n g). The kernels
// number the k dimension so that k t is column 2t and k t + 4 column
// 2t + 1 of each 8-wide chunk, in A and in B alike (a product sums over
// k, so any order common to both is the same product): an f32
// accumulator tile (cols 2t, 2t+1) is then an A operand as it stands,
// and a Q or K row fragment is one 8-byte load.
#pragma once

#include "flash_common.cuh"
#include "grouped_gemm_tc.cuh"

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the cp.async copies of common.cuh
using pt::cp_async16;
using pt::cp_async4;
using pt::cp_async_commit;
using pt::cp_async_wait;

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
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kC = kD / kE;         // chunks per row
  constexpr int kN = kRows * kC;
#pragma unroll
  for (int it = 0; it < (kN + kNT - 1) / kNT; ++it) {
    const int i = tid + it * kNT;
    if (kN % kNT == 0 || i < kN) {
      const int r = i / kC;
      const int c = (i - r * kC) * kE;
      const bool ok = r0 + r < nvalid && c < D;
      cp_async16(dst + r * kLd + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  }
}

// s[mi][n] = A B^T over depth kD for this warp's kM m16 row tiles of A
// (rows r0 + 16 mi.., row stride kLdA) against the kNT n8 row tiles of B
// (rows 0.., row stride kLdB), both row-major 16-bit in shared memory:
// S = Q K^T in the forward and dQ, dP = dO V^T in dQ.
template <typename T, int kM, int kNT, int kD, int kLdA, int kLdB>
__device__ __forceinline__ void warp_abt(const T* a_s, const T* b_s, int r0,
                                         int lane,
                                         float (&s)[kM][kNT][4]) {
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    unsigned af[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
      ldsm_x4(af[mi], a_s + (r0 + 16 * mi + a_row(lane)) * kLdA + kk * 16 +
                          a_col(lane));
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, b_s + (np * 16 + b_row(lane)) * kLdB + kk * 16 +
                      b_col(lane));
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        mma<T>(s[mi][2 * np], af[mi], bf[0], bf[1]);
        mma<T>(s[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// acc[mi][n] += P B, P given as f32 accumulators (kM m16 row tiles x kKT
// n8 tiles of the k dimension) and split into hi + lo terms of T, B
// k-major in shared memory (row = k, stride kLdB), output columns
// [c0, c0 + 8 kNT): O += P V in the forward, dQ += dS K in dQ.
template <typename T, int kM, int kKT, int kNT, int kLdB>
__device__ __forceinline__ void warp_pb_split(const float (&p)[kM][kKT][4],
                                              const T* b_s, int c0,
                                              int lane,
                                              float (&acc)[kM][kNT][4]) {
#pragma unroll
  for (int kk = 0; kk < kKT / 2; ++kk) {
    unsigned ph[kM][4], pl[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
      split_a<T>(p[mi][2 * kk], p[mi][2 * kk + 1], ph[mi], pl[mi]);
#pragma unroll
    for (int dn = 0; dn < kNT / 2; ++dn) {
      unsigned bf[4];
      ldsm_x4_t(bf, b_s + (kk * 16 + a_row(lane)) * kLdB + c0 + dn * 16 +
                        a_col(lane));
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        mma<T>(acc[mi][2 * dn], ph[mi], bf[0], bf[1]);
        mma<T>(acc[mi][2 * dn], pl[mi], bf[0], bf[1]);
        mma<T>(acc[mi][2 * dn + 1], ph[mi], bf[2], bf[3]);
        mma<T>(acc[mi][2 * dn + 1], pl[mi], bf[2], bf[3]);
      }
    }
  }
}

// ---------------------------------------------------------------- tf32x3

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, both tf32 (round to nearest, ties away); returns big.
__device__ __forceinline__ unsigned split_tf32(float x, unsigned& small) {
  unsigned big, sm;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(sm) : "f"(x - __uint_as_float(big)));
  small = sm;
  return big;
}

// c += a b on split operands: the two cross terms, then big big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ab)[4],
                                           const unsigned (&as)[4],
                                           unsigned bb0, unsigned bb1,
                                           unsigned bs0, unsigned bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// warp_abt on f32 operands by 3xTF32: a row's 8-wide k chunk is read as
// one float2 per lane (k t = column 2t, k t + 4 = column 2t + 1). Rows of
// stride kLdA, kLdB = 8 (mod 32) words keep those reads free of bank
// conflicts.
template <int kM, int kNT, int kD, int kLdA, int kLdB>
__device__ __forceinline__ void warp_abt_tf32x3(const float* a_s,
                                                const float* b_s, int r0,
                                                int lane,
                                                float (&s)[kM][kNT][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    unsigned ab[kM][4], as[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      const float* ar = a_s + (r0 + 16 * mi + g) * kLdA + kk * 8 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(ar);
      const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * kLdA);
      ab[mi][0] = split_tf32(x0.x, as[mi][0]);
      ab[mi][1] = split_tf32(x1.x, as[mi][1]);
      ab[mi][2] = split_tf32(x0.y, as[mi][2]);
      ab[mi][3] = split_tf32(x1.y, as[mi][3]);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(
          b_s + (n * 8 + g) * kLdB + kk * 8 + 2 * t);
      unsigned bs0, bs1;
      const unsigned bb0 = split_tf32(y.x, bs0);
      const unsigned bb1 = split_tf32(y.y, bs1);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
        mma_3xtf32(s[mi][n], ab[mi], as[mi], bb0, bb1, bs0, bs1);
    }
  }
}

// acc += P B by 3xTF32, P given as f32 accumulators (kM x kKT tiles) —
// an accumulator tile is the A operand of its 8-wide k chunk as it stands
// (k t = key 2t, k t + 4 = key 2t + 1) — and B f32 k-major in shared
// memory (row = k, stride kLdB = 4 (mod 32) words: the reads of rows 2t
// and 2t + 1 are free of bank conflicts), all kNT n8 tiles of columns.
template <int kM, int kKT, int kNT, int kLdB>
__device__ __forceinline__ void warp_pb_tf32x3(const float (&p)[kM][kKT][4],
                                               const float* b_s, int lane,
                                               float (&acc)[kM][kNT][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    unsigned ab[kM][4], as[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      ab[mi][0] = split_tf32(p[mi][kk][0], as[mi][0]);
      ab[mi][1] = split_tf32(p[mi][kk][2], as[mi][1]);
      ab[mi][2] = split_tf32(p[mi][kk][1], as[mi][2]);
      ab[mi][3] = split_tf32(p[mi][kk][3], as[mi][3]);
    }
    const float* br = b_s + (kk * 8 + 2 * t) * kLdB + g;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      unsigned bs0, bs1;
      const unsigned bb0 = split_tf32(br[n * 8], bs0);
      const unsigned bb1 = split_tf32(br[kLdB + n * 8], bs1);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
        mma_3xtf32(acc[mi][n], ab[mi], as[mi], bb0, bb1, bs0, bs1);
    }
  }
}

// The route rule of the three flash kernels, shared by the C entries; the
// Python wrappers mirror it in `flash_route`. All routes need a head dim
// that is a multiple of 8 up to 256 and every base address 16-byte
// aligned; then
// - kTc (mma.sync on 16-bit operands): bf16 for every kernel, fp16 for
//   the forward only (its split operand P lies in [0, 1]; the backward's
//   dS does not fit fp16's range, see above), with every batch, sequence
//   and head stride a multiple of 8 elements;
// - kTf32x3: f32 for the forward, with strides a multiple of 4 elements;
// - kSimt (f32 FMA on the CUDA cores): everything else — f32 backward,
//   fp16 backward, odd head dims, unaligned rows.
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };
enum Route { kSimt = 0, kTc = 1, kTf32x3 = 2 };

__host__ inline Route route(Kernel kernel, int dtype, int D,
                            const void* const* ptrs, int n_ptrs,
                            const long long* strides, int n_strides) {
  if (D % 8 != 0 || D > 256) return kSimt;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return kSimt;
  const bool tc = dtype == pt::kBF16 || (dtype == pt::kF16 && kernel == kFwd);
  const bool tf32 = dtype == pt::kF32 && kernel == kFwd;
  if (!tc && !tf32) return kSimt;
  const int align = tc ? 8 : 4;  // elements in 16 bytes
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % align != 0) return kSimt;
  return tc ? kTc : kTf32x3;
}

// The compile-time head dim a tc or tf32x3 kernel is instantiated at.
__host__ inline int tile_d(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Which kernel a launch on the tc route runs, one rule for the forward,
// dQ and dK/dV (mirrored by flash_attention.flash_tc_kernel): the wgmma
// kernels at tile head dims up to 128 (flash_fwd.cu
// `flash_fwd_wgmma_kernel`, flash_bwd.cu `flash_bwd_dq_wgmma_kernel` and
// `flash_bwd_dkv_wgmma_kernel`), the mma.sync kernels at 256.
__host__ inline bool wgmma(int D) { return tile_d(D) <= 128; }

// The kernel a C entry reports it ran (its last argument; mirrored by
// flash_attention._LAUNCHED): the backward entries report kSimt, kMma or
// kWgmma, the forward any of the four.
enum Launched {
  kLaunchedSimt = 0,
  kLaunchedTf32x3 = 1,
  kLaunchedMma = 2,
  kLaunchedWgmma = 3
};

}  // namespace tc

// ------------------------------------------- the wgmma kernels' pieces --
//
// Shared by the tc route's wgmma kernels (flash_fwd.cu
// `flash_fwd_wgmma_kernel`, flash_bwd.cu `flash_bwd_dq_wgmma_kernel` and
// `flash_bwd_dkv_wgmma_kernel`): each is a producer warp that loads tiles
// by TMA through 4-D tensor maps (`make_map_bshd`) into a ring of stages
// and alone decides the walk, and consumer warpgroups that run wgmma on
// them (csrc/grouped_gemm_tc.cuh holds the products, barriers and TMA
// copies). A tile of rows x D is D / 64 slabs of rows x 128 bytes, 128B
// swizzle; TMA writes zeros past D and past the rows of a tensor.
//
// Products on those slabs: `ss` (A and B both K-major: S = Q K^T, dP =
// dO V^T, S^T = K Q^T, dP^T = V dO^T) and `rs_split` (A from registers,
// two 16-bit terms of an f32 operand, B read MN-major through the
// descriptor's transpose bit: O += P V, dQ += dS K, dV += P^T dO, dK +=
// dS^T Q). The f32 accumulators of an m64nNk16 product hold, in thread t
// of its warpgroup, row 16 (t / 32) + g + 8 (i % 4 / 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2 of accumulator i (g = t % 32 / 4): for
// each warp's 16 rows that is the mma.m16n8k16 A fragment's layout, so
// `split` turns them into register-A fragments in place
// (tests/test_torch_flash_tc_arith.py emulates both maps).

namespace wg {

// keeps the compiler from moving A fragments' reads across the
// asynchronous products that read them
template <int N>
__device__ __forceinline__ void fence(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// 2^x on the SFU, flushing results below 2^-126 to 0 (a probability that
// small is below every sum's rounding)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc = A B^T over depth kD: A's 64 rows and B's N rows K-major in
// 64-column slabs a_slab and b_slab bytes apart (from a and b); a k16
// step is 32 bytes along the swizzled 128-byte rows, 8-row groups 1 KB
// apart. One wgmma group.
template <typename T, int N, int kD>
__device__ __forceinline__ void ss(float (&acc)[N / 2], uint32_t a,
                                   uint32_t a_slab, uint32_t b,
                                   uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ggtc::mma_ss<T, N, 0, 0>(
        acc, ggtc::desc(a + (kk / 4) * a_slab + (kk % 4) * 32, 16, 1024),
        ggtc::desc(b + (kk / 4) * b_slab + (kk % 4) * 32, 16, 1024),
        kk > 0);
  ggtc::wgmma_commit();
}

// acc += hi B + lo B: A given as the hi and lo register fragments of its
// kK / 16 k16 chunks, B [kK rows][N] read MN-major from b (a k16 chunk is
// 16 rows of 128 bytes; the 64-column slabs `slab` bytes apart, the
// leading byte offset). One wgmma group.
template <typename T, int N, int kK>
__device__ __forceinline__ void rs_split(float (&acc)[N / 2],
                                         const unsigned (&hi)[kK / 16][4],
                                         const unsigned (&lo)[kK / 16][4],
                                         uint32_t b, uint32_t slab) {
#pragma unroll
  for (int c = 0; c < kK / 16; ++c) {
    const uint64_t db = ggtc::desc(b + c * 16 * 128, slab, 1024);
    ggtc::mma_rs<T, N, 1>(acc, hi[c], db, true);
    ggtc::mma_rs<T, N, 1>(acc, lo[c], db, true);
  }
  ggtc::wgmma_commit();
}

// The f32 accumulators x of an m64nNk16 product -> the A fragments of its
// k16 chunks (columns 16 c .. 16 c + 15), split into hi + lo 16-bit terms
// (tc::split2): accumulators 8 c + 2 r and 8 c + 2 r + 1 are register r of
// chunk c.
template <typename T, int N>
__device__ __forceinline__ void split(const float (&x)[N / 2],
                                      unsigned (&hi)[N / 16][4],
                                      unsigned (&lo)[N / 16][4]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hi[c][r] = tc::split2<T>(x[8 * c + 2 * r], x[8 * c + 2 * r + 1],
                               lo[c][r]);
}

// Moves registers between the warpgroups of a block (sm_90a; every warp
// of the warpgroup executes it): a producer warpgroup gives registers up,
// consumer warpgroups take them (N a multiple of 8 in [24, 256]).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// *p read by lane 0 and given to every lane: the same value in every lane
// for the compiler, so a product behind a branch on it is not on a path
// ptxas thinks divergent (which would serialize it, C7518)
__device__ __forceinline__ int uniform(const int* p) {
  return __shfl_sync(0xffffffffu, *p, 0);
}

// The producer warp or a consumer thread (the first kConsumers threads),
// the same in every lane for the compiler.
template <int kConsumers>
__device__ __forceinline__ bool is_producer() {
  return __shfl_sync(0xffffffffu, int(threadIdx.x) / kConsumers, 0) != 0;
}

// the first key tile at or after kt (tiles of kBN keys, up to kt_hi) that
// the bands of `seb` do not cover whole for query rows [q0, q_end) (the
// whole warp computes it; every lane gets the same answer)
template <int kBN>
__device__ __forceinline__ int next_k_tile(int kt, int kt_hi, const int* seb,
                                           long long s4, int Sk, int q0,
                                           int q_end, int lane) {
  if (seb != nullptr)
    while (kt < kt_hi &&
           fl::tile_full(
               fl::warp_band_extremes<kBN>(seb, s4, kt * kBN, Sk, lane), q0,
               q_end))
      ++kt;
  return kt;
}

// The producer warp's walk over the key tiles a block of query rows
// [q0, q_end) visits (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel):
// from kt to kt_hi, minus the tiles one flashmask band of `seb` covers
// whole. For each tile, in order, the key columns' bands and its index go
// into its stage's info (C::kInfo ints: bands [4][kBN], then the index),
// and TMA loads its K and V slabs (kv head hk, batch b; C::kStageBytes on
// the stage's full barrier, which every lane arrives on); a stage whose
// index is -1 ends the walk. Only the producer decides the walk, and the
// consumers follow the stages (two sides that disagreed would deadlock
// on a barrier).
template <class C, class Sm>
__device__ __forceinline__ void produce_kv(const Sm& sm, const CUtensorMap* k,
                                           const CUtensorMap* v, int kt,
                                           int kt_hi, const int* seb,
                                           long long s4, int Sk, int q0,
                                           int q_end, int hk, int b,
                                           int lane) {
  constexpr int S = C::kStages, kBN = C::kBN, kInfo = C::kInfo;
  kt = next_k_tile<kBN>(kt, kt_hi, seb, s4, Sk, q0, q_end, lane);
  for (int j = 0;; ++j) {
    const int s = j % S;
    if (j >= S) ggtc::mbar_wait(sm.empty(s), ((j / S) + 1) & 1);
    int* info = sm.info + s * kInfo;
    if (kt >= kt_hi) {  // the end of the walk
      if (lane == 0) info[4 * kBN] = -1;
      ggtc::mbar_arrive(sm.full(s));
      return;
    }
    const int k0 = kt * kBN;
    if (seb != nullptr)
#pragma unroll 1
      for (int i = 0; i < kBN / 32; ++i) {
        const int c = lane + 32 * i;
        const fl::Bands bj = fl::load_bands(seb, s4, k0 + c, Sk);
        info[c] = bj.lts;
        info[kBN + c] = bj.lte;
        info[2 * kBN + c] = bj.uts;
        info[3 * kBN + c] = bj.ute;
      }
    if (lane == 0) {
      info[4 * kBN] = kt;
      ggtc::mbar_expect_tx(sm.full(s), C::kStageBytes);
#pragma unroll
      for (int c = 0; c < C::kSlabs; ++c) {
        ggtc::tma_load4(sm.k(s, c), k, sm.full(s), 64 * c, hk, k0, b);
        ggtc::tma_load4(sm.v(s, c), v, sm.full(s), 64 * c, hk, k0, b);
      }
    } else {
      ggtc::mbar_arrive(sm.full(s));
    }
    kt = next_k_tile<kBN>(kt + 1, kt_hi, seb, s4, Sk, q0, q_end, lane);
  }
}

// Lays a block's dynamic shared memory out from a 1024-byte aligned base
// (the 128B swizzle's unit): returns the base's shared address.
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  const uint32_t raw = ggtc::smem_u32(smem);
  return (raw + 1023) & ~1023u;
}

// Initialises a block's barriers: each of the kStages stages' full barrier
// (the producer warp's 32 lanes arrive) and empty barrier (each of the
// kConsumers / 32 consumer warps), then the kernel's own ones (`more()`:
// the operands loaded once, a second ring). Every thread of the block must
// call it.
template <int kStages, int kConsumers, class Sm, typename More>
__device__ __forceinline__ void init_barriers(const Sm& sm, More more) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ggtc::mbar_init(sm.full(s), 32);
      ggtc::mbar_init(sm.empty(s), kConsumers / 32);
    }
    more();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A map over a [B, rows, heads, D] tensor of T (bf16 or fp16; dtype) given
// by element strides (batch sb, row ss, head sh; D contiguous), as 4-D
// (D, heads, rows, B): boxes of 64 columns x box_rows rows of one head and
// batch. False if libcuda refuses it.
inline bool make_map_bshd(CUtensorMap* m, const void* p, int dtype, int D,
                          int heads, int rows, int B, long long sh,
                          long long ss, long long sb, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(rows > 0 ? rows : 1),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  return ggtc::make_map_nd(m, p, dtype, 4, dims, strides, 2, box_rows);
}

}  // namespace wg
