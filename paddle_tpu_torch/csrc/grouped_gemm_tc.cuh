// The Hopper mainloop of the grouped expert-FFN kernels' tensor-core
// route ("tc": bf16 and fp16 with h and dff multiples of 8;
// grouped_ffn_fwd.cu, grouped_ffn_bwd.cu), and the device and host
// helpers (barriers, TMA, descriptors, tensor maps) of the flash forward's
// wgmma kernel (flash_fwd.cu). One block computes a 128 x 128
// tile of C = A B for one expert, in f32 registers, and hands them to the
// kernel's epilogue, as gg::mainloop does for the "simt" route.
//
// - Products: wgmma.mma_async m64n128k16, bf16 x bf16 (or fp16 x fp16)
//   with f32 accumulators, both operands in shared memory. That is the
//   reference's own arithmetic: it rounds every left operand to T before
//   its product (paddle_tpu/kernels/moe.py:271, :416, :445) and every
//   right operand is a T weight; only the order of summation differs.
// - 288 threads: two consumer warpgroups (threads 0-255; warpgroup w owns
//   rows 64 w .. 64 w + 63 of the block's tile) and one producer warp
//   (256-287) whose lane 0 issues the TMA loads.
// - K advances 64 at a time (128-byte rows, the 128B swizzle). Stages sit
//   in a ring of S (a kernel's choice) in dynamic shared memory, each with
//   a full barrier (the producer's expect_tx, completed by TMA) and an
//   empty one (one arrival per consumer warp, once its wgmma group on the
//   stage has retired); the producer keeps up to S tiles in flight.
// - Operands come through 3-D tensor maps (contiguous dim, rows, expert),
//   encoded on the host at each launch with libcuda's
//   cuTensorMapEncodeTiled, obtained through cudaGetDriverEntryPoint (no
//   -lcuda). A is K-major (box {64, 128}: the forward's and dx's rows) or
//   MN-major (two boxes {64, 64}: x^T or ha^T of the dw products, read as
//   stored); B is K-major (box {64, 128}: a weight read transposed) or
//   MN-major (two boxes {64, 64}: a weight or a row buffer read as
//   stored). The descriptors' transpose bits pick the majorness, so no
//   transposed copy is made.
// - Ragged edges: TMA fills what lies past a tensor's bounds (rows past C,
//   columns past h or dff, the K tail) with zeros. Rows past counts[e]
//   but inside C are read as they are: the kernels' scratch rows there may
//   hold anything, NaN included. Where the product's depth runs over
//   columns (forward, dx), each product is independent by row, such a row
//   reaches only its own output row, and every epilogue drops it by a
//   select (never by a multiply with a mask). Where the depth runs over
//   rows (dw: both operands MN-major), a dead row would enter every sum
//   (0 * NaN = NaN), so the consumers zero the dead rows of the last
//   stage in both tiles before its products (`zero_k_rows`).
//
// Accumulator layout (the wgmma D fragment): thread t of a warpgroup, warp
// w = t / 32, lane l, holds d[4 j + q] at row 16 w + l / 4 + 8 (q >> 1),
// column 8 j + 2 (l % 4) + (q & 1), for j in [0, 16), q in [0, 4).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the types only)

#include <type_traits>

#include "grouped_gemm.cuh"

namespace gg {

enum Route { kSimt = 0, kTc = 1, kRows = 2 };

// the largest capacity the forward's "rows" route takes
constexpr int kRowsMaxC = 16;

// The route of one launch of the forward, the dx or the dw entry
// (mirrored by moe.grouped_ffn_route): the tensor cores for bf16 and fp16
// when every row of x, g, the weights and the scratch is a multiple of 16
// bytes (TMA's rule for strides); for the forward (`capacity` > 0, the
// buffer's C) of f32 with C <= kRowsMaxC and 16-byte rows, "rows", the
// weight-streaming passes of grouped_ffn_fwd.cu; the CUDA-core tiles for
// the rest (f32, odd widths). dx and dw pass no capacity.
__host__ inline Route route(int dtype, int h, int dff, int capacity = 0) {
  if ((dtype == pt::kBF16 || dtype == pt::kF16) && h % 8 == 0 &&
      dff % 8 == 0)
    return kTc;
  if (dtype == pt::kF32 && capacity > 0 && capacity <= kRowsMaxC &&
      h % 4 == 0 && dff % 4 == 0)
    return kRows;
  return kSimt;
}

}  // namespace gg

namespace ggtc {

constexpr int kBM = 128;                   // rows of a block's tile
constexpr int kBN = 128;                   // columns of a block's tile
constexpr int kBK = 64;                    // depth of a stage
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kTileBytes = kBM * kBK * 2;  // an A or a B tile of a stage
constexpr int kHalfTile = kTileBytes / 2;  // 64 rows (or columns) x kBK
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAcc = kBN / 2;              // f32 accumulators a thread
// [2 warpgroups][4 warps][kBN columns] f32: the column sums' scratch
constexpr int kRedBytes = 2 * 4 * kBN * 4;

// The tensor maps of a launch: up to two products, A and B each.
struct Maps {
  CUtensorMap a0, b0, a1, b1;
};

// The ring of a pass: S stages of an A tile (128 x 64) and a B tile
// (64 x 128) in dynamic shared memory, each 1024-byte aligned as the 128B
// swizzle needs, then S full and S empty barriers and the epilogue's
// column-sum scratch; B blocks an SM.
template <int S, int B>
struct Ring {
  static constexpr int kStages = S;
  static constexpr int kBlocks = B;
  static constexpr int kSmemBytes =
      1024 + S * kStageBytes + 2 * S * 8 + kRedBytes;
  uint32_t base;
  float* red;
  __device__ __forceinline__ uint32_t a(int s) const {
    return base + s * kStageBytes;
  }
  __device__ __forceinline__ uint32_t b(int s) const {
    return a(s) + kTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + S * kStageBytes + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full(S) + 8 * s;
  }
};

// -- device side ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbarrier wait that traps instead of hanging: a producer and consumers
// that disagree would otherwise wait forever (about 10 s of %globaltimer)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// box of map at (c0, c1, c2) (innermost first) -> shared dst, completing
// its bytes on barrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the 4-D box of map at (c0, c1, c2, c3) -> shared dst, as tma_load
__device__ __forceinline__ void tma_load4(uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma products m64nNk16 (N = 32, 64 or 128) with f32 accumulators
// d[N / 2]: operand lists and their register numbers
#define GGTC_D8(b)                                                      \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define GGTC_D16 GGTC_D8(0), GGTC_D8(8)
#define GGTC_D32 GGTC_D16, GGTC_D8(16), GGTC_D8(24)
#define GGTC_D64 GGTC_D32, GGTC_D8(32), GGTC_D8(40), GGTC_D8(48), GGTC_D8(56)
#define GGTC_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, " \
                "%13, %14, %15"
#define GGTC_R16 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
                 "%27, %28, %29, %30, %31"
#define GGTC_R32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
                 "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
                 "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define GGTC_N32 "32", "{" GGTC_R0 "}", GGTC_D16
#define GGTC_N64 "64", "{" GGTC_R0 ", " GGTC_R16 "}", GGTC_D32
#define GGTC_N128 \
  "128", "{" GGTC_R0 ", " GGTC_R16 ", " GGTC_R32 "}", GGTC_D64
// A and B from shared memory (descriptors da, db): after the n
// accumulators come da, db, the accumulate flag and the transpose bits
// (the accumulators' operand list is the variadic tail)
#define GGTC_SS(ty, pred, args, n, regs, ...)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " pred ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" n "k16.f32." ty "." ty \
               " " regs ", " args ";\n}\n"                                \
               : __VA_ARGS__                                              \
               : "l"(da), "l"(db), "r"(int(accumulate)), "n"(kTransA),    \
                 "n"(kTransB))
// A from registers (a[4]), B from shared memory: after the n accumulators
// come a, db, the accumulate flag and B's transpose bit
#define GGTC_RS(ty, pred, args, n, regs, ...)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " pred ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" n "k16.f32." ty "." ty \
               " " regs ", " args ";\n}\n"                                \
               : __VA_ARGS__                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(int(accumulate)), "n"(kTransB))
#define GGTC_TY(T, M, ...)                            \
  if constexpr (std::is_same<T, __half>::value)       \
    M("f16", __VA_ARGS__);                            \
  else                                                \
    M("bf16", __VA_ARGS__)

// d = A B + (accumulate ? d : 0) for T = bf16 or fp16: A 64 x 16
// (descriptor da; kTransA: MN-major), B 16 x N (descriptor db; kTransB:
// MN-major)
template <typename T, int N, int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, bool accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma n");
  if constexpr (N == 32) {
    GGTC_TY(T, GGTC_SS, "%18", "%16, %17, p, 1, 1, %19, %20", GGTC_N32);
  } else if constexpr (N == 64) {
    GGTC_TY(T, GGTC_SS, "%34", "%32, %33, p, 1, 1, %35, %36", GGTC_N64);
  } else {
    GGTC_TY(T, GGTC_SS, "%66", "%64, %65, p, 1, 1, %67, %68", GGTC_N128);
  }
}

// the same with A 64 x 16 from registers: a[4], the fragment of a thread
// (the layout of an accumulator's 16 columns)
template <typename T, int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const unsigned (&a)[4], uint64_t db,
                                       bool accumulate) {
  static_assert(N == 64 || N == 128, "wgmma n");
  if constexpr (N == 64) {
    GGTC_TY(T, GGTC_RS, "%37", "{%32, %33, %34, %35}, %36, p, 1, 1, %38",
            GGTC_N64);
  } else {
    GGTC_TY(T, GGTC_RS, "%69", "{%64, %65, %66, %67}, %68, p, 1, 1, %70",
            GGTC_N128);
  }
}

#undef GGTC_TY
#undef GGTC_RS
#undef GGTC_SS
#undef GGTC_N128
#undef GGTC_N64
#undef GGTC_N32
#undef GGTC_R32
#undef GGTC_R16
#undef GGTC_R0
#undef GGTC_D64
#undef GGTC_D32
#undef GGTC_D16
#undef GGTC_D8

// One product of a block: A read K-major ([E, M, K]) or MN-major
// ([E, K, M]), B read K-major ([E, N, K]) or MN-major ([E, K, N]), over
// k_tiles stages.
struct Product {
  const CUtensorMap* a;
  const CUtensorMap* b;
  bool b_mn;
  int k_tiles;
  bool a_mn = false;
};

// Lays the ring out over the kernel's dynamic shared memory and
// initialises its barriers. Every thread of the block must call it (it
// synchronizes).
template <typename R>
__device__ __forceinline__ R make_ring(uint8_t* smem) {
  const uint32_t raw = smem_u32(smem);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  R r{raw + pad, reinterpret_cast<float*>(smem + pad +
                                          R::kStages * kStageBytes +
                                          2 * R::kStages * 8)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer (one thread): the stages of products p[0..np) in order,
// for expert e, rows m0.., columns n0.. of the block.
template <typename R>
__device__ __forceinline__ void produce(const R& r, const Product* p, int np,
                                        int e, int m0, int n0) {
  constexpr int S = R::kStages;
  int j = 0;
  for (int q = 0; q < np; ++q)
    for (int kt = 0; kt < p[q].k_tiles; ++kt, ++j) {
      const int s = j % S;
      if (j >= S) mbar_wait(r.empty(s), ((j / S) + 1) & 1);
      const uint32_t full = r.full(s);
      mbar_expect_tx(full, kStageBytes);
      if (p[q].a_mn) {
#pragma unroll
        for (int c = 0; c < kBM / 64; ++c)
          tma_load(r.a(s) + c * kHalfTile, p[q].a, full, m0 + 64 * c,
                   kt * kBK, e);
      } else {
        tma_load(r.a(s), p[q].a, full, kt * kBK, m0, e);
      }
      if (p[q].b_mn) {
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c)
          tma_load(r.b(s) + c * kHalfTile, p[q].b, full, n0 + 64 * c,
                   kt * kBK, e);
      } else {
        tma_load(r.b(s), p[q].b, full, kt * kBK, n0, e);
      }
    }
}

// The two consumer warpgroups only (the producer warp may have exited).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Zeroes K rows [live, kBK) of a stage whose A and B tiles are both
// MN-major (four 64 x 64 slabs, one 128-byte line per K row; the 128B
// swizzle only permutes the 16-byte chunks inside a line), then makes the
// writes visible to the tensor cores' (async) proxy and waits for both
// consumer warpgroups, which share the B tile.
template <typename R>
__device__ __forceinline__ void zero_k_rows(const R& r, int s, int live) {
  const int per_slab = (kBK - live) * 8;  // 16-byte chunks a slab
  for (int i = threadIdx.x; i < 4 * per_slab; i += kConsumers) {
    const int slab = i / per_slab;
    const uint32_t at = r.a(s) + slab * kHalfTile + live * 128 +
                        (i - slab * per_slab) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at),
                 "r"(0)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
}

// A consumer warpgroup: acc = its 64 rows of one product, stages j.. of
// the ring (j advances); the first k16 product overwrites acc (scale-d 0),
// so no other instruction writes an accumulator while products are in
// flight. Each stage's four k16 products form one wgmma group; once the
// next group is issued the previous one has retired and its stage is
// released. kAMn: A MN-major; then B is too, the depth runs over rows,
// and `tail` (1..63, or 0 for none) rows of the last stage are live: the
// rest are zeroed before its products (`zero_k_rows`).
template <typename T, bool kBMn, bool kAMn = false, typename R>
__device__ __forceinline__ void consume(float (&acc)[kAcc], const R& r,
                                        int& j, int k_tiles, int tail = 0) {
  static_assert(!kAMn || kBMn, "a depth over rows reads B MN-major too");
  constexpr int S = R::kStages;
  const int wg = threadIdx.x / 128;
  const bool lead = threadIdx.x % 32 == 0;
  for (int kt = 0; kt < k_tiles; ++kt, ++j) {
    const int s = j % S;
    mbar_wait(r.full(s), (j / S) & 1);
    if constexpr (kAMn)
      if (tail > 0 && kt == k_tiles - 1) zero_k_rows(r, s, tail);
    const uint32_t a = r.a(s) + wg * kHalfTile;
    const uint32_t b = r.b(s);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // K-major: a k16 step is 32 bytes along the swizzled 128-byte row;
      // MN-major: 16 rows of 128 bytes, the 64-column slabs 8 KB apart
      // (leading byte offset), 8-row groups 1 KB apart (stride); an
      // MN-major A is one slab (64 rows of the warpgroup)
      const uint64_t da = kAMn ? desc(a + kk * 16 * 128, kHalfTile, 1024)
                               : desc(a + kk * 32, 16, 1024);
      const uint64_t db = kBMn ? desc(b + kk * 16 * 128, kHalfTile, 1024)
                               : desc(b + kk * 32, 16, 1024);
      mma_ss<T, kBN, kAMn ? 1 : 0, kBMn ? 1 : 0>(acc, da, db,
                                              kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (j > 0 && lead) mbar_arrive(r.empty((j - 1) % S));
  }
}

// After the last consume: every product of the warpgroup has landed.
__device__ __forceinline__ void drain(float (&acc)[kAcc]) {
  wgmma_wait<0>();
  fence_acc(acc);
}

// Two adjacent T values from f32, one 4-byte store.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  T v[2] = {pt::from_f32<T>(a), pt::from_f32<T>(b)};
  *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(v);
}

// Sum over the 16 rows a warp holds of a column value v (the lanes with
// equal lane % 4): the result is in every lane.
__device__ __forceinline__ float warp_col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Sum over the 4 lanes of a row (lane % 4) of a row value v.
__device__ __forceinline__ float quad_row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Column sums of a warpgroup's 64 rows from each thread's per-column
// partials cs[2 j + c] (column 8 j + 2 (lane % 4) + c, over its two rows),
// in a fixed order (rows within a warp by shuffles, then warps 0-3), into
// out[col] for col < ncols if write. Both consumer warpgroups must call
// it.
template <typename R>
__device__ __forceinline__ void col_sums(const R& r, float (&cs)[kBN / 4],
                                         float* out, int ncols, bool write) {
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  float* red = r.red + (wg * 4 + warp) * kBN;
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) {
    const float v = warp_col_sum(cs[i]);
    if (lane < 4) red[8 * (i / 2) + 2 * lane + i % 2] = v;
  }
  consumers_sync();
  const int c = threadIdx.x % 128;  // kBN columns: one a thread
  if (write && c < ncols) {
    const float* w = r.red + wg * 4 * kBN;
    out[c] = ((w[c] + w[kBN + c]) + w[2 * kBN + c]) + w[3 * kBN + c];
  }
}

// -- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (null if
// it cannot be had)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of `rank` dims (innermost first, the first contiguous; byte
// strides of dims 1..rank-1) over T (dtype bf16 or fp16): boxes of 64
// elements of dim 0 x box_rows of dim `row_dim`, 1 of every other dim,
// 128B swizzle, zeros past the bounds. False if libcuda refuses it (e.g.
// an address or a stride not a multiple of 16 bytes).
inline bool make_map_nd(CUtensorMap* map, const void* base, int dtype,
                        int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, int row_dim,
                        int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t box[4] = {64, 1, 1, 1};
  box[row_dim] = cuuint32_t(box_rows);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            dtype == pt::kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            cuuint32_t(rank), const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over [E, rows, cols] of T (cols contiguous): boxes of 64 columns x
// box_rows rows of one expert.
inline bool make_map(CUtensorMap* map, const void* base, int dtype, int cols,
                     int rows, int E, int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(E)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(cols) * rows * 2};
  return make_map_nd(map, base, dtype, 3, dims, strides, 1, box_rows);
}

// Box rows of a K-major A, a K-major B and an MN-major B (or A).
constexpr int kBoxA = kBM;
constexpr int kBoxBK = kBN;
constexpr int kBoxBMn = kBK;

// Lets kernel take the dynamic shared memory of its ring R.
template <typename R, typename Kernel>
inline int allow_smem(Kernel kernel) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes));
}

}  // namespace ggtc
