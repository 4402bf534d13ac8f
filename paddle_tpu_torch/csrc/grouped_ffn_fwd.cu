// Grouped expert FFN forward for Hopper.
//
// Replaces the Pallas kernel `_grouped_ffn_fwd_kernel` launched by
// `_grouped_ffn_fwd_pallas` (paddle_tpu/kernels/moe.py:181, :296). Same
// function over the sorted-by-expert capacity buffer x [E, C, h]:
//
//   out[e, c] = (round_T(act(x[e, c] w1[e] + b1[e])) w2[e] + b2[e]) ws[e, c]
//
// with f32 accumulation, bias and combine weight applied in f32, the
// result rounded once to T, and rows at or past counts[e] (read on the
// device) zero. No block reads a dead row of x or issues a weight read
// for a tile of dead rows.
//
// The Pallas kernel keeps one [256, h] f32 accumulator and two
// double-buffered [h, 512] weight tiles in VMEM (megabytes), which an
// H100 block's 227 KB of shared memory (data sheet) cannot hold. The
// port splits the two products into two passes, blocks over (expert, row
// tile, column tile), launched one after the other on the caller's
// stream:
//
// - up:   ha[e, rows, f-tile] = round_T(act(x w1[e][:, f-tile] + b1));
// - down: out[e, rows, h-tile] = (ha w2[e][:, h-tile] + b2) ws, masked.
//
// ha of the live rows goes through device memory in T ([E, C, dff], the
// wrapper's scratch; rows past counts[e] are neither written nor read):
// the TPU kernel's DMA pipeline, next-live-expert look-ahead and clamped
// index maps are not carried — a block of dead rows writes zeros (down)
// or nothing (up) and exits.
//
// What bounds it on an H100: at the training shape (8 experts, ~4,096
// live rows each, h 1024, dff 2816) arithmetic, 4 x rows x h x dff
// operations against a few tens of MB; at a decode tick (a few live rows
// per expert) the expert weights are the bytes that bound it: 161 MB of
// w1 and w2 for 7 live experts, 0.048 ms at 3.35 TB/s (data sheet).
// Three routes by gg::route (grouped_gemm_tc.cuh):
//
// - "tc" (bf16, fp16; h and dff multiples of 8): both passes run the
//   Hopper mainloop of grouped_gemm_tc.cuh (wgmma on TMA-fed 128 x 128
//   tiles), blocks over (expert, 128-row tile, 128-column tile). The up
//   pass computes z with exactly the K loop of the dx entry's first pass
//   (same maps, tiles, order and instruction), so the forward's ha and
//   the dx entry's are equal bit for bit.
// - "rows" (f32 with C <= gg::kRowsMaxC, h and dff multiples of 4: the
//   serving decode tick): each pass streams every live expert's weight
//   once over many blocks (namespace rows below): a 64-row tile would
//   use a few of its rows while one block per SM streamed its weight
//   slab with nothing in flight behind it.
// - "simt" (f32 and odd widths otherwise, e.g. the serving prefill at C
//   128): the f32 FMA product of grouped_gemm.cuh on the CUDA cores,
//   blocks of 64 x 64.
#include "grouped_gemm_tc.cuh"

namespace {

struct FwdArgs {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* ws;
  const int* counts;
  void* ha;
  void* out;
  int E, C, h, dff, act;
};

template <typename T>
__global__ void __launch_bounds__(gg::kThreads) grouped_ffn_fwd_up(FwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;
  const int n0 = blockIdx.x * gg::kBN;
  if (m0 >= count) return;  // dead rows: their ha is never read
  __shared__ __align__(16) float As[gg::kBK * gg::kAP];
  __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t xe = size_t(e) * a.C * a.h;
  const size_t we = size_t(e) * a.h * a.dff;
  const gg::RowMajor<T> A{static_cast<const T*>(a.x) + xe, a.h, count, a.h};
  const gg::RowMajor<T> B{static_cast<const T*>(a.w1) + we, a.dff, a.h,
                          a.dff};
  float acc[4][4];
  gg::zero(acc);
  gg::mainloop(A, B, m0, n0, a.h, m0 + ty * 4 < count, acc, As, Bs);
  T* ha = static_cast<T*>(a.ha) + size_t(e) * a.C * a.dff;
  const float* b1 = a.b1 + size_t(e) * a.dff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= count) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < a.dff)
        ha[size_t(m) * a.dff + n] =
            pt::from_f32<T>(gg::act_apply(acc[i][j] + b1[n], a.act));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(gg::kThreads)
    grouped_ffn_fwd_down(FwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;
  const int n0 = blockIdx.x * gg::kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T* out = static_cast<T*>(a.out) + size_t(e) * a.C * a.h;
  float acc[4][4];
  gg::zero(acc);
  if (m0 < count) {  // block-uniform
    __shared__ __align__(16) float As[gg::kBK * gg::kAP];
    __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
    const gg::RowMajor<T> A{static_cast<const T*>(a.ha) +
                                size_t(e) * a.C * a.dff,
                            a.dff, count, a.dff};
    const gg::RowMajor<T> B{static_cast<const T*>(a.w2) +
                                size_t(e) * a.dff * a.h,
                            a.h, a.dff, a.h};
    gg::mainloop(A, B, m0, n0, a.dff, m0 + ty * 4 < count, acc, As, Bs);
  }
  const float* b2 = a.b2 + size_t(e) * a.h;
  const float* ws = a.ws + size_t(e) * a.C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.h) continue;
      const float v = m < count ? (acc[i][j] + b2[n]) * ws[m] : 0.f;
      out[size_t(m) * a.h + n] = pt::from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const dim3 up(gg::cdiv(a.dff, gg::kBN), gg::cdiv(a.C, gg::kBM), a.E);
  grouped_ffn_fwd_up<T><<<up, gg::kThreads, 0, stream>>>(a);
  if (int e = int(cudaGetLastError())) return e;
  const dim3 down(gg::cdiv(a.h, gg::kBN), gg::cdiv(a.C, gg::kBM), a.E);
  grouped_ffn_fwd_down<T><<<down, gg::kThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// -- the "tc" route ---------------------------------------------------------

// The ring of both passes (stages, blocks an SM): one accumulator a pass
// leaves registers for two blocks an SM, so one block's prologue and
// epilogue overlap the other's products; three stages (99 KB) let two
// blocks share the SM's shared memory. Chosen over 2, 4 and 6 stages, and
// over a 256-column down pass, by a timing comparison at the training
// shape on an H100.
using TcRing = ggtc::Ring<3, 2>;

// up: maps.a0 = x [E, C, h], maps.b0 = w1 [E, h, dff] (MN-major)
template <typename T>
__global__ void __launch_bounds__(ggtc::kThreads, TcRing::kBlocks)
    grouped_ffn_fwd_up_tc(const __grid_constant__ ggtc::Maps maps,
                          FwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * ggtc::kBM;
  const int n0 = blockIdx.x * ggtc::kBN;
  if (m0 >= count) return;  // dead rows: their ha is never read
  extern __shared__ uint8_t smem[];
  const TcRing r = ggtc::make_ring<TcRing>(smem);
  const int k_tiles = gg::cdiv(a.h, ggtc::kBK);
  if (threadIdx.x >= ggtc::kConsumers) {
    if (threadIdx.x == ggtc::kConsumers) {
      const ggtc::Product p{&maps.a0, &maps.b0, true, k_tiles};
      ggtc::produce(r, &p, 1, e, m0, n0);
    }
    return;
  }
  float z[ggtc::kAcc];
  int j = 0;
  ggtc::consume<T, true>(z, r, j, k_tiles);
  ggtc::drain(z);
  T* ha = static_cast<T*>(a.ha) + size_t(e) * a.C * a.dff;
  const float* b1 = a.b1 + size_t(e) * a.dff;
  const int lane = threadIdx.x % 32;
  const int row = m0 + threadIdx.x / 32 * 16 + lane / 4;
#pragma unroll
  for (int jj = 0; jj < ggtc::kBN / 8; ++jj) {
    const int n = n0 + 8 * jj + 2 * (lane % 4);
    if (n >= a.dff) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = row + 8 * hr;
      if (m < count)
        ggtc::store2(ha + size_t(m) * a.dff + n,
                     gg::act_apply(z[4 * jj + 2 * hr] + b1[n], a.act),
                     gg::act_apply(z[4 * jj + 2 * hr + 1] + b1[n + 1],
                                   a.act));
    }
  }
}

// down: maps.a0 = ha [E, C, dff], maps.b0 = w2 [E, dff, h] (MN-major)
template <typename T>
__global__ void __launch_bounds__(ggtc::kThreads, TcRing::kBlocks)
    grouped_ffn_fwd_down_tc(const __grid_constant__ ggtc::Maps maps,
                            FwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * ggtc::kBM;
  const int n0 = blockIdx.x * ggtc::kBN;
  T* out = static_cast<T*>(a.out) + size_t(e) * a.C * a.h;
  if (m0 >= count) {  // block-uniform: dead rows of out are zeros
    for (int i = threadIdx.x; i < ggtc::kBM * ggtc::kBN / 2;
         i += ggtc::kThreads) {
      const int m = m0 + i / (ggtc::kBN / 2);
      const int n = n0 + 2 * (i % (ggtc::kBN / 2));
      if (m < a.C && n < a.h)
        ggtc::store2(out + size_t(m) * a.h + n, 0.f, 0.f);
    }
    return;
  }
  extern __shared__ uint8_t smem[];
  const TcRing r = ggtc::make_ring<TcRing>(smem);
  const int k_tiles = gg::cdiv(a.dff, ggtc::kBK);
  if (threadIdx.x >= ggtc::kConsumers) {
    if (threadIdx.x == ggtc::kConsumers) {
      const ggtc::Product p{&maps.a0, &maps.b0, true, k_tiles};
      ggtc::produce(r, &p, 1, e, m0, n0);
    }
    return;
  }
  float acc[ggtc::kAcc];
  int j = 0;
  ggtc::consume<T, true>(acc, r, j, k_tiles);
  ggtc::drain(acc);
  const float* b2 = a.b2 + size_t(e) * a.h;
  const float* ws = a.ws + size_t(e) * a.C;
  const int lane = threadIdx.x % 32;
  const int row = m0 + threadIdx.x / 32 * 16 + lane / 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = row + 8 * hr;
    if (m >= a.C) continue;
    const bool live = m < count;
    const float w = live ? ws[m] : 0.f;
#pragma unroll
    for (int jj = 0; jj < ggtc::kBN / 8; ++jj) {
      const int n = n0 + 8 * jj + 2 * (lane % 4);
      if (n >= a.h) continue;
      const float v0 = acc[4 * jj + 2 * hr], v1 = acc[4 * jj + 2 * hr + 1];
      ggtc::store2(out + size_t(m) * a.h + n,
                   live ? (v0 + b2[n]) * w : 0.f,
                   live ? (v1 + b2[n + 1]) * w : 0.f);
    }
  }
}

template <typename T>
int launch_tc(const FwdArgs& a, int dtype, cudaStream_t stream) {
  using ggtc::kBoxA;
  using ggtc::kBoxBMn;
  ggtc::Maps up{}, down{};
  if (!ggtc::make_map(&up.a0, a.x, dtype, a.h, a.C, a.E, kBoxA) ||
      !ggtc::make_map(&up.b0, a.w1, dtype, a.dff, a.h, a.E, kBoxBMn) ||
      !ggtc::make_map(&down.a0, a.ha, dtype, a.dff, a.C, a.E, kBoxA) ||
      !ggtc::make_map(&down.b0, a.w2, dtype, a.h, a.dff, a.E, kBoxBMn))
    return int(cudaErrorInvalidValue);
  const auto up_k = grouped_ffn_fwd_up_tc<T>;
  const auto down_k = grouped_ffn_fwd_down_tc<T>;
  if (int e = ggtc::allow_smem<TcRing>(up_k)) return e;
  if (int e = ggtc::allow_smem<TcRing>(down_k)) return e;
  const dim3 gu(gg::cdiv(a.dff, ggtc::kBN), gg::cdiv(a.C, ggtc::kBM), a.E);
  up_k<<<gu, ggtc::kThreads, TcRing::kSmemBytes, stream>>>(up, a);
  if (int e = int(cudaGetLastError())) return e;
  const dim3 gd(gg::cdiv(a.h, ggtc::kBN), gg::cdiv(a.C, ggtc::kBM), a.E);
  down_k<<<gd, ggtc::kThreads, TcRing::kSmemBytes, stream>>>(down, a);
  return int(cudaGetLastError());
}


// -- the "rows" route --------------------------------------------------------

// f32 buffers of few rows (C <= gg::kRowsMaxC: a serving decode tick).
// Four launches: up pass, up reduce, down pass, down reduce, each after
// the first a programmatic dependent launch, so a kernel's blocks take
// their places during the tail of the one before: the down pass streams
// its first weight stages before it waits for ha.
// Each pass is out_rows[e] = rows[e] w[e] over the live rows only, a few
// per expert against a [K, N] weight, so its bytes are the weights: the
// pass streams every live expert's weight once across many blocks.
// Blocks go over (128-column slab, K split of kKS rows, expert); an
// expert with count 0 exits before any load. A block copies its expert's
// live rows of the K split into shared memory (16-byte cp.async, zeros
// past K) and streams its [kKS, 128] weight slab through a ring of
// kStages stages of kStageK rows (16-byte cp.async, zeros past K), one
// row of 512 bytes a warp: lane l holds columns 4l..4l+3 and the four
// warps take every fourth row of a stage. f32 FMAs on the CUDA cores, a
// [rows][4] accumulator a thread; the warps' sums add in order through
// shared memory into the K split's f32 partial of the live rows, and a
// reduce kernel sums the splits in order (no atomics) and applies the
// pass's epilogue: b1 and act into ha (up), b2 and ws into out, rows
// past counts[e] zero (down). Dead rows of x and ha are never read.
namespace rows {

// Programmatic dependent launch (sm_90): a kernel launched by
// launch_dependent may start while the kernel before it on the stream is
// still running, once every block of that one has called
// pdl_launch_dependents (or exited); pdl_wait then returns when it has
// completed and its writes are visible. Work that reads nothing the
// earlier kernel writes (weights, the block's own setup) goes before
// pdl_wait. In a kernel launched the ordinary way pdl_wait returns at
// once.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" :::);
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;    // columns a block: 4 a lane
constexpr int kKS = 256;    // K rows a block (the K split)
constexpr int kStageK = 16;  // K rows a stage
constexpr int kStages = 4;  // ring depth
static_assert(kStageK % kWarps == 0, "whole rows a warp");
static_assert(kStages * kStageK >= kWarps * gg::kRowsMaxC,
              "the warps' sums fit in the ring");

template <int kRows>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kStages) * kStageK * kBN +
                          size_t(kRows) * kKS);
}

struct Pass {
  const float* a;  // [E, C, K] rows (x, or ha)
  const float* w;  // [E, K, N]
  const int* counts;
  float* part;  // [S, E, C, N]: the K splits' sums of the live rows
  int E, C, K, N;
};

template <int kRows>
__global__ void __launch_bounds__(kThreads)
    grouped_ffn_rows_pass(const Pass p) {
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int e = blockIdx.z;
  pdl_launch_dependents();  // the reduce may take its places now
  const int count = min(p.counts[e], p.C);
  if (count <= 0) return;  // no live row: no weight read
  const int k0 = split * kKS;
  const int kn = min(kKS, p.K - k0);
  const int nst = gg::cdiv(kn, kStageK);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(16) float smem_f[];
  float* ring = smem_f;                          // [kStages][kStageK][kBN]
  float* xs = ring + kStages * kStageK * kBN;    // [kRows][kKS]
  const float* we = p.w + size_t(e) * p.K * p.N;

  auto load_stage = [&](int st) {
    float* dst = ring + (st % kStages) * kStageK * kBN;
    for (int i = tid; i < kStageK * kBN / 4; i += kThreads) {
      const int kk = i / (kBN / 4);
      const int c = 4 * (i - kk * (kBN / 4));
      const int k = st * kStageK + kk;
      const bool ok = k < kn && n0 + c < p.N;  // N % 4 == 0
      pt::cp_async16(dst + kk * kBN + c,
                     ok ? we + size_t(k0 + k) * p.N + n0 + c : we, ok);
    }
  };
  // the weights do not depend on the kernel before: their first stages
  // are in flight before the wait
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) load_stage(st);
    pt::cp_async_commit();
  }
  pdl_wait();  // down: the up pass's reduce has written ha
  // the live rows of this K split
  const float* ae = p.a + size_t(e) * p.C * p.K + k0;
  for (int i = tid; i < count * (kKS / 4); i += kThreads) {
    const int m = i / (kKS / 4);
    const int kk = 4 * (i - m * (kKS / 4));
    const bool ok = kk < kn;  // K % 4 == 0: a piece is whole or past K
    pt::cp_async16(xs + m * kKS + kk, ok ? ae + size_t(m) * p.K + kk : ae,
                   ok);
  }
  pt::cp_async_commit();
  pt::cp_async_wait<0>();  // the rows (and the first stages) landed

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  for (int st = 0; st < nst; ++st) {
    if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
    pt::cp_async_commit();
    pt::cp_async_wait<kStages - 1>();  // stage st landed
    __syncthreads();
    const float* ws = ring + (st % kStages) * kStageK * kBN;
#pragma unroll
    for (int i = 0; i < kStageK / kWarps; ++i) {
      const int kk = warp + kWarps * i;
      const float4 wv = *reinterpret_cast<const float4*>(ws + kk * kBN +
                                                         4 * lane);
      const float* xk = xs + st * kStageK + kk;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < count) {  // block-uniform
          const float xv = xk[m * kKS];
          acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
          acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
          acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
          acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
        }
      }
    }
    __syncthreads();  // the stage may be refilled
  }
  pt::cp_async_wait<0>();  // only empty groups remain; the ring is free

  // the four warps' sums, in warp order, into the split's partial
  float* red = ring;  // [kWarps][kRows][kBN]
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    if (m < count)
      *reinterpret_cast<float4*>(red + (warp * kRows + m) * kBN + 4 * lane) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  float* out = p.part + (size_t(split) * p.E + e) * p.C * p.N;
  for (int i = tid; i < count * (kBN / 4); i += kThreads) {
    const int m = i / (kBN / 4);
    const int c = 4 * (i - m * (kBN / 4));
    if (n0 + c >= p.N) continue;
    float4 s = *reinterpret_cast<const float4*>(red + m * kBN + c);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 t =
          *reinterpret_cast<const float4*>(red + (w * kRows + m) * kBN + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *reinterpret_cast<float4*>(out + size_t(m) * p.N + n0 + c) = s;
  }
}

// the sum of the S split partials of row (e, m), columns n..n+3, in
// split order
__device__ __forceinline__ float4 split_sum(const float* part, int S, int E,
                                            int C, int N, int e, int m,
                                            int n) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < S; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(
        part + ((size_t(k) * E + e) * C + m) * N + n);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  return s;
}

// up: ha[e, m, n] = act(sum + b1[e, n]) for the live rows (the simt
// route's epilogue); dead rows are neither read nor written
__global__ void __launch_bounds__(kThreads)
    grouped_ffn_rows_up_reduce(FwdArgs a, const float* part, int S) {
  const int m = blockIdx.y;
  const int e = blockIdx.z;
  const int n = 4 * (blockIdx.x * kThreads + threadIdx.x);
  pdl_launch_dependents();  // the down pass may prefetch w2 now
  if (m >= min(a.counts[e], a.C) || n >= a.dff) return;
  pdl_wait();  // the up pass has written its partials
  const float4 z = split_sum(part, S, a.E, a.C, a.dff, e, m, n);
  const float* b1 = a.b1 + size_t(e) * a.dff + n;
  *reinterpret_cast<float4*>(static_cast<float*>(a.ha) +
                             (size_t(e) * a.C + m) * a.dff + n) =
      make_float4(gg::act_apply(z.x + b1[0], a.act),
                  gg::act_apply(z.y + b1[1], a.act),
                  gg::act_apply(z.z + b1[2], a.act),
                  gg::act_apply(z.w + b1[3], a.act));
}

// down: out[e, m, n] = (sum + b2[e, n]) ws[e, m] on the live rows, 0 on
// every other row of the buffer
__global__ void __launch_bounds__(kThreads)
    grouped_ffn_rows_down_reduce(FwdArgs a, const float* part, int S) {
  const int m = blockIdx.y;
  const int e = blockIdx.z;
  const int n = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (n >= a.h) return;
  pdl_wait();  // the down pass has written its partials
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m < min(a.counts[e], a.C)) {
    const float4 s = split_sum(part, S, a.E, a.C, a.h, e, m, n);
    const float* b2 = a.b2 + size_t(e) * a.h + n;
    const float w = a.ws[size_t(e) * a.C + m];
    v = make_float4((s.x + b2[0]) * w, (s.y + b2[1]) * w, (s.z + b2[2]) * w,
                    (s.w + b2[3]) * w);
  }
  *reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                             (size_t(e) * a.C + m) * a.h + n) = v;
}

// the f32 elements the scratch of both passes takes: S splits of the
// live rows, [S, E, C, N] (mirrored by moe.grouped_ffn_rows_scratch)
inline long long part_elems(const FwdArgs& a) {
  const long long up = 1LL * gg::cdiv(a.h, kKS) * a.dff;
  const long long down = 1LL * gg::cdiv(a.dff, kKS) * a.h;
  return (up > down ? up : down) * a.E * a.C;
}

template <int kRows>
int launch(const FwdArgs& a, float* part, cudaStream_t stream) {
  static_assert(smem_bytes<kRows>() <= 48 * 1024, "static shared limit");
  const auto pass = grouped_ffn_rows_pass<kRows>;
  constexpr size_t smem = smem_bytes<kRows>();
  const int* counts = a.counts;
  const Pass up{static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
                counts, part, a.E, a.C, a.h, a.dff};
  const Pass down{static_cast<const float*>(a.ha),
                  static_cast<const float*>(a.w2), counts, part, a.E, a.C,
                  a.dff, a.h};
  // the up pass after the caller's kernels; each next kernel a
  // programmatic dependent launch of the one before (pdl_wait)
  pass<<<dim3(gg::cdiv(a.dff, kBN), gg::cdiv(a.h, kKS), a.E), kThreads, smem,
         stream>>>(up);
  if (int e = int(cudaGetLastError())) return e;
  if (int e = int(launch_dependent(
          grouped_ffn_rows_up_reduce,
          dim3(gg::cdiv(a.dff, 4 * kThreads), a.C, a.E), dim3(kThreads), 0,
          stream, a, static_cast<const float*>(part), gg::cdiv(a.h, kKS))))
    return e;
  if (int e = int(launch_dependent(
          pass, dim3(gg::cdiv(a.h, kBN), gg::cdiv(a.dff, kKS), a.E),
          dim3(kThreads), smem, stream, down)))
    return e;
  return int(launch_dependent(
      grouped_ffn_rows_down_reduce, dim3(gg::cdiv(a.h, 4 * kThreads), a.C, a.E),
      dim3(kThreads), 0, stream, a, static_cast<const float*>(part),
      gg::cdiv(a.dff, kKS)));
}

}  // namespace rows

}  // namespace

PT_DEFINE_PROBE(grouped_ffn_fwd)

// x [E, C, h], w1 [E, h, dff], w2 [E, dff, h] contiguous in one dtype T
// (`dtype`: 0 f32, 1 bf16, 2 f16); b1 [E, 1, dff], b2 [E, 1, h], ws
// [E, C, 1] f32; counts [E] int32 on the device; ha [E, C, dff] T scratch;
// out [E, C, h] T; part: f32 scratch of part_elems elements, read on the
// "rows" route only (rows::part_elems). act: 0 tanh-GELU, 1 ReLU. The
// route is gg::route's with the capacity; *route gets the one that ran
// (gg::Route). Returns cudaGetLastError() after its launches (or the
// error of a tensor map libcuda refuses).
extern "C" int grouped_ffn_fwd_launch(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* ws,
                                      const void* counts, void* ha, void* out,
                                      void* part, int E, int C, int h,
                                      int dff, int act, int dtype,
                                      int part_elems, void* stream,
                                      int* route) {
  if (E < 1 || C < 1 || h < 1 || dff < 1 || act < 0 || act > 1 ||
      E > 65535 || gg::cdiv(C, gg::kBM) > 65535)
    return int(cudaErrorInvalidValue);
  const FwdArgs a{x,
                  w1,
                  static_cast<const float*>(b1),
                  w2,
                  static_cast<const float*>(b2),
                  static_cast<const float*>(ws),
                  static_cast<const int*>(counts),
                  ha,
                  out,
                  E,
                  C,
                  h,
                  dff,
                  act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gg::Route r = gg::route(dtype, h, dff, C);
  *route = int(r);
  if (r == gg::kRows) {
    if (part == nullptr || part_elems < rows::part_elems(a))
      return int(cudaErrorInvalidValue);
    float* p = static_cast<float*>(part);
    return C <= 8 ? rows::launch<8>(a, p, s) : rows::launch<16>(a, p, s);
  }
  const bool tc = r == gg::kTc;
  switch (dtype) {
    case pt::kF32:
      return launch<float>(a, s);
    case pt::kBF16:
      return tc ? launch_tc<__nv_bfloat16>(a, dtype, s)
                : launch<__nv_bfloat16>(a, s);
    case pt::kF16:
      return tc ? launch_tc<__half>(a, dtype, s) : launch<__half>(a, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
