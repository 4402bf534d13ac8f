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
// per expert) the expert weights are the bytes that bound it. Two routes
// by gg::route (grouped_gemm_tc.cuh):
//
// - "tc" (bf16, fp16; h and dff multiples of 8): both passes run the
//   Hopper mainloop of grouped_gemm_tc.cuh (wgmma on TMA-fed 128 x 128
//   tiles), blocks over (expert, 128-row tile, 128-column tile). The up
//   pass computes z with exactly the K loop of the dx entry's first pass
//   (same maps, tiles, order and instruction), so the forward's ha and
//   the dx entry's are equal bit for bit.
// - "simt" (f32, odd widths): the f32 FMA product of grouped_gemm.cuh on
//   the CUDA cores, blocks of 64 x 64.
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

}  // namespace

PT_DEFINE_PROBE(grouped_ffn_fwd)

// x [E, C, h], w1 [E, h, dff], w2 [E, dff, h] contiguous in one dtype T
// (`dtype`: 0 f32, 1 bf16, 2 f16); b1 [E, 1, dff], b2 [E, 1, h], ws
// [E, C, 1] f32; counts [E] int32 on the device; ha [E, C, dff] T scratch;
// out [E, C, h] T. act: 0 tanh-GELU, 1 ReLU. The route is gg::route's.
// Returns cudaGetLastError() after its launches (or the error of a tensor
// map libcuda refuses).
extern "C" int grouped_ffn_fwd_launch(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* ws,
                                      const void* counts, void* ha, void* out,
                                      int E, int C, int h, int dff, int act,
                                      int dtype, void* stream) {
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
  const bool tc = gg::route(dtype, h, dff) == gg::kTc;
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
