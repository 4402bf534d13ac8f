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
// port splits the two products into two passes of the tiled product of
// grouped_gemm.cuh, blocks over (expert, 64-row tile, 64-column tile),
// launched one after the other on the caller's stream:
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
// operations against a few tens of MB; these first kernels run it in f32
// on the CUDA cores (67 TFLOP/s on an H100 SXM at 700 W, data sheet), so
// they sit far above the bf16 tensor-core bound. At a decode tick (a few
// live rows per expert) the expert weights are the bytes that bound it.
// wgmma tiles, TMA and a fused up/down pass are later work.
#include "grouped_gemm.cuh"

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

}  // namespace

PT_DEFINE_PROBE(grouped_ffn_fwd)

// x [E, C, h], w1 [E, h, dff], w2 [E, dff, h] contiguous in one dtype T
// (`dtype`: 0 f32, 1 bf16, 2 f16); b1 [E, 1, dff], b2 [E, 1, h], ws
// [E, C, 1] f32; counts [E] int32 on the device; ha [E, C, dff] T scratch;
// out [E, C, h] T. act: 0 tanh-GELU, 1 ReLU. Returns cudaGetLastError()
// after its launches.
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
  switch (dtype) {
    case pt::kF32:
      return launch<float>(a, s);
    case pt::kBF16:
      return launch<__nv_bfloat16>(a, s);
    case pt::kF16:
      return launch<__half>(a, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
