// The tiled product shared by the grouped expert-FFN kernels
// (grouped_ffn_fwd.cu, grouped_ffn_bwd.cu): one block computes a 64 x 64
// tile of C = A B in f32 registers on the CUDA cores, with A [M, K] and
// B [K, N] read through operand views that convert T to f32 on load.
//
// - 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows
//   m0 + 4 ty .. +3 and columns n0 + 4 tx .. +3 (16 accumulators).
// - K advances 16 at a time. Each step stages A as [16][64 + 4] and B as
//   [16][64 + 4] f32 in shared memory (the padding keeps the staging
//   stores at most 2-way bank-conflicted and the rows 16-byte aligned),
//   then every thread reads one float4 of A (a broadcast: a warp reads
//   two) and one of B per k and does 16 FMAs: FMA-bound, not
//   shared-memory-bound.
// - The staging loads follow the memory: where an operand's contiguous
//   dimension is k, neighbouring threads take neighbouring k, otherwise
//   neighbouring m (or n), so a warp reads whole runs of a row.
// - A view returns 0 outside its bounds, which masks the ragged tile
//   edges and, with I = counts[e], the dead rows of an expert: a dead row
//   is never read.
#pragma once

#include "common.cuh"

namespace gg {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kAP = kBM + 4;  // padded row (over m) of the staged A tile
constexpr int kBP = kBN + 4;  // padded row (over n) of the staged B tile

// (i, j) -> p[i * ld + j]: j is the contiguous dimension
template <typename T>
struct RowMajor {
  static constexpr bool kJContig = true;
  const T* p;
  long long ld;
  int I, J;
  __device__ __forceinline__ float at(int i, int j) const {
    return (i < I && j < J) ? pt::to_f32(p[i * ld + j]) : 0.f;
  }
};

// (i, j) -> p[j * ld + i]: the transpose of a row-major matrix
template <typename T>
struct ColMajor {
  static constexpr bool kJContig = false;
  const T* p;
  long long ld;
  int I, J;
  __device__ __forceinline__ float at(int i, int j) const {
    return (i < I && j < J) ? pt::to_f32(p[j * ld + i]) : 0.f;
  }
};

// (row i, column j) of gw = g * ws[row], rounded to T (the kernels'
// rounding point, paddle_tpu/kernels/moe.py:416), zero past I = counts[e]
template <typename T>
struct ScaledRows {
  static constexpr bool kJContig = true;
  const T* p;
  const float* ws;
  long long ld;
  int I, J;
  __device__ __forceinline__ float at(int i, int j) const {
    if (i >= I || j >= J) return 0.f;
    return pt::to_f32(pt::from_f32<T>(pt::to_f32(p[i * ld + j]) * ws[i]));
  }
};

// A (m0 + mm, k0 + kk) -> As[kk][mm]
template <typename LA>
__device__ __forceinline__ void load_a(const LA& A, int m0, int k0,
                                       float* As, int tid) {
  if (LA::kJContig) {
    const int kk = tid % kBK;
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int mm = tid / kBK + r * (kThreads / kBK);
      As[kk * kAP + mm] = A.at(m0 + mm, k0 + kk);
    }
  } else {
    const int mm = tid % kBM;
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int kk = tid / kBM + r * (kThreads / kBM);
      As[kk * kAP + mm] = A.at(m0 + mm, k0 + kk);
    }
  }
}

// B (k0 + kk, n0 + nn) -> Bs[kk][nn]
template <typename LB>
__device__ __forceinline__ void load_b(const LB& B, int k0, int n0,
                                       float* Bs, int tid) {
  if (LB::kJContig) {
    const int nn = tid % kBN;
#pragma unroll
    for (int r = 0; r < kBN * kBK / kThreads; ++r) {
      const int kk = tid / kBN + r * (kThreads / kBN);
      Bs[kk * kBP + nn] = B.at(k0 + kk, n0 + nn);
    }
  } else {
    const int kk = tid % kBK;
#pragma unroll
    for (int r = 0; r < kBN * kBK / kThreads; ++r) {
      const int nn = tid / kBK + r * (kThreads / kBK);
      Bs[kk * kBP + nn] = B.at(k0 + kk, n0 + nn);
    }
  }
}

// acc += A[m0:m0+64, 0:K] B[0:K, n0:n0+64] for this thread's 4 x 4 entries.
// `active` false: the thread's rows are all dead, it stages but skips the
// FMAs. Every thread of the block must call it (it synchronizes).
template <typename LA, typename LB>
__device__ __forceinline__ void mainloop(const LA& A, const LB& B, int m0,
                                         int n0, int K, bool active,
                                         float (&acc)[4][4], float* As,
                                         float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous tile has been consumed
    load_a(A, m0, k0, As, tid);
    load_b(B, k0, n0, Bs, tid);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * kAP + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kBP + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// tanh-GELU (jax.nn.gelu's default, its operation order) or ReLU, and
// the hand-coded derivative (paddle_tpu/kernels/moe.py:150-165)
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluK = 0.044715f;
enum Act { kGelu = 0, kRelu = 1 };

__device__ __forceinline__ float act_apply(float z, int act) {
  if (act == kGelu) {
    const float cdf = 0.5f * (1.f + tanhf(kGeluC * (z + kGeluK * (z * z * z))));
    return z * cdf;
  }
  return fmaxf(z, 0.f);
}

__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == kGelu) {
    const float u = kGeluC * (z + kGeluK * z * z * z);
    const float t = tanhf(u);
    const float du = kGeluC * (1.f + 3.f * kGeluK * z * z);
    return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
  }
  return z > 0.f ? 1.f : 0.f;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace gg
