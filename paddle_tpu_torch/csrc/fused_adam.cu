// The Adam / AdamW update as one pass over the parameters (sm_90a).
//
// No TPU kernel stands behind this one: the JAX TrainStep traces
// apply_gradients_pytree into one jitted step (paddle_tpu/jit/api.py:
// 501-509) and XLA fuses each parameter's update into one pass. The
// plain PyTorch rule (kernels/fused_adam.py::adam_update_plain, the
// port's _adam_core) runs about fifteen elementwise ops a tensor, each a
// pass over f32 tensors: ~150 bytes of device memory a parameter.
//
// What bounds it: bytes. Each element is read and written once: the f32
// parameter (read, write), the f32 gradient (read), moment1 and moment2
// in f32 or bf16 (read, write), moment2_max under amsgrad: 20 bytes a
// parameter with bf16 moments, 28 with f32 (24 / 36 with amsgrad). The
// design: one launch over every parameter of the step, blocks driven by a
// chunk table (parameter, first element, count; ADAM_CHUNK elements a
// chunk, each starting at a multiple of it), 256 threads a block, 8
// elements a thread and step as 16-byte vector loads and stores (a scalar
// tail, and scalar code for a tensor that is not 16-byte aligned). A
// second launch, one thread a parameter, then advances the beta powers:
// every block of a parameter reads them, so none may advance them.
//
// The arithmetic is the plain version's, op for op and in its order,
// with round-to-nearest intrinsics so that nvcc contracts no FMA:
//   AdamW: p = p * (1 - lr * coeff)      Adam (L2): g = g + coeff * p
//   m1 = b1 * m1 + (1 - b1) * g          m2 = b2 * m2 + ((1 - b2) * g) * g
//   lr_t = lr * sqrt(1 - b2p) / (1 - b1p); eps_t = eps * sqrt(1 - b2p)
//   [amsgrad] v = maximum(m2max, m2); m2max = v
//   p = p - (lr_t * m1) / (sqrt(v) + eps_t)
// with the moments rounded to their dtype (nearest even) on store and
// the constants rounded to f32 by the caller from the same Python doubles
// PyTorch rounds (b1, 1 - b1, ...): on the card the kernel is bit-equal
// to the plain version.
#include "common.cuh"

PT_DEFINE_PROBE(fused_adam)

namespace fa {

constexpr int kThreads = 256;
constexpr int kVec = 8;                        // elements a thread and step
constexpr long long kChunk = 8192;             // == ADAM_CHUNK (Python)

enum Decay { kNone = 0, kDecoupled = 1, kL2 = 2 };

// One row of the per-launch parameter table (eight int64 fields).
struct Param {
  float* p;
  const float* g;
  void* m1;
  void* m2;
  void* m2max;
  float* b1p;
  float* b2p;
  long long n;
};

// One row of the chunk table.
struct Chunk {
  long long param, start, count;
};

struct Consts {
  float lr, b1, omb1, b2, omb2, eps, coeff;
  int decay;
};

// The route rule (kernels/fused_adam.py::adam_update_route): f32
// parameters and gradients, f32 or bf16 moments.
__host__ __device__ inline bool route_fused(int param_dtype, int grad_dtype,
                                            int moment_dtype) {
  return param_dtype == pt::kF32 && grad_dtype == pt::kF32 &&
         (moment_dtype == pt::kF32 || moment_dtype == pt::kBF16);
}

// torch.maximum: NaN in either operand propagates (the first one first).
__device__ __forceinline__ float maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <typename M>
__device__ __forceinline__ float mload(const M* p) {
  return pt::to_f32(*p);
}

template <typename M>
__device__ __forceinline__ void mstore(M* p, float x);
template <>
__device__ __forceinline__ void mstore<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void mstore<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 moments at a 16-byte aligned address, to and from f32.
template <typename M>
struct Vec8;
template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* s, float* d) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* s, const float* d) {
    *reinterpret_cast<float4*>(s) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(s + 4) = make_float4(d[4], d[5], d[6], d[7]);
  }
};
template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* s,
                                              float* d) {
    const uint4 raw = *reinterpret_cast<const uint4*>(s);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = __bfloat162float(e[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* s,
                                               const float* d) {
    uint4 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(d[i]);
    *reinterpret_cast<uint4*>(s) = raw;
  }
};

// The per-parameter scalars every element of the parameter shares.
struct Scalars {
  float lr_t, eps_t, dfac;
};

__device__ __forceinline__ Scalars scalars(const Consts& c, float b1p,
                                           float b2p) {
  const float s2 = __fsqrt_rn(__fsub_rn(1.0f, b2p));
  Scalars s;
  s.lr_t = __fdiv_rn(__fmul_rn(c.lr, s2), __fsub_rn(1.0f, b1p));
  s.eps_t = __fmul_rn(c.eps, s2);
  s.dfac = __fsub_rn(1.0f, __fmul_rn(c.lr, c.coeff));
  return s;
}

// One element: p, m1, m2 (and m2max) updated in registers from g.
template <bool kAms>
__device__ __forceinline__ void step1(float& p, float g, float& m1,
                                      float& m2, float& mx, const Consts& c,
                                      const Scalars& s) {
  if (c.decay == kDecoupled) {
    p = __fmul_rn(p, s.dfac);
  } else if (c.decay == kL2) {
    g = __fadd_rn(g, __fmul_rn(c.coeff, p));
  }
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(__fmul_rn(c.omb2, g), g));
  float v = m2;
  if (kAms) {
    v = maximum(mx, m2);
    mx = v;
  }
  const float denom = __fadd_rn(__fsqrt_rn(v), s.eps_t);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr_t, m1), denom));
}

template <typename M, bool kAms>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const Param* __restrict__ params,
                      const Chunk* __restrict__ chunks, Consts c) {
  const Chunk ch = chunks[blockIdx.x];
  const Param pr = params[ch.param];
  const Scalars s = scalars(c, *pr.b1p, *pr.b2p);
  float* p = pr.p + ch.start;
  const float* g = pr.g + ch.start;
  M* m1 = static_cast<M*>(pr.m1) + ch.start;
  M* m2 = static_cast<M*>(pr.m2) + ch.start;
  M* mx = kAms ? static_cast<M*>(pr.m2max) + ch.start : nullptr;
  const int count = static_cast<int>(ch.count);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(m1) | reinterpret_cast<uintptr_t>(m2) |
      (kAms ? reinterpret_cast<uintptr_t>(mx) : 0);
  const int nvec = (addr % 16 == 0) ? count / kVec : 0;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int i = v * kVec;
    float pv[kVec], gv[kVec], a[kVec], b[kVec], x[kVec];
    Vec8<float>::load(p + i, pv);
    {
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + i));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + i + 4));
      gv[0] = g0.x; gv[1] = g0.y; gv[2] = g0.z; gv[3] = g0.w;
      gv[4] = g1.x; gv[5] = g1.y; gv[6] = g1.z; gv[7] = g1.w;
    }
    Vec8<M>::load(m1 + i, a);
    Vec8<M>::load(m2 + i, b);
    if (kAms) Vec8<M>::load(mx + i, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) step1<kAms>(pv[e], gv[e], a[e], b[e], x[e],
                                                c, s);
    Vec8<float>::store(p + i, pv);
    Vec8<M>::store(m1 + i, a);
    Vec8<M>::store(m2 + i, b);
    if (kAms) Vec8<M>::store(mx + i, x);
  }
  // the scalar tail (and the whole chunk of an unaligned tensor)
  for (int i = nvec * kVec + threadIdx.x; i < count; i += kThreads) {
    float pv = p[i], a = mload(m1 + i), b = mload(m2 + i);
    float x = kAms ? mload(mx + i) : 0.0f;
    step1<kAms>(pv, g[i], a, b, x, c, s);
    p[i] = pv;
    mstore(m1 + i, a);
    mstore(m2 + i, b);
    if (kAms) mstore(mx + i, x);
  }
}

// b1p *= b1, b2p *= b2, one thread a parameter (after the update).
__global__ void fused_adam_pows(const Param* __restrict__ params, int n,
                                float b1, float b2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float* b1p = params[i].b1p;
    float* b2p = params[i].b2p;
    *b1p = __fmul_rn(*b1p, b1);
    *b2p = __fmul_rn(*b2p, b2);
  }
}

template <typename M, bool kAms>
cudaError_t launch(const Param* params, const Chunk* chunks,
                   long long n_chunks, const Consts& c, cudaStream_t st) {
  fused_adam_kernel<M, kAms><<<static_cast<unsigned>(n_chunks), kThreads,
                               0, st>>>(params, chunks, c);
  return cudaGetLastError();
}

}  // namespace fa

// 1 when the kernel takes a parameter of these dtypes (pt::DType codes),
// else 0: the rule of adam_update_route, for the tests to compare.
extern "C" int fused_adam_route(int param_dtype, int grad_dtype,
                                int moment_dtype) {
  return fa::route_fused(param_dtype, grad_dtype, moment_dtype) ? 1 : 0;
}

// Update n_params parameters in place over the n_chunks rows of `chunks`
// ([n, 3] int64), reading `params` ([n_params, 8] int64: parameter,
// gradient, moment1, moment2, moment2_max, beta1_pow, beta2_pow, numel),
// then advance every parameter's beta powers. Refuses (returns
// cudaErrorInvalidValue) a dtype combination the route does not take.
extern "C" int fused_adam_launch(const void* params, const void* chunks,
                                 long long n_chunks, int n_params,
                                 int param_dtype, int grad_dtype,
                                 int moment_dtype, int amsgrad, int decay,
                                 float lr, float b1, float omb1, float b2,
                                 float omb2, float eps, float coeff,
                                 void* stream) {
  if (!fa::route_fused(param_dtype, grad_dtype, moment_dtype) ||
      n_chunks < 0 || n_chunks > 2147483647LL || n_params < 0 || decay < 0 ||
      decay > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_params == 0 || n_chunks == 0) return 0;
  const fa::Consts c{lr, b1, omb1, b2, omb2, eps, coeff, decay};
  const auto* pp = static_cast<const fa::Param*>(params);
  const auto* cc = static_cast<const fa::Chunk*>(chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (moment_dtype == pt::kF32) {
    err = amsgrad ? fa::launch<float, true>(pp, cc, n_chunks, c, st)
                  : fa::launch<float, false>(pp, cc, n_chunks, c, st);
  } else {
    err = amsgrad ? fa::launch<__nv_bfloat16, true>(pp, cc, n_chunks, c, st)
                  : fa::launch<__nv_bfloat16, false>(pp, cc, n_chunks, c, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  fa::fused_adam_pows<<<(n_params + 127) / 128, 128, 0, st>>>(pp, n_params,
                                                               b1, b2);
  return static_cast<int>(cudaGetLastError());
}
