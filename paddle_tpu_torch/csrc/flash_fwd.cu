// Flash-attention forward for Hopper (no-cache LLaMA attention).
//
// Replaces the Pallas kernel `_flash_fwd_kernel` launched by
// `_flash_pallas_fwd` (paddle_tpu/kernels/flash_attention.py:280,
// :387). Same contract: causal (bottom-right aligned, diag_off =
// sk - sq) or full online-softmax attention with f32 accumulation, GQA
// by index (query head qh reads kv head qh / rep, the repeated K/V is
// never built), an optional sliding window measured back from the
// causal diagonal, and 0 for a row that sees no key. Flashmask bands
// and the logsumexp output belong to the training slice.
//
// Unlike the Pallas entry, which sends shapes that do not tile to XLA,
// this kernel masks ragged edges itself: any seq_q, seq_k and head dim
// up to 256, and any strides with a unit last-dim stride, so the
// wrapper reads q/k/v in the paddle [B, S, H, D] layout without a
// transpose copy and writes out contiguous [B, Sq, H, D].
//
// What bounds it on an H100: arithmetic. At seq 1024, d 128 every
// loaded K/V element is reused by 64 query rows of a tile (and the
// other tiles hit L2), so the work is ~4*S*S*D/2 flops against O(S*D)
// bytes. This first version runs the f32 math on the CUDA cores
// (67 TFLOP/s peak), not the tensor cores: one block per (batch*head,
// 64-row q tile), 4 warps of 16 rows each; K/V stream through shared
// memory 32 keys at a time (one key column per lane); q, K and the
// probabilities are read as 16-byte vectors from shared memory so the
// inner loops are FMA- rather than load-bound; m/l/acc stay in
// registers in f32. The tile loop runs only over key tiles that meet
// the causal band and the window (the counterparts of `_causal_k_hi`
// :151 and `_window_k_lo` :169). Tensor-core (wgmma) tiles and
// TMA-fed pipelining are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per block (16 per warp)
constexpr int kBK = 32;   // keys per shared-memory tile (1 per lane)
constexpr int kRows = 16; // query rows per warp

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

size_t smem_bytes(int d) {
  const int dp = pad4(d);
  // q [kBQ][dp], K [kBK][dp+4], V [kBK][dp], p [kBQ][kBK]
  return sizeof(float) * (size_t(kBQ) * dp + size_t(kBK) * (dp + 4) +
                          size_t(kBK) * dp + size_t(kBQ) * kBK);
}

// Stage rows [r0, r0 + nrows) of one (batch, head) slice into f32
// shared memory rows of stride `ds`, scaled by `mul`; rows past `nvalid`
// and columns in [d, dp) are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ base,
                                      long long row_stride, int r0,
                                      int nrows, int nvalid, int d, int dp,
                                      float* __restrict__ dst, int ds,
                                      float mul, int tid) {
  constexpr int kVec = pt::Vec16<T>::n;
  const bool vec = (d % kVec) == 0 && (row_stride % kVec) == 0 &&
                   (reinterpret_cast<uintptr_t>(base) % 16) == 0;
  if (vec) {
    const int vpr = d / kVec;
    for (int idx = tid; idx < nrows * vpr; idx += kThreads) {
      const int j = idx / vpr;
      const int c = (idx - j * vpr) * kVec;
      float* out = dst + j * ds + c;
      if (r0 + j < nvalid) {
        pt::load16_f32(base + (r0 + j) * row_stride + c, out, mul);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = 0.f;
      }
    }
    for (int idx = tid; idx < nrows * (dp - d); idx += kThreads) {
      const int j = idx / (dp - d);
      dst[j * ds + d + (idx - j * (dp - d))] = 0.f;
    }
  } else {
    for (int idx = tid; idx < nrows * dp; idx += kThreads) {
      const int j = idx / dp;
      const int c = idx - j * dp;
      dst[j * ds + c] = (r0 + j < nvalid && c < d)
                            ? pt::to_f32(base[(r0 + j) * row_stride + c]) * mul
                            : 0.f;
    }
  }
}

template <typename T, int kDPL>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, int D, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, int causal, int window,
                     float scale) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = pad4(D);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [kBQ][dp], pre-scaled
  float* k_s = q_s + kBQ * dp;         // [kBK][dp + 4]
  float* v_s = k_s + kBK * (dp + 4);   // [kBK][dp]
  float* p_s = v_s + kBK * dp;         // [kBQ][kBK]

  stage(q + b * q_sb + hq * q_sh, q_ss, q0, kBQ, Sq, D, dp, q_s, dp, scale,
        tid);

  // key-tile range that can meet this q tile's causal band / window
  const int nkt = (Sk + kBK - 1) / kBK;
  int kt_hi = nkt;
  int kt_lo = 0;
  if (causal) {
    const int last_k = min(q0 + kBQ, Sq) - 1 + diag;
    kt_hi = last_k < 0 ? 0 : min(nkt, last_k / kBK + 1);
    if (window > 0) {
      const int first_k = q0 + diag - window + 1;
      kt_lo = first_k > 0 ? first_k / kBK : 0;
    }
  }

  const int r0 = warp * kRows;  // this warp's first row within the tile
  float acc[kRows][kDPL];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous K/V tile consumed (and q staged)
    stage(kb, k_ss, k0, kBK, Sk, D, dp, k_s, dp + 4, 1.f, tid);
    stage(vb, v_ss, k0, kBK, Sk, D, dp, v_s, dp, 1.f, tid);
    __syncthreads();

    // S = q K^T for this warp's 16 rows; lane owns key column k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * (dp + 4));
    for (int c4 = 0; c4 < dp / 4; ++c4) {
      const float4 kv = kr[c4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + (r0 + r) * dp)[c4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r;
      bool keep = kj < Sk && qi < Sq;
      if (causal) {
        keep = keep && (qi + diag >= kj);
        if (window > 0) keep = keep && (qi + diag - kj < window);
      }
      const float sv = keep ? s[r] : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float p = 0.f;
      float alpha = 1.f;
      if (m_new != -INFINITY) {
        p = expf(sv - m_new);
        alpha = expf(m[r] - m_new);
      }
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= alpha;
      p_s[(r0 + r) * kBK + lane] = p;
    }
    __syncwarp();

    // acc += P V; lane owns output columns lane + 32 * i
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][kDPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int c = lane + 32 * i;
          vv[jj][i] = c < dp ? v_s[(j4 * 4 + jj) * dp + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            reinterpret_cast<const float4*>(p_s + (r0 + r) * kBK)[j4];
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          float a = acc[r][i];
          a = fmaf(pv.x, vv[0][i], a);
          a = fmaf(pv.y, vv[1][i], a);
          a = fmaf(pv.z, vv[2][i], a);
          a = fmaf(pv.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = o + ((size_t(b) * Sq + qi) * H + hq) * size_t(D);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = pt::from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int kDPL>
int launch_dpl(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, int D, const long long* st,
               int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kDPL>;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int D, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch_dpl<T, 1>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                            window, scale, stream);
  if (D <= 64)
    return launch_dpl<T, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                            window, scale, stream);
  if (D <= 128)
    return launch_dpl<T, 4>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                            window, scale, stream);
  if (D <= 256)
    return launch_dpl<T, 8>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                            window, scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

PT_DEFINE_PROBE(flash_fwd)

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D] given by element strides
// (batch, seq, head; the last dim is contiguous); o contiguous
// [B, Sq, H, D] of the same dtype (`dtype`: pt::DType f32/bf16/f16).
// window <= 0 means no window (only read when causal). Returns
// cudaGetLastError() after launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Hkv, int Sq,
                                int Sk, int D, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, int causal, int window,
                                float scale, int dtype, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pt::kF32:
      return launch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                           window, scale, s);
    case pt::kBF16:
      return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st,
                                   causal, window, scale, s);
    case pt::kF16:
      return launch<__half>(q, k, v, o, B, H, Hkv, Sq, Sk, D, st, causal,
                            window, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
