// Flash-attention forward for Hopper (no-cache LLaMA attention, and the
// forward of training).
//
// Replaces the Pallas kernel `_flash_fwd_kernel` launched by
// `_flash_pallas_fwd` (paddle_tpu/kernels/flash_attention.py:280,
// :387). Same contract: causal (bottom-right aligned, diag_off =
// sk - sq) or full online-softmax attention with f32 accumulation, GQA
// by index (query head qh reads kv head qh / rep, the repeated K/V is
// never built), an optional sliding window measured back from the
// causal diagonal, flashmask row bands per key column (the se head of
// query head qh is qh / (H / h_se), the batch stride 0 broadcasts a
// batch-1 mask), and 0 for a row that sees no key. When the caller
// differentiates (a non-null `lse`), the row logsumexp m + log(l) is
// written in f32 [B, H, Sq] — NEG_INF for a row that saw no key, which
// the backward kernels read as "no probability mass".
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
// the causal band and the window, and a tile whose every row one
// flashmask band covers is skipped before its K/V are loaded (the
// document mask's cross-document tiles). Tensor-core (wgmma) tiles and
// TMA-fed pipelining are later work.
#include "flash_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per block (16 per warp)
constexpr int kBK = 32;   // keys per shared-memory tile (1 per lane)
constexpr int kRows = 16; // query rows per warp

size_t smem_bytes(int d) {
  const int dp = fl::pad4(d);
  // q [kBQ][dp], K [kBK][dp+4], V [kBK][dp], p [kBQ][kBK]
  return sizeof(float) * (size_t(kBQ) * dp + size_t(kBK) * (dp + 4) +
                          size_t(kBK) * dp + size_t(kBQ) * kBK);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;       // [B, H, Sq] f32, or null
  const int* se;    // flashmask bands, or null
  int H, Hkv, Sq, Sk, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long se_sb, se_sh, se_s4;
  int h_se, causal, window;
  float scale;
};

template <typename T, int kDPL>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = fl::pad4(D);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [kBQ][dp], pre-scaled
  float* k_s = q_s + kBQ * dp;         // [kBK][dp + 4]
  float* v_s = k_s + kBK * (dp + 4);   // [kBK][dp]
  float* p_s = v_s + kBK * dp;         // [kBQ][kBK]

  fl::stage<T, kThreads>(q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, kBQ, Sq,
                         D, dp, q_s, dp, a.scale, tid);

  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kBK, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;

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

  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    const int kj = k0 + lane;  // this lane's key column
    fl::Bands bands{};
    if (seb != nullptr) {
      bands = fl::load_bands(seb, a.se_s4, kj, Sk);
      // every warp reads the same 32 columns: a block-uniform skip
      if (fl::warp_tile_full(bands, q0, q_end)) continue;
    }
    __syncthreads();  // previous K/V tile consumed (and q staged)
    fl::stage<T, kThreads>(kb, a.k_ss, k0, kBK, Sk, D, dp, k_s, dp + 4, 1.f,
                           tid);
    fl::stage<T, kThreads>(vb, a.v_ss, k0, kBK, Sk, D, dp, v_s, dp, 1.f,
                           tid);
    __syncthreads();

    // S = q K^T for this warp's 16 rows; lane owns key column kj
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
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r;
      bool keep = fl::band_keep(qi, kj, Sq, Sk, a.causal, a.window, diag);
      if (seb != nullptr) keep = keep && !fl::band_masked(bands, qi);
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
          float acc_ri = acc[r][i];
          acc_ri = fmaf(pv.x, vv[0][i], acc_ri);
          acc_ri = fmaf(pv.y, vv[1][i], acc_ri);
          acc_ri = fmaf(pv.z, vv[2][i], acc_ri);
          acc_ri = fmaf(pv.w, vv[3][i], acc_ri);
          acc[r][i] = acc_ri;
        }
      }
    }
    __syncwarp();
  }

  // a row is valid when it saw a key: m > -inf, l > 0 (the running-max
  // counterpart of `m > ROW_INVALID_LSE` :365)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Sq) continue;
    const bool valid = l[r] > 0.f;
    const float inv = valid ? 1.f / l[r] : 0.f;
    T* orow = o + ((size_t(b) * Sq + qi) * H + hq) * size_t(D);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = pt::from_f32<T>(acc[r][i] * inv);
    }
    if (a.lse != nullptr && lane == 0)
      a.lse[size_t(bh) * Sq + qi] = valid ? m[r] + logf(l[r]) : fl::kNegInf;
  }
}

template <typename T, int kDPL>
int launch_dpl(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kDPL>;
  const size_t smem = smem_bytes(a.D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(B * a.H, (a.Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch_dpl<T, 1>(a, B, stream);
  if (a.D <= 64) return launch_dpl<T, 2>(a, B, stream);
  if (a.D <= 128) return launch_dpl<T, 4>(a, B, stream);
  if (a.D <= 256) return launch_dpl<T, 8>(a, B, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

PT_DEFINE_PROBE(flash_fwd)

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D] given by element strides
// (batch, seq, head; the last dim is contiguous); o contiguous
// [B, Sq, H, D] of the same dtype (`dtype`: pt::DType f32/bf16/f16).
// lse: f32 [B, H, Sq] or null (not wanted). se: int32 flashmask bands
// by strides (batch — 0 broadcasts —, se head, band; the Sk column
// stride is 1) with h_se se heads, or null. window <= 0 means no window
// (only read when causal). Returns cudaGetLastError() after launch.
extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, const void* se,
    long long se_sb, long long se_sh, long long se_s4, int h_se, int causal,
    int window, float scale, int dtype, void* stream) {
  if (h_se < 1 || H % Hkv != 0 || H % h_se != 0)
    return int(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    o,    static_cast<float*>(lse),
               static_cast<const int*>(se),
               H,    Hkv,  Sq,   Sk,   D,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               se_sb, se_sh, se_s4, h_se, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pt::kF32:
      return launch<float>(a, B, s);
    case pt::kBF16:
      return launch<__nv_bfloat16>(a, B, s);
    case pt::kF16:
      return launch<__half>(a, B, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
