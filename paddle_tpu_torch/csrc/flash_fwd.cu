// Flash-attention forward for Hopper (no-cache LLaMA attention, and the
// forward of training and of the BERT encoder), and the head-dim-64 probe.
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
// Three routes, chosen in `flash_fwd_launch` by dtype and shape
// (`tc::route`; the wrapper's `flash_route` mirrors it):
//
// - tc: bf16 and fp16 operands with a head dim that is a multiple of 8 up
//   to 256 and 16-byte aligned rows — every training path (LLaMA
//   [12, 1024, 32, 128], ERNIE-MoE [32, 512, 16, 64], BERT [256, 128, 12,
//   64]). Head dims up to 128 (every main path) run wgmma fed by TMA
//   (`flash_fwd_wgmma_kernel`, below); larger ones mma.sync m16n8k16 from
//   ldmatrix fragments, K/V through a cp.async ring
//   (`flash_fwd_mma_kernel` with `FwdTc`). Both take f32 accumulators and
//   run the online softmax on them. P is split into P_hi + P_lo, both
//   16-bit, for O += P V: one rounding of P to bf16 (FlashAttention-2/3's
//   arithmetic) fails the port's bf16 gate by ~6-23x, the split passes it
//   at ~0.48, as f32 math does (csrc/flash_tc.cuh,
//   tests/test_torch_flash_tc_arith.py). The split costs 1.5x the
//   tensor-core operations.
// - tf32x3: f32 operands with a head dim that is a multiple of 8 up to 256,
//   16-byte aligned rows and strides that are multiples of 4 elements —
//   the f32 serving paths (LLaMA no-cache forward [2, 1024, 32, 128], the
//   encoder [16, L, 12, 64] with key bands) and the head-dim-64 probe. The
//   same kernel body with `FwdTf32`: mma.sync m16n8k8 on tf32 operands,
//   each product taken as big big + big small + small big (3xTF32), which
//   holds the f32 gate (atol 1e-4 of max(1, max |ref|)) that one TF32
//   product misses.
// - simt: what the other two refuse (an odd head dim, unaligned rows).
//   f32 math on the CUDA cores (`flash_fwd_kernel`): one block per
//   (batch*head, 64-row q tile), 4 warps of 16 rows each; K/V stream
//   through shared memory 32 keys at a time (one key column per lane); q,
//   K and the probabilities are read as 16-byte vectors from shared
//   memory so the inner loops are FMA- rather than load-bound; m/l/acc
//   stay in registers in f32.
//
// What bounds it on an H100: at the LLaMA training shape bytes and
// operations nearly tie (~400 MB of q, k, v and out at 3.35 TB/s; ~103
// GFLOP of S and P V at the bf16 peak); at BERT's S 128, bytes. The tc
// route issues 1.5x those operations (the split); f32-grade results on
// the tensor cores take 3x
// the operations at the TF32 peak (495 TFLOP/s), so the tf32x3 route's
// bound at the LLaMA serving shape (17.2 GFLOP counted) is operations.
// PERF.md keeps the times beside the bounds. Every route runs the key
// tiles that meet the causal band and the window only, and skips a tile
// whose every row one flashmask band covers before its K/V are loaded
// (the document mask's cross-document tiles).
#include "flash_tc.cuh"
#include "grouped_gemm_tc.cuh"

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

// S = q K^T for one warp's kRows rows (r0, r0 + kRows) of the staged
// q tile q_s [.][dp] against the staged key tile k_s [kBK][dp + 4]: lane
// owns key column `lane`. q and K are read as 16-byte vectors, so the
// loop is FMA- rather than load-bound.
__device__ __forceinline__ void warp_qk(const float* __restrict__ q_s,
                                        const float* __restrict__ k_s,
                                        int dp, int r0, int lane,
                                        float (&s)[kRows]) {
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
}

// acc += P V for the same warp's rows: P from p_s [.][kBK], V from the
// staged tile v_s [kBK][dp]; lane owns output columns lane + 32 * i
// (kDPL of them: 2 at head dim 64).
template <int kDPL>
__device__ __forceinline__ void warp_pv(const float* __restrict__ p_s,
                                        const float* __restrict__ v_s,
                                        int dp, int r0, int lane,
                                        float (&acc)[kRows][kDPL]) {
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
    warp_qk(q_s, k_s, dp, r0, lane, s);
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

    warp_pv(p_s, v_s, dp, r0, lane, acc);
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

// ------------------------------------------------- tc and tf32x3 routes --
//
// One kernel body, `flash_fwd_mma_kernel<C>`, for both tensor-core routes;
// the traits C name the operand type, the tile shape and the two products.
// One block per (batch * head, kBQ-row q tile); each warp owns kM m16
// row tiles, so each K/V fragment it loads feeds kM products. The q tile
// is copied once by cp.async; K/V tiles of kBK keys stream through a
// 2-stage cp.async ring in padded shared memory, with one barrier a tile.
// S = Q K^T into f32 accumulators; the online softmax runs on the
// accumulators (scale applied in f32, exp2 with scale * log2e folded in,
// masks only on tiles the band, window, bands or the ragged key edge
// reach); O += P V with P taken from the accumulators as the A operand
// and split (16-bit hi + lo, or tf32 big + small); l is summed from the
// unsplit P.
//
// - FwdTc (bf16/fp16, head dims above 128 since the wgmma kernel took the
//   rest): mma.sync m16n8k16 from ldmatrix fragments (rows of kD + 8
//   elements: ldmatrix reads are conflict-free), one row tile a warp.
// - FwdTf32 (f32): mma.sync m16n8k8 on tf32 operands, 3xTF32 (each
//   product big big + big small + small big, csrc/flash_tc.cuh), fragments
//   read by 32-bit loads from rows of kD + 8 (Q, K) and kD + 4 (V) words,
//   split as they are read. Shared memory is twice the 16-bit kernel's per
//   element, so every head dim runs one row tile a warp and 32-key tiles:
//   64-row q tiles, two blocks an SM at head dim 128, and twice the blocks
//   of 128-row tiles at the encoder's short sequences (a comparison on the
//   card found two row tiles a warp no faster at head dim 128, where they
//   spill, and slower at 64).

template <typename T, int kD_>
struct FwdTc {
  using Elem = T;
  static constexpr int kD = kD_;
  static_assert(kD == 256, "the wgmma kernel takes tile head dims <= 128");
  static constexpr int kWarps = 8;                  // warps per block
  static constexpr int kM = 1;                      // m16 row tiles a warp
  static constexpr int kBK = 32;                    // keys per tile
  static constexpr int kLdQ = kD + 8, kLdK = kD + 8, kLdV = kD + 8;
  static constexpr int kNT = kBK / 8;               // S n8 tiles per row tile
  static constexpr int kDT = kD / 8;                // O n8 tiles per row tile
  static __device__ __forceinline__ void qk(const T* q_s, const T* k_s,
                                            int r0, int lane,
                                            float (&s)[kM][kNT][4]) {
    tc::warp_abt<T, kM, kNT, kD, kLdQ, kLdK>(q_s, k_s, r0, lane, s);
  }
  static __device__ __forceinline__ void pv(const float (&p)[kM][kNT][4],
                                            const T* v_s, int lane,
                                            float (&acc)[kM][kDT][4]) {
    tc::warp_pb_split<T, kM, kNT, kDT, kLdV>(p, v_s, 0, lane, acc);
  }
  static __device__ __forceinline__ void store2(T* p, float x, float y) {
    *reinterpret_cast<unsigned*>(p) = tc::pack2<T>(x, y);
  }
};

template <int kD_>
struct FwdTf32 {
  using Elem = float;
  static constexpr int kD = kD_;
  static constexpr int kWarps = 4;
  static constexpr int kM = 1;
  static constexpr int kBK = 32;
  static constexpr int kLdQ = kD + 8, kLdK = kD + 8, kLdV = kD + 4;
  static constexpr int kNT = kBK / 8;
  static constexpr int kDT = kD / 8;
  static __device__ __forceinline__ void qk(const float* q_s,
                                            const float* k_s, int r0,
                                            int lane,
                                            float (&s)[kM][kNT][4]) {
    tc::warp_abt_tf32x3<kM, kNT, kD, kLdQ, kLdK>(q_s, k_s, r0, lane, s);
  }
  static __device__ __forceinline__ void pv(const float (&p)[kM][kNT][4],
                                            const float* v_s, int lane,
                                            float (&acc)[kM][kDT][4]) {
    tc::warp_pb_tf32x3<kM, kNT, kDT, kLdV>(p, v_s, lane, acc);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// The block shape and shared memory of a traits struct C.
template <class C>
struct Tile {
  static constexpr int kThreads = 32 * C::kWarps;
  static constexpr int kBQ = 16 * C::kM * C::kWarps;  // query rows a block
  static constexpr size_t smem() {
    // q [kBQ][kLdQ], K [2][kBK][kLdK], V [2][kBK][kLdV], bands [2][4][kBK]
    return sizeof(typename C::Elem) *
               (size_t(kBQ) * C::kLdQ + 2 * size_t(C::kBK) * (C::kLdK + C::kLdV)) +
           sizeof(int) * 8 * size_t(C::kBK);
  }
};

template <class C>
__global__ void __launch_bounds__(Tile<C>::kThreads)
    flash_fwd_mma_kernel(Args a) {
  using T = typename C::Elem;
  constexpr int kD = C::kD, kBK = C::kBK, kM = C::kM;
  constexpr int kLdQ = C::kLdQ, kLdK = C::kLdK, kLdV = C::kLdV;
  constexpr int kNT = C::kNT, kDT = C::kDT;
  constexpr int kBQ = Tile<C>::kBQ, kThreads = Tile<C>::kThreads;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / a.Hkv);
  // the last q tiles (the longest under a causal band) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 * kM;  // this warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* q_s = reinterpret_cast<T*>(smem_tc);                   // [kBQ][kLdQ]
  T* k_s = q_s + kBQ * kLdQ;                                // [2][kBK][kLdK]
  T* v_s = k_s + 2 * kBK * kLdK;                            // [2][kBK][kLdV]
  int* se_s = reinterpret_cast<int*>(v_s + 2 * kBK * kLdV);  // [2][4][kBK]
  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;
  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kBK, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);
  // the first key tile at or after kt that the bands do not cover whole
  // (every warp computes the same answer: the skip is block-uniform)
  auto next = [&](int kt) {
    if (seb != nullptr)
      while (kt < kt_hi &&
             fl::tile_full(fl::warp_band_extremes<kBK>(seb, a.se_s4, kt * kBK,
                                                       Sk, lane),
                           q0, q_end))
        ++kt;
    return kt;
  };
  // start the copy of key tile kt (when there is one) into stage st
  auto load_kv = [&](int kt, int st) {
    if (kt < kt_hi) {
      const int k0 = kt * kBK;
      tc::load_tile<T, kBK, kD, kLdK, kThreads>(k_s + st * kBK * kLdK, kb,
                                                a.k_ss, k0, Sk, D, tid);
      tc::load_tile<T, kBK, kD, kLdV, kThreads>(v_s + st * kBK * kLdV, vb,
                                                a.v_ss, k0, Sk, D, tid);
      if (seb != nullptr && tid < kBK) {
        const fl::Bands bj = fl::load_bands(seb, a.se_s4, k0 + tid, Sk);
        int* s = se_s + st * 4 * kBK + tid;
        s[0] = bj.lts;
        s[kBK] = bj.lte;
        s[2 * kBK] = bj.uts;
        s[3 * kBK] = bj.ute;
      }
    }
    tc::cp_async_commit();  // one group a tile, empty past the last one
  };

  tc::load_tile<T, kBQ, kD, kLdQ, kThreads>(
      q_s, q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, Sq, D, tid);
  int kt = next(kt_lo);
  load_kv(kt, 0);  // one group: q and the first key tile

  float acc[kM][kDT][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  // the running max of scale log2e S, and this thread's share of the row
  // sum, of rows g and g + 8 of each row tile
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mi][h] = -INFINITY;
      l[mi][h] = 0.f;
    }
  const float sl2 = a.scale * tc::kLog2e;

  for (int st = 0; kt < kt_hi; st ^= 1) {
    tc::cp_async_wait<0>();
    // tile kt (and q) landed for every thread, and every warp is done
    // with the tile before it, whose stage the next copy refills
    __syncthreads();
    const int kn = next(kt + 1);
    load_kv(kn, st ^ 1);
    const int k0 = kt * kBK;

    // S = Q K^T for this warp's kM x 16 rows x kBK keys
    float s[kM][kNT][4];
    C::qk(q_s, k_s + st * kBK * kLdK, r0, lane, s);

    // masks, only where the band, the window, the bands or the ragged
    // key edge reach into the tile
    const bool masked =
        seb != nullptr || k0 + kBK > Sk ||
        (a.causal && (q0 + diag < k0 + kBK - 1 ||
                      (a.window > 0 && q_end - 1 + diag - k0 >= a.window)));
    if (masked) {
      const int* sst = se_s + st * 4 * kBK;
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + r0 + 16 * mi + g + ((e >> 1) << 3);
            const int jl = n * 8 + 2 * t + (e & 1);
            bool keep = fl::band_keep(qi, k0 + jl, Sq, Sk, a.causal,
                                      a.window, diag);
            if (seb != nullptr)
              keep = keep &&
                     !fl::band_masked(
                         fl::Bands{sst[jl], sst[kBK + jl], sst[2 * kBK + jl],
                                   sst[3 * kBK + jl]},
                         qi);
            if (!keep) s[mi][n][e] = -INFINITY;
          }
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1) of each row
    // tile; a quad of lanes shares a row
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mx = fmaxf(mx, fmaxf(s[mi][n][2 * h], s[mi][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mi][h], mx * sl2);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[mi][h] - base);
        m[mi][h] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = exp2f(fmaf(s[mi][n][2 * h + j], sl2, -base));
            s[mi][n][2 * h + j] = p;
            rs += p;
          }
        l[mi][h] = l[mi][h] * alpha + rs;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          acc[mi][n][2 * h] *= alpha;
          acc[mi][n][2 * h + 1] *= alpha;
        }
      }

    // O += P V, the accumulators of S as the A operand
    C::pv(s, v_s + st * kBK * kLdV, lane, acc);
    kt = kn;
  }
  tc::cp_async_wait<0>();

  // a row is valid when it saw a key (l > 0); lse = (m + log2 l) ln 2
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mi][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int qi = q0 + r0 + 16 * mi + g + 8 * h;
      if (qi >= Sq) continue;
      const bool valid = lh > 0.f;
      const float inv = valid ? 1.f / lh : 0.f;
      T* orow = o + ((size_t(b) * Sq + qi) * H + hq) * size_t(D);
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < D)
          C::store2(orow + c, acc[mi][n][2 * h] * inv,
                    acc[mi][n][2 * h + 1] * inv);
      }
      if (a.lse != nullptr && t == 0)
        a.lse[size_t(bh) * Sq + qi] =
            valid ? (m[mi][h] + log2f(lh)) * tc::kLn2 : fl::kNegInf;
    }
}

template <class C>
int launch_mma_d(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<C>;
  const size_t smem = Tile<C>::smem();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(B * a.H, (a.Sq + Tile<C>::kBQ - 1) / Tile<C>::kBQ);
  kernel<<<grid, Tile<C>::kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <template <int> class C>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  switch (tc::tile_d(a.D)) {
    case 32: return launch_mma_d<C<32>>(a, B, stream);
    case 64: return launch_mma_d<C<64>>(a, B, stream);
    case 128: return launch_mma_d<C<128>>(a, B, stream);
    default: return launch_mma_d<C<256>>(a, B, stream);
  }
}

// ------------------------------------------- tc route: the wgmma kernel --
//
// `flash_fwd_wgmma_kernel<C>`: the tc route's forward at tile head dims 64
// and 128 (head dims up to 128; `launch_tc`), on Hopper's wgmma with TMA.
// One block per (batch * head, 64-row q tile), the shape of the
// grouped-FFN mainloop (csrc/grouped_gemm_tc.cuh, whose barrier, TMA,
// descriptor and tensor-map helpers it uses) cut to one consumer
// warpgroup and a producer warp, several blocks an SM. Its products, the
// producer's walk and the fragment split are the ones the backward's
// wgmma kernels use too (csrc/flash_tc.cuh `wg`).
//
// - The producer warp loads Q once and then K and V tiles of kBN keys
//   into a ring of kStages stages with full/empty mbarriers, through 4-D
//   tensor maps over (D, heads, S, B) with the caller's strides (no copy
//   of a strided view). A row of a tile is one or two 64-column slabs of
//   128 bytes (128B swizzle, as the grouped FFN's MN-major boxes); TMA
//   writes zeros past D, Sq and Sk.
// - The producer alone decides which key tiles a block visits: the causal
//   band and the window (fl::k_tile_range), minus the tiles one flashmask
//   band covers whole (the same skip as the mma.sync kernel, before the
//   K/V loads). With each stage it writes the tile's index and its key
//   columns' bands into shared memory; a stage with index -1 ends the
//   walk. The consumers follow that sequence, so the two sides cannot
//   disagree on it (a disagreement would deadlock on a barrier).
// - The consumer warpgroup computes S = Q K^T by wgmma m64n{kBN}k16 (Q and
//   K from shared memory, both K-major) into f32 accumulators; the masks
//   and the online softmax on the accumulators (scale and exp2 in f32, as
//   the mma.sync kernel); P split into 16-bit P_hi + P_lo; O += P_hi V +
//   P_lo V by wgmma m64n{kD}k16 with A from registers and V from shared
//   memory, MN-major (the transpose bit). The A fragment of each warp's
//   16 rows has the layout of the accumulator of S
//   (tests/test_torch_flash_tc_arith.py emulates both maps), so P turns
//   into its fragments in place. l is summed from the unsplit P.
// - It issues S of tile j together with O's products of tile j - 1 (P_hi
//   and P_lo stay live in registers until those retire), so its softmax
//   of tile j runs while its O products do; the stage of tile j - 1 is
//   released once they have retired. The other blocks of the SM (3 or 4,
//   Fwd64 / Fwd128) fill the tensor cores while this one runs its softmax,
//   loads or stores: at every main-path shape that beat two warpgroups a
//   block taking turns (FlashAttention-3's ping-pong) and larger key
//   tiles (PERF.md).
// - The branches around the products depend only on values the compiler
//   knows to be the same in every lane (the role and the tile index
//   broadcast by __shfl_sync): a product on a path it thinks divergent is
//   serialized (ptxas C7518).
// What bounds it: at the LLaMA training shape the tensor cores (S and the
// split O products, 1.5x the second product's operations); at BERT's S
// 128 the bytes and each block's fill and drain.

namespace fwg {

constexpr int kBQ = 64;                    // query rows a block
constexpr int kConsumers = 128;            // the consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// tile head dim kD (64 or 128), keys per tile kBN (32, 64 or 128),
// stages, blocks an SM kBlocks (one block's loads, softmax and stores
// overlap another's products)
template <typename T, int kD_, int kBN_, int kStages_, int kBlocks_>
struct Cfg {
  using Elem = T;
  static constexpr int kD = kD_, kBN = kBN_, kStages = kStages_;
  static constexpr int kBlocks = kBlocks_;
  static constexpr int kSlabs = kD / 64;   // 64-column slabs of a row
  static constexpr int kQSlab = kBQ * 128;  // bytes of a Q slab
  static constexpr int kKSlab = kBN * 128;  // bytes of a K or V slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kStageBytes = 2 * kKBytes;  // K, then V
  static constexpr int kInfo = 4 * kBN + 1;        // bands [4][kBN], kt
  static constexpr int kBarOff =
      (kQBytes + kStages * kStageBytes + kStages * kInfo * 4 + 7) & ~7;
  static constexpr int kSmemBytes = 1024 + kBarOff + (2 * kStages + 1) * 8;
  static_assert(kD == 64 || kD == 128, "tile head dim");
  static_assert(kBlocks * (kSmemBytes + 1024) <= 233472,
                "the blocks of an SM fit its shared memory");
  static_assert(kBN == 32 || kBN == 64 || kBN == 128, "keys per tile");
};

// The shared memory of a block: Q slabs, the stages (K slabs, V slabs),
// each stage's info (its key tile's bands and index), the barriers.
template <class C>
struct Smem {
  uint32_t base;  // shared address, 1024-byte aligned
  int* info;      // [kStages][kInfo]
  __device__ __forceinline__ uint32_t q(int slab) const {
    return base + slab * C::kQSlab;
  }
  __device__ __forceinline__ uint32_t k(int s, int slab) const {
    return base + C::kQBytes + s * C::kStageBytes + slab * C::kKSlab;
  }
  __device__ __forceinline__ uint32_t v(int s, int slab) const {
    return k(s, slab) + C::kKBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + C::kBarOff + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full(C::kStages + s);
  }
  __device__ __forceinline__ uint32_t qbar() const {
    return full(2 * C::kStages);
  }
};

struct Maps {
  CUtensorMap q, k, v;
};

// S = Q K^T of the tile in stage s (one wgmma group)
template <class C>
__device__ __forceinline__ void qk(float (&sc)[C::kBN / 2], const Smem<C>& sm,
                                   int s) {
  wg::ss<typename C::Elem, C::kBN, C::kD>(sc, sm.q(0), C::kQSlab, sm.k(s, 0),
                                          C::kKSlab);
}

// O += P_hi V + P_lo V of the tile in stage s (one wgmma group)
template <class C>
__device__ __forceinline__ void pv(float (&o)[C::kD / 2],
                                   const unsigned (&ph)[C::kBN / 16][4],
                                   const unsigned (&pl)[C::kBN / 16][4],
                                   const Smem<C>& sm, int s) {
  wg::rs_split<typename C::Elem, C::kD, C::kBN>(o, ph, pl, sm.v(s, 0),
                                                C::kKSlab);
}

// The masks of key tile kt (only where the band, the window, the bands in
// `info` or the ragged key edge reach into it; block rows [q0, q_end),
// this thread's rows qr and qr + 8, key columns 8 jj + 2 t (+1)), then the
// online softmax of the thread's two rows (a quad of lanes shares a row):
// P in sc, l updated, O's rescale in alpha.
template <class C>
__device__ __forceinline__ void softmax(float (&sc)[C::kBN / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Args& a, const int* seb,
                                        const int* info, int kt, int q0,
                                        int q_end, int qr, int t, float sl2) {
  constexpr int kBN = C::kBN;
  const int Sq = a.Sq, Sk = a.Sk, diag = Sk - Sq;
  const int k0 = kt * kBN;
  const bool masked =
      seb != nullptr || k0 + kBN > Sk ||
      (a.causal && (q0 + diag < k0 + kBN - 1 ||
                    (a.window > 0 && q_end - 1 + diag - k0 >= a.window)));
  if (masked) {
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qr + ((e >> 1) << 3);
        const int jl = 8 * jj + 2 * t + (e & 1);
        bool keep =
            fl::band_keep(qi, k0 + jl, Sq, Sk, a.causal, a.window, diag);
        if (seb != nullptr)
          keep = keep &&
                 !fl::band_masked(fl::Bands{info[jl], info[kBN + jl],
                                            info[2 * kBN + jl],
                                            info[3 * kBN + jl]},
                                  qi);
        if (!keep) sc[4 * jj + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * h], sc[4 * jj + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * sl2);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = wg::exp2_ftz(m[h] - base);
    m[h] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p =
            wg::exp2_ftz(fmaf(sc[4 * jj + 2 * h + c], sl2, -base));
        sc[4 * jj + 2 * h + c] = p;
        rs += p;
      }
    l[h] = l[h] * alpha[h] + rs;
  }
}

// the key tile in stage s (-1: the walk has ended), the same in every lane
// for the compiler
template <class C>
__device__ __forceinline__ int tile_at(const Smem<C>& sm, int s) {
  return wg::uniform(sm.info + s * C::kInfo + 4 * C::kBN);
}

template <class C>
__global__ void __launch_bounds__(kThreads, C::kBlocks)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, Args a) {
  using T = typename C::Elem;
  constexpr int kD = C::kD, kBN = C::kBN, S = C::kStages;
  constexpr int kSlabs = C::kSlabs, kInfo = C::kInfo;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk;
  // one block per (batch * head, q tile), q tiles fastest, so the blocks
  // in flight share heads and their K/V stay in L2; the last q tiles of a
  // head (the longest under a causal band) start first
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / a.Hkv);
  const int q0 = (nq - 1 - (blockIdx.x - bh * nq)) * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int diag = Sk - Sq;
  const int lane = threadIdx.x % 32;

  extern __shared__ uint8_t smem_wg[];
  const uint32_t base = wg::aligned_base(smem_wg);
  const Smem<C> sm{base, reinterpret_cast<int*>(
                             smem_wg + (base - ggtc::smem_u32(smem_wg)) +
                             C::kQBytes + S * C::kStageBytes)};
  wg::init_barriers<S, kConsumers>(sm,
                                   [&] { ggtc::mbar_init(sm.qbar(), 1); });
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;
  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kBN, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);

  // producer or consumer, known to the compiler as the same in every
  // lane, so that the products below are not on a divergent path (which
  // would serialize them)
  if (wg::is_producer<kConsumers>()) {
    // -- the producer warp --
    if (lane == 0) {
      ggtc::mbar_expect_tx(sm.qbar(), C::kQBytes);
#pragma unroll
      for (int c = 0; c < kSlabs; ++c)
        ggtc::tma_load4(sm.q(c), &maps.q, sm.qbar(), 64 * c, hq, q0, b);
    }
    wg::produce_kv<C>(sm, &maps.k, &maps.v, kt_lo, kt_hi, seb, a.se_s4, Sk,
                      q0, q_end, hk, b, lane);
  } else {
    // -- the consumer warpgroup --
    const int g = lane / 4, t = lane % 4;
    // this thread's rows (h = 0, 1) in the block: the warp's 16
    const int r0 = (threadIdx.x / 32) * 16 + g;
    const float sl2 = a.scale * tc::kLog2e;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[kBN / 2];
    // P_hi and P_lo of the last tile, live until its products retire
    unsigned ph[kBN / 16][4], pl[kBN / 16][4];
    const int qr = q0 + r0;

    // S of tile j is issued with O's products of tile j - 1 (P_hi and P_lo
    // stay live until those retire): the softmax of tile j runs while
    // they do.
    ggtc::mbar_wait(sm.qbar(), 0);
    ggtc::mbar_wait(sm.full(0), 0);
    int kt = tile_at(sm, 0);
    if (kt >= 0) {
      float alpha[2];
      ggtc::wgmma_fence();
      qk(sc, sm, 0);
      ggtc::wgmma_wait<0>();
      ggtc::fence_acc(sc);
      // O is 0: nothing to rescale
      softmax<C>(sc, m, l, alpha, a, seb, sm.info, kt, q0, q_end, qr, t,
                 sl2);
      wg::split<T, kBN>(sc, ph, pl);
      int s_prev = 0;
      for (int j = 1;; ++j) {
        const int s = j % S;
        ggtc::mbar_wait(sm.full(s), (j / S) & 1);
        kt = tile_at(sm, s);
        if (kt < 0) break;
        ggtc::wgmma_fence();
        qk(sc, sm, s);
        pv(o, ph, pl, sm, s_prev);
        ggtc::wgmma_wait<1>();  // S (the O products may still run)
        ggtc::fence_acc(sc);
        softmax<C>(sc, m, l, alpha, a, seb, sm.info + s * kInfo, kt, q0,
                   q_end, qr, t, sl2);
        ggtc::wgmma_wait<0>();  // the previous tile's O products
        ggtc::fence_acc(o);
        wg::fence(ph);
        wg::fence(pl);
        if (lane == 0) ggtc::mbar_arrive(sm.empty(s_prev));
#pragma unroll
        for (int jj = 0; jj < kD / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * jj + e] *= alpha[e >> 1];
        wg::split<T, kBN>(sc, ph, pl);
        s_prev = s;
      }
      ggtc::wgmma_fence();
      pv(o, ph, pl, sm, s_prev);  // the last tile's O products
      ggtc::wgmma_wait<0>();
      ggtc::fence_acc(o);
    }

    // a row is valid when it saw a key (l > 0); lse = (m + log2 l) ln 2
    T* ob = static_cast<T*>(a.o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int qi = q0 + r0 + 8 * h;
      if (qi >= Sq) continue;
      const bool valid = lh > 0.f;
      const float inv = valid ? 1.f / lh : 0.f;
      T* orow = ob + ((size_t(b) * Sq + qi) * H + hq) * size_t(a.D);
#pragma unroll
      for (int jj = 0; jj < kD / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c < a.D)
          *reinterpret_cast<unsigned*>(orow + c) = tc::pack2<T>(
              o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
      }
      if (a.lse != nullptr && t == 0)
        a.lse[size_t(bh) * Sq + qi] =
            valid ? (m[h] + log2f(lh)) * tc::kLn2 : fl::kNegInf;
    }
  }
}

}  // namespace fwg

// The wgmma kernel's configurations by tile head dim: 32 keys a tile, 4
// stages and 4 blocks an SM at 64, 3 and 3 at 128 (chosen by timing them
// against 64- and 128-key tiles on the card; PERF.md). Small blocks, many
// to an SM, win at every main-path shape: the blocks overlap one
// another's loads, softmax and stores.
template <typename T>
using Fwd64 = fwg::Cfg<T, 64, 32, 4, 4>;
template <typename T>
using Fwd128 = fwg::Cfg<T, 128, 32, 3, 3>;

// One launch of the wgmma kernel (tile head dim 64 or 128): the tensor
// maps over (D, heads, S, B) with the caller's strides, then the grid.
template <class C>
int launch_wgmma_d(const Args& a, int B, int dtype, cudaStream_t stream) {
  constexpr int kBN = C::kBN;
  fwg::Maps maps{};
  if (!wg::make_map_bshd(&maps.q, a.q, dtype, a.D, a.H, a.Sq, B, a.q_sh,
                         a.q_ss, a.q_sb, fwg::kBQ) ||
      !wg::make_map_bshd(&maps.k, a.k, dtype, a.D, a.Hkv, a.Sk, B, a.k_sh,
                         a.k_ss, a.k_sb, kBN) ||
      !wg::make_map_bshd(&maps.v, a.v, dtype, a.D, a.Hkv, a.Sk, B, a.v_sh,
                         a.v_ss, a.v_sb, kBN))
    return int(cudaErrorInvalidValue);
  auto kernel = fwg::flash_fwd_wgmma_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return int(e);
  const long long blocks =
      (long long)((a.Sq + fwg::kBQ - 1) / fwg::kBQ) * B * a.H;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), fwg::kThreads, C::kSmemBytes, stream>>>(maps,
                                                                     a);
  return int(cudaGetLastError());
}

// The tc route: the wgmma kernel where tc::wgmma holds (tile head dims up
// to 128), the mma.sync kernel (FwdTc) above; *kernel says which
// (tc::Launched).
template <typename T>
int launch_tc(const Args& a, int B, int dtype, cudaStream_t stream,
              int* kernel) {
  if (!tc::wgmma(a.D)) {
    *kernel = tc::kLaunchedMma;
    return launch_mma_d<FwdTc<T, 256>>(a, B, stream);
  }
  *kernel = tc::kLaunchedWgmma;
  if (tc::tile_d(a.D) <= 64)
    return launch_wgmma_d<Fwd64<T>>(a, B, dtype, stream);
  return launch_wgmma_d<Fwd128<T>>(a, B, dtype, stream);
}

// The head-dim-64 probe (row 5): one block computes s = x x^T ([128, 128],
// f32) and o = s x ([128, 64]) for an f32 x [128, 64] with the tf32x3
// route's own tiles at head dim 64 (FwdTf32<64>: its warps, row tiles,
// key tiles and padded shared-memory rows), 64-row tile by tile: S by
// `qk`, then O += S V by `pv` with S in the accumulators as P stands there
// in the forward, without the softmax. On the probe's input (integers in
// [-3, 3]) every entry of s is an integer of magnitude <= 576 < 2^11 and
// every entry of o one below 2^24, so each tf32 split is exact (small
// terms 0) and so is every sum: the answer must equal (x x^T) x bit for
// bit.
using Probe = FwdTf32<64>;
constexpr int kProbeRows = 128;
static_assert(kProbeRows % Tile<Probe>::kBQ == 0 &&
                  kProbeRows % Probe::kBK == 0,
              "the probe's rows are whole row and key tiles");

constexpr size_t probe_smem() {
  return sizeof(float) * (size_t(Tile<Probe>::kBQ) * Probe::kLdQ +
                          size_t(Probe::kBK) * (Probe::kLdK + Probe::kLdV));
}

__global__ void __launch_bounds__(Tile<Probe>::kThreads)
    minor64_probe_kernel(const float* __restrict__ x, float* __restrict__ o) {
  using C = Probe;
  constexpr int kBK = C::kBK, kD = C::kD, kM = C::kM;
  constexpr int kBQ = Tile<C>::kBQ, kThreads = Tile<C>::kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 * kM;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_probe[];
  float* q_s = reinterpret_cast<float*>(smem_probe);  // [kBQ][kLdQ]
  float* k_s = q_s + kBQ * C::kLdQ;                     // [kBK][kLdK]
  float* v_s = k_s + kBK * C::kLdK;                     // [kBK][kLdV]
  for (int q0 = 0; q0 < kProbeRows; q0 += kBQ) {
    float acc[kM][C::kDT][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int n = 0; n < C::kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
    for (int k0 = 0; k0 < kProbeRows; k0 += kBK) {
      __syncthreads();  // the previous row and key tiles are consumed
      if (k0 == 0)
        tc::load_tile<float, kBQ, kD, C::kLdQ, kThreads>(
            q_s, x, kD, q0, kProbeRows, kD, tid);
      tc::load_tile<float, kBK, kD, C::kLdK, kThreads>(k_s, x, kD, k0,
                                                       kProbeRows, kD, tid);
      tc::load_tile<float, kBK, kD, C::kLdV, kThreads>(v_s, x, kD, k0,
                                                       kProbeRows, kD, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      float s[kM][C::kNT][4];
      C::qk(q_s, k_s, r0, lane, s);
      C::pv(s, v_s, lane, acc);
    }
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* orow = o + size_t(q0 + r0 + 16 * mi + g + 8 * h) * kD;
#pragma unroll
        for (int n = 0; n < C::kDT; ++n)
          C::store2(orow + n * 8 + 2 * t, acc[mi][n][2 * h],
                    acc[mi][n][2 * h + 1]);
      }
  }
}

}  // namespace

PT_DEFINE_PROBE(flash_fwd)

// The head-dim-64 probe, replacing `_pallas_minor64_supported`
// (paddle_tpu/kernels/flash_attention.py:801, its pl.pallas_call at :827):
// x f32 contiguous [128, 64] -> o f32 contiguous [128, 64] = (x x^T) x.
// The wrapper (kernels/flash_attention.py `probe_minor64`) checks the
// answer and raises when it is wrong. Returns cudaGetLastError().
extern "C" int flash_fwd_minor64_probe(const void* x, void* o, void* stream) {
  const size_t smem = probe_smem();
  cudaError_t e = cudaFuncSetAttribute(
      minor64_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  minor64_probe_kernel<<<1, Tile<Probe>::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o));
  return int(cudaGetLastError());
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D] given by element strides
// (batch, seq, head; the last dim is contiguous); o contiguous
// [B, Sq, H, D] of the same dtype (`dtype`: pt::DType f32/bf16/f16).
// lse: f32 [B, H, Sq] or null (not wanted). se: int32 flashmask bands
// by strides (batch — 0 broadcasts —, se head, band; the Sk column
// stride is 1) with h_se se heads, or null. window <= 0 means no window
// (only read when causal). *kernel (unless null) is set to the kernel
// the launch ran (tc::Launched: 0 simt, 1 tf32x3, 2 tc mma.sync, 3 tc
// wgmma). Returns cudaGetLastError() after launch.
extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, const void* se,
    long long se_sb, long long se_sh, long long se_s4, int h_se, int causal,
    int window, float scale, int dtype, void* stream, int* kernel) {
  if (h_se < 1 || H % Hkv != 0 || H % h_se != 0)
    return int(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    o,    static_cast<float*>(lse),
               static_cast<const int*>(se),
               H,    Hkv,  Sq,   Sk,   D,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               se_sb, se_sh, se_s4, h_se, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {q, k, v};
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  const tc::Route r = tc::route(tc::kFwd, dtype, D, ptrs, 3, strides, 9);
  int launched = r == tc::kTf32x3 ? tc::kLaunchedTf32x3 : tc::kLaunchedSimt;
  int err;
  switch (dtype) {
    case pt::kF32:
      err = r == tc::kTf32x3 ? launch_mma<FwdTf32>(a, B, s)
                             : launch<float>(a, B, s);
      break;
    case pt::kBF16:
      err = r == tc::kTc ? launch_tc<__nv_bfloat16>(a, B, dtype, s, &launched)
                         : launch<__nv_bfloat16>(a, B, s);
      break;
    case pt::kF16:
      err = r == tc::kTc ? launch_tc<__half>(a, B, dtype, s, &launched)
                         : launch<__half>(a, B, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (kernel != nullptr) *kernel = launched;
  return err;
}
