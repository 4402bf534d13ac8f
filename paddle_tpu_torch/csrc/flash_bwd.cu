// Flash-attention backward for Hopper: the dQ kernel and the dK/dV
// kernel of FlashAttention-2's recompute scheme.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` launched by `_flash_pallas_bwd`
// (paddle_tpu/kernels/flash_attention.py:452, :521, :601). Same math:
// S = scale * q k^T under the causal band / window / flashmask bands of
// the forward, P = exp(S - lse) (zero for a row whose lse is NEG_INF),
// dP = dO V^T, dS = P * (dP - Delta) with Delta = rowsum(dO * O)
// computed by the wrapper in f32, then dQ = scale * dS K,
// dK = scale * dS^T Q and dV = P^T dO. Inputs are read by strides in the
// paddle [B, S, H, D] layout, ragged edges are masked here, and
// sq != sk goes through diag_off = sk - sq like the forward.
//
// Each kernel takes one of two routes, chosen in its entry by dtype and
// shape (`tc::route`, the rule the forward shares; the wrapper's
// `flash_route` mirrors it): tc for bf16 with a head dim that is a
// multiple of 8 up to 256 and 16-byte aligned rows (every training path),
// simt for the rest — f32, fp16 (whose exponent range cannot carry dS's
// 16-bit split: csrc/flash_tc.cuh), odd head dims, unaligned rows. On tc
// the kernel follows the forward's rule (`tc::wgmma`): at head dims up to
// 128 (every main path) the wgmma kernels, at 136-256 the mma.sync ones.
// Each entry reports the kernel it ran (its last argument).
//
// - dQ, tc: `flash_bwd_dq_wgmma_kernel` (wgmma fed by TMA, the forward's
//   block shape; below) and `flash_bwd_dq_tc_kernel` (mma.sync m16n8k16
//   from ldmatrix fragments through a cp.async ring, tile head dim 256);
//   both split dS into bf16 hi + lo for dQ += dS K. simt
//   (`flash_bwd_dq_kernel`): one block per (batch*head, 64-row q tile), 4
//   warps of 16 rows. Q (pre-scaled), dO, lse and Delta are staged once;
//   K and V stream through shared memory 32 keys at a time over the key
//   tiles the band and window allow. Per tile S and dP are recomputed
//   (lane = key column), dS goes through shared memory, and dS K
//   accumulates in f32 registers (lane = output column).
// - dK/dV: here the port departs from the Pallas block structure, which
//   writes per-q-head partials in k's dtype and sums a GQA group
//   afterwards. A block keeps a key tile's K and V in shared memory and
//   loops over the group's rep query heads and over the q tiles the band
//   and window allow. dK and dV accumulate in f32 registers across the
//   whole group and are written once: no partial buffer, no second pass,
//   no atomics, and the result is deterministic.
//   - tc: `flash_bwd_dkv_wgmma_kernel` (wgmma fed by TMA, keys as the M
//     dimension, persistent over key tiles; below) and
//     `flash_bwd_dkv_tc_kernel` (mma.sync tiles, Q/dO streamed through a
//     cp.async ring, tile head dim 256: eight warps, two per 16-key row,
//     each owning half of dK's and dV's columns); both split P^T and dS^T
//     into bf16 hi + lo terms for the second products (one bf16 rounding
//     fails the port's gate ~9-23x, the split passes it at ~0.48;
//     csrc/flash_tc.cuh).
//   - simt: `flash_bwd_dkv_kernel`, 8 warps of 8 keys, 32-row q tiles
//     (lane = row), f32 FMA on the CUDA cores.
//
// Every kernel skips a tile whose every row one flashmask band covers
// before its operands are staged, and reads the same lse and Delta.
//
// What bounds them on an H100: arithmetic. A backward pass does 2.5x the
// forward's operations (S once more, dP, dV, dK, dQ); these kernels
// recompute S and dP in each of the two kernels, so they do 3.5x (the tc
// route 1.5x that on the split products). The simt inner loops read
// 16-byte vectors from padded shared memory (a row per lane at stride
// dp + 4 is bank-conflict free) so they stay FMA-bound. Sharing S/dP
// between dQ and dK/dV is later work.
#include "flash_tc.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, H, Sq] f32
  const float* delta;   // [B, H, Sq] f32
  void* out0;           // dq, or dk
  void* out1;           // null, or dv
  const int* se;        // flashmask bands, or null
  int H, Hkv, Sq, Sk, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long se_sb, se_sh, se_s4;
  int h_se, causal, window;
  float scale;
};

// ---------------------------------------------------------------- dQ --

constexpr int kQThreads = 128;
constexpr int kQBQ = 64;    // query rows per block (16 per warp)
constexpr int kQBK = 32;    // keys per tile (1 per lane)
constexpr int kQRows = 16;  // query rows per warp

size_t dq_smem_bytes(int d) {
  const int dp = fl::pad4(d);
  // q, dO [kQBQ][dp]; K, V [kQBK][dp+4]; dS [kQBQ][kQBK]; lse, Delta
  return sizeof(float) * (2 * size_t(kQBQ) * dp + 2 * size_t(kQBK) * (dp + 4) +
                          size_t(kQBQ) * kQBK + 2 * size_t(kQBQ));
}

template <typename T, int kDPL>
__global__ void __launch_bounds__(kQThreads) flash_bwd_dq_kernel(Args a) {
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ dq = static_cast<T*>(a.out0);
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / a.Hkv);
  const int q0 = blockIdx.y * kQBQ;
  const int q_end = min(q0 + kQBQ, Sq);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = fl::pad4(D);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [kQBQ][dp], pre-scaled
  float* do_s = q_s + kQBQ * dp;         // [kQBQ][dp]
  float* k_s = do_s + kQBQ * dp;         // [kQBK][dp + 4]
  float* v_s = k_s + kQBK * (dp + 4);    // [kQBK][dp + 4]
  float* ds_s = v_s + kQBK * (dp + 4);   // [kQBQ][kQBK]
  float* lse_s = ds_s + kQBQ * kQBK;     // [kQBQ]
  float* dl_s = lse_s + kQBQ;            // [kQBQ]

  fl::stage<T, kQThreads>(q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, kQBQ, Sq,
                          D, dp, q_s, dp, a.scale, tid);
  fl::stage<T, kQThreads>(dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0,
                          kQBQ, Sq, D, dp, do_s, dp, 1.f, tid);
  for (int i = tid; i < kQBQ; i += kQThreads) {
    const int qi = q0 + i;
    lse_s[i] = qi < Sq ? a.lse[size_t(bh) * Sq + qi] : fl::kNegInf;
    dl_s[i] = qi < Sq ? a.delta[size_t(bh) * Sq + qi] : 0.f;
  }

  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kQBK, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;

  const int r0 = warp * kQRows;
  float acc[kQRows][kDPL];
#pragma unroll
  for (int r = 0; r < kQRows; ++r)
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;

  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kQBK;
    const int kj = k0 + lane;
    fl::Bands bands{};
    if (seb != nullptr) {
      bands = fl::load_bands(seb, a.se_s4, kj, Sk);
      if (fl::warp_tile_full(bands, q0, q_end)) continue;  // block-uniform
    }
    __syncthreads();  // previous tile consumed (and Q, dO, lse staged)
    fl::stage<T, kQThreads>(kb, a.k_ss, k0, kQBK, Sk, D, dp, k_s, dp + 4,
                            1.f, tid);
    fl::stage<T, kQThreads>(vb, a.v_ss, k0, kQBK, Sk, D, dp, v_s, dp + 4,
                            1.f, tid);
    __syncthreads();

    // S = q K^T and dP = dO V^T for this warp's rows; lane = key column
    float s[kQRows], dpv[kQRows];
#pragma unroll
    for (int r = 0; r < kQRows; ++r) s[r] = dpv[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * (dp + 4));
    const float4* vr = reinterpret_cast<const float4*>(v_s + lane * (dp + 4));
    for (int c4 = 0; c4 < dp / 4; ++c4) {
      const float4 kv = kr[c4];
      const float4 vv = vr[c4];
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + (r0 + r) * dp)[c4];
        const float4 dv =
            reinterpret_cast<const float4*>(do_s + (r0 + r) * dp)[c4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
        dpv[r] = fmaf(dv.x, vv.x, dpv[r]);
        dpv[r] = fmaf(dv.y, vv.y, dpv[r]);
        dpv[r] = fmaf(dv.z, vv.z, dpv[r]);
        dpv[r] = fmaf(dv.w, vv.w, dpv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int qi = q0 + r0 + r;
      const float lse = lse_s[r0 + r];
      bool keep = lse > fl::kRowInvalidLse &&
                  fl::band_keep(qi, kj, Sq, Sk, a.causal, a.window, diag);
      if (seb != nullptr) keep = keep && !fl::band_masked(bands, qi);
      const float p = keep ? expf(s[r] - lse) : 0.f;
      ds_s[(r0 + r) * kQBK + lane] = p * (dpv[r] - dl_s[r0 + r]);
    }
    __syncwarp();

    // acc += dS K; lane owns output columns lane + 32 * i
    for (int j4 = 0; j4 < kQBK / 4; ++j4) {
      float kk[4][kDPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int c = lane + 32 * i;
          kk[jj][i] = c < dp ? k_s[(j4 * 4 + jj) * (dp + 4) + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float4 dsv =
            reinterpret_cast<const float4*>(ds_s + (r0 + r) * kQBK)[j4];
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          float x = acc[r][i];
          x = fmaf(dsv.x, kk[0][i], x);
          x = fmaf(dsv.y, kk[1][i], x);
          x = fmaf(dsv.z, kk[2][i], x);
          x = fmaf(dsv.w, kk[3][i], x);
          acc[r][i] = x;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t(b) * Sq + qi) * H + hq) * size_t(D);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) row[c] = pt::from_f32<T>(acc[r][i] * a.scale);
    }
  }
}

// ------------------------------------------------------------- dK/dV --

constexpr int kKThreads = 256;
constexpr int kKW = 8;                       // keys per warp
constexpr int kKBK = kKW * (kKThreads / 32); // keys per block (64)
constexpr int kKBQ = 32;                     // q rows per tile (1 per lane)

size_t dkv_smem_bytes(int d) {
  const int dp = fl::pad4(d);
  // K, V [kKBK][dp]; q, dO [kKBQ][dp+4]; P^T, dS^T [kKBK][kKBQ];
  // lse, Delta [kKBQ]; bands [4][kKBK] (int)
  return sizeof(float) * (2 * size_t(kKBK) * dp + 2 * size_t(kKBQ) * (dp + 4) +
                          2 * size_t(kKBK) * kKBQ + 2 * size_t(kKBQ) +
                          4 * size_t(kKBK));
}

template <typename T, int kDPL>
__global__ void __launch_bounds__(kKThreads) flash_bwd_dkv_kernel(Args a) {
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ dk = static_cast<T*>(a.out0);
  T* __restrict__ dv = static_cast<T*>(a.out1);
  const int H = a.H, Hkv = a.Hkv, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int rep = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kKBK;
  const int k_end = min(k0 + kKBK, Sk);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = fl::pad4(D);

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // [kKBK][dp]
  float* v_s = k_s + kKBK * dp;            // [kKBK][dp]
  float* q_s = v_s + kKBK * dp;            // [kKBQ][dp + 4], pre-scaled
  float* do_s = q_s + kKBQ * (dp + 4);     // [kKBQ][dp + 4]
  float* pt_s = do_s + kKBQ * (dp + 4);    // [kKBK][kKBQ]
  float* dst_s = pt_s + kKBK * kKBQ;       // [kKBK][kKBQ]
  float* lse_s = dst_s + kKBK * kKBQ;      // [kKBQ]
  float* dl_s = lse_s + kKBQ;              // [kKBQ]
  int* se_s = reinterpret_cast<int*>(dl_s + kKBQ);  // [4][kKBK]

  fl::stage<T, kKThreads>(k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, kKBK, Sk,
                          D, dp, k_s, dp, 1.f, tid);
  fl::stage<T, kKThreads>(v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, kKBK, Sk,
                          D, dp, v_s, dp, 1.f, tid);
  // the group's query heads share one se head (h_se divides Hkv)
  const bool has_se = a.se != nullptr;
  if (has_se) {
    const int* seb = a.se + b * a.se_sb + (hk / (Hkv / a.h_se)) * a.se_sh;
    for (int j = tid; j < kKBK; j += kKThreads) {
      const fl::Bands bj = fl::load_bands(seb, a.se_s4, k0 + j, Sk);
      se_s[j] = bj.lts;
      se_s[kKBK + j] = bj.lte;
      se_s[2 * kKBK + j] = bj.uts;
      se_s[3 * kKBK + j] = bj.ute;
    }
  }
  __syncthreads();
  int mx_lts = INT_MIN, mn_lte = INT_MAX, mx_uts = INT_MIN, mn_ute = INT_MAX;
  if (has_se) {
    for (int j = 0; j < kKBK; ++j) {
      mx_lts = max(mx_lts, se_s[j]);
      mn_lte = min(mn_lte, se_s[kKBK + j]);
      mx_uts = max(mx_uts, se_s[2 * kKBK + j]);
      mn_ute = min(mn_ute, se_s[3 * kKBK + j]);
    }
  }

  int qt_lo, qt_hi;
  fl::q_tile_range(k0, k_end, Sq, kKBQ, a.causal, a.window, diag, &qt_lo,
                   &qt_hi);

  const int jw = warp * kKW;  // this warp's first key within the tile
  float dk_acc[kKW][kDPL], dv_acc[kKW][kDPL];
#pragma unroll
  for (int r = 0; r < kKW; ++r)
#pragma unroll
    for (int i = 0; i < kDPL; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int hq = hk * rep + g;
    const size_t bhq = size_t(b) * H + hq;
    const T* qb = q + b * a.q_sb + hq * a.q_sh;
    const T* dob = dout + b * a.do_sb + hq * a.do_sh;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int qlo = qt * kKBQ;
      if (has_se &&
          fl::tile_full(mx_lts, mn_lte, mx_uts, mn_ute, qlo,
                        min(qlo + kKBQ, Sq)))
        continue;  // block-uniform
      __syncthreads();  // previous q tile consumed
      fl::stage<T, kKThreads>(qb, a.q_ss, qlo, kKBQ, Sq, D, dp, q_s, dp + 4,
                              a.scale, tid);
      fl::stage<T, kKThreads>(dob, a.do_ss, qlo, kKBQ, Sq, D, dp, do_s,
                              dp + 4, 1.f, tid);
      for (int i = tid; i < kKBQ; i += kKThreads) {
        const int qi = qlo + i;
        lse_s[i] = qi < Sq ? a.lse[bhq * Sq + qi] : fl::kNegInf;
        dl_s[i] = qi < Sq ? a.delta[bhq * Sq + qi] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for this warp's keys; lane = query row
      float s[kKW], dpv[kKW];
#pragma unroll
      for (int r = 0; r < kKW; ++r) s[r] = dpv[r] = 0.f;
      const float4* qr =
          reinterpret_cast<const float4*>(q_s + lane * (dp + 4));
      const float4* dor =
          reinterpret_cast<const float4*>(do_s + lane * (dp + 4));
      for (int c4 = 0; c4 < dp / 4; ++c4) {
        const float4 qv = qr[c4];
        const float4 dov = dor[c4];
#pragma unroll
        for (int r = 0; r < kKW; ++r) {
          const float4 kv =
              reinterpret_cast<const float4*>(k_s + (jw + r) * dp)[c4];
          const float4 vv =
              reinterpret_cast<const float4*>(v_s + (jw + r) * dp)[c4];
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
          dpv[r] = fmaf(dov.x, vv.x, dpv[r]);
          dpv[r] = fmaf(dov.y, vv.y, dpv[r]);
          dpv[r] = fmaf(dov.z, vv.z, dpv[r]);
          dpv[r] = fmaf(dov.w, vv.w, dpv[r]);
        }
      }
      const int qi = qlo + lane;
      const float lse = lse_s[lane];
      const float dl = dl_s[lane];
      const bool row_ok = lse > fl::kRowInvalidLse;
#pragma unroll
      for (int r = 0; r < kKW; ++r) {
        const int jl = jw + r;
        bool keep = row_ok && fl::band_keep(qi, k0 + jl, Sq, Sk, a.causal,
                                            a.window, diag);
        if (has_se) {
          const fl::Bands bj{se_s[jl], se_s[kKBK + jl], se_s[2 * kKBK + jl],
                             se_s[3 * kKBK + jl]};
          keep = keep && !fl::band_masked(bj, qi);
        }
        const float p = keep ? expf(s[r] - lse) : 0.f;
        pt_s[jl * kKBQ + lane] = p;
        dst_s[jl * kKBQ + lane] = p * (dpv[r] - dl);
      }
      __syncwarp();

      // dV += P^T dO, dK += dS^T (scale * q); lane owns columns lane + 32 i
      for (int i4 = 0; i4 < kKBQ / 4; ++i4) {
        float dov[4][kDPL], qv[4][kDPL];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int i = 0; i < kDPL; ++i) {
            const int c = lane + 32 * i;
            const int off = (i4 * 4 + ii) * (dp + 4) + c;
            dov[ii][i] = c < dp ? do_s[off] : 0.f;
            qv[ii][i] = c < dp ? q_s[off] : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < kKW; ++r) {
          const float4 pv =
              reinterpret_cast<const float4*>(pt_s + (jw + r) * kKBQ)[i4];
          const float4 dsv =
              reinterpret_cast<const float4*>(dst_s + (jw + r) * kKBQ)[i4];
#pragma unroll
          for (int i = 0; i < kDPL; ++i) {
            float x = dv_acc[r][i];
            x = fmaf(pv.x, dov[0][i], x);
            x = fmaf(pv.y, dov[1][i], x);
            x = fmaf(pv.z, dov[2][i], x);
            x = fmaf(pv.w, dov[3][i], x);
            dv_acc[r][i] = x;
            float y = dk_acc[r][i];
            y = fmaf(dsv.x, qv[0][i], y);
            y = fmaf(dsv.y, qv[1][i], y);
            y = fmaf(dsv.z, qv[2][i], y);
            y = fmaf(dsv.w, qv[3][i], y);
            dk_acc[r][i] = y;
          }
        }
      }
      __syncwarp();
    }
  }

  // q was staged pre-scaled, so dk_acc already carries the scale
#pragma unroll
  for (int r = 0; r < kKW; ++r) {
    const int kj = k0 + jw + r;
    if (kj >= Sk) continue;
    const size_t off = ((size_t(b) * Sk + kj) * Hkv + hk) * size_t(D);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        dk[off + c] = pt::from_f32<T>(dk_acc[r][i]);
        dv[off + c] = pt::from_f32<T>(dv_acc[r][i]);
      }
    }
  }
}

// ------------------------------------------ dK/dV, tc route, mma.sync --
//
// The tc route's dK/dV at tile head dim 256 (tc::wgmma takes the rest).
// The simt kernel's block structure on the tensor cores: one block per
// (batch, kv head, 64-key tile) keeps its K and V tile in shared memory
// and loops over the group's rep query heads and the 32-row q tiles the
// band, window and bands allow; Q, dO, lse and Delta stream through a
// 2-stage cp.async ring. Four warps of 16 keys each (keys are the M
// dimension): S^T = K Q^T and dP^T = V dO^T by mma.sync from ldmatrix
// fragments, P^T = exp2(scale log2e S^T - log2e lse) (0 for a masked pair
// or a row without keys), dS^T = P^T (dP^T - Delta); both are split into
// hi + lo 16-bit terms in registers (their accumulators are the A
// operand) and dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
// with ldmatrix.trans fragments of dO and Q. dK and dV accumulate in f32
// across the whole GQA group and are written once (dK times scale): no
// atomics, no partial buffers, deterministic. Eight warps run: two per
// key row, each owning half of dK's and dV's columns (and both computing
// that row's S^T and dP^T), so the accumulators stay at 128 registers a
// thread.

struct DkvTc {
  static constexpr int kD = 256;        // tile head dim
  static constexpr int kDW = kD / 2;    // dK/dV columns per warp
  static constexpr int kWarps = 8;      // two per 16-key row
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = 64;        // keys per block
  static constexpr int kBQ = 32;        // q rows per tile
  static constexpr int kLd = kD + 8;    // shared row stride
  // K, V [kBK][kLd]; Q, dO [2][kBQ][kLd] (bf16); lse, Delta [2][kBQ] (f32)
  static constexpr size_t kSmem =
      2 * (2 * size_t(kBK) * kLd + 4 * size_t(kBQ) * kLd) +
      sizeof(float) * 4 * size_t(kBQ);
};

__global__ void __launch_bounds__(DkvTc::kThreads)
    flash_bwd_dkv_tc_kernel(Args a) {
  using T = __nv_bfloat16;
  using C = DkvTc;
  constexpr int kD = C::kD, kBK = C::kBK, kBQ = C::kBQ, kLd = C::kLd;
  constexpr int kNT = kBQ / 8, kDT = C::kDW / 8, kThreads = C::kThreads;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ dk = static_cast<T*>(a.out0);
  T* __restrict__ dv = static_cast<T*>(a.out1);
  const int H = a.H, Hkv = a.Hkv, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int rep = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kBK;
  const int k_end = min(k0 + kBK, Sk);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp & 3) * 16;         // this warp's keys [kr, kr + 16)
  const int c0 = (warp >> 2) * C::kDW;    // and dK/dV columns [c0, +kDW)
  const int j0 = k0 + kr + g;             // this thread's keys j0, j0 + 8

  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* k_s = reinterpret_cast<T*>(smem_tc);                       // [kBK][kLd]
  T* v_s = k_s + kBK * kLd;                                     // [kBK][kLd]
  T* q_s = v_s + kBK * kLd;                                // [2][kBQ][kLd]
  T* do_s = q_s + 2 * kBQ * kLd;                           // [2][kBQ][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * kLd);  // [2][kBQ]
  float* dl_s = lse_s + 2 * kBQ;                                  // [2][kBQ]

  tc::load_tile<T, kBK, kD, kLd, kThreads>(
      k_s, k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, Sk, D, tid);
  tc::load_tile<T, kBK, kD, kLd, kThreads>(
      v_s, v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, Sk, D, tid);

  // the group's query heads share one se head (h_se divides Hkv): the
  // bands of this thread's two keys, and the block's skip extremes
  const bool has_se = a.se != nullptr;
  fl::Bands bj[2] = {}, ext = {};
  if (has_se) {
    const int* seb = a.se + b * a.se_sb + (hk / (Hkv / a.h_se)) * a.se_sh;
    bj[0] = fl::load_bands(seb, a.se_s4, j0, Sk);
    bj[1] = fl::load_bands(seb, a.se_s4, j0 + 8, Sk);
    ext = fl::warp_band_extremes<kBK>(seb, a.se_s4, k0, Sk, lane);
  }

  int qt_lo, qt_hi;
  fl::q_tile_range(k0, k_end, Sq, kBQ, a.causal, a.window, diag, &qt_lo,
                   &qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = rep * nq;  // (query head of the group, q tile)
  auto next = [&](int it) {      // block-uniform whole-tile skip
    if (has_se)
      for (; it < n_items; ++it) {
        const int qlo = (qt_lo + it % nq) * kBQ;
        if (!fl::tile_full(ext, qlo, min(qlo + kBQ, Sq))) break;
      }
    return it;
  };
  // start the copy of item it (when there is one) into stage st
  auto load_q = [&](int it, int st) {
    if (it >= n_items) {
      tc::cp_async_commit();
      return;
    }
    const int hq = hk * rep + it / nq;
    const int qlo = (qt_lo + it % nq) * kBQ;
    const size_t row0 = (size_t(b) * H + hq) * Sq + qlo;
    tc::load_tile<T, kBQ, kD, kLd, kThreads>(
        q_s + st * kBQ * kLd, q + b * a.q_sb + hq * a.q_sh, a.q_ss, qlo, Sq,
        D, tid);
    tc::load_tile<T, kBQ, kD, kLd, kThreads>(
        do_s + st * kBQ * kLd, dout + b * a.do_sb + hq * a.do_sh, a.do_ss,
        qlo, Sq, D, tid);
    if (tid < kBQ) {
      const bool ok = qlo + tid < Sq;
      tc::cp_async4(lse_s + st * kBQ + tid, a.lse + (ok ? row0 + tid : 0), ok);
      tc::cp_async4(dl_s + st * kBQ + tid, a.delta + (ok ? row0 + tid : 0),
                    ok);
    }
    tc::cp_async_commit();
  };

  int it = next(0);
  load_q(it, 0);  // one group: K, V and the first q tile

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float sl2 = a.scale * tc::kLog2e;

  for (int st = 0; it < n_items; st ^= 1) {
    tc::cp_async_wait<0>();
    // this q tile (and K, V) landed for every thread, and every warp is
    // done with the tile before it, whose stage the next copy refills
    __syncthreads();
    const int in = next(it + 1);
    load_q(in, st ^ 1);
    const int qlo = (qt_lo + it % nq) * kBQ;
    const T* qs = q_s + st * kBQ * kLd;
    const T* dos = do_s + st * kBQ * kLd;
    const float* ls = lse_s + st * kBQ;
    const float* dls = dl_s + st * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x kBQ rows
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      unsigned ka[4], va[4];
      const int off = (kr + tc::a_row(lane)) * kLd + kk * 16 + tc::a_col(lane);
      tc::ldsm_x4(ka, k_s + off);
      tc::ldsm_x4(va, v_s + off);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned qf[4], df[4];
        const int qoff =
            (np * 16 + tc::b_row(lane)) * kLd + kk * 16 + tc::b_col(lane);
        tc::ldsm_x4(qf, qs + qoff);
        tc::mma<T>(s[2 * np], ka, qf[0], qf[1]);
        tc::mma<T>(s[2 * np + 1], ka, qf[2], qf[3]);
        tc::ldsm_x4(df, dos + qoff);
        tc::mma<T>(dp[2 * np], va, df[0], df[1]);
        tc::mma<T>(dp[2 * np + 1], va, df[2], df[3]);
      }
    }

    // P^T and dS^T in place; masks only where the band, window or bands
    // reach into the tile (rows past Sq or without keys get lse2 = inf)
    const bool masked =
        has_se ||
        (a.causal && (qlo + diag < k0 + kBK - 1 ||
                      (a.window > 0 &&
                       qlo + kBQ - 1 + diag - k0 >= a.window)));
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const int qi = qlo + ql;
        const float lse = ls[ql];
        const float lse2 = qi < Sq && lse > fl::kRowInvalidLse
                               ? lse * tc::kLog2e
                               : INFINITY;
        float p = exp2f(fmaf(s[n][e], sl2, -lse2));
        if (masked) {
          const int h = e >> 1;
          bool keep = fl::band_keep(qi, j0 + 8 * h, Sq, Sk, a.causal,
                                    a.window, diag);
          if (has_se) keep = keep && !fl::band_masked(bj[h], qi);
          if (!keep) p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dls[ql]);
      }

    // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      unsigned ph[4], pl[4], dh[4], dl[4];
      tc::split_a<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
      tc::split_a<T>(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
      for (int dn = 0; dn < kDT / 2; ++dn) {
        const int off = (kk * 16 + tc::a_row(lane)) * kLd + c0 + dn * 16 +
                        tc::a_col(lane);
        unsigned of[4], qf[4];
        tc::ldsm_x4_t(of, dos + off);
        tc::mma<T>(dv_acc[2 * dn], ph, of[0], of[1]);
        tc::mma<T>(dv_acc[2 * dn], pl, of[0], of[1]);
        tc::mma<T>(dv_acc[2 * dn + 1], ph, of[2], of[3]);
        tc::mma<T>(dv_acc[2 * dn + 1], pl, of[2], of[3]);
        tc::ldsm_x4_t(qf, qs + off);
        tc::mma<T>(dk_acc[2 * dn], dh, qf[0], qf[1]);
        tc::mma<T>(dk_acc[2 * dn], dl, qf[0], qf[1]);
        tc::mma<T>(dk_acc[2 * dn + 1], dh, qf[2], qf[3]);
        tc::mma<T>(dk_acc[2 * dn + 1], dl, qf[2], qf[3]);
      }
    }
    it = in;
  }
  tc::cp_async_wait<0>();

  // dK carries the scale of S = scale q k^T once, here
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 8 * h;
    if (j >= Sk) continue;
    const size_t off = ((size_t(b) * Sk + j) * Hkv + hk) * size_t(D);
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = c0 + n * 8 + 2 * t;
      if (c < D) {
        *reinterpret_cast<unsigned*>(dk + off + c) = tc::pack2<T>(
            dk_acc[n][2 * h] * a.scale, dk_acc[n][2 * h + 1] * a.scale);
        *reinterpret_cast<unsigned*>(dv + off + c) =
            tc::pack2<T>(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
    }
  }
}

// --------------------------------------------- dQ, tc route, mma.sync --
//
// The tc route's dQ at tile head dim 256 (tc::wgmma takes the rest).
// The tc forward's block structure with q rows as the M dimension: one
// block per (batch * head, 64-row q tile), the longest causal tiles
// first. Q and dO are copied once by cp.async (lse and Delta of this
// thread's two rows are read into registers beside them); K and V tiles of
// kBK keys stream through a 2-stage cp.async ring in padded shared memory,
// with one barrier a tile, over the key tiles the band and window allow,
// skipping a tile one flashmask band covers whole before it is loaded.
// Each warp owns one m16 row tile: S = Q K^T and dP = dO V^T by mma.sync
// m16n8k16 from ldmatrix fragments (products of bf16 inputs, exact into
// f32), P = exp2(scale log2e S - log2e lse) on the accumulators (0 for a
// masked pair, a row past Sq or a row without keys: lse NEG_INF), dS =
// P (dP - Delta) in place, split into hi + lo bf16 terms that are the A
// operand as P is in the forward, and dQ += dS_hi K + dS_lo K from
// ldmatrix.trans fragments of the same K tile that S read. dQ is scaled
// once on store. Eight warps run: two per row tile, each owning half of
// dQ's columns (both compute that tile's S and dP), so the accumulator
// stays at 64 registers a thread. GQA by index: q head h reads
// kv head h / rep, and dQ needs no group sum. bf16 only (see the route
// rule in flash_tc.cuh).

struct DqTc {
  static constexpr int kD = 256;        // tile head dim
  static constexpr int kDW = kD / 2;    // dQ columns per warp
  static constexpr int kM = 1;          // m16 row tiles a warp
  static constexpr int kWarps = 8;      // two per row tile
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 64 * kM;   // q rows per block
  static constexpr int kBK = 32;        // keys per tile
  static constexpr int kLd = kD + 8;    // shared row stride
  static constexpr int kNT = kBK / 8;   // S n8 tiles
  static constexpr int kDT = kDW / 8;   // dQ n8 tiles per warp
  // Q, dO [kBQ][kLd]; K, V [2][kBK][kLd] (bf16); bands [2][4][kBK] (int)
  static constexpr size_t kSmem =
      2 * (2 * size_t(kBQ) + 4 * size_t(kBK)) * kLd +
      sizeof(int) * 8 * size_t(kBK);
};

__global__ void __launch_bounds__(DqTc::kThreads)
    flash_bwd_dq_tc_kernel(Args a) {
  using T = __nv_bfloat16;
  using C = DqTc;
  constexpr int kD = C::kD, kBQ = C::kBQ, kBK = C::kBK, kLd = C::kLd;
  constexpr int kM = C::kM;
  constexpr int kNT = C::kNT, kDT = C::kDT, kThreads = C::kThreads;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ dq = static_cast<T*>(a.out0);
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hq = bh - b * H;
  const int hk = hq / (H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int diag = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16 * kM;  // this warp's rows [r0, +16 kM)
  const int c0 = (warp >> 2) * C::kDW;  // and dQ columns [c0, c0 + kDW)

  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* q_s = reinterpret_cast<T*>(smem_tc);                    // [kBQ][kLd]
  T* do_s = q_s + kBQ * kLd;                                 // [kBQ][kLd]
  T* k_s = do_s + kBQ * kLd;                                 // [2][kBK][kLd]
  T* v_s = k_s + 2 * kBK * kLd;                              // [2][kBK][kLd]
  int* se_s = reinterpret_cast<int*>(v_s + 2 * kBK * kLd);  // [2][4][kBK]
  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;
  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kBK, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);
  auto next = [&](int kt) {  // block-uniform whole-tile skip
    if (seb != nullptr)
      while (kt < kt_hi &&
             fl::tile_full(fl::warp_band_extremes<kBK>(seb, a.se_s4, kt * kBK,
                                                       Sk, lane),
                           q0, q_end))
        ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int st) {
    if (kt < kt_hi) {
      const int k0 = kt * kBK;
      tc::load_tile<T, kBK, kD, kLd, kThreads>(k_s + st * kBK * kLd, kb,
                                               a.k_ss, k0, Sk, D, tid);
      tc::load_tile<T, kBK, kD, kLd, kThreads>(v_s + st * kBK * kLd, vb,
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
    tc::cp_async_commit();
  };

  tc::load_tile<T, kBQ, kD, kLd, kThreads>(
      q_s, q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, Sq, D, tid);
  tc::load_tile<T, kBQ, kD, kLd, kThreads>(
      do_s, dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0, Sq, D, tid);
  int kt = next(kt_lo);
  load_kv(kt, 0);  // one group: Q, dO and the first key tile

  // log2e lse (inf for a row past Sq or without keys: P = 0) and Delta of
  // rows g and g + 8 of each of this warp's row tiles
  float lse2[kM][2], dl[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + r0 + 16 * mi + g + 8 * h;
      const float lse = qi < Sq ? a.lse[size_t(bh) * Sq + qi] : fl::kNegInf;
      lse2[mi][h] = lse > fl::kRowInvalidLse ? lse * tc::kLog2e : INFINITY;
      dl[mi][h] = qi < Sq ? a.delta[size_t(bh) * Sq + qi] : 0.f;
    }

  float acc[kM][kDT][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  const float sl2 = a.scale * tc::kLog2e;

  for (int st = 0; kt < kt_hi; st ^= 1) {
    tc::cp_async_wait<0>();
    // tile kt (and Q, dO) landed for every thread, and every warp is done
    // with the tile before it, whose stage the next copy refills
    __syncthreads();
    const int kn = next(kt + 1);
    load_kv(kn, st ^ 1);
    const T* ks = k_s + st * kBK * kLd;
    const int k0 = kt * kBK;

    float s[kM][kNT][4], dp[kM][kNT][4];
    tc::warp_abt<T, kM, kNT, kD, kLd, kLd>(q_s, ks, r0, lane, s);
    tc::warp_abt<T, kM, kNT, kD, kLd, kLd>(do_s, v_s + st * kBK * kLd, r0,
                                           lane, dp);

    // P and dS in place; masks only where the band, the window, the bands
    // or the ragged key edge reach into the tile
    const bool masked =
        seb != nullptr || k0 + kBK > Sk ||
        (a.causal && (q0 + diag < k0 + kBK - 1 ||
                      (a.window > 0 && q_end - 1 + diag - k0 >= a.window)));
    const int* sst = se_s + st * 4 * kBK;
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2f(fmaf(s[mi][n][e], sl2, -lse2[mi][h]));
          if (masked) {
            const int qi = q0 + r0 + 16 * mi + g + 8 * h;
            const int jl = n * 8 + 2 * t + (e & 1);
            bool keep = fl::band_keep(qi, k0 + jl, Sq, Sk, a.causal,
                                      a.window, diag);
            if (seb != nullptr)
              keep = keep &&
                     !fl::band_masked(
                         fl::Bands{sst[jl], sst[kBK + jl], sst[2 * kBK + jl],
                                   sst[3 * kBK + jl]},
                         qi);
            if (!keep) p = 0.f;
          }
          dp[mi][n][e] = p * (dp[mi][n][e] - dl[mi][h]);
        }

    // dQ += dS_hi K + dS_lo K
    tc::warp_pb_split<T, kM, kNT, kDT, kLd>(dp, ks, c0, lane, acc);
    kt = kn;
  }
  tc::cp_async_wait<0>();

  // dQ carries the scale of S = scale q k^T once, here
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + r0 + 16 * mi + g + 8 * h;
      if (qi >= Sq) continue;
      T* row = dq + ((size_t(b) * Sq + qi) * H + hq) * size_t(D);
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int c = c0 + n * 8 + 2 * t;
        if (c < D)
          *reinterpret_cast<unsigned*>(row + c) =
              tc::pack2<T>(acc[mi][n][2 * h] * a.scale,
                           acc[mi][n][2 * h + 1] * a.scale);
      }
    }
}

// ------------------------------------------ tc route: the wgmma kernels --
//
// `flash_bwd_dq_wgmma_kernel<C>` and `flash_bwd_dkv_wgmma_kernel<C>`: the
// tc route's dQ and dK/dV at tile head dims 64 and 128 (every head dim up
// to 128, tc::wgmma), bf16, on Hopper's wgmma fed by TMA. Both are built
// from the forward's pieces (csrc/flash_tc.cuh `wg`, csrc/grouped_gemm_tc.cuh
// `ggtc`): a producer warp that loads tiles through 4-D tensor maps over
// the caller's strides into a ring of stages with full/empty mbarriers and
// alone decides the walk, writing with each stage which tile it holds (-1
// ends the walk); consumer warpgroups that run wgmma on the stages and
// turn f32 accumulators into register-A fragments in place, split into
// bf16 hi + lo (one bf16 rounding of P or dS misses the port's gate
// 6-23x; csrc/flash_tc.cuh). The branches around the products depend only
// on values broadcast by __shfl_sync (role, tile), and the first tile is
// peeled, so ptxas does not serialize them (C7518).
//
// - dQ: the forward's shape. One block per (batch * head, 64-row q tile),
//   q tiles fastest and the last (the longest under a causal band) first;
//   one consumer warpgroup and the producer warp, kBlocks blocks an SM. Q
//   and dO are loaded once; K and V tiles of kBN keys go through the ring
//   over the tiles fl::k_tile_range and the flashmask whole-tile skip
//   allow (wg::produce_kv, the forward's walk). S = Q K^T and dP = dO V^T
//   by wgmma m64n{kBN}k16 (both operands K-major); P = exp2(scale log2e S
//   - log2e lse) on the accumulators (lse is given: no online rescale; a
//   row past Sq or without keys has lse2 = inf, so P = 0 where TMA's zero
//   rows would give P = 1 for lse 0), masked, dS = P (dP - Delta) in place,
//   split into hi + lo fragments; dQ += dS_hi K + dS_lo K by wgmma RS
//   m64n{kD}k16 with the same K tile read MN-major (the transpose bit, as
//   V in the forward). S and dP of tile j are issued with dQ's products of
//   tile j - 1, so the exp and masks of tile j run while those do. dQ is
//   scaled once on store.
// - dK/dV: keys are the M dimension, 64 a consumer warpgroup (kWG of them:
//   key tiles of kBK = 64 kWG). Persistent: a block walks key tiles
//   blockIdx.x, + gridDim.x, ... in a longest-first order (`KeyTile`),
//   with K and V double-buffered, so the next tile's loads overlap this
//   tile's last products and stores (a block a tile left each block's
//   fill and drain exposed, 1 or 2 blocks an SM). Per key tile the
//   producer loads K and V once and walks the items (query head of the
//   GQA group, kBQ-row q tile) that fl::q_tile_range and the flashmask
//   whole-tile skip (the tile's band extremes) allow, loading each item's
//   Q and dO tiles by TMA and its rows' log2e lse (inf past Sq or without
//   keys) and Delta into a stage; a stage of -1 ends the key tile. S^T = K
//   Q^T and dP^T = V dO^T by wgmma m64n{kBQ}k16 (K-major); P^T and dS^T in
//   place (the keys' bands are the tile's, stored once); dV += P^T_hi dO
//   + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q by wgmma RS m64n{kD}k16
//   with dO and Q read MN-major from the slabs the SS products read
//   K-major. S^T and dP^T of item i are issued with dV's and dK's products
//   of item i - 1. dK and dV accumulate in f32 over the whole group and
//   are written once (dK times scale): no atomics, no partial buffers, a
//   deterministic result. Registers: dK and dV take kD f32 a thread, S^T
//   and dP^T kBQ / 2 each and the four fragment sets kBQ / 4 each (DkvCfg).
// What bounds them: at the LLaMA training shape the tensor cores (S and dP
// recomputed in each kernel, the second products issued twice: dQ 8,
// dK/dV 12 products of pairs x D); at the ERNIE-MoE and BERT shapes the
// bytes and each block's fill and drain.

namespace bwg {

constexpr int kBQ = 64;  // dQ: query rows a block

// The tensor maps of a launch: Q and dO (box rows: the kernel's q tile),
// K and V (its key tile).
struct Maps {
  CUtensorMap q, dout, k, v;
};

// ------------------------------------------------------------------ dQ

// tile head dim kD (64 or 128), stages, blocks an SM; 32 keys a tile
template <typename T, int kD_, int kStages_, int kBlocks_>
struct DqCfg {
  using Elem = T;
  static constexpr int kD = kD_, kBN = 32, kStages = kStages_;
  static constexpr int kBlocks = kBlocks_;
  static constexpr int kConsumers = 128;           // one warpgroup
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kSlabs = kD / 64;            // 64-column slabs
  static constexpr int kQSlab = kBQ * 128;          // bytes of a Q/dO slab
  static constexpr int kKSlab = kBN * 128;          // bytes of a K/V slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kStageBytes = 2 * kKBytes;   // K, then V
  static constexpr int kInfo = 4 * kBN + 1;         // bands [4][kBN], kt
  static constexpr int kBarOff =
      (2 * kQBytes + kStages * kStageBytes + kStages * kInfo * 4 + 7) & ~7;
  static constexpr int kSmemBytes = 1024 + kBarOff + (2 * kStages + 1) * 8;
  static_assert(kD == 64 || kD == 128, "tile head dim");
  static_assert(kBlocks * (kSmemBytes + 1024) <= 233472,
                "the blocks of an SM fit its shared memory");
};

// Q slabs, dO slabs, the stages (K slabs, V slabs), each stage's info
// (its key tile's bands and index), the barriers.
template <class C>
struct DqSmem {
  uint32_t base;  // shared address, 1024-byte aligned
  int* info;      // [kStages][kInfo]
  __device__ __forceinline__ uint32_t q(int slab) const {
    return base + slab * C::kQSlab;
  }
  __device__ __forceinline__ uint32_t dout(int slab) const {
    return q(slab) + C::kQBytes;
  }
  __device__ __forceinline__ uint32_t k(int s, int slab) const {
    return base + 2 * C::kQBytes + s * C::kStageBytes + slab * C::kKSlab;
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
  __device__ __forceinline__ uint32_t once() const {  // Q and dO
    return full(2 * C::kStages);
  }
};

// S = Q K^T and dP = dO V^T of the key tile in stage s (two wgmma groups)
template <class C>
__device__ __forceinline__ void dq_sdp(float (&sc)[C::kBN / 2],
                                       float (&dp)[C::kBN / 2],
                                       const DqSmem<C>& sm, int s) {
  using T = typename C::Elem;
  wg::ss<T, C::kBN, C::kD>(sc, sm.q(0), C::kQSlab, sm.k(s, 0), C::kKSlab);
  wg::ss<T, C::kBN, C::kD>(dp, sm.dout(0), C::kQSlab, sm.v(s, 0),
                           C::kKSlab);
}

// dS = P (dP - Delta) of key tile kt in place of dP, P = exp2(scale log2e
// S - log2e lse) from the accumulators of S, 0 where the band, the window,
// the bands in `info` or the ragged key edge mask the pair (checked only
// where they reach into the tile); this thread's rows qr and qr + 8 (lse2
// and dl), key columns 8 jj + 2 t (+1).
template <class C>
__device__ __forceinline__ void dq_ds(const float (&sc)[C::kBN / 2],
                                      float (&dp)[C::kBN / 2], const Args& a,
                                      const int* seb, const int* info,
                                      int kt, int q0, int q_end, int qr,
                                      int t, float sl2,
                                      const float (&lse2)[2],
                                      const float (&dl)[2]) {
  constexpr int kBN = C::kBN;
  const int Sq = a.Sq, Sk = a.Sk, diag = Sk - Sq;
  const int k0 = kt * kBN;
  const bool masked =
      seb != nullptr || k0 + kBN > Sk ||
      (a.causal && (q0 + diag < k0 + kBN - 1 ||
                    (a.window > 0 && q_end - 1 + diag - k0 >= a.window)));
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = wg::exp2_ftz(fmaf(sc[4 * jj + e], sl2, -lse2[h]));
      if (masked) {
        const int qi = qr + 8 * h;
        const int jl = 8 * jj + 2 * t + (e & 1);
        bool keep =
            fl::band_keep(qi, k0 + jl, Sq, Sk, a.causal, a.window, diag);
        if (seb != nullptr)
          keep = keep &&
                 !fl::band_masked(fl::Bands{info[jl], info[kBN + jl],
                                            info[2 * kBN + jl],
                                            info[3 * kBN + jl]},
                                  qi);
        if (!keep) p = 0.f;
      }
      dp[4 * jj + e] = p * (dp[4 * jj + e] - dl[h]);
    }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kBlocks)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Maps maps, Args a) {
  using T = typename C::Elem;
  constexpr int kD = C::kD, kBN = C::kBN, S = C::kStages;
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

  extern __shared__ uint8_t smem_dq[];
  const uint32_t base = wg::aligned_base(smem_dq);
  const DqSmem<C> sm{base, reinterpret_cast<int*>(
                               smem_dq + (base - ggtc::smem_u32(smem_dq)) +
                               2 * C::kQBytes + S * C::kStageBytes)};
  wg::init_barriers<S, C::kConsumers>(
      sm, [&] { ggtc::mbar_init(sm.once(), 1); });
  const int* seb = a.se == nullptr
                       ? nullptr
                       : a.se + b * a.se_sb + (hq / (H / a.h_se)) * a.se_sh;
  int kt_lo, kt_hi;
  fl::k_tile_range(q0, q_end, Sk, kBN, a.causal, a.window, diag, &kt_lo,
                   &kt_hi);

  if (wg::is_producer<C::kConsumers>()) {
    // -- the producer warp: Q and dO once, then the forward's walk --
    if (lane == 0) {
      ggtc::mbar_expect_tx(sm.once(), 2 * C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kSlabs; ++c) {
        ggtc::tma_load4(sm.q(c), &maps.q, sm.once(), 64 * c, hq, q0, b);
        ggtc::tma_load4(sm.dout(c), &maps.dout, sm.once(), 64 * c, hq, q0,
                        b);
      }
    }
    wg::produce_kv<C>(sm, &maps.k, &maps.v, kt_lo, kt_hi, seb, a.se_s4, Sk,
                      q0, q_end, hk, b, lane);
  } else {
    // -- the consumer warpgroup --
    const int g = lane / 4, t = lane % 4;
    const int qr = q0 + (threadIdx.x / 32) * 16 + g;  // rows qr, qr + 8
    const float sl2 = a.scale * tc::kLog2e;
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qr + 8 * h;
      const float lse =
          qi < Sq ? a.lse[size_t(bh) * Sq + qi] : fl::kNegInf;
      lse2[h] = lse > fl::kRowInvalidLse ? lse * tc::kLog2e : INFINITY;
      dl[h] = qi < Sq ? a.delta[size_t(bh) * Sq + qi] : 0.f;
    }
    float dq[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
    float sc[kBN / 2], dp[kBN / 2];
    // dS_hi and dS_lo of the last tile, live until its products retire
    unsigned dh[kBN / 16][4], dlo[kBN / 16][4];

    ggtc::mbar_wait(sm.once(), 0);
    ggtc::mbar_wait(sm.full(0), 0);
    int kt = wg::uniform(sm.info + 4 * kBN);
    if (kt >= 0) {
      ggtc::wgmma_fence();
      dq_sdp(sc, dp, sm, 0);
      ggtc::wgmma_wait<0>();
      ggtc::fence_acc(sc);
      ggtc::fence_acc(dp);
      dq_ds<C>(sc, dp, a, seb, sm.info, kt, q0, q_end, qr, t, sl2, lse2, dl);
      wg::split<T, kBN>(dp, dh, dlo);
      int s_prev = 0;
      for (int j = 1;; ++j) {
        const int s = j % S;
        ggtc::mbar_wait(sm.full(s), (j / S) & 1);
        const int* info = sm.info + s * C::kInfo;
        kt = wg::uniform(info + 4 * kBN);
        if (kt < 0) break;
        ggtc::wgmma_fence();
        dq_sdp(sc, dp, sm, s);
        wg::rs_split<T, kD, kBN>(dq, dh, dlo, sm.k(s_prev, 0), C::kKSlab);
        ggtc::wgmma_wait<1>();  // S and dP (dQ's products may still run)
        ggtc::fence_acc(sc);
        ggtc::fence_acc(dp);
        dq_ds<C>(sc, dp, a, seb, info, kt, q0, q_end, qr, t, sl2, lse2, dl);
        ggtc::wgmma_wait<0>();  // the previous tile's dQ products
        ggtc::fence_acc(dq);
        wg::fence(dh);
        wg::fence(dlo);
        if (lane == 0) ggtc::mbar_arrive(sm.empty(s_prev));
        wg::split<T, kBN>(dp, dh, dlo);
        s_prev = s;
      }
      ggtc::wgmma_fence();
      wg::rs_split<T, kD, kBN>(dq, dh, dlo, sm.k(s_prev, 0), C::kKSlab);
      ggtc::wgmma_wait<0>();
      ggtc::fence_acc(dq);
    }

    // dQ carries the scale of S = scale q k^T once, here
    T* dqb = static_cast<T*>(a.out0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qr + 8 * h;
      if (qi >= Sq) continue;
      T* row = dqb + ((size_t(b) * Sq + qi) * H + hq) * size_t(a.D);
#pragma unroll
      for (int jj = 0; jj < kD / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c < a.D)
          *reinterpret_cast<unsigned*>(row + c) =
              tc::pack2<T>(dq[4 * jj + 2 * h] * a.scale,
                           dq[4 * jj + 2 * h + 1] * a.scale);
      }
    }
  }
}

// --------------------------------------------------------------- dK/dV

// registers a thread of the producer warpgroup and of the two consumer
// warpgroups after setmaxnreg (3 warps a sub-partition: 56 + 2 x 224 of
// its 512 a lane; 24 / 240 spilled 132 bytes)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// tile head dim kD (64 or 128), consumer warpgroups kWG (64 keys each),
// stages, blocks an SM; 32 q rows an item. Registers are
// shared out by SM sub-partition (16 K each, a block's warps dealt out in
// turn): two consumer warpgroups and a producer warp put 3 warps on one,
// which caps every thread at 168 registers, and dK and dV alone take 128
// at head dim 128. So with two consumer warpgroups the producer is a
// whole warpgroup (384 threads, 168 registers each at launch) that gives
// its registers to the consumers (setmaxnreg, kProducerRegs and
// kConsumerRegs).
// The kernel is persistent: each block walks its key tiles (tile
// blockIdx.x, then + gridDim.x, ...) with K and V double-buffered, so the
// producer loads the next tile's K, V and first items while the consumers
// finish this tile's products and store it.
template <typename T, int kD_, int kWG_, int kStages_, int kBlocks_>
struct DkvCfg {
  using Elem = T;
  static constexpr int kD = kD_, kBQ = 32, kWG = kWG_;
  static constexpr int kStages = kStages_, kBlocks = kBlocks_;
  static constexpr int kBK = 64 * kWG;              // keys a tile
  static constexpr int kConsumers = 128 * kWG;
  static constexpr bool kRebalance = kWG == 2;      // setmaxnreg
  static constexpr int kThreads = kConsumers + (kRebalance ? 128 : 32);
  static constexpr int kSlabs = kD / 64;            // 64-column slabs
  static constexpr int kKSlab = kBK * 128;          // bytes of a K/V slab
  static constexpr int kQSlab = kBQ * 128;          // bytes of a Q/dO slab
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kStageBytes = 2 * kQBytes;   // Q, then dO
  // K and V [2 buffers]; the stages; f32 [kStages][2][kBQ] (log2e lse,
  // Delta); int [kStages] (the item's first q row; -1 ends the tile);
  // int [2 buffers][4][kBK] (the keys' bands)
  static constexpr int kStagesOff = 4 * kKBytes;
  static constexpr int kRowsOff = kStagesOff + kStages * kStageBytes;
  static constexpr int kTileOff = kRowsOff + kStages * 2 * kBQ * 4;
  static constexpr int kBandOff = kTileOff + kStages * 4;
  static constexpr int kBarOff = (kBandOff + 2 * 4 * kBK * 4 + 7) & ~7;
  static constexpr int kSmemBytes = 1024 + kBarOff + (2 * kStages + 4) * 8;
  static_assert(kD == 64 || kD == 128, "tile head dim");
  static_assert(kWG == 1 || kWG == 2, "consumer warpgroups");
  static_assert(!kRebalance || kBlocks == 1, "setmaxnreg: one block an SM");
  static_assert(kBlocks * (kSmemBytes + 1024) <= 233472,
                "the blocks of an SM fit its shared memory");
};

// K and V (two buffers), the stages (Q slabs, dO slabs), each stage's
// rows and item, the keys' bands (a buffer each), the barriers.
template <class C>
struct DkvSmem {
  uint32_t base;  // shared address, 1024-byte aligned
  float* rows;    // [kStages][2][kBQ]
  int* tile;      // [kStages]
  int* bands;     // [2][4][kBK]
  __device__ __forceinline__ uint32_t k(int tb, int slab) const {
    return base + tb * 2 * C::kKBytes + slab * C::kKSlab;
  }
  __device__ __forceinline__ uint32_t v(int tb, int slab) const {
    return k(tb, slab) + C::kKBytes;
  }
  __device__ __forceinline__ uint32_t q(int s, int slab) const {
    return base + C::kStagesOff + s * C::kStageBytes + slab * C::kQSlab;
  }
  __device__ __forceinline__ uint32_t dout(int s, int slab) const {
    return q(s, slab) + C::kQBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + C::kBarOff + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full(C::kStages + s);
  }
  __device__ __forceinline__ uint32_t kv_full(int tb) const {
    return full(2 * C::kStages + tb);
  }
  __device__ __forceinline__ uint32_t kv_empty(int tb) const {
    return full(2 * C::kStages + 2 + tb);
  }
};

// A key tile of the dK/dV kernel. Tiles run key tile outer, from the
// lowest (the longest under a causal band), and (batch, kv head) inner:
// the blocks, each taking every gridDim.x-th tile, then work through
// tiles of one length at a time and finish together (longest first),
// where a (batch, head)-outer order would hand each block the same few
// key tiles of the causal triangle over and over.
struct KeyTile {
  int b, hk, k0, k_end;
  const int* seb;  // its (batch, se head) bands, or null
};

template <class C>
__device__ __forceinline__ KeyTile key_tile(const Args& a, int tile,
                                            int n_tiles) {
  const int nbh = n_tiles / ((a.Sk + C::kBK - 1) / C::kBK);  // B * Hkv
  const int ki = tile / nbh;
  const int bhk = tile - ki * nbh;
  KeyTile kt;
  kt.b = bhk / a.Hkv;
  kt.hk = bhk - kt.b * a.Hkv;
  kt.k0 = ki * C::kBK;
  kt.k_end = min(kt.k0 + C::kBK, a.Sk);
  // the group's query heads share one se head (h_se divides Hkv)
  kt.seb = a.se == nullptr ? nullptr
                           : a.se + kt.b * a.se_sb +
                                 (kt.hk / (a.Hkv / a.h_se)) * a.se_sh;
  return kt;
}

// The producer warp's walk over the items (query head of the GQA group,
// q tile) of key tile kt, from stage j on: every q tile fl::q_tile_range
// allows of every query head, minus the tiles one flashmask band covers
// whole for all the tile's keys (ext); per item, its rows' log2e lse (inf
// past Sq or for a row without keys) and Delta into the stage's rows, its
// first q row into the stage's tile, its Q and dO slabs by TMA; then a
// stage whose tile is -1 ends the key tile. Returns the next stage.
template <class C>
__device__ __forceinline__ int produce_items(const DkvSmem<C>& sm,
                                             const Maps& maps, const Args& a,
                                             const KeyTile& kt,
                                             const fl::Bands& ext, int j,
                                             int lane) {
  constexpr int S = C::kStages, kBQ = C::kBQ;
  const int H = a.H, Sq = a.Sq;
  const int rep = H / a.Hkv;
  int qt_lo, qt_hi;
  fl::q_tile_range(kt.k0, kt.k_end, Sq, kBQ, a.causal, a.window,
                   a.Sk - Sq, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = rep * nq;
  auto next = [&](int it) {  // the same in every lane (ext is)
    if (kt.seb != nullptr)
      for (; it < n_items; ++it) {
        const int qlo = (qt_lo + it % nq) * kBQ;
        if (!fl::tile_full(ext, qlo, min(qlo + kBQ, Sq))) break;
      }
    return it;
  };
  for (int it = next(0);; ++j) {
    const int s = j % S;
    if (j >= S) ggtc::mbar_wait(sm.empty(s), ((j / S) + 1) & 1);
    if (it >= n_items) {  // the end of the key tile
      if (lane == 0) sm.tile[s] = -1;
      ggtc::mbar_arrive(sm.full(s));
      return j + 1;
    }
    const int hq = kt.hk * rep + it / nq;
    const int qlo = (qt_lo + it % nq) * kBQ;
    const float* lse = a.lse + (size_t(kt.b) * H + hq) * Sq;
    const float* delta = a.delta + (size_t(kt.b) * H + hq) * Sq;
    float* rows = sm.rows + s * 2 * kBQ;
    for (int i = lane; i < kBQ; i += 32) {
      const int qi = qlo + i;
      const float l = qi < Sq ? lse[qi] : fl::kNegInf;
      rows[i] = l > fl::kRowInvalidLse ? l * tc::kLog2e : INFINITY;
      rows[kBQ + i] = qi < Sq ? delta[qi] : 0.f;
    }
    if (lane == 0) {
      sm.tile[s] = qlo;
      ggtc::mbar_expect_tx(sm.full(s), C::kStageBytes);
#pragma unroll
      for (int c = 0; c < C::kSlabs; ++c) {
        ggtc::tma_load4(sm.q(s, c), &maps.q, sm.full(s), 64 * c, hq, qlo,
                        kt.b);
        ggtc::tma_load4(sm.dout(s, c), &maps.dout, sm.full(s), 64 * c, hq,
                        qlo, kt.b);
      }
    } else {
      ggtc::mbar_arrive(sm.full(s));
    }
    it = next(it + 1);
  }
}

// S^T = K Q^T and dP^T = V dO^T of the item in stage s for this
// warpgroup's 64 keys (K and V from ka and va; two wgmma groups)
template <class C>
__device__ __forceinline__ void dkv_sdp(float (&st)[C::kBQ / 2],
                                        float (&dpt)[C::kBQ / 2],
                                        const DkvSmem<C>& sm, uint32_t ka,
                                        uint32_t va, int s) {
  using T = typename C::Elem;
  wg::ss<T, C::kBQ, C::kD>(st, ka, C::kKSlab, sm.q(s, 0), C::kQSlab);
  wg::ss<T, C::kBQ, C::kD>(dpt, va, C::kKSlab, sm.dout(s, 0), C::kQSlab);
}

// dV += P^T_hi dO + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q with the
// item in stage s (two wgmma groups)
template <class C>
__device__ __forceinline__ void dkv_acc(float (&dv)[C::kD / 2],
                                        float (&dk)[C::kD / 2],
                                        const unsigned (&ph)[C::kBQ / 16][4],
                                        const unsigned (&pl)[C::kBQ / 16][4],
                                        const unsigned (&dh)[C::kBQ / 16][4],
                                        const unsigned (&dl)[C::kBQ / 16][4],
                                        const DkvSmem<C>& sm, int s) {
  using T = typename C::Elem;
  wg::rs_split<T, C::kD, C::kBQ>(dv, ph, pl, sm.dout(s, 0), C::kQSlab);
  wg::rs_split<T, C::kD, C::kBQ>(dk, dh, dl, sm.q(s, 0), C::kQSlab);
}

// P^T in place of S^T and dS^T = P^T (dP^T - Delta) in place of dP^T for
// the item in stage s (first q row qlo): P^T = exp2(scale log2e S^T -
// log2e lse), 0 where the band, the window, the keys' bands or the ragged
// key edge mask the pair (checked only where they reach into this
// warpgroup's keys [k0w, k0w + 64)); this thread's keys kr and kr + 8
// (bands jb[0], jb[4 kBK]: this key's in the tile's band buffer, and the
// key 8 on), q columns 8 jj + 2 t (+1).
template <class C>
__device__ __forceinline__ void dkv_p_ds(float (&st)[C::kBQ / 2],
                                         float (&dpt)[C::kBQ / 2],
                                         const Args& a, const DkvSmem<C>& sm,
                                         int s, const int* jb, int qlo,
                                         int k0w, int kr, int t, float sl2) {
  constexpr int kBQ = C::kBQ, kBK = C::kBK;
  const int Sq = a.Sq, Sk = a.Sk, diag = Sk - Sq;
  const bool masked =
      jb != nullptr || k0w + 64 > Sk ||
      (a.causal && (qlo + diag < k0w + 63 ||
                    (a.window > 0 && qlo + kBQ - 1 + diag - k0w >= a.window)));
  fl::Bands bj[2] = {};
  if (masked && jb != nullptr)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bj[h] = fl::Bands{jb[8 * h], jb[kBK + 8 * h], jb[2 * kBK + 8 * h],
                        jb[3 * kBK + 8 * h]};
  const float* rows = sm.rows + s * 2 * kBQ;
#pragma unroll
  for (int jj = 0; jj < kBQ / 8; ++jj) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(rows + 8 * jj + 2 * t);
    const float2 dl =
        *reinterpret_cast<const float2*>(rows + kBQ + 8 * jj + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jj + e;
      float p = wg::exp2_ftz(fmaf(st[i], sl2, (e & 1) ? -l2.y : -l2.x));
      if (masked) {
        const int h = e >> 1;
        const int qi = qlo + 8 * jj + 2 * t + (e & 1);
        bool keep = fl::band_keep(qi, kr + 8 * h, Sq, Sk, a.causal,
                                  a.window, diag);
        if (jb != nullptr) keep = keep && !fl::band_masked(bj[h], qi);
        if (!keep) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kBlocks)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ Maps maps, Args a,
                               int n_tiles) {
  using T = typename C::Elem;
  constexpr int kD = C::kD, kBQ = C::kBQ, kBK = C::kBK, S = C::kStages;
  const int lane = threadIdx.x % 32;

  extern __shared__ uint8_t smem_dkv[];
  const uint32_t base = wg::aligned_base(smem_dkv);
  uint8_t* at = smem_dkv + (base - ggtc::smem_u32(smem_dkv));
  const DkvSmem<C> sm{base, reinterpret_cast<float*>(at + C::kRowsOff),
                      reinterpret_cast<int*>(at + C::kTileOff),
                      reinterpret_cast<int*>(at + C::kBandOff)};
  wg::init_barriers<S, C::kConsumers>(sm, [&] {
    for (int tb = 0; tb < 2; ++tb) {  // K and V's buffers, as the stages
      ggtc::mbar_init(sm.kv_full(tb), 32);
      ggtc::mbar_init(sm.kv_empty(tb), C::kConsumers / 32);
    }
  });

  if (wg::is_producer<C::kConsumers>()) {
    // -- the producer warp: per key tile K and V, the keys' bands, the
    //    items --
    if constexpr (C::kRebalance) {
      wg::setmaxnreg_dec<kProducerRegs>();
      if (threadIdx.x >= C::kConsumers + 32) return;  // one warp loads
    }
    int j = 0;
    for (int n = 0;; ++n) {
      const int tile = blockIdx.x + n * gridDim.x;
      if (tile >= n_tiles) break;
      const KeyTile kt = key_tile<C>(a, tile, n_tiles);
      const int tb = n & 1;
      // the consumers are done with the tile two back in this buffer
      if (n >= 2) ggtc::mbar_wait(sm.kv_empty(tb), ((n / 2) + 1) & 1);
      fl::Bands ext{};
      if (kt.seb != nullptr) {
        int* bands = sm.bands + tb * 4 * kBK;
        for (int c = lane; c < kBK; c += 32) {
          const fl::Bands bj = fl::load_bands(kt.seb, a.se_s4, kt.k0 + c,
                                              a.Sk);
          bands[c] = bj.lts;
          bands[kBK + c] = bj.lte;
          bands[2 * kBK + c] = bj.uts;
          bands[3 * kBK + c] = bj.ute;
        }
        ext = fl::warp_band_extremes<kBK>(kt.seb, a.se_s4, kt.k0, a.Sk,
                                          lane);
      }
      if (lane == 0) {
        ggtc::mbar_expect_tx(sm.kv_full(tb), 2 * C::kKBytes);
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c) {
          ggtc::tma_load4(sm.k(tb, c), &maps.k, sm.kv_full(tb), 64 * c,
                          kt.hk, kt.k0, kt.b);
          ggtc::tma_load4(sm.v(tb, c), &maps.v, sm.kv_full(tb), 64 * c,
                          kt.hk, kt.k0, kt.b);
        }
      } else {
        ggtc::mbar_arrive(sm.kv_full(tb));  // publishes the bands
      }
      j = produce_items<C>(sm, maps, a, kt, ext, j, lane);
    }
  } else {
    // -- the consumer warpgroups: keys k0w .. k0w + 63 of a tile each --
    if constexpr (C::kRebalance) wg::setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128;
    const int g = lane / 4, t = lane % 4;
    const int jr = 64 * w + (threadIdx.x / 32 % 4) * 16 + g;  // in a tile
    const float sl2 = a.scale * tc::kLog2e;
    float dk[kD / 2], dv[kD / 2];
    float st[kBQ / 2], dpt[kBQ / 2];
    // the fragments of the last item, live until its products retire
    unsigned ph[kBQ / 16][4], pl[kBQ / 16][4], dh[kBQ / 16][4],
        dl[kBQ / 16][4];
    int j = 0;
    for (int n = 0;; ++n) {
      const int tile = blockIdx.x + n * gridDim.x;
      if (tile >= n_tiles) break;
      const KeyTile kt = key_tile<C>(a, tile, n_tiles);
      const int tb = n & 1;
      const int k0w = kt.k0 + 64 * w;
      const int kr = kt.k0 + jr;  // this thread's keys kr, kr + 8
      const int* jb = kt.seb == nullptr ? nullptr
                                        : sm.bands + tb * 4 * kBK + jr;
      const uint32_t ka = sm.k(tb, 0) + w * 64 * 128;
      const uint32_t va = sm.v(tb, 0) + w * 64 * 128;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

      ggtc::mbar_wait(sm.kv_full(tb), (n / 2) & 1);
      int s = j % S;
      ggtc::mbar_wait(sm.full(s), (j / S) & 1);
      int qlo = wg::uniform(sm.tile + s);
      if (qlo >= 0) {
        ggtc::wgmma_fence();
        dkv_sdp(st, dpt, sm, ka, va, s);
        ggtc::wgmma_wait<0>();
        ggtc::fence_acc(st);
        ggtc::fence_acc(dpt);
        dkv_p_ds<C>(st, dpt, a, sm, s, jb, qlo, k0w, kr, t, sl2);
        wg::split<T, kBQ>(st, ph, pl);
        wg::split<T, kBQ>(dpt, dh, dl);
        int s_prev = s;
        for (++j;; ++j) {
          s = j % S;
          ggtc::mbar_wait(sm.full(s), (j / S) & 1);
          qlo = wg::uniform(sm.tile + s);
          if (qlo < 0) break;
          ggtc::wgmma_fence();
          dkv_sdp(st, dpt, sm, ka, va, s);
          dkv_acc(dv, dk, ph, pl, dh, dl, sm, s_prev);
          ggtc::wgmma_wait<2>();  // S^T and dP^T (dV's, dK's may run on)
          ggtc::fence_acc(st);
          ggtc::fence_acc(dpt);
          dkv_p_ds<C>(st, dpt, a, sm, s, jb, qlo, k0w, kr, t, sl2);
          ggtc::wgmma_wait<0>();  // the previous item's dV and dK products
          ggtc::fence_acc(dv);
          ggtc::fence_acc(dk);
          wg::fence(ph);
          wg::fence(pl);
          wg::fence(dh);
          wg::fence(dl);
          if (lane == 0) ggtc::mbar_arrive(sm.empty(s_prev));
          wg::split<T, kBQ>(st, ph, pl);
          wg::split<T, kBQ>(dpt, dh, dl);
          s_prev = s;
        }
        ggtc::wgmma_fence();
        dkv_acc(dv, dk, ph, pl, dh, dl, sm, s_prev);
        ggtc::wgmma_wait<0>();
        ggtc::fence_acc(dv);
        ggtc::fence_acc(dk);
        if (lane == 0) ggtc::mbar_arrive(sm.empty(s_prev));
      }
      // stage s ends the key tile; K and V of buffer tb are read no more
      if (lane == 0) {
        ggtc::mbar_arrive(sm.empty(s));
        ggtc::mbar_arrive(sm.kv_empty(tb));
      }
      ++j;

      // dK carries the scale of S = scale q k^T once, here
      T* dkb = static_cast<T*>(a.out0);
      T* dvb = static_cast<T*>(a.out1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kr + 8 * h;
        if (key >= a.Sk) continue;
        const size_t off =
            ((size_t(kt.b) * a.Sk + key) * a.Hkv + kt.hk) * size_t(a.D);
#pragma unroll
        for (int jj = 0; jj < kD / 8; ++jj) {
          const int c = 8 * jj + 2 * t;
          if (c < a.D) {
            *reinterpret_cast<unsigned*>(dkb + off + c) =
                tc::pack2<T>(dk[4 * jj + 2 * h] * a.scale,
                             dk[4 * jj + 2 * h + 1] * a.scale);
            *reinterpret_cast<unsigned*>(dvb + off + c) =
                tc::pack2<T>(dv[4 * jj + 2 * h], dv[4 * jj + 2 * h + 1]);
          }
        }
      }
    }
  }
}

}  // namespace bwg

// The wgmma kernels' configurations by tile head dim (chosen by timing
// variants at the LLaMA, ERNIE-MoE and BERT training shapes on an H100;
// PERF.md): dQ with 32-key tiles, 3 blocks an SM at 64 (106 registers)
// and 2 at 128 (150; 64-key tiles spill there at the 168 a thread that 10
// warps an SM leave); dK/dV with 32-row items, at 64 one consumer
// warpgroup and 2 blocks an SM (168 registers, no spills), at 128 two
// consumer warpgroups fed registers by the producer warpgroup (224 / 56,
// no spills).
template <typename T>
using Dq64 = bwg::DqCfg<T, 64, 4, 3>;
template <typename T>
using Dq128 = bwg::DqCfg<T, 128, 4, 2>;
template <typename T>
using Dkv64 = bwg::DkvCfg<T, 64, 1, 4, 2>;
template <typename T>
using Dkv128 = bwg::DkvCfg<T, 128, 2, 4, 1>;

// One launch of a wgmma kernel: the tensor maps over (D, heads, S, B) with
// the caller's strides (Q and dO in boxes of kq rows, K and V of kk), then
// `blocks` blocks with (maps, a, extra...); a map that cannot be encoded is
// an error (no other route).
template <class C, typename Kernel, typename... Extra>
int launch_wgmma(Kernel kernel, const Args& a, int B, int dtype, int kq,
                 int kk, long long blocks, cudaStream_t stream,
                 Extra... extra) {
  bwg::Maps maps{};
  if (!wg::make_map_bshd(&maps.q, a.q, dtype, a.D, a.H, a.Sq, B, a.q_sh,
                         a.q_ss, a.q_sb, kq) ||
      !wg::make_map_bshd(&maps.dout, a.dout, dtype, a.D, a.H, a.Sq, B,
                         a.do_sh, a.do_ss, a.do_sb, kq) ||
      !wg::make_map_bshd(&maps.k, a.k, dtype, a.D, a.Hkv, a.Sk, B, a.k_sh,
                         a.k_ss, a.k_sb, kk) ||
      !wg::make_map_bshd(&maps.v, a.v, dtype, a.D, a.Hkv, a.Sk, B, a.v_sh,
                         a.v_ss, a.v_sb, kk))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return int(e);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), C::kThreads, C::kSmemBytes, stream>>>(
      maps, a, extra...);
  return int(cudaGetLastError());
}

template <class C>
int launch_dq_wgmma(const Args& a, int B, int dtype, cudaStream_t stream) {
  const long long blocks =
      (long long)((a.Sq + bwg::kBQ - 1) / bwg::kBQ) * B * a.H;
  return launch_wgmma<C>(bwg::flash_bwd_dq_wgmma_kernel<C>, a, B, dtype,
                         bwg::kBQ, C::kBN, blocks, stream);
}

// The persistent dK/dV kernel: kBlocks blocks an SM (at most one a key
// tile) walk the key tiles.
template <class C>
int launch_dkv_wgmma(const Args& a, int B, int dtype, cudaStream_t stream) {
  const long long tiles =
      (long long)((a.Sk + C::kBK - 1) / C::kBK) * B * a.Hkv;
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const long long slots = (long long)sms * C::kBlocks;
  return launch_wgmma<C>(bwg::flash_bwd_dkv_wgmma_kernel<C>, a, B, dtype,
                         C::kBQ, C::kBK, tiles < slots ? tiles : slots,
                         stream, int(tiles));
}

// ------------------------------------------------------------ launch --

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T, int kDPL>
int launch_dq_dpl(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kDPL>;
  const size_t smem = dq_smem_bytes(a.D);
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid(B * a.H, (a.Sq + kQBQ - 1) / kQBQ);
  kernel<<<grid, kQThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int kDPL>
int launch_dkv_dpl(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kDPL>;
  const size_t smem = dkv_smem_bytes(a.D);
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid(B * a.Hkv, (a.Sk + kKBK - 1) / kKBK);
  kernel<<<grid, kKThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch_dkv_tc(const Args& a, int B, cudaStream_t stream) {
  using C = DkvTc;
  if (int e = set_smem(flash_bwd_dkv_tc_kernel, C::kSmem)) return e;
  dim3 grid(B * a.Hkv, (a.Sk + C::kBK - 1) / C::kBK);
  flash_bwd_dkv_tc_kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch_dq_tc(const Args& a, int B, cudaStream_t stream) {
  using C = DqTc;
  if (int e = set_smem(flash_bwd_dq_tc_kernel, C::kSmem)) return e;
  dim3 grid(B * a.H, (a.Sq + C::kBQ - 1) / C::kBQ);
  flash_bwd_dq_tc_kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return int(cudaGetLastError());
}

// The tc route (bf16 only): the wgmma kernels where tc::wgmma holds (tile
// head dims up to 128), the mma.sync kernels at 256; *launched says which
// (tc::Launched).
int launch_tc(const Args& a, int B, tc::Kernel kernel, int dtype,
              cudaStream_t s, int* launched) {
  using T = __nv_bfloat16;
  const bool dq = kernel == tc::kDq;
  if (!tc::wgmma(a.D)) {
    *launched = tc::kLaunchedMma;
    return dq ? launch_dq_tc(a, B, s) : launch_dkv_tc(a, B, s);
  }
  *launched = tc::kLaunchedWgmma;
  if (tc::tile_d(a.D) <= 64)
    return dq ? launch_dq_wgmma<Dq64<T>>(a, B, dtype, s)
              : launch_dkv_wgmma<Dkv64<T>>(a, B, dtype, s);
  return dq ? launch_dq_wgmma<Dq128<T>>(a, B, dtype, s)
            : launch_dkv_wgmma<Dkv128<T>>(a, B, dtype, s);
}

// the simt kernels: which 0 dQ, 1 dK/dV
template <typename T>
int launch(const Args& a, int B, int which, cudaStream_t stream) {
  const int dpl = a.D <= 32 ? 1 : a.D <= 64 ? 2 : a.D <= 128 ? 4
                : a.D <= 256 ? 8 : 0;
  switch (which * 16 + dpl) {
    case 1: return launch_dq_dpl<T, 1>(a, B, stream);
    case 2: return launch_dq_dpl<T, 2>(a, B, stream);
    case 4: return launch_dq_dpl<T, 4>(a, B, stream);
    case 8: return launch_dq_dpl<T, 8>(a, B, stream);
    case 17: return launch_dkv_dpl<T, 1>(a, B, stream);
    case 18: return launch_dkv_dpl<T, 2>(a, B, stream);
    case 20: return launch_dkv_dpl<T, 4>(a, B, stream);
    case 24: return launch_dkv_dpl<T, 8>(a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// One backward kernel (dQ or dK/dV) on the route `tc::route` gives;
// *launched (unless null) is set to the kernel it ran (tc::Launched).
int dispatch(const Args& a, int B, tc::Kernel kernel, int dtype,
             void* stream, int* launched) {
  if (a.h_se < 1 || a.H % a.Hkv != 0 || a.Hkv % a.h_se != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const long long st[12] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb,  a.k_ss,
                            a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.do_sb,
                            a.do_ss, a.do_sh};
  int ran = tc::kLaunchedSimt;
  if (launched == nullptr) launched = &ran;
  *launched = tc::kLaunchedSimt;
  if (tc::route(kernel, dtype, a.D, ptrs, 4, st, 12) == tc::kTc)
    return launch_tc(a, B, kernel, dtype, s, launched);
  const int which = kernel == tc::kDq ? 0 : 1;
  switch (dtype) {
    case pt::kF32: return launch<float>(a, B, which, s);
    case pt::kBF16: return launch<__nv_bfloat16>(a, B, which, s);
    case pt::kF16: return launch<__half>(a, B, which, s);
    default: return int(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* out0, void* out1,
               int H, int Hkv, int Sq, int Sk, int D, const long long* st,
               const void* se, long long se_sb, long long se_sh,
               long long se_s4, int h_se, int causal, int window,
               float scale) {
  return Args{q,      k,      v,      dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              out0,   out1,   static_cast<const int*>(se),
              H,      Hkv,    Sq,     Sk,     D,
              st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
              st[6],  st[7],  st[8],  st[9],  st[10], st[11],
              se_sb,  se_sh,  se_s4,  h_se,   causal, window, scale};
}

}  // namespace

PT_DEFINE_PROBE(flash_bwd)

// Shared argument list of the two entries. q/dout [B, Sq, H, D] and
// k/v [B, Sk, Hkv, D] by element strides (batch, seq, head; unit last
// stride), lse and delta f32 [B, H, Sq] contiguous, outputs contiguous
// in the paddle layout and the inputs' dtype: dq [B, Sq, H, D] (out1
// unused) or dk, dv [B, Sk, Hkv, D]. se: int32 flashmask bands by
// strides (batch — 0 broadcasts —, se head, band; unit column stride)
// with h_se se heads dividing Hkv, or null. window <= 0: no window.
// *kernel (unless null) is set to the kernel the launch ran
// (tc::Launched: 0 simt, 2 tc mma.sync, 3 tc wgmma). Each returns
// cudaGetLastError() after its launch.
#define FLASH_BWD_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *lse, const void *delta, void *out0, void *out1, int B,   \
      int H, int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,      \
      long long v_sb, long long v_ss, long long v_sh, long long do_sb,     \
      long long do_ss, long long do_sh, const void *se, long long se_sb,   \
      long long se_sh, long long se_s4, int h_se, int causal, int window,  \
      float scale, int dtype, void *stream, int *kernel

#define FLASH_BWD_ARGS                                                      \
  make_args(q, k, v, dout, lse, delta, out0, out1, H, Hkv, Sq, Sk, D, st,  \
            se, se_sb, se_sh, se_s4, h_se, causal, window, scale)

extern "C" int flash_bwd_dq_launch(FLASH_BWD_PARAMS) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  return dispatch(FLASH_BWD_ARGS, B, tc::kDq, dtype, stream, kernel);
}

extern "C" int flash_bwd_dkv_launch(FLASH_BWD_PARAMS) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  if (out1 == nullptr) return int(cudaErrorInvalidValue);
  return dispatch(FLASH_BWD_ARGS, B, tc::kDkv, dtype, stream, kernel);
}
