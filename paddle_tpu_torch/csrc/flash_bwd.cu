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
// 16-bit split: csrc/flash_tc.cuh), odd head dims, unaligned rows.
//
// - dQ kernel, tc (`flash_bwd_dq_tc_kernel`): the tc forward's block
//   structure with q rows as the M dimension; S, dP and dQ += dS K by
//   mma.sync from ldmatrix fragments, dS split into bf16 hi + lo terms for
//   its product (below). simt (`flash_bwd_dq_kernel`): one block per
//   (batch*head, 64-row q tile), 4 warps of 16 rows. Q (pre-scaled), dO,
//   lse and Delta are staged once; K and V stream through shared memory
//   32 keys at a time over the key tiles the band and window allow. Per
//   tile S and dP are recomputed (lane = key column), dS goes through
//   shared memory, and dS K accumulates in f32 registers (lane = output
//   column).
// - dK/dV kernel: here the port departs from the Pallas block structure,
//   which writes per-q-head partials in k's dtype and sums a GQA group
//   afterwards. One block per (batch, kv head, 64-key tile) keeps its K
//   and V tile in shared memory and loops over the group's rep query
//   heads and over the q tiles the band and window allow. dK and dV
//   accumulate in f32 registers across the whole group and are written
//   once: no partial buffer, no second pass, no atomics, and the result
//   is deterministic.
//   - tc: `flash_bwd_dkv_tc_kernel`, mma.sync tiles with keys as the M
//     dimension, Q/dO streamed through a cp.async ring, P^T and dS^T split
//     into bf16 hi + lo terms for the second products (one bf16 rounding
//     fails the port's gate ~9-23x, the split passes it at ~0.48;
//     csrc/flash_tc.cuh). Two 16 x 128 f32 accumulators a warp are 128
//     registers a thread at head dim <= 128; head dim 256 splits the
//     columns over two warps.
//   - simt: `flash_bwd_dkv_kernel`, 8 warps of 8 keys, 32-row q tiles
//     (lane = row), f32 FMA on the CUDA cores.
//
// Both kernels skip a tile whose every row one flashmask band covers
// before its operands are staged, and read the same lse and Delta.
//
// What bounds them on an H100: arithmetic. A backward pass does 2.5x the
// forward's operations (S once more, dP, dV, dK, dQ); these kernels
// recompute S and dP in each of the two kernels, so they do 3.5x (the tc
// route 1.5x that on the split products). The simt inner loops read
// 16-byte vectors from padded shared memory (a row per lane at stride
// dp + 4 is bank-conflict free) so they stay FMA-bound. wgmma tiles and
// sharing S/dP between dQ and dK/dV are later work.
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

// ------------------------------------------------------ dK/dV, tc route --
//
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
// atomics, no partial buffers, deterministic. At head dim 256 eight warps
// run: two per key row, each owning half of dK's and dV's columns (and
// both computing that row's S^T and dP^T), so the accumulators stay at
// 128 registers a thread.

template <int kD>
struct DkvTc {
  static constexpr int kWD = kD > 128 ? 2 : 1;  // warps per 16-key row
  static constexpr int kDW = kD / kWD;          // dK/dV columns per warp
  static constexpr int kWarps = 4 * kWD;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = 64;                // keys per block
  static constexpr int kBQ = 32;                // q rows per tile
  static constexpr int kLd = kD + 8;            // shared row stride
  template <typename T>
  static constexpr size_t smem() {
    // K, V [kBK][kLd]; Q, dO [2][kBQ][kLd]; lse, Delta [2][kBQ] (f32)
    return sizeof(T) * (2 * size_t(kBK) * kLd + 4 * size_t(kBQ) * kLd) +
           sizeof(float) * 4 * size_t(kBQ);
  }
};

template <typename T, int kD>
__global__ void __launch_bounds__(DkvTc<kD>::kThreads)
    flash_bwd_dkv_tc_kernel(Args a) {
  using C = DkvTc<kD>;
  constexpr int kBK = C::kBK, kBQ = C::kBQ, kLd = C::kLd;
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

// --------------------------------------------------------- dQ, tc route --
//
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
// once on store. At head dim 256 eight warps run: two per row tile, each
// owning half of dQ's columns (both compute that tile's S and dP), so the
// accumulator stays at 64 registers a thread. GQA by index: q head h reads
// kv head h / rep, and dQ needs no group sum. bf16 only (see the route
// rule in flash_tc.cuh).

template <int kD>
struct DqTc {
  static constexpr int kWD = kD > 128 ? 2 : 1;    // warps per row tile
  static constexpr int kDW = kD / kWD;            // dQ columns per warp
  static constexpr int kM = 1;                    // m16 row tiles a warp
  static constexpr int kWarps = 4 * kWD;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 64 * kM;             // q rows per block
  static constexpr int kBK = kD <= 64 ? 64 : 32;  // keys per tile
  static constexpr int kLd = kD + 8;              // shared row stride
  static constexpr int kNT = kBK / 8;             // S n8 tiles
  static constexpr int kDT = kDW / 8;             // dQ n8 tiles per warp
  template <typename T>
  static constexpr size_t smem() {
    // Q, dO [kBQ][kLd]; K, V [2][kBK][kLd]; bands [2][4][kBK] (int)
    return sizeof(T) * (2 * size_t(kBQ) + 4 * size_t(kBK)) * kLd +
           sizeof(int) * 8 * size_t(kBK);
  }
};

template <int kD>
__global__ void __launch_bounds__(DqTc<kD>::kThreads)
    flash_bwd_dq_tc_kernel(Args a) {
  using T = __nv_bfloat16;
  using C = DqTc<kD>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kLd = C::kLd, kM = C::kM;
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

template <typename T, int kD>
int launch_dkv_tc_d(const Args& a, int B, cudaStream_t stream) {
  using C = DkvTc<kD>;
  auto kernel = flash_bwd_dkv_tc_kernel<T, kD>;
  const size_t smem = C::template smem<T>();
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid(B * a.Hkv, (a.Sk + C::kBK - 1) / C::kBK);
  kernel<<<grid, C::kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int kD>
int launch_dq_tc_d(const Args& a, int B, cudaStream_t stream) {
  using C = DqTc<kD>;
  auto kernel = flash_bwd_dq_tc_kernel<kD>;
  const size_t smem = C::template smem<__nv_bfloat16>();
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid(B * a.H, (a.Sq + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// the tc kernels (bf16 only) at the tile head dim of D
int launch_tc(const Args& a, int B, tc::Kernel kernel, cudaStream_t s) {
  using T = __nv_bfloat16;
  const bool dq = kernel == tc::kDq;
  switch (tc::tile_d(a.D)) {
    case 32: return dq ? launch_dq_tc_d<32>(a, B, s)
                       : launch_dkv_tc_d<T, 32>(a, B, s);
    case 64: return dq ? launch_dq_tc_d<64>(a, B, s)
                       : launch_dkv_tc_d<T, 64>(a, B, s);
    case 128: return dq ? launch_dq_tc_d<128>(a, B, s)
                        : launch_dkv_tc_d<T, 128>(a, B, s);
    default: return dq ? launch_dq_tc_d<256>(a, B, s)
                       : launch_dkv_tc_d<T, 256>(a, B, s);
  }
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

// One backward kernel (dQ or dK/dV) on the route `tc::route` gives.
int dispatch(const Args& a, int B, tc::Kernel kernel, int dtype,
             void* stream) {
  if (a.h_se < 1 || a.H % a.Hkv != 0 || a.Hkv % a.h_se != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const long long st[12] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb,  a.k_ss,
                            a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.do_sb,
                            a.do_ss, a.do_sh};
  if (tc::route(kernel, dtype, a.D, ptrs, 4, st, 12) == tc::kTc)
    return launch_tc(a, B, kernel, s);
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
// Each returns cudaGetLastError() after its launch.
#define FLASH_BWD_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *lse, const void *delta, void *out0, void *out1, int B,   \
      int H, int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,      \
      long long v_sb, long long v_ss, long long v_sh, long long do_sb,     \
      long long do_ss, long long do_sh, const void *se, long long se_sb,   \
      long long se_sh, long long se_s4, int h_se, int causal, int window,  \
      float scale, int dtype, void *stream

#define FLASH_BWD_ARGS                                                      \
  make_args(q, k, v, dout, lse, delta, out0, out1, H, Hkv, Sq, Sk, D, st,  \
            se, se_sb, se_sh, se_s4, h_se, causal, window, scale)

extern "C" int flash_bwd_dq_launch(FLASH_BWD_PARAMS) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  return dispatch(FLASH_BWD_ARGS, B, tc::kDq, dtype, stream);
}

extern "C" int flash_bwd_dkv_launch(FLASH_BWD_PARAMS) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  if (out1 == nullptr) return int(cudaErrorInvalidValue);
  return dispatch(FLASH_BWD_ARGS, B, tc::kDkv, dtype, stream);
}
