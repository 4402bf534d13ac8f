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
// - dQ kernel: one block per (batch*head, 64-row q tile), 4 warps of 16
//   rows. Q (pre-scaled), dO, lse and Delta are staged once; K and V
//   stream through shared memory 32 keys at a time over the key tiles
//   the band and window allow. Per tile S and dP are recomputed (lane =
//   key column), dS goes through shared memory, and dS K accumulates in
//   f32 registers (lane = output column).
// - dK/dV kernel: here the port departs from the Pallas block structure,
//   which writes per-q-head partials in k's dtype and sums a GQA group
//   afterwards. One block per (batch, kv head, 64-key tile), 8 warps of
//   8 keys, keeps its K and V tile in shared memory and loops over the
//   group's rep query heads and over the q tiles (32 rows, lane = row)
//   the band and window allow. dK and dV accumulate in f32 registers
//   across the whole group and are written once: no partial buffer, no
//   second pass, no atomics, and the result is deterministic.
//
// Both skip a tile whose every row one flashmask band covers before its
// operands are staged.
//
// What bounds them on an H100: arithmetic. A backward pass does 2.5x the
// forward's operations (S once more, dP, dV, dK, dQ); these kernels
// recompute S and dP in each of the two kernels, so they do 3.5x, in
// f32 on the CUDA cores (67 TFLOP/s peak), against O(S*D) bytes. The
// inner loops read 16-byte vectors from padded shared memory (a row per
// lane at stride dp + 4 is bank-conflict free) so they stay FMA-bound.
// Tensor-core tiles, TMA pipelining and sharing S/dP between dQ and
// dK/dV are later work.
#include "flash_common.cuh"

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

int dispatch(const Args& a, int B, int which, int dtype, void* stream) {
  if (a.h_se < 1 || a.H % a.Hkv != 0 || a.Hkv % a.h_se != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pt::kF32:
      return launch<float>(a, B, which, s);
    case pt::kBF16:
      return launch<__nv_bfloat16>(a, B, which, s);
    case pt::kF16:
      return launch<__half>(a, B, which, s);
    default:
      return int(cudaErrorInvalidValue);
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
  return dispatch(FLASH_BWD_ARGS, B, 0, dtype, stream);
}

extern "C" int flash_bwd_dkv_launch(FLASH_BWD_PARAMS) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  if (out1 == nullptr) return int(cudaErrorInvalidValue);
  return dispatch(FLASH_BWD_ARGS, B, 1, dtype, stream);
}
