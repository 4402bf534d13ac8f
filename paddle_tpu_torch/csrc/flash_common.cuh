// Pieces shared by the flash forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels of both routes (simt and tc), so no two of them
// can mask or skip differently (the counterpart of the helpers shared by
// the three Pallas kernels in paddle_tpu/kernels/flash_attention.py:
// 151-273).
//
// Layout of the flashmask bands: the wrapper normalizes
// startend_row_indices to int32 [B|1, h_se, 4, Sk] (lts, lte, uts, ute
// per key column, `_normalize_startend` :190) and passes its batch, head
// and band strides; key column j is masked for query rows in
// [lts[j], lte[j]) or [uts[j], ute[j]) (`_flashmask_tile` :227).
#pragma once

#include <climits>

#include "common.cuh"

namespace fl {

constexpr float kNegInf = -1e30f;                 // NEG_INF
constexpr float kRowInvalidLse = kNegInf / 2.f;   // ROW_INVALID_LSE :273

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

// Stage rows [r0, r0 + nrows) of one (batch, head) slice into f32 shared
// memory rows of stride `ds`, multiplied by `mul`; rows past `nvalid` and
// columns in [d, dp) are zero. kNT threads take part.
template <typename T, int kNT>
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
    for (int idx = tid; idx < nrows * vpr; idx += kNT) {
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
    for (int idx = tid; idx < nrows * (dp - d); idx += kNT) {
      const int j = idx / (dp - d);
      dst[j * ds + d + (idx - j * (dp - d))] = 0.f;
    }
  } else {
    for (int idx = tid; idx < nrows * dp; idx += kNT) {
      const int j = idx / dp;
      const int c = idx - j * dp;
      dst[j * ds + c] = (r0 + j < nvalid && c < d)
                            ? pt::to_f32(base[(r0 + j) * row_stride + c]) * mul
                            : 0.f;
    }
  }
}

// Key tiles [*lo, *hi) of width bk that can meet query rows [q0, q_end)
// under the bottom-right causal band and the window (`_causal_k_hi` :151,
// `_window_k_lo` :169); all tiles when not causal.
__device__ __forceinline__ void k_tile_range(int q0, int q_end, int Sk,
                                             int bk, int causal, int window,
                                             int diag, int* lo, int* hi) {
  const int nkt = (Sk + bk - 1) / bk;
  *lo = 0;
  *hi = nkt;
  if (!causal) return;
  const int last_k = q_end - 1 + diag;
  *hi = last_k < 0 ? 0 : min(nkt, last_k / bk + 1);
  if (window > 0) {
    const int first_k = q0 + diag - window + 1;
    *lo = first_k > 0 ? min(nkt, first_k / bk) : 0;
  }
}

// Query tiles [*lo, *hi) of height bq that can see keys [k0, k_end)
// (`_causal_q_lo` :161, `_window_q_hi` :179); all tiles when not causal.
__device__ __forceinline__ void q_tile_range(int k0, int k_end, int Sq,
                                             int bq, int causal, int window,
                                             int diag, int* lo, int* hi) {
  const int nqt = (Sq + bq - 1) / bq;
  *lo = 0;
  *hi = nqt;
  if (!causal) return;
  const int first_q = k0 - diag;
  *lo = first_q > 0 ? min(nqt, first_q / bq) : 0;
  if (window > 0) {
    const int last_q = k_end - 1 + window - 1 - diag;
    *hi = last_q < 0 ? 0 : min(nqt, last_q / bq + 1);
  }
}

// The causal band and window of one (query row, key column) pair
// (`_band_mask` :252), plus the ragged edges.
__device__ __forceinline__ bool band_keep(int qi, int kj, int Sq, int Sk,
                                          int causal, int window, int diag) {
  bool keep = qi < Sq && kj < Sk;
  if (causal) {
    keep = keep && (qi + diag >= kj);
    if (window > 0) keep = keep && (qi + diag - kj < window);
  }
  return keep;
}

// One key column's flashmask bands.
struct Bands {
  int lts, lte, uts, ute;
};

// Bands of column kj of one (batch, se head) slice `seb` (band stride
// s4); a column past Sk gets bands that mask nothing and never stop a
// tile skip (max/min neutral values).
__device__ __forceinline__ Bands load_bands(const int* __restrict__ seb,
                                            long long s4, int kj, int Sk) {
  if (kj >= Sk) return Bands{INT_MIN, INT_MAX, INT_MIN, INT_MAX};
  return Bands{seb[kj], seb[s4 + kj], seb[2 * s4 + kj], seb[3 * s4 + kj]};
}

__device__ __forceinline__ bool band_masked(const Bands& b, int row) {
  return (row >= b.lts && row < b.lte) || (row >= b.uts && row < b.ute);
}

// `_flashmask_tile_full` :239: every row of [q_lo, q_hi) is masked in
// every column of the tile, because one band covers them all. Inputs are
// the tile's max lts, min lte, max uts and min ute.
__device__ __forceinline__ bool tile_full(int mx_lts, int mn_lte, int mx_uts,
                                          int mn_ute, int q_lo, int q_hi) {
  return (mx_lts <= q_lo && mn_lte >= q_hi) ||
         (mx_uts <= q_lo && mn_ute >= q_hi);
}

// tile_full over a tile of 32 key columns held one per lane (every lane
// of the warp gets the same answer).
__device__ __forceinline__ bool warp_tile_full(const Bands& b, int q_lo,
                                               int q_hi) {
  const unsigned all = 0xffffffffu;
  return tile_full(__reduce_max_sync(all, b.lts),
                   __reduce_min_sync(all, b.lte),
                   __reduce_max_sync(all, b.uts),
                   __reduce_min_sync(all, b.ute), q_lo, q_hi);
}

// The tile_full inputs (max lts, min lte, max uts, min ute) of key
// columns [k0, k0 + kNK) (kNK a multiple of 32), the same in every lane.
template <int kNK>
__device__ __forceinline__ Bands warp_band_extremes(
    const int* __restrict__ seb, long long s4, int k0, int Sk, int lane) {
  Bands e = load_bands(seb, s4, k0 + lane, Sk);
#pragma unroll
  for (int i = 1; i < kNK / 32; ++i) {
    const Bands b = load_bands(seb, s4, k0 + lane + 32 * i, Sk);
    e.lts = max(e.lts, b.lts);
    e.lte = min(e.lte, b.lte);
    e.uts = max(e.uts, b.uts);
    e.ute = min(e.ute, b.ute);
  }
  const unsigned all = 0xffffffffu;
  return Bands{__reduce_max_sync(all, e.lts), __reduce_min_sync(all, e.lte),
               __reduce_max_sync(all, e.uts), __reduce_min_sync(all, e.ute)};
}

__device__ __forceinline__ bool tile_full(const Bands& ext, int q_lo,
                                          int q_hi) {
  return tile_full(ext.lts, ext.lte, ext.uts, ext.ute, q_lo, q_hi);
}

}  // namespace fl
