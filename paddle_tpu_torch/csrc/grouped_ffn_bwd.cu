// Grouped expert FFN backward for Hopper: the dx kernel and the dw kernel.
//
// Replaces the Pallas kernels `_grouped_ffn_bwd_dx_kernel` and
// `_grouped_ffn_bwd_dw_kernel` launched by `_grouped_ffn_bwd_pallas`
// (paddle_tpu/kernels/moe.py:344, :462, :552). Same formulas and rounding
// points, on live rows (r < counts[e], read on the device) only:
//
//   gw = round_T(g ws)   z = x w1 + b1   ha = round_T(act(z))
//   dh = gw w2^T         dz = dh act'(z) (f32), dz_T = round_T(dz)
//   dx  = round_T(dz_T w1^T), zero on dead rows
//   dws = sum_h g (ha w2 + b2), zero on dead rows     db2 = sum_rows g ws
//   dw1 = x^T dz_T       db1 = sum_rows dz (f32)      dw2 = ha^T gw
//
// Products accumulate in f32: on the tensor cores ("tc" route, bf16 and
// fp16 with h and dff multiples of 8, gg::route) through the Hopper
// mainloop of grouped_gemm_tc.cuh (wgmma on TMA-fed 128 x 128 tiles), or
// on the CUDA cores ("simt" route: f32, odd widths) through the tiled
// product of grouped_gemm.cuh (64 x 64 tiles). Both entries pick their
// route by that rule, so they agree on the same operands.
//
// Design. The Pallas dw kernel recomputes z and dh for its ff tile and
// keeps dw1 [h, 512] and dw2 [512, h] f32 accumulators (4 MB) in VMEM;
// the dx kernel sums db2 into an output block that stays resident because
// the TPU grid runs in order. Neither carries to an H100 (227 KB of
// shared memory a block by the data sheet, blocks in no order). Here:
//
// - dx entry (row 8), on the caller's stream:
//   0. (tc only) gw = round_T(g ws) of the live rows, zero on the dead,
//      into the wrapper's scratch [E, C, h]: TMA cannot scale rows while
//      it loads, so the product reads gw as stored (bit for bit the value
//      gg::ScaledRows computes on load on the simt route);
//   1. blocks (expert, row tile, ff tile): z and dh (two products over
//      h), then ha and dz_T of the live rows into the wrapper's scratch
//      [E, C, dff] in T, and the column sums of f32 dz over each 64-row
//      tile into db1_part [E, C/64, dff];
//   2. blocks (expert, row tile, h tile): dx = dz_T w1^T and ha w2 (two
//      products over dff), dx written, the row sums of g (ha w2 + b2)
//      over each 64-column tile into dws_part [E, C, h/64] and the column
//      sums of g ws over each 64-row tile into db2_part [E, C/64, h];
//   3. one pass summing the partials in a fixed order into dws and db2.
//   The partials keep their 64-granular layout on both routes: a 128-row
//   tc block writes one row-tile partial per warpgroup, and one column
//   partial per 64 columns.
// - dw entry (row 9), reading the dx entry's scratch:
//   1. dw1 = x^T dz_T, blocks (expert, h tile, ff tile), the product's
//      depth running over the expert's live rows only;
//   2. dw2 = ha^T gw, blocks (expert, ff tile, h tile), likewise (the
//      simt route scales g by ws on load; the tc route reads the dx
//      entry's gw scratch);
//   3. db1 from db1_part.
//   On the tc route both products read both operands MN-major (x, dz,
//   ha, gw as stored: the descriptors' transpose bits), cdiv(count, 64)
//   stages deep; the rows of the last stage past the count lie inside C
//   and may hold anything (the caller's dispatch buffer, scratch rows the
//   dx entry never writes), so the consumers zero them in both tiles
//   before that stage's products (ggtc::zero_k_rows).
//
// So the backward does six products where the Pallas pair recomputes z
// and dh in both kernels (eight), at the price of the scratch: 2 x E x C
// x dff elements of T (and E x C x h for gw on the tc route) plus the
// partials. Every sum runs in a fixed order:
// no atomics, the result is deterministic. A block of dead rows writes
// zeros where the output has rows (dx) and exits; an expert with no live
// row issues no read and gets dw1 = dw2 = 0.
//
// What bounds it on an H100: at the training shape arithmetic (each
// product 2 x rows x h x dff operations): on the tc route both entries'
// products run on the tensor cores; on the simt route in f32 on the CUDA
// cores.
#include "grouped_gemm_tc.cuh"

namespace {

struct BwdArgs {
  const void* x;
  const void* g;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* ws;
  const int* counts;
  void* ha;          // [E, C, dff] T scratch
  void* dz;          // [E, C, dff] T scratch
  void* gw;          // [E, C, h] T scratch (tc route)
  float* db1_part;   // [E, nrt, dff]
  float* db2_part;   // [E, nrt, h]
  float* dws_part;   // [E, C, nct]
  void* dx;          // [E, C, h] T
  float* dws;        // [E, C]
  float* db2;        // [E, h]
  void* dw1;         // [E, h, dff] T
  float* db1;        // [E, dff]
  void* dw2;         // [E, dff, h] T
  int E, C, h, dff, act, nrt, nct;
};

// dx pass 1: z, dh -> ha, dz_T, db1_part
template <typename T>
__global__ void __launch_bounds__(gg::kThreads) grouped_ffn_dx_zdh(BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;
  const int n0 = blockIdx.x * gg::kBN;
  if (m0 >= count) return;
  __shared__ __align__(16) float As[gg::kBK * gg::kAP];
  __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool active = m0 + ty * 4 < count;
  const size_t xe = size_t(e) * a.C * a.h;
  const size_t we = size_t(e) * a.h * a.dff;
  float z[4][4], dh[4][4];
  gg::zero(z);
  gg::zero(dh);
  {
    const gg::RowMajor<T> A{static_cast<const T*>(a.x) + xe, a.h, count, a.h};
    const gg::RowMajor<T> B{static_cast<const T*>(a.w1) + we, a.dff, a.h,
                            a.dff};
    gg::mainloop(A, B, m0, n0, a.h, active, z, As, Bs);
  }
  {
    const gg::ScaledRows<T> A{static_cast<const T*>(a.g) + xe,
                              a.ws + size_t(e) * a.C, a.h, count, a.h};
    // w2^T: (k = h index, n = ff index) -> w2[e][n * h + k]
    const gg::ColMajor<T> B{static_cast<const T*>(a.w2) + we, a.h, a.h,
                            a.dff};
    gg::mainloop(A, B, m0, n0, a.h, active, dh, As, Bs);
  }
  T* ha = static_cast<T*>(a.ha) + size_t(e) * a.C * a.dff;
  T* dz = static_cast<T*>(a.dz) + size_t(e) * a.C * a.dff;
  const float* b1 = a.b1 + size_t(e) * a.dff;
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= count) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.dff) continue;
      const float zz = z[i][j] + b1[n];
      const float d = dh[i][j] * gg::act_grad(zz, a.act);
      ha[size_t(m) * a.dff + n] = pt::from_f32<T>(gg::act_apply(zz, a.act));
      dz[size_t(m) * a.dff + n] = pt::from_f32<T>(d);
      colsum[j] += d;
    }
  }
  // the tile's column sums of f32 dz, over ty in a fixed order
  __syncthreads();  // As is free again
  float* red = As;  // [16][64]
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * gg::kBN + tx * 4 + j] = colsum[j];
  __syncthreads();
  if (tid < gg::kBN && n0 + tid < a.dff) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r * gg::kBN + tid];
    a.db1_part[(size_t(e) * a.nrt + blockIdx.y) * a.dff + n0 + tid] = s;
  }
}

// dx pass 2: dx = dz_T w1^T; g (ha w2 + b2) row sums; g ws column sums
template <typename T>
__global__ void __launch_bounds__(gg::kThreads) grouped_ffn_dx_out(BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;
  const int n0 = blockIdx.x * gg::kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T* dx = static_cast<T*>(a.dx) + size_t(e) * a.C * a.h;
  if (m0 >= count) {  // block-uniform: dead rows of dx are zeros
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (m < a.C && n < a.h) dx[size_t(m) * a.h + n] = pt::from_f32<T>(0.f);
      }
    }
    return;
  }
  __shared__ __align__(16) float As[gg::kBK * gg::kAP];
  __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
  const bool active = m0 + ty * 4 < count;
  const size_t he = size_t(e) * a.C * a.dff;
  const size_t we = size_t(e) * a.h * a.dff;
  float dxa[4][4], ffn[4][4];
  gg::zero(dxa);
  gg::zero(ffn);
  {
    const gg::RowMajor<T> A{static_cast<const T*>(a.dz) + he, a.dff, count,
                            a.dff};
    // w1^T: (k = ff index, n = h index) -> w1[e][n * dff + k]
    const gg::ColMajor<T> B{static_cast<const T*>(a.w1) + we, a.dff, a.dff,
                            a.h};
    gg::mainloop(A, B, m0, n0, a.dff, active, dxa, As, Bs);
  }
  {
    const gg::RowMajor<T> A{static_cast<const T*>(a.ha) + he, a.dff, count,
                            a.dff};
    const gg::RowMajor<T> B{static_cast<const T*>(a.w2) + we, a.h, a.dff,
                            a.h};
    gg::mainloop(A, B, m0, n0, a.dff, active, ffn, As, Bs);
  }
  const T* g = static_cast<const T*>(a.g) + size_t(e) * a.C * a.h;
  const float* b2 = a.b2 + size_t(e) * a.h;
  const float* ws = a.ws + size_t(e) * a.C;
  float rowsum[4] = {0.f, 0.f, 0.f, 0.f};
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.C) continue;
    const bool live = m < count;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.h) continue;
      dx[size_t(m) * a.h + n] = pt::from_f32<T>(live ? dxa[i][j] : 0.f);
      if (live) {
        const float gg_ = pt::to_f32(g[size_t(m) * a.h + n]);
        rowsum[i] += gg_ * (ffn[i][j] + b2[n]);
        colsum[j] += gg_ * ws[m];
      }
    }
  }
  __syncthreads();  // As and Bs are free again
  float* rred = As;  // [64 rows][16 tx]
  float* cred = Bs;  // [16 ty][64 cols]
#pragma unroll
  for (int i = 0; i < 4; ++i) rred[(ty * 4 + i) * 16 + tx] = rowsum[i];
#pragma unroll
  for (int j = 0; j < 4; ++j) cred[ty * gg::kBN + tx * 4 + j] = colsum[j];
  __syncthreads();
  if (tid < gg::kBM) {
    const int m = m0 + tid;
    if (m < count) {
      float s = 0.f;
      for (int c = 0; c < 16; ++c) s += rred[tid * 16 + c];
      a.dws_part[(size_t(e) * a.C + m) * a.nct + blockIdx.x] = s;
    }
  } else if (tid < gg::kBM + gg::kBN) {
    const int c = tid - gg::kBM;
    if (n0 + c < a.h) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += cred[r * gg::kBN + c];
      a.db2_part[(size_t(e) * a.nrt + blockIdx.y) * a.h + n0 + c] = s;
    }
  }
}

// dx pass 3: dws and db2 from their partials, in a fixed order
__global__ void __launch_bounds__(256) grouped_ffn_dx_reduce(BwdArgs a) {
  const int e = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int count = min(a.counts[e], a.C);
  if (i < a.C) {
    float s = 0.f;
    if (i < count)
      for (int t = 0; t < a.nct; ++t)
        s += a.dws_part[(size_t(e) * a.C + i) * a.nct + t];
    a.dws[size_t(e) * a.C + i] = s;
  }
  if (i < a.h) {
    const int live_tiles = gg::cdiv(count, gg::kBM);
    float s = 0.f;
    for (int t = 0; t < live_tiles; ++t)
      s += a.db2_part[(size_t(e) * a.nrt + t) * a.h + i];
    a.db2[size_t(e) * a.h + i] = s;
  }
}

// dw pass 1: dw1[e] = x[e, :count]^T dz_T[e, :count]  ([h, dff])
template <typename T>
__global__ void __launch_bounds__(gg::kThreads) grouped_ffn_dw1(BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;  // h
  const int n0 = blockIdx.x * gg::kBN;  // dff
  __shared__ __align__(16) float As[gg::kBK * gg::kAP];
  __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
  gg::zero(acc);
  // x^T: (m = h index, k = row) -> x[e][k * h + m]
  const gg::ColMajor<T> A{static_cast<const T*>(a.x) + size_t(e) * a.C * a.h,
                          a.h, a.h, count};
  const gg::RowMajor<T> B{static_cast<const T*>(a.dz) +
                              size_t(e) * a.C * a.dff,
                          a.dff, count, a.dff};
  gg::mainloop(A, B, m0, n0, count, true, acc, As, Bs);
  T* dw1 = static_cast<T*>(a.dw1) + size_t(e) * a.h * a.dff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.h) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < a.dff) dw1[size_t(m) * a.dff + n] = pt::from_f32<T>(acc[i][j]);
    }
  }
}

// dw pass 2: dw2[e] = ha[e, :count]^T gw[e, :count]  ([dff, h])
template <typename T>
__global__ void __launch_bounds__(gg::kThreads) grouped_ffn_dw2(BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * gg::kBM;  // dff
  const int n0 = blockIdx.x * gg::kBN;  // h
  __shared__ __align__(16) float As[gg::kBK * gg::kAP];
  __shared__ __align__(16) float Bs[gg::kBK * gg::kBP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
  gg::zero(acc);
  // ha^T: (m = ff index, k = row) -> ha[e][k * dff + m]
  const gg::ColMajor<T> A{static_cast<const T*>(a.ha) +
                              size_t(e) * a.C * a.dff,
                          a.dff, a.dff, count};
  const gg::ScaledRows<T> B{static_cast<const T*>(a.g) +
                                size_t(e) * a.C * a.h,
                            a.ws + size_t(e) * a.C, a.h, count, a.h};
  gg::mainloop(A, B, m0, n0, count, true, acc, As, Bs);
  T* dw2 = static_cast<T*>(a.dw2) + size_t(e) * a.dff * a.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.dff) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < a.h) dw2[size_t(m) * a.h + n] = pt::from_f32<T>(acc[i][j]);
    }
  }
}

// dw pass 3: db1 from db1_part over the expert's live row tiles
__global__ void __launch_bounds__(256) grouped_ffn_db1_reduce(BwdArgs a) {
  const int e = blockIdx.y;
  const int f = blockIdx.x * 256 + threadIdx.x;
  if (f >= a.dff) return;
  const int live_tiles = gg::cdiv(min(a.counts[e], a.C), gg::kBM);
  float s = 0.f;
  for (int t = 0; t < live_tiles; ++t)
    s += a.db1_part[(size_t(e) * a.nrt + t) * a.dff + f];
  a.db1[size_t(e) * a.dff + f] = s;
}

// -- the "tc" route of the dx entry ------------------------------------------

// The ring of both tc passes (stages, blocks an SM): two 128-column f32
// accumulators take ~157 registers a thread, so one block an SM. Chosen
// over 3, 5 and 6 stages, and over 64-column tiles (two blocks an SM, or
// one with six stages), by a timing comparison at the training shape on
// an H100.
using TcRing = ggtc::Ring<4, 1>;

// The ring of the dw products (one 64-register accumulator, an epilogue
// that only rounds and stores): four stages, one block an SM, chosen by
// timing it against 2 and 3 stages at two blocks an SM and 6 at one
// (PERF.md).
using DwRing = ggtc::Ring<4, 1>;

// dx pass 0: gw = round_T(g ws) on live rows, zero on dead rows; one
// thread per 8 elements (h is a multiple of 8 on this route)
template <typename T>
__global__ void __launch_bounds__(256) grouped_ffn_dx_gw(BwdArgs a) {
  const int e = blockIdx.y;
  const int count = min(a.counts[e], a.C);
  const int per_row = a.h / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)a.C * per_row) return;
  const int m = int(i / per_row);
  const size_t off = (size_t(e) * a.C + m) * a.h + size_t(i % per_row) * 8;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (m < count) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(static_cast<const T*>(a.g) + off);
    const T* gi = reinterpret_cast<const T*>(&raw);
    T* go = reinterpret_cast<T*>(&v);
    const float w = a.ws[size_t(e) * a.C + m];
#pragma unroll
    for (int k = 0; k < 8; ++k) go[k] = pt::from_f32<T>(pt::to_f32(gi[k]) * w);
  }
  *reinterpret_cast<uint4*>(static_cast<T*>(a.gw) + off) = v;
}

// dx pass 1: z = x w1 (maps a0, b0: w1 MN-major; the forward's up pass
// runs the same loop), dh = gw w2^T (a1, b1: w2 K-major) -> ha, dz_T,
// db1_part
template <typename T>
__global__ void __launch_bounds__(ggtc::kThreads, TcRing::kBlocks)
    grouped_ffn_dx_zdh_tc(const __grid_constant__ ggtc::Maps maps,
                          BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * ggtc::kBM;
  const int n0 = blockIdx.x * ggtc::kBN;
  if (m0 >= count) return;
  extern __shared__ uint8_t smem[];
  const TcRing r = ggtc::make_ring<TcRing>(smem);
  const int k_tiles = gg::cdiv(a.h, ggtc::kBK);
  if (threadIdx.x >= ggtc::kConsumers) {
    if (threadIdx.x == ggtc::kConsumers) {
      const ggtc::Product p[2] = {{&maps.a0, &maps.b0, true, k_tiles},
                                  {&maps.a1, &maps.b1, false, k_tiles}};
      ggtc::produce(r, p, 2, e, m0, n0);
    }
    return;
  }
  float z[ggtc::kAcc], dh[ggtc::kAcc];
  int j = 0;
  ggtc::consume<T, true>(z, r, j, k_tiles);
  ggtc::consume<T, false>(dh, r, j, k_tiles);
  ggtc::drain(z);
  ggtc::fence_acc(dh);
  T* ha = static_cast<T*>(a.ha) + size_t(e) * a.C * a.dff;
  T* dz = static_cast<T*>(a.dz) + size_t(e) * a.C * a.dff;
  const float* b1 = a.b1 + size_t(e) * a.dff;
  const int lane = threadIdx.x % 32;
  const int row = m0 + threadIdx.x / 32 * 16 + lane / 4;
  // cs[2 jj + c]: this thread's sum of f32 dz of column 8 jj + 2 (lane %
  // 4) + c over its two rows, live rows only
  float cs[ggtc::kBN / 4];
#pragma unroll
  for (int jj = 0; jj < ggtc::kBN / 8; ++jj) {
    const int n = n0 + 8 * jj + 2 * (lane % 4);
    cs[2 * jj] = cs[2 * jj + 1] = 0.f;
    if (n >= a.dff) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = row + 8 * hr;
      if (m >= count) continue;
      float d[2], h2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float zz = z[4 * jj + 2 * hr + c] + b1[n + c];
        d[c] = dh[4 * jj + 2 * hr + c] * gg::act_grad(zz, a.act);
        h2[c] = gg::act_apply(zz, a.act);
        cs[2 * jj + c] += d[c];
      }
      ggtc::store2(ha + size_t(m) * a.dff + n, h2[0], h2[1]);
      ggtc::store2(dz + size_t(m) * a.dff + n, d[0], d[1]);
    }
  }
  const int tile = blockIdx.y * 2 + threadIdx.x / 128;
  ggtc::col_sums(r, cs,
                 a.db1_part + (size_t(e) * a.nrt + tile) * a.dff + n0,
                 a.dff - n0, tile < a.nrt);
}

// dx pass 2: dx = dz_T w1^T (maps a0, b0: w1 K-major), ffn = ha w2 (a1,
// b1: w2 MN-major); g (ffn + b2) row sums, g ws column sums
template <typename T>
__global__ void __launch_bounds__(ggtc::kThreads, TcRing::kBlocks)
    grouped_ffn_dx_out_tc(const __grid_constant__ ggtc::Maps maps,
                          BwdArgs a) {
  const int e = blockIdx.z;
  const int count = min(a.counts[e], a.C);
  const int m0 = blockIdx.y * ggtc::kBM;
  const int n0 = blockIdx.x * ggtc::kBN;
  T* dx = static_cast<T*>(a.dx) + size_t(e) * a.C * a.h;
  if (m0 >= count) {  // block-uniform: dead rows of dx are zeros
    for (int i = threadIdx.x; i < ggtc::kBM * ggtc::kBN / 2;
         i += ggtc::kThreads) {
      const int m = m0 + i / (ggtc::kBN / 2);
      const int n = n0 + 2 * (i % (ggtc::kBN / 2));
      if (m < a.C && n < a.h)
        ggtc::store2(dx + size_t(m) * a.h + n, 0.f, 0.f);
    }
    return;
  }
  extern __shared__ uint8_t smem[];
  const TcRing r = ggtc::make_ring<TcRing>(smem);
  const int k_tiles = gg::cdiv(a.dff, ggtc::kBK);
  if (threadIdx.x >= ggtc::kConsumers) {
    if (threadIdx.x == ggtc::kConsumers) {
      const ggtc::Product p[2] = {{&maps.a0, &maps.b0, false, k_tiles},
                                  {&maps.a1, &maps.b1, true, k_tiles}};
      ggtc::produce(r, p, 2, e, m0, n0);
    }
    return;
  }
  float dxa[ggtc::kAcc], ffn[ggtc::kAcc];
  int j = 0;
  ggtc::consume<T, false>(dxa, r, j, k_tiles);
  ggtc::consume<T, true>(ffn, r, j, k_tiles);
  ggtc::drain(ffn);
  ggtc::fence_acc(dxa);
  const T* g = static_cast<const T*>(a.g) + size_t(e) * a.C * a.h;
  const float* b2 = a.b2 + size_t(e) * a.h;
  const float* ws = a.ws + size_t(e) * a.C;
  const int lane = threadIdx.x % 32;
  const int row = m0 + threadIdx.x / 32 * 16 + lane / 4;
  constexpr int kHalves = ggtc::kBN / 64;  // 64-column partials of dws
  float cs[ggtc::kBN / 4];
  float rs[2][kHalves] = {};  // [row][64-column half], live rows only
#pragma unroll
  for (int jj = 0; jj < ggtc::kBN / 8; ++jj) {
    const int n = n0 + 8 * jj + 2 * (lane % 4);
    cs[2 * jj] = cs[2 * jj + 1] = 0.f;
    if (n >= a.h) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = row + 8 * hr;
      if (m >= a.C) continue;
      const bool live = m < count;
      ggtc::store2(dx + size_t(m) * a.h + n,
                   live ? dxa[4 * jj + 2 * hr] : 0.f,
                   live ? dxa[4 * jj + 2 * hr + 1] : 0.f);
      if (!live) continue;
      const float w = ws[m];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float gv = pt::to_f32(g[size_t(m) * a.h + n + c]);
        rs[hr][jj / 8] += gv * (ffn[4 * jj + 2 * hr + c] + b2[n + c]);
        cs[2 * jj + c] += gv * w;
      }
    }
  }
  // row sums over each 64-column half: the 4 lanes of a row, in order
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = row + 8 * hr;
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const float v = ggtc::quad_row_sum(rs[hr][half]);
      const int t = blockIdx.x * kHalves + half;
      if (lane % 4 == 0 && m < count && t < a.nct)
        a.dws_part[(size_t(e) * a.C + m) * a.nct + t] = v;
    }
  }
  const int tile = blockIdx.y * 2 + threadIdx.x / 128;
  ggtc::col_sums(r, cs, a.db2_part + (size_t(e) * a.nrt + tile) * a.h + n0,
                 a.h - n0, tile < a.nrt);
}

template <typename T>
int launch_dx_tc(const BwdArgs& a, int dtype, cudaStream_t s) {
  using ggtc::kBoxA;
  using ggtc::kBoxBMn;
  using ggtc::make_map;
  if (reinterpret_cast<uintptr_t>(a.g) % 16 ||
      reinterpret_cast<uintptr_t>(a.gw) % 16)
    return int(cudaErrorMisalignedAddress);
  ggtc::Maps p1{}, p2{};
  if (!make_map(&p1.a0, a.x, dtype, a.h, a.C, a.E, kBoxA) ||
      !make_map(&p1.b0, a.w1, dtype, a.dff, a.h, a.E, kBoxBMn) ||
      !make_map(&p1.a1, a.gw, dtype, a.h, a.C, a.E, kBoxA) ||
      !make_map(&p1.b1, a.w2, dtype, a.h, a.dff, a.E, ggtc::kBoxBK) ||
      !make_map(&p2.a0, a.dz, dtype, a.dff, a.C, a.E, kBoxA) ||
      !make_map(&p2.b0, a.w1, dtype, a.dff, a.h, a.E, ggtc::kBoxBK) ||
      !make_map(&p2.a1, a.ha, dtype, a.dff, a.C, a.E, kBoxA) ||
      !make_map(&p2.b1, a.w2, dtype, a.h, a.dff, a.E, kBoxBMn))
    return int(cudaErrorInvalidValue);
  const auto zdh_k = grouped_ffn_dx_zdh_tc<T>;
  const auto out_k = grouped_ffn_dx_out_tc<T>;
  if (int err = ggtc::allow_smem<TcRing>(zdh_k)) return err;
  if (int err = ggtc::allow_smem<TcRing>(out_k)) return err;
  const dim3 p0(
      unsigned((static_cast<long long>(a.C) * (a.h / 8) + 255) / 256), a.E);
  grouped_ffn_dx_gw<T><<<p0, 256, 0, s>>>(a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 g1(gg::cdiv(a.dff, ggtc::kBoxBK), gg::cdiv(a.C, ggtc::kBM), a.E);
  zdh_k<<<g1, ggtc::kThreads, TcRing::kSmemBytes, s>>>(p1, a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 g2(gg::cdiv(a.h, ggtc::kBoxBK), gg::cdiv(a.C, ggtc::kBM), a.E);
  out_k<<<g2, ggtc::kThreads, TcRing::kSmemBytes, s>>>(p2, a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p3(gg::cdiv(a.C > a.h ? a.C : a.h, 256), a.E);
  grouped_ffn_dx_reduce<<<p3, 256, 0, s>>>(a);
  return int(cudaGetLastError());
}

// dw products on the tc route: out[e] = A[e, :count]^T B[e, :count] with
// A (maps.a0: x or ha, M = its columns) and B (maps.b0: dz or gw, N = its
// columns) both MN-major, the depth over the expert's live rows; out
// [E, M, N] in T. An expert without live rows gets zeros and issues no
// load.
template <typename T>
__global__ void __launch_bounds__(ggtc::kThreads, DwRing::kBlocks)
    grouped_ffn_dw_mn_tc(const __grid_constant__ ggtc::Maps maps,
                         const int* counts, int C, void* out, int M, int N) {
  const int e = blockIdx.z;
  const int count = min(counts[e], C);
  const int m0 = blockIdx.y * ggtc::kBM;
  const int n0 = blockIdx.x * ggtc::kBN;
  T* o = static_cast<T*>(out) + size_t(e) * M * N;
  if (count <= 0) {  // block-uniform
    for (int i = threadIdx.x; i < ggtc::kBM * ggtc::kBN / 2;
         i += ggtc::kThreads) {
      const int m = m0 + i / (ggtc::kBN / 2);
      const int n = n0 + 2 * (i % (ggtc::kBN / 2));
      if (m < M && n < N) ggtc::store2(o + size_t(m) * N + n, 0.f, 0.f);
    }
    return;
  }
  extern __shared__ uint8_t smem[];
  const DwRing r = ggtc::make_ring<DwRing>(smem);
  const int k_tiles = gg::cdiv(count, ggtc::kBK);
  if (threadIdx.x >= ggtc::kConsumers) {
    if (threadIdx.x == ggtc::kConsumers) {
      const ggtc::Product p{&maps.a0, &maps.b0, true, k_tiles, true};
      ggtc::produce(r, &p, 1, e, m0, n0);
    }
    return;
  }
  float acc[ggtc::kAcc];
  int j = 0;
  ggtc::consume<T, true, true>(acc, r, j, k_tiles, count % ggtc::kBK);
  ggtc::drain(acc);
  const int lane = threadIdx.x % 32;
  const int row = m0 + threadIdx.x / 32 * 16 + lane / 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = row + 8 * hr;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < ggtc::kBN / 8; ++jj) {
      const int n = n0 + 8 * jj + 2 * (lane % 4);
      if (n < N)
        ggtc::store2(o + size_t(m) * N + n, acc[4 * jj + 2 * hr],
                     acc[4 * jj + 2 * hr + 1]);
    }
  }
}

template <typename T>
int launch_dw_tc(const BwdArgs& a, int dtype, cudaStream_t s) {
  using ggtc::kBoxBMn;
  using ggtc::make_map;
  if (a.gw == nullptr) return int(cudaErrorInvalidValue);
  ggtc::Maps m1{}, m2{};
  if (!make_map(&m1.a0, a.x, dtype, a.h, a.C, a.E, kBoxBMn) ||
      !make_map(&m1.b0, a.dz, dtype, a.dff, a.C, a.E, kBoxBMn) ||
      !make_map(&m2.a0, a.ha, dtype, a.dff, a.C, a.E, kBoxBMn) ||
      !make_map(&m2.b0, a.gw, dtype, a.h, a.C, a.E, kBoxBMn))
    return int(cudaErrorInvalidValue);
  const auto k = grouped_ffn_dw_mn_tc<T>;
  if (int err = ggtc::allow_smem<DwRing>(k)) return err;
  const dim3 g1(gg::cdiv(a.dff, ggtc::kBN), gg::cdiv(a.h, ggtc::kBM), a.E);
  k<<<g1, ggtc::kThreads, DwRing::kSmemBytes, s>>>(m1, a.counts, a.C, a.dw1,
                                                    a.h, a.dff);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 g2(gg::cdiv(a.h, ggtc::kBN), gg::cdiv(a.dff, ggtc::kBM), a.E);
  k<<<g2, ggtc::kThreads, DwRing::kSmemBytes, s>>>(m2, a.counts, a.C, a.dw2,
                                                    a.dff, a.h);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p3(gg::cdiv(a.dff, 256), a.E);
  grouped_ffn_db1_reduce<<<p3, 256, 0, s>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dx(const BwdArgs& a, cudaStream_t s) {
  const dim3 p1(gg::cdiv(a.dff, gg::kBN), a.nrt, a.E);
  grouped_ffn_dx_zdh<T><<<p1, gg::kThreads, 0, s>>>(a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p2(a.nct, a.nrt, a.E);
  grouped_ffn_dx_out<T><<<p2, gg::kThreads, 0, s>>>(a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p3(gg::cdiv(a.C > a.h ? a.C : a.h, 256), a.E);
  grouped_ffn_dx_reduce<<<p3, 256, 0, s>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dw(const BwdArgs& a, cudaStream_t s) {
  const dim3 p1(gg::cdiv(a.dff, gg::kBN), gg::cdiv(a.h, gg::kBM), a.E);
  grouped_ffn_dw1<T><<<p1, gg::kThreads, 0, s>>>(a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p2(gg::cdiv(a.h, gg::kBN), gg::cdiv(a.dff, gg::kBM), a.E);
  grouped_ffn_dw2<T><<<p2, gg::kThreads, 0, s>>>(a);
  if (int err = int(cudaGetLastError())) return err;
  const dim3 p3(gg::cdiv(a.dff, 256), a.E);
  grouped_ffn_db1_reduce<<<p3, 256, 0, s>>>(a);
  return int(cudaGetLastError());
}

int dispatch(BwdArgs a, int which, int dtype, void* stream) {
  if (a.E < 1 || a.C < 1 || a.h < 1 || a.dff < 1 || a.act < 0 || a.act > 1 ||
      a.E > 65535 || gg::cdiv(a.C, gg::kBM) > 65535 ||
      gg::cdiv(a.dff, gg::kBM) > 65535 || gg::cdiv(a.h, gg::kBM) > 65535)
    return int(cudaErrorInvalidValue);
  a.nrt = gg::cdiv(a.C, gg::kBM);
  a.nct = gg::cdiv(a.h, gg::kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = gg::route(dtype, a.h, a.dff) == gg::kTc;
  switch (dtype * 2 + which) {
    case pt::kF32 * 2 + 0: return launch_dx<float>(a, s);
    case pt::kF32 * 2 + 1: return launch_dw<float>(a, s);
    case pt::kBF16 * 2 + 0:
      return tc ? launch_dx_tc<__nv_bfloat16>(a, dtype, s)
                : launch_dx<__nv_bfloat16>(a, s);
    case pt::kBF16 * 2 + 1:
      return tc ? launch_dw_tc<__nv_bfloat16>(a, dtype, s)
                : launch_dw<__nv_bfloat16>(a, s);
    case pt::kF16 * 2 + 0:
      return tc ? launch_dx_tc<__half>(a, dtype, s) : launch_dx<__half>(a, s);
    case pt::kF16 * 2 + 1:
      return tc ? launch_dw_tc<__half>(a, dtype, s) : launch_dw<__half>(a, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

PT_DEFINE_PROBE(grouped_ffn_bwd)

// Operands as grouped_ffn_fwd_launch's, plus g [E, C, h] T. Scratch the
// wrapper allocates: ha, dz [E, C, dff] T; gw [E, C, h] T (written and
// read on the tc route only); db1_part [E, ceil(C/64), dff],
// db2_part [E, ceil(C/64), h], dws_part [E, C, ceil(h/64)] f32. Outputs:
// dx [E, C, h] T, dws [E, C, 1] f32, db2 [E, 1, h] f32. Returns
// cudaGetLastError() after its launches (or the error of a tensor map
// libcuda refuses). The route is gg::route's.
extern "C" int grouped_ffn_bwd_dx_launch(
    const void* x, const void* g, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* ws, const void* counts,
    void* ha, void* dz, void* gw, void* db1_part, void* db2_part,
    void* dws_part,
    void* dx, void* dws, void* db2, int E, int C, int h, int dff, int act,
    int dtype, void* stream) {
  BwdArgs a{};
  a.x = x;
  a.g = g;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.ws = static_cast<const float*>(ws);
  a.counts = static_cast<const int*>(counts);
  a.ha = ha;
  a.dz = dz;
  a.gw = gw;
  a.db1_part = static_cast<float*>(db1_part);
  a.db2_part = static_cast<float*>(db2_part);
  a.dws_part = static_cast<float*>(dws_part);
  a.dx = dx;
  a.dws = static_cast<float*>(dws);
  a.db2 = static_cast<float*>(db2);
  a.E = E;
  a.C = C;
  a.h = h;
  a.dff = dff;
  a.act = act;
  return dispatch(a, 0, dtype, stream);
}

// Reads the scratch ha, dz, db1_part (and, on the tc route, gw) the dx
// entry wrote for the same operands; gw may be null on the simt route,
// and the tc route refuses a null gw. Outputs: dw1 [E, h, dff] T, db1
// [E, 1, dff] f32, dw2 [E, dff, h] T. Returns cudaGetLastError() after
// its launches (or the error of a tensor map libcuda refuses). The route
// is gg::route's, as the dx entry's.
extern "C" int grouped_ffn_bwd_dw_launch(const void* x, const void* g,
                                         const void* ws, const void* counts,
                                         void* ha, void* dz, void* gw,
                                         void* db1_part, void* dw1, void* db1,
                                         void* dw2, int E, int C, int h,
                                         int dff, int dtype, void* stream) {
  BwdArgs a{};
  a.x = x;
  a.g = g;
  a.ws = static_cast<const float*>(ws);
  a.counts = static_cast<const int*>(counts);
  a.ha = ha;
  a.dz = dz;
  a.gw = gw;
  a.db1_part = static_cast<float*>(db1_part);
  a.dw1 = dw1;
  a.db1 = static_cast<float*>(db1);
  a.dw2 = dw2;
  a.E = E;
  a.C = C;
  a.h = h;
  a.dff = dff;
  return dispatch(a, 1, dtype, stream);
}
