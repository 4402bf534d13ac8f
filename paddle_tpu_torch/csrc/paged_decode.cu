// Multi-sequence single-token paged-KV decode attention for Hopper.
//
// Replaces the Pallas kernel `_paged_decode_kernel` launched by
// `paged_decode_pallas` (paddle_tpu/kernels/paged_attention.py:278,
// :461). Same contract: q [b, h, d] (one token per slot) attends the
// slot's pages of the head-major pools [num_blocks, h_kv, block_size,
// d], found through block_tables [b, nblk], masked to context_lens [b]
// and an optional sliding window. GQA: query head qh reads kv head
// qh / rep. int8 pools carry per-(page, head, row) f32 scales and are
// dequantized on load. A slot with context 0 (an idle serving lane)
// loads nothing and writes zeros; a context past the block table's
// capacity is clamped to nblk * block_size.
//
// What bounds it on an H100: bytes. Each key/value element is read once
// and used for 2 * rep flops, far below the ~295 flops per byte the
// card needs before its arithmetic is the limit, so the least time is
// the live K/V bytes over 3.35 TB/s (data sheet). Serving decodes a few
// hundred tokens a slot: at the ERNIE-MoE shape (8 slots, 16 kv heads)
// one block per (kv head, slot) is 128 blocks for 132 SMs, each walking
// its context alone. The design keeps every SM streaming:
//
// - Split over the context. The live range [max(0, ctx - window),
//   min(ctx, nblk * bs)) is cut into chunks of kChunk tokens at absolute
//   positions; blocks go over (chunk, kv head, slot), and a block whose
//   chunk lies outside the live range exits before it loads anything.
//   Each block writes its chunk's partial: the row maximum m, the sum l
//   and the unnormalised accumulator [rep, d], all f32, into the
//   wrapper's scratch; `paged_decode_combine` rescales the partials by
//   exp(m_i - max m), sums them in chunk order (no atomics: repeated
//   runs give the same bits), divides by the summed l and writes zeros
//   for dead slots. When the block table holds one chunk (nch == 1)
//   the block normalises and writes the output itself and no combine
//   runs.
// - The pool's own bytes, copied asynchronously. Rows of one (page, kv
//   head) are contiguous, so a token's K and V rows are whole 16-byte
//   runs (whenever d * sizeof(T) is a multiple of 16) copied with
//   cp.async in the pool's dtype: a bf16 chunk takes half the shared
//   memory of an f32 one. The chunk's kTiles tiles of kTile tokens are
//   started at once, one cp.async group each, and consumed in order, so
//   the later tiles' loads are in flight during the first tile's math;
//   several blocks an SM overlap one another. int8 scales come beside
//   the values (4-byte cp.async).
// - All warps compute, converting to f32 in registers. The four warps
//   form (row slot, token group) pairs: with rep = 1 (both serving
//   models) each warp takes a quarter of every tile's tokens for the one
//   query row, with its own online-softmax state (m, l) and a d-wide
//   accumulator of kDPL floats a lane; rep 2 takes two token groups,
//   rep >= 4 one (a warp walks rows r, r + 4, ... in turn). Scores come
//   eight tokens at a time from lane-partial dot products and xor
//   shuffles; the warps' states merge in shared memory at the end.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // tokens a cp.async group
constexpr int kChunk = 64;              // tokens a block
constexpr int kTiles = kChunk / kTile;  // groups in flight a block
constexpr int kGroup = 8;               // scores a warp reduces at once
constexpr int kMaxHeadDim = 256;        // 8 values a lane
constexpr int kMaxSmem = 232448;        // a block's limit on an H100
static_assert(kTiles >= 1 && kTiles <= 4, "pd_wait covers up to 4 groups");

// bytes of one staged K or V row (pool dtype), padded to 16
__host__ __device__ inline int row_pitch(int d, int item) {
  return (d * item + 15) / 16 * 16;
}

// the warps' (row slot, token group) split for rep query rows a kv head
__host__ __device__ inline int row_slots(int rep) {
  return rep < kWarps ? rep : kWarps;
}

// K and V [kChunk][pitch] in the pool dtype, their scales [kChunk] f32,
// the pool row of each token [kChunk] (int64), the warps' partials
// [groups][rep][d] and (m, l) [groups][rep][2] f32, and 32 bytes a
// partial-width lane may read past the last V row into (mirrored by
// paged_attention.paged_decode_smem_bytes)
size_t smem_bytes(int rep, int d, int item) {
  const size_t groups = kWarps / row_slots(rep);
  return 2 * size_t(kChunk) * row_pitch(d, item) + 2 * kChunk * 4 +
         kChunk * 8 + 4 * groups * rep * (d + 2) + 32;
}

struct Args {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  float* out;   // [b, h, d]
  float* part;  // [b, h, nch, d] unnormalised accumulators (nch > 1)
  float* ml;    // [b, h, nch, 2] (m, l) (nch > 1)
  int h, hkv, d, bs, nblk, window, nch;
  float scale;
  bool vec;  // K/V rows are whole 16-byte runs at 16-byte addresses
};

// live keys [lo, hi) of a slot: the window is measured back from the
// slot's own position (ctx - 1); only the walk is clamped to the block
// table's capacity, as in the Pallas kernel
struct Live {
  int lo, hi;
};

__device__ __forceinline__ Live live_range(const Args& a, int slot) {
  const int ctx_raw = a.context_lens[slot];
  const int lo = (a.window > 0 && ctx_raw > a.window) ? ctx_raw - a.window
                                                      : 0;
  return {lo, min(ctx_raw, a.nblk * a.bs)};
}

// wait until at most `pending` (in [0, kTiles)) of the thread's copy
// groups are in flight (cp.async.wait_group takes an immediate)
__device__ __forceinline__ void pd_wait(int pending) {
  if (pending >= 3) pt::cp_async_wait<3>();
  else if (pending == 2) pt::cp_async_wait<2>();
  else if (pending == 1) pt::cp_async_wait<1>();
  else pt::cp_async_wait<0>();
}

// kN values of T at `p` (aligned to their size, up to 16 bytes a load)
// -> f32
template <typename T, int kN>
__device__ __forceinline__ void load_f32(const uint8_t* p, float (&o)[kN]) {
  constexpr int kBytes = kN * int(sizeof(T));
  if constexpr (kBytes >= 16) {
    uint4 w[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      w[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = pt::to_f32(e[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = pt::to_f32(e[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = pt::to_f32(e[i]);
  } else {
    static_assert(kBytes == 2, "two int8 values");
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = pt::to_f32(e[i]);
  }
}

// One block: chunk blockIdx.x of kv head blockIdx.y of slot blockIdx.z.
// kDPL: head-dim values a lane (d <= 32 kDPL).
template <typename T, int kDPL, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const Args a) {
  const int ch = blockIdx.x;
  const int g = blockIdx.y;
  const int slot = blockIdx.z;
  const int rep = a.h / a.hkv;
  const int d = a.d;
  const int tid = threadIdx.x;
  const Live lv = live_range(a, slot);
  const int c0 = ch * kChunk;
  // this chunk's live tokens, chunk-local: [ja, je)
  const int ja = max(lv.lo, c0) - c0;
  const int je = min(lv.hi, c0 + kChunk) - c0;
  const bool direct = a.nch == 1;
  const size_t orow = size_t(slot) * a.h + size_t(g) * rep;  // first row
  if (je <= ja) {  // nothing live here: load nothing
    if (direct)    // (a split launch leaves dead slots to the combine)
      for (int i = tid; i < rep * d; i += kThreads) a.out[orow * d + i] = 0.f;
    return;
  }

  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = row_pitch(d, int(sizeof(T)));
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + kChunk * pitch;
  float* ks_s = reinterpret_cast<float*>(v_s + kChunk * pitch);
  float* vs_s = ks_s + kChunk;
  long long* row_of = reinterpret_cast<long long*>(vs_s + kChunk);
  const int nrs = row_slots(rep);
  const int ntg = kWarps / nrs;
  float* m_acc = reinterpret_cast<float*>(row_of + kChunk);  // [ntg][rep][d]
  float* m_ml = m_acc + ntg * rep * d;                       // [ntg][rep][2]

  // the pool row (page, g, offset) of each live token of the chunk
  const int* bt = a.block_tables + size_t(slot) * a.nblk;
  for (int j = tid; j < kChunk; j += kThreads) {
    const int t = c0 + j;
    row_of[j] = (j >= ja && j < je)
                    ? (static_cast<long long>(bt[t / a.bs]) * a.hkv + g) *
                              a.bs +
                          t % a.bs
                    : -1;
  }
  __syncthreads();

  // start every tile's copies, one group a tile (empty groups past the
  // live tokens keep the count uniform)
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int segs = d * int(sizeof(T)) / 16;  // 16-byte runs a row (vec)
#pragma unroll
  for (int tile = 0; tile < kTiles; ++tile) {
    const int j0 = tile * kTile;
    if (a.vec) {
      for (int idx = tid; idx < kTile * segs; idx += kThreads) {
        const int j = j0 + idx / segs;
        const int s = idx - (idx / segs) * segs;
        const long long r = row_of[j];
        if (r >= 0) {
          pt::cp_async16(k_s + j * pitch + 16 * s,
                         reinterpret_cast<const uint8_t*>(kp + r * d) + 16 * s,
                         true);
          pt::cp_async16(v_s + j * pitch + 16 * s,
                         reinterpret_cast<const uint8_t*>(vp + r * d) + 16 * s,
                         true);
        }
      }
    } else {  // rows not whole 16-byte runs: element copies, synchronous
      for (int idx = tid; idx < kTile * d; idx += kThreads) {
        const int j = j0 + idx / d;
        const int c = idx - (idx / d) * d;
        const long long r = row_of[j];
        if (r >= 0) {
          reinterpret_cast<T*>(k_s + j * pitch)[c] = kp[r * d + c];
          reinterpret_cast<T*>(v_s + j * pitch)[c] = vp[r * d + c];
        }
      }
    }
    if (kQuant) {
      for (int j = j0 + tid; j < j0 + kTile; j += kThreads) {
        const long long r = row_of[j];
        if (r >= 0) {
          pt::cp_async4(ks_s + j, a.k_scale + r, true);
          pt::cp_async4(vs_s + j, a.v_scale + r, true);
        }
      }
    }
    pt::cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tg = warp / nrs;       // token group (tg >= ntg: idle warp)
  const int rs = warp - tg * nrs;  // row slot
  const int span = kTile / ntg;    // a warp's tokens of each tile
  const int cl = lane * kDPL;      // the lane's first head-dim value
  const int nv = max(0, min(kDPL, d - cl));
  const int rows = (rep + nrs - 1) / nrs;  // row passes, the same a warp

  for (int rr = 0; rr < rows; ++rr) {
    const int r = rs + rr * nrs;
    const bool active = tg < ntg && r < rep;  // warp-uniform
    float qv[kDPL], acc[kDPL];
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      qv[i] = (active && i < nv)
                  ? a.q[(orow + r) * d + cl + i] * a.scale
                  : 0.f;
      acc[i] = 0.f;
    }
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
      if (rr == 0) {  // the first pass waits for each tile in turn
        pd_wait(kTiles - 1 - tile);
        __syncthreads();
      }
      if (!active) continue;
      const int jb = tile * kTile + tg * span;
      const int j_lo = max(jb, ja);
      const int j_hi = min(jb + span, je);
      for (int j8 = j_lo; j8 < j_hi; j8 += kGroup) {
        const int n8 = min(kGroup, j_hi - j8);
        float s[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float dot = 0.f;
          if (u < n8 && nv > 0) {
            float kv[kDPL];
            load_f32<T, kDPL>(k_s + (j8 + u) * pitch + cl * int(sizeof(T)),
                              kv);
#pragma unroll
            for (int i = 0; i < kDPL; ++i)
              dot = fmaf(qv[i], i < nv ? kv[i] : 0.f, dot);
          }
          s[u] = dot;
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        float mx = m;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (kQuant && u < n8) s[u] *= ks_s[j8 + u];
          if (u < n8) mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m - mx);  // 0 on the first group
        l *= alpha;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[i] *= alpha;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (u < n8) {
            const float p = expf(s[u] - mx);
            l += p;
            if (nv > 0) {
              const float pv = kQuant ? p * vs_s[j8 + u] : p;
              float vv[kDPL];
              load_f32<T, kDPL>(
                  v_s + (j8 + u) * pitch + cl * int(sizeof(T)), vv);
#pragma unroll
              for (int i = 0; i < kDPL; ++i) acc[i] = fmaf(pv, vv[i], acc[i]);
            }
          }
        }
        m = mx;
      }
    }
    if (active) {
      const int slot_row = tg * rep + r;
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        if (i < nv) m_acc[slot_row * d + cl + i] = acc[i];
      if (lane == 0) {
        m_ml[2 * slot_row] = m;  // -inf where the group saw no token
        m_ml[2 * slot_row + 1] = l;
      }
    }
  }
  __syncthreads();

  // merge the token groups in order; the chunk holds a live token, so
  // the merged maximum is finite and a group that saw none weighs 0
  for (int idx = tid; idx < rep * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    float mm = -INFINITY;
    for (int t = 0; t < ntg; ++t) mm = fmaxf(mm, m_ml[2 * (t * rep + r)]);
    float ll = 0.f, av = 0.f;
    for (int t = 0; t < ntg; ++t) {
      const float w = expf(m_ml[2 * (t * rep + r)] - mm);
      ll += m_ml[2 * (t * rep + r) + 1] * w;
      av += m_acc[(t * rep + r) * d + c] * w;
    }
    const size_t row = orow + r;
    if (direct) {
      a.out[row * d + c] = av / ll;
    } else {
      a.part[(row * a.nch + ch) * d + c] = av;
      if (c == 0) {
        a.ml[2 * (row * a.nch + ch)] = mm;
        a.ml[2 * (row * a.nch + ch) + 1] = ll;
      }
    }
  }
}

// One block a (query head, slot): the slot's chunk partials, rescaled to
// their common maximum and summed in chunk order, over the summed l;
// zeros for a dead slot.
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine(const Args a) {
  const int qh = blockIdx.x;
  const int slot = blockIdx.y;
  const int d = a.d;
  const Live lv = live_range(a, slot);
  const size_t row = size_t(slot) * a.h + qh;
  float* o = a.out + row * d;
  if (lv.hi <= lv.lo) {
    for (int i = threadIdx.x; i < d; i += kThreads) o[i] = 0.f;
    return;
  }
  const int first = lv.lo / kChunk;
  const int last = (lv.hi - 1) / kChunk;
  const float* ml = a.ml + 2 * row * a.nch;
  const float* part = a.part + row * a.nch * d;
  float mm = -INFINITY;
  for (int c = first; c <= last; ++c) mm = fmaxf(mm, ml[2 * c]);
  float ll = 0.f;
  for (int c = first; c <= last; ++c)
    ll += ml[2 * c + 1] * expf(ml[2 * c] - mm);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float av = 0.f;
    for (int c = first; c <= last; ++c)
      av += part[c * d + i] * expf(ml[2 * c] - mm);
    o[i] = av / ll;
  }
}

template <typename T, int kDPL>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  auto kernel = paged_decode_split<T, kDPL, kQuant>;
  const size_t smem = smem_bytes(a.h / a.hkv, a.d, int(sizeof(T)));
  // raised once to the card's limit (a launch never sets it again, so a
  // CUDA graph can capture the launches)
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (smem > 48 * 1024 && allowed != cudaSuccess) return int(allowed);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  kernel<<<dim3(a.nch, a.hkv, b), kThreads, smem, stream>>>(a);
  if (int e = int(cudaGetLastError())) return e;
  if (a.nch > 1)
    paged_decode_combine<<<dim3(a.h, b), kThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dpl(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 2>(a, b, stream);
  if (a.d <= 128) return launch<T, 4>(a, b, stream);
  return launch<T, 8>(a, b, stream);
}

}  // namespace

PT_DEFINE_PROBE(paged_decode)

// q/out: [b, h, d] f32 contiguous; pools [nb, hkv, bs, d] of `kv_dtype`
// (pt::DType) contiguous; scales [nb, hkv, bs] f32 (int8 pools only,
// else null); block_tables [b, nblk] and context_lens [b] int32.
// window <= 0 means no window. part [b, h, part_chunks, d] and ml [b, h,
// part_chunks, 2] f32 scratch, read only when the launch splits (nch =
// ceil(nblk * bs / chunk) > 1; it needs part_chunks >= nch). report[0]
// gets the chunk (tokens a block), report[1] nch, the chunks launched a
// (kv head, slot): more than 1 means the split kernel and the combine
// ran, 1 that the one chunk wrote the output. Returns
// cudaGetLastError() after the launches.
extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* context_lens, void* out,
                                   void* part, void* ml, int part_chunks,
                                   int b, int h, int hkv, int d, int bs,
                                   int nblk, int window, float scale,
                                   int kv_dtype, void* stream, int* report) {
  const int nch = (nblk * bs + kChunk - 1) / kChunk;
  if (b < 1 || hkv < 1 || h % hkv || d < 1 || d > kMaxHeadDim || bs < 1 ||
      nblk < 1 || nch < 1 || hkv > 65535 || b > 65535 ||
      (nch > 1 && (part == nullptr || ml == nullptr || part_chunks < nch)))
    return int(cudaErrorInvalidValue);
  static const int kItem[] = {4, 2, 2, 1};
  if (kv_dtype < 0 || kv_dtype > 3) return int(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q),
               k_pool,
               v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens),
               static_cast<float*>(out),
               static_cast<float*>(part),
               static_cast<float*>(ml),
               h,
               hkv,
               d,
               bs,
               nblk,
               window,
               nch,
               scale,
               (d * kItem[kv_dtype]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pool) % 16 == 0};
  report[0] = kChunk;
  report[1] = nch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case pt::kF32:
      return launch_dpl<float>(a, b, st);
    case pt::kBF16:
      return launch_dpl<__nv_bfloat16>(a, b, st);
    case pt::kF16:
      return launch_dpl<__half>(a, b, st);
    default:
      return launch_dpl<int8_t>(a, b, st);
  }
}
