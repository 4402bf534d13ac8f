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
// What bounds it on an H100: bytes. Each key/value element is read
// once and used for 2 * rep flops, far below the ~295 flops per byte
// the card needs before its arithmetic is the limit. So the design
// reads every live K/V byte exactly once and nothing else:
//   - one block per (kv head, slot): the slot's `rep` query rows are
//     loaded once and serve every K/V row the block reads, so GQA
//     costs no extra K/V traffic;
//   - the block walks only the live tokens [max(0, ctx - window), ctx)
//     through the block table it reads itself; dead slots and pages
//     left of the window are never touched;
//   - a page is staged in sub-tiles of 32 tokens (K and V, converted to
//     f32) so one tile fits in shared memory whatever the page size:
//     at page 128, d 128 a whole K+V page would be 128 KB in f32, over
//     the 48 KB static limit; the dynamic shared-memory limit is raised
//     only for head dims that need it;
//   - K rows are read as 16-byte vectors (int8 pools move a quarter of
//     the f32 bytes) and the online softmax keeps m, l and the output
//     accumulator in f32.
// Not done yet (later work): overlapping a tile's loads with the
// previous tile's math (cp.async / TMA), and splitting long contexts
// over several blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 32;  // tokens per staged tile: one per lane

size_t smem_bytes(int rep, int d) {
  // q [rep][d], K [kTok][d+1], V [kTok][d], p [rep][kTok], acc [rep][d],
  // m, l, alpha [rep] (mirrored by paged_attention.paged_decode_smem_bytes)
  return sizeof(float) *
         (size_t(rep) * d + size_t(kTok) * (d + 1) + size_t(kTok) * d +
          size_t(rep) * kTok + size_t(rep) * d + 3 * size_t(rep));
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const float* __restrict__ q,
                        const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        float* __restrict__ out, int h, int hkv, int d,
                        int bs, int nblk, int window, float scale) {
  const int g = blockIdx.x;     // kv head
  const int slot = blockIdx.y;  // sequence / serving lane
  const int rep = h / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [rep][d], pre-scaled
  float* k_s = q_s + rep * d;          // [kTok][d + 1]
  float* v_s = k_s + kTok * (d + 1);   // [kTok][d]
  float* p_s = v_s + kTok * d;         // [rep][kTok]
  float* acc = p_s + rep * kTok;       // [rep][d]
  float* m_s = acc + rep * d;          // [rep]
  float* l_s = m_s + rep;              // [rep]
  float* a_s = l_s + rep;              // [rep]
  __shared__ long long row_of[kTok];   // pool row (page, g, slot) per token

  const size_t qo = (size_t(slot) * h + size_t(g) * rep) * d;
  float* o = out + qo;
  // live keys [lo, ctx): the window is measured back from the slot's
  // own position (ctx - 1); only the walk is clamped to the block
  // table's capacity, as in the Pallas kernel
  const int ctx_raw = context_lens[slot];
  const int ctx = min(ctx_raw, nblk * bs);
  const int lo = (window > 0 && ctx_raw > window) ? ctx_raw - window : 0;
  if (ctx <= lo) {  // dead slot (context 0) or nothing left of the window
    for (int i = tid; i < rep * d; i += kThreads) o[i] = 0.f;
    return;
  }
  const int* bt = block_tables + size_t(slot) * nblk;

  for (int i = tid; i < rep * d; i += kThreads) {
    q_s[i] = q[qo + i] * scale;
    acc[i] = 0.f;
  }
  if (tid < rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  constexpr int kVec = pt::Vec16<T>::n;
  const bool vec = (d % kVec) == 0;
  for (int t0 = lo; t0 < ctx; t0 += kTok) {
    const int nt = min(kTok, ctx - t0);
    __syncthreads();  // the previous tile is fully consumed
    if (tid < nt) {
      const int t = t0 + tid;
      const long long page = bt[t / bs];
      row_of[tid] = (page * hkv + g) * bs + (t % bs);
    }
    __syncthreads();
    if (vec) {
      const int vpr = d / kVec;
      for (int idx = tid; idx < nt * vpr; idx += kThreads) {
        const int j = idx / vpr;
        const int c = (idx - j * vpr) * kVec;
        const long long r = row_of[j];
        const float ks = kQuant ? k_scale[r] : 1.f;
        const float vs = kQuant ? v_scale[r] : 1.f;
        pt::load16_f32(k_pool + r * d + c, k_s + j * (d + 1) + c, ks);
        pt::load16_f32(v_pool + r * d + c, v_s + j * d + c, vs);
      }
    } else {
      for (int idx = tid; idx < nt * d; idx += kThreads) {
        const int j = idx / d;
        const int c = idx - j * d;
        const long long r = row_of[j];
        const float ks = kQuant ? k_scale[r] : 1.f;
        const float vs = kQuant ? v_scale[r] : 1.f;
        k_s[j * (d + 1) + c] = pt::to_f32(k_pool[r * d + c]) * ks;
        v_s[j * d + c] = pt::to_f32(v_pool[r * d + c]) * vs;
      }
    }
    __syncthreads();
    // scores + online-softmax statistics: one warp per query row, one
    // lane per token (K rows padded to d + 1: conflict-free reads)
    for (int r = warp; r < rep; r += kWarps) {
      float s = -INFINITY;
      if (lane < nt) {
        const float* qr = q_s + r * d;
        const float* kr = k_s + lane * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot;
      }
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: token t0 is live
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r * kTok + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rep * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const float* pr = p_s + r * kTok;
      float a = acc[idx] * a_s[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], v_s[j * d + c], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rep * d; idx += kThreads) {
    const float l = l_s[idx / d];
    o[idx] = l > 0.f ? acc[idx] / l : 0.f;
  }
}

template <typename T, bool kQuant>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* bt, const void* cl, void* out, int b,
           int h, int hkv, int d, int bs, int nblk, int window, float scale,
           cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, kQuant>;
  const size_t smem = smem_bytes(h / hkv, d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(cl), static_cast<float*>(out), h, hkv, d, bs,
      nblk, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

PT_DEFINE_PROBE(paged_decode)

// q/out: [b, h, d] f32 contiguous; pools [nb, hkv, bs, d] of `kv_dtype`
// (pt::DType) contiguous; scales [nb, hkv, bs] f32 (int8 pools only,
// else null); block_tables [b, nblk] and context_lens [b] int32.
// window <= 0 means no window. Returns cudaGetLastError() after launch.
extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* context_lens, void* out, int b,
                                   int h, int hkv, int d, int bs, int nblk,
                                   int window, float scale, int kv_dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case pt::kF32:
      return launch<float, false>(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, context_lens, out, b, h, hkv,
                                  d, bs, nblk, window, scale, st);
    case pt::kBF16:
      return launch<__nv_bfloat16, false>(q, k_pool, v_pool, k_scale,
                                          v_scale, block_tables,
                                          context_lens, out, b, h, hkv, d,
                                          bs, nblk, window, scale, st);
    case pt::kF16:
      return launch<__half, false>(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, context_lens, out, b, h,
                                   hkv, d, bs, nblk, window, scale, st);
    case pt::kI8:
      return launch<int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, context_lens, out, b, h, hkv,
                                  d, bs, nblk, window, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
