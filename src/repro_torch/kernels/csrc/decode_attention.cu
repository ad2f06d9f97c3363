// K5 and K6: single-token decode attention, over a contiguous cache (K5)
// or read through a page table (K6), with a runtime kv tile.
//
// Replaces the Pallas kernels in src/repro/kernels/flash_attention.py
// (`decode_flash_attention` and `paged_decode_flash_attention`).  There the
// grid was (batch*kv head, kv blocks) with the kv axis sequential and the
// running (m, l, acc) statistics in VMEM scratch; the paged kernel aimed each
// kv step's DMA at the slot's next physical page through a scalar-prefetched
// page table.  Here one CTA owns one (batch, kv head): the G query rows of the
// GQA group share it, and the CTA loops over the kv axis itself in tiles of
// `bkv` rows (K5: a runtime divisor of T; K6: one page of `ps` rows, the page
// id read from the table and clamped to n_pages - 1, straight from the pools
// with no gathered copy).  Scores are q.k scaled by `scale`, soft-capped
// (cap * tanh(s / cap)), then the additive bias row (0 or -1e30, the length
// and window masks as data) is added; online softmax; the output divides by
// max(l, 1e-30) — the reference's numerics exactly.
//
// Bound on an H100: at the smollm-135m serving shape (B=4, KVH=3, G=3,
// T=256, D=64) the call reads 1.6 MB of K/V and does 4*B*KVH*G*T*D = 2.4
// MFLOP, so it is bound by bytes (0.48 us at 3.35 TB/s).  This first version
// is far from that: with one CTA per (batch, kv head) only B*KVH = 12 CTAs
// run, so 120 of the 132 SMs idle and each CTA streams its 128 KB of K/V
// alone.  Splitting the kv axis across CTAs with a second combining pass
// (flash-decoding), and vectorised / TMA loads, come in a later PR.  The K
// tile is padded to D+1 floats a row so the score loop reads it without bank
// conflicts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, o: (B*KVH, G, D); bias: (B, n_tiles*bkv).  Contiguous cache (table ==
// nullptr): k, v are (B*KVH, n_tiles*bkv, D).  Paged (table != nullptr): k, v
// are (n_pages, KVH, bkv, D) pools and table is (B, n_tiles) page ids.
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const int* __restrict__ table, float* __restrict__ o, int KVH, int G,
    int D, int bkv, int n_tiles, int n_pages, float scale, float softcap) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* qs = smem;              // [G][D]
  float* ks = qs + G * D;        // [bkv][D + 1]
  float* vs = ks + bkv * ldk;    // [bkv][D]
  float* ss = vs + bkv * D;      // [G][bkv] scores, then probabilities
  float* acc = ss + G * bkv;     // [G][D]
  float* m_s = acc + G * D;      // [G] running max
  float* l_s = m_s + G;          // [G] running sum
  float* a_s = l_s + G;          // [G] rescale factor of this kv step

  const int bh = blockIdx.x;
  const int b = bh / KVH, kvh = bh - b * KVH;
  const float* qb = q + (long long)bh * G * D;
  const float* brow = bias + (long long)b * n_tiles * bkv;
  float* ob = o + (long long)bh * G * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  for (int e = tid; e < G * D; e += blockDim.x) {
    qs[e] = qb[e];
    acc[e] = 0.f;
  }
  for (int r = tid; r < G; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const float* kt;
    const float* vt;
    if (table != nullptr) {
      int page = table[(long long)b * n_tiles + t];
      page = page > n_pages - 1 ? n_pages - 1 : (page < 0 ? 0 : page);
      const long long off = ((long long)page * KVH + kvh) * bkv * D;
      kt = k + off;
      vt = v + off;
    } else {
      const long long off = ((long long)bh * n_tiles + t) * bkv * D;
      kt = k + off;
      vt = v + off;
    }
    for (int e = tid; e < bkv * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      ks[r * ldk + c] = kt[e];
      vs[e] = vt[e];
    }
    __syncthreads();

    const float* bt = brow + (long long)t * bkv;
    for (int e = tid; e < G * bkv; e += blockDim.x) {
      const int r = e / bkv, c = e - r * bkv;
      const float* qr = qs + r * D;
      const float* kr = ks + c * ldk;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      ss[e] = s + bt[c];
    }
    __syncthreads();

    // one warp per query row: new max, probabilities, running sum
    for (int r = warp; r < G; r += n_warps) {
      float* sr = ss + r * bkv;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int c = lane; c < bkv; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < bkv; c += 32) {
        const float p = expf(sr[c] - mx);
        sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      const float* pr = ss + r * bkv;
      float pv = 0.f;
      for (int c = 0; c < bkv; ++c) pv = fmaf(pr[c], vs[c * D + d], pv);
      acc[e] = acc[e] * a_s[r] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += blockDim.x) {
    const int r = e / D;
    ob[e] = acc[e] / fmaxf(l_s[r], 1e-30f);
  }
}

size_t smem_bytes(int G, int D, int bkv) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)bkv * (D + 1) +
                          (size_t)bkv * D + (size_t)G * bkv + 3 * (size_t)G);
}

int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* table, void* o, int BH, int KVH, int G, int D, int bkv,
           int n_tiles, int n_pages, float scale, float softcap,
           void* stream) {
  const size_t smem = smem_bytes(G, D, bkv);
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  decode_attention_kernel<<<BH, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(table), static_cast<float*>(o), KVH, G, D, bkv,
      n_tiles, n_pages, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. q, o: (B, KVH, G, D); k, v: (B, KVH, T, D); bias: (B, T); all f32,
// contiguous; bkv divides T.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, int B, int KVH, int G, int T,
                                      int D, int bkv, float scale,
                                      float softcap, void* stream) {
  return launch(q, k, v, bias, nullptr, o, B * KVH, KVH, G, D, bkv, T / bkv,
                0, scale, softcap, stream);
}

// K6. q, o: (B, KVH, G, D); k_pool, v_pool: (n_pages, KVH, ps, D); table:
// (B, P) int32 page ids (entries >= n_pages are clamped to the last page);
// bias: (B, P * ps); f32 and contiguous.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* o, int B, int KVH, int G, int D, int ps, int P,
    int n_pages, float scale, float softcap, void* stream) {
  return launch(q, k_pool, v_pool, bias, table, o, B * KVH, KVH, G, D, ps, P,
                n_pages, scale, softcap, stream);
}
