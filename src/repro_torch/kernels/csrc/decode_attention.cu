// K5 and K6: single-token decode attention, over a contiguous cache (K5)
// or read through a page table (K6), with a runtime kv tile, split over the
// kv axis (flash-decoding).
//
// Replaces the Pallas kernels in src/repro/kernels/flash_attention.py
// (`decode_flash_attention` and `paged_decode_flash_attention`).  There the
// grid was (batch*kv head, kv blocks) with the kv axis sequential and the
// running (m, l, acc) statistics in VMEM scratch; the paged kernel aimed each
// kv step's DMA at the slot's next physical page through a scalar-prefetched
// page table.  Here the grid is (batch*kv head, splits): the G query rows of
// a GQA group share a CTA, and split s of a (batch, kv head) takes a
// contiguous run of `rps` kv rows, in steps of at most one kv tile of `bkv`
// rows held in shared memory (K5: a runtime divisor of T; K6: one page of
// `ps` rows, the page id read from the table and clamped to n_pages - 1,
// straight from the pools with no gathered copy).  With enough tiles a
// split is a run of whole tiles; with fewer tiles than the card needs
// splits (bkv 128 or 256 at T 256), a split is part of one tile.  K and V
// are loaded 16 bytes a thread where D and the pointers allow.  Scores are
// q.k scaled by `scale`, soft-capped (cap * tanh(s / cap)), then the
// additive bias row (0 or -1e30, the length and window masks as data) is
// added; an online softmax runs over the split's steps.
// With one split the CTA writes acc / max(l, 1e-30) itself.  With more,
// each CTA writes its (m, l, acc) to a scratch the wrapper allocates, and
// the last CTA of a (batch, kv head) to arrive (a counter per (batch, kv
// head), reset by that CTA; the counters of kernels/matmul.py's split-K,
// kept per device and stream) combines the splits online in split order
// (M' = max(M, m_s); l' = l exp(M - M') + l_s exp(m_s - M'); acc likewise)
// and writes acc / max(l, 1e-30) — the reference's numerics.  A split that
// the bias masks whole has m_s = -1e30, so its weight is 0 unless every
// split is masked, when all weights are 1 and the output is the mean of v,
// as in the reference.  One launch; the same bits every run.
//
// Bound on an H100: at the smollm-135m serving shape (B=4, KVH=3, G=3,
// T=256, D=64) the call reads 1.6 MB of K/V and does 4*B*KVH*G*T*D = 2.4
// MFLOP, so it is bound by bytes (0.48 us at 3.35 TB/s).  The first kernel,
// one CTA per (batch, kv head), ran 12 CTAs on 132 SMs, each streaming its
// 128 KB of K/V alone.  The split count is a pure function of (B*KVH, T,
// bkv, SMs) (kernels/flash_attention.py, `decode_splits`): at that shape,
// 16 splits of one tile each at bkv 16 (192 CTAs), 11 splits of 24 rows at
// bkv 32 and above (132 CTAs).  What is left is the latency of a load and
// of the combining CTA's pass.  The K tile is padded to D+1 floats a row so
// the score loop reads it without bank conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// are (n_pages, KVH, bkv, D) pools and table is (B, n_tiles) page ids.  Grid
// (B*KVH, splits); split s takes rows [s*rps, min((s+1)*rps, T)) in steps
// that never cross a tile (a page) and hold at most bkv rows: whole tiles
// when rps is a multiple of bkv, part of one tile otherwise.  part:
// (B*KVH, splits, 2G + G*D) f32 and counters: one int per (batch, kv
// head), zero, left zero; both unused with one split.  kvec: D % 4 == 0 and
// k, v 16-byte aligned.
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const int* __restrict__ table, float* __restrict__ o,
    float* __restrict__ part, int* __restrict__ counters, int KVH, int G,
    int D, int bkv, int n_tiles, int rps, int n_pages, float scale,
    float softcap, int kvec) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 1;
  const int splits = gridDim.y, split = blockIdx.y;
  float* qs = smem;              // [G][D]
  float* vs = qs + G * D;        // [bkv][D]
  float* ks = vs + bkv * D;      // [bkv][D + 1]
  float* ss = ks + bkv * ldk;    // [G][bkv] scores, then probabilities
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

  const int T = n_tiles * bkv;
  const int r_end = min((split + 1) * rps, T);
  for (int r0 = split * rps; r0 < r_end;) {
    const int t = r0 / bkv;                         // the tile (page) of this step
    const int rows = min(r_end, (t + 1) * bkv) - r0;  // its rows, at most bkv
    const float* kt;
    const float* vt;
    if (table != nullptr) {
      int page = table[(long long)b * n_tiles + t];
      page = page > n_pages - 1 ? n_pages - 1 : (page < 0 ? 0 : page);
      const long long off = (((long long)page * KVH + kvh) * bkv + r0 - t * bkv) * D;
      kt = k + off;
      vt = v + off;
    } else {
      const long long off = ((long long)bh * T + r0) * D;
      kt = k + off;
      vt = v + off;
    }
    if (kvec) {
      const int dv = D >> 2;
      for (int e = tid; e < rows * dv; e += blockDim.x) {
        const int r = e / dv, c = (e - r * dv) << 2;
        const float4 kk = __ldg(reinterpret_cast<const float4*>(kt + r * D + c));
        const float4 vv = __ldg(reinterpret_cast<const float4*>(vt + r * D + c));
        float* kd = ks + r * ldk + c;
        kd[0] = kk.x;
        kd[1] = kk.y;
        kd[2] = kk.z;
        kd[3] = kk.w;
        *reinterpret_cast<float4*>(vs + r * D + c) = vv;
      }
    } else {
      for (int e = tid; e < rows * D; e += blockDim.x) {
        const int r = e / D, c = e - r * D;
        ks[r * ldk + c] = kt[e];
        vs[e] = vt[e];
      }
    }
    __syncthreads();

    const float* bt = brow + r0;
    for (int e = tid; e < G * rows; e += blockDim.x) {
      const int r = e / rows, c = e - r * rows;
      const float* qr = qs + r * D;
      const float* kr = ks + c * ldk;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      ss[r * bkv + c] = s + bt[c];
    }
    __syncthreads();

    // one warp per query row: new max, probabilities, running sum
    for (int r = warp; r < G; r += n_warps) {
      float* sr = ss + r * bkv;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int c = lane; c < rows; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < rows; c += 32) {
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
      for (int c = 0; c < rows; ++c) pv = fmaf(pr[c], vs[c * D + d], pv);
      acc[e] = acc[e] * a_s[r] + pv;
    }
    __syncthreads();
    r0 += rows;
  }

  if (splits == 1) {
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int r = e / D;
      ob[e] = acc[e] / fmaxf(l_s[r], 1e-30f);
    }
    return;
  }

  // this split's (m, l, acc), then the last CTA of the (batch, kv head)
  // combines every split in split order
  const int stride = 2 * G + G * D;
  float* pp = part + ((long long)bh * splits + split) * stride;
  for (int r = tid; r < G; r += blockDim.x) {
    pp[r] = m_s[r];
    pp[G + r] = l_s[r];
  }
  for (int e = tid; e < G * D; e += blockDim.x) pp[2 * G + e] = acc[e];
  __shared__ int last_cta;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_cta = atomicAdd(counters + bh, 1) == splits - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();

  // online over the splits, in split order, eight splits' loads in flight
  const float* pb = part + (long long)bh * splits * stride;
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int r = e / D;
    float mx = kNegInf, l = 0.f, a = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float ms[8], ls[8], as[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* ps = pb + (long long)min(s0 + u, splits - 1) * stride;
        ms[u] = __ldcg(ps + r);
        ls[u] = __ldcg(ps + G + r);
        as[u] = __ldcg(ps + 2 * G + e);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < splits) {
          const float m_new = fmaxf(mx, ms[u]);
          const float keep = expf(mx - m_new), w = expf(ms[u] - m_new);
          l = l * keep + ls[u] * w;
          a = a * keep + as[u] * w;
          mx = m_new;
        }
      }
    }
    ob[e] = a / fmaxf(l, 1e-30f);
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

size_t smem_bytes(int G, int D, int bkv) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)bkv * (D + 1) +
                          (size_t)bkv * D + (size_t)G * bkv + 3 * (size_t)G);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* table, void* o, void* part, void* counters, int BH,
           int KVH, int G, int D, int bkv, int n_tiles, int rps, int splits,
           int n_pages, float scale, float softcap, long long smem_arg,
           void* stream) {
  const size_t smem = smem_bytes(G, D, bkv);
  if ((long long)smem != smem_arg || rps < 1 ||
      (splits > 1 && (part == nullptr || counters == nullptr)) ||
      splits != (n_tiles * bkv + rps - 1) / rps)
    return (int)cudaErrorInvalidValue;
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  const int kvec = D % 4 == 0 && aligned16(k) && aligned16(v);
  decode_attention_kernel<<<dim3(BH, splits), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(table), static_cast<float*>(o),
      static_cast<float*>(part), static_cast<int*>(counters), KVH, G, D, bkv,
      n_tiles, rps, n_pages, scale, softcap, kvec);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. q, o: (B, KVH, G, D); k, v: (B, KVH, T, D); bias: (B, T); all f32,
// contiguous; bkv divides T.  rps rows a split, splits = ceil(T / rps);
// part: (B*KVH, splits, 2G + G*D) f32 and counters: B*KVH zero ints, both
// null with one split; smem: the wrapper's figure, checked.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* part, void* counters,
                                      int B, int KVH, int G, int T, int D,
                                      int bkv, int rps, int splits,
                                      float scale, float softcap,
                                      long long smem, void* stream) {
  return launch(q, k, v, bias, nullptr, o, part, counters, B * KVH, KVH, G, D,
                bkv, T / bkv, rps, splits, 0, scale, softcap, smem, stream);
}

// K6. q, o: (B, KVH, G, D); k_pool, v_pool: (n_pages, KVH, ps, D); table:
// (B, P) int32 page ids (entries >= n_pages are clamped to the last page);
// bias: (B, P * ps); f32 and contiguous.  rps rows a split, as for K5 over
// the P * ps rows the table maps; part, counters and smem as for K5.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* o, void* part, void* counters, int B, int KVH,
    int G, int D, int ps, int P, int rps, int splits, int n_pages, float scale,
    float softcap, long long smem, void* stream) {
  return launch(q, k_pool, v_pool, bias, table, o, part, counters, B * KVH,
                KVH, G, D, ps, P, rps, splits, n_pages, scale, softcap, smem,
                stream);
}
