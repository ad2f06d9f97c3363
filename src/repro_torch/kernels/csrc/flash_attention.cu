// K3: online-softmax prefill attention with runtime (block_q, block_kv).
//
// Replaces the Pallas kernel in src/repro/kernels/flash_attention.py
// (`flash_attention`).  There the kv grid axis was sequential and the
// running (m, l, acc) statistics lived in VMEM scratch; here a CTA loops
// over its kv tiles itself.  Scores are scaled by `scale`, soft-capped
// (cap * tanh(s / cap)) before the causal / sliding-window mask and masked
// to -1e30 (not -inf); the output is acc / max(l, 1e-30) (the tc variant
// multiplies by 1 / max(l, 1e-30), within an ulp of the division): the
// reference's numerics.  A kv tile that every row of the tile masks out is
// skipped; the running statistics are unchanged by it.  One rule
// (kernels/flash_attention.py, `variant`) picks one of two kernels from the
// head dim and the kv tile:
//
// * `tc` (bkv % 8 == 0, D 8, 16, 32 or 64): Q.K^T and P.V on the tensor
//   cores through mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh), each 8-deep
//   step summed from zero and added to f32 registers.  A CTA takes one q
//   block of bq positions for all G query heads of one kv head, so each K
//   and V tile is copied once for the G heads.  Its G * bq rows are
//   position-major (row r: position q0 + r / G, head r % G), so a warp's
//   16 rows span few positions and the causal skip stays tight.  The rows
//   fill m16 tiles (the last one padded: padded rows are neither loaded
//   nor stored); a CTA holds one or two of them (`groups` CTAs a q block)
//   and gives each `splits` warps, each a contiguous share of the CTA's kv
//   range: a run of whole kv tiles where the tiles are many, part of each
//   tile of a run where they are few.  So the few rows of a prefill (144
//   m16 tiles at smollm-135m's forward for 132 SMs) still give short mma
//   chains on every SM.  Q's rows are copied once for the CTA; the runs'
//   kv tiles, only the rows the CTA's chunks read, go through a cp.async
//   ring of two stages where two fit (one when a run is one tile long),
//   one tile of every run a round.  A warp keeps its rows' online softmax
//   in registers: the C fragment holds rows g and g+8, their max and sum
//   need two quad shuffles, and P never leaves the registers: V's B
//   fragment is read at kv rows 2t and 2t+1, so (c0, c2, c1, c3) of the
//   score fragment is P's A fragment as it stands (a permutation of the
//   summed kv index, which is exact).  The mma chains of several 8-wide
//   tiles are interleaved.  The mask is applied only on the chunks it cuts
//   (the diagonal, the window's edge).  Then every split writes its
//   partial (m, l, acc) to shared memory and the warps of an m16 tile each
//   combine a share of its columns, in split order, so two runs give the
//   same bits; a split that the mask covers entirely has m = -1e30 and
//   weighs 0.  The q blocks are launched from the last to the first: under
//   a causal mask the last ones are the heaviest.
// * `fma` (every other tile): the first kernel.  One CTA owns one
//   (batch*head, block of bq query rows) and loops over the kv blocks with
//   plain FMAs out of shared memory, keeping m, l and acc in shared memory;
//   the GQA index map (q head h reads kv head h // G) is an offset computed
//   from blockIdx, and the K tile is padded to D+1 floats a row so the
//   score loop reads it without bank conflicts.
//
// Bound on an H100: at the smollm-135m prefill shape (B=1, H=9, KVH=3,
// S=256, D=64, causal) the function needs 75.8 MFLOP (the unmasked pairs)
// and 1.57 MB of q, k, v and o: 0.00046 ms at the 3xTF32 rate (495 / 3
// TFLOP/s), 0.00047 ms at 3.35 TB/s, so by bytes for `tc`; 0.0011 ms at
// the 67 TFLOP/s f32 rate of `fma`, by operations.  What is left is
// latency in the CTA of the last q block (tools/k3_phases.py stamps each
// CTA's phases): it copies every kv row, ~2.5 us at the rate L2 feeds one
// SM while every SM copies; its warps' mma chains and the ALU work around
// them (fragment loads and splits, f32 sums) take 4-6 us; the combine and
// the stores ~1.5 us.  TMA multicast, wgmma and kv splits across CTAs come
// later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

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

// ---------------------------------------------------------------------------
// fma: every tile the tc variant does not take
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int H, int KVH,
    int S, int D, int bq, int bkv, float scale, int causal, int window,
    float softcap) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* qs = smem;              // [bq][D]
  float* ks = qs + bq * D;       // [bkv][D + 1]
  float* vs = ks + bkv * ldk;    // [bkv][D]
  float* ss = vs + bkv * D;      // [bq][bkv] scores, then probabilities
  float* acc = ss + bq * bkv;    // [bq][D]
  float* m_s = acc + bq * D;     // [bq] running max
  float* l_s = m_s + bq;         // [bq] running sum
  float* a_s = l_s + bq;         // [bq] rescale factor of this kv step

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kv_head = h / (H / KVH);
  const int q0 = blockIdx.x * bq;
  const float* qb = q + ((long long)bh * S + q0) * D;
  const float* kb = k + (long long)(b * KVH + kv_head) * S * D;
  const float* vb = v + (long long)(b * KVH + kv_head) * S * D;
  float* ob = o + ((long long)bh * S + q0) * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  for (int e = tid; e < bq * D; e += blockDim.x) {
    qs[e] = qb[e];
    acc[e] = 0.f;
  }
  for (int r = tid; r < bq; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int q_last = q0 + bq - 1;
  for (int j0 = 0; j0 < S; j0 += bkv) {
    if (causal && j0 > q_last) break;                    // all later keys are future
    if (window > 0 && q0 - (j0 + bkv - 1) >= window) continue;  // all too old
    for (int e = tid; e < bkv * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      ks[r * ldk + c] = kb[(long long)j0 * D + e];
      vs[e] = vb[(long long)j0 * D + e];
    }
    __syncthreads();

    for (int e = tid; e < bq * bkv; e += blockDim.x) {
      const int r = e / bkv, c = e - r * bkv;
      const float* qr = qs + r * D;
      const float* kr = ks + c * ldk;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int qp = q0 + r, kp = j0 + c;
      bool keep = true;
      if (causal) keep = kp <= qp;
      if (window > 0) keep = keep && (qp - kp < window);
      ss[e] = keep ? s : kNegInf;
    }
    __syncthreads();

    // one warp per row: new max, probabilities, running sum
    for (int r = warp; r < bq; r += n_warps) {
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

    for (int e = tid; e < bq * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      const float* pr = ss + r * bkv;
      float pv = 0.f;
      for (int c = 0; c < bkv; ++c) pv = fmaf(pr[c], vs[c * D + d], pv);
      acc[e] = acc[e] * a_s[r] + pv;
    }
    __syncthreads();
  }
  __syncthreads();

  for (int e = tid; e < bq * D; e += blockDim.x) {
    const int r = e / D;
    ob[e] = acc[e] / fmaxf(l_s[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// tc: 3xTF32 mma.sync, the kv range of a q block split over warps
// ---------------------------------------------------------------------------

constexpr int kTcMaxWarps = 8;
constexpr int kTcPad = 4;  // floats a K or V row is padded by

// The run of the CTA's n kv tiles that run s of ns takes: the first n % ns
// runs take one tile more.
__device__ __forceinline__ void split_run(int n, int ns, int s, int& start, int& count) {
  const int base = n / ns, rem = n % ns;
  start = s * base + min(s, rem);
  count = base + (s < rem ? 1 : 0);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store columns c, c + 1 of this thread's rows g (at o + row_a) and g + 8
// (at o + row_b), the real ones, times their 1 / max(l, 1e-30).
__device__ __forceinline__ void store_rows(float* o, long long row_a, long long row_b,
                                           bool in_a, bool in_b, int c,
                                           const float (&v)[4], float inv_a,
                                           float inv_b) {
  if (in_a)
    *reinterpret_cast<float2*>(o + row_a + c) = make_float2(v[0] * inv_a, v[1] * inv_a);
  if (in_b)
    *reinterpret_cast<float2*>(o + row_b + c) = make_float2(v[2] * inv_b, v[3] * inv_b);
}

// One CTA: rows [16*mw*grp, 16*mw*(grp + 1)) of one q block of one
// (batch, kv head); warp (wm, split) owns m16 tile mw*grp + wm over its
// split's keys.  The CTA's kv tiles are split into `tiles` contiguous
// runs, one tile of each a round, and each staged tile into `sub`
// contiguous parts: split = run * sub + part, so the splits follow the
// keys.  NK: 8-key mma tiles a softmax step (8 * NK divides bkv / sub);
// ND: 8-wide d steps, D / 8, a compile-time value (a runtime head dim
// kept every fragment load behind a branch, one after another).  Shared
// memory: Q's rows, then the ring, `stages` x `tiles` x (K, V) tiles of
// bkv rows, rows of D + kTcPad floats; after the kv loop the splits'
// partials reuse the ring.
template <int NK, int ND>
__global__ void __launch_bounds__(kTcMaxWarps * 32) flash_attention_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int B, int H, int KVH,
    int S, int bq, int bkv, int groups, int mw, int tiles, int sub, int stages,
    int vec, float scale, int causal, int window, float softcap) {
  extern __shared__ __align__(16) float smem_all[];
  constexpr int D = 8 * ND;
  const int G = H / KVH, R = G * bq;
  constexpr int ld = D + kTcPad;
  const int tile = bkv * ld;              // floats of one K or V tile
  const int stage_floats = 2 * tiles * tile;
  const int ns = tiles * sub, span = bkv / sub;
  float* qs = smem_all;                   // [mw * 16][ld]: Q's rows
  float* smem = qs + mw * 16 * ld;        // the ring, then the partials

  // blockIdx.x: the q block slowest, from the last (the heaviest under a
  // causal mask) to the first, then the (batch, kv head), then the group
  int idx = blockIdx.x;
  const int grp = idx % groups;
  idx /= groups;
  const int bkvh = idx % (B * KVH);
  const int q0 = (S / bq - 1 - idx / (B * KVH)) * bq;
  const int b = bkvh / KVH, kvh = bkvh - b * KVH;
  const float* kb = k + (long long)bkvh * S * D;
  const float* vb = v + (long long)bkvh * S * D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % mw, split = warp / mw;
  const int run = split / sub, part = split - run * sub;

  // the CTA's rows, its positions and its kv tiles
  const int c_r0 = grp * mw * 16, c_r1 = min(R, c_r0 + mw * 16);
  const int c_pos_lo = q0 + c_r0 / G, c_pos_hi = q0 + (c_r1 - 1) / G;
  const int kv_hi = causal ? c_pos_hi + 1 : S;
  const int kv_lo = window > 0 ? max(0, c_pos_lo - window + 1) : 0;
  const int t_lo = kv_lo / bkv, n_t = (kv_hi + bkv - 1) / bkv - t_lo;
  const int rounds = (n_t + tiles - 1) / tiles;
  // the rows a chunk of the CTA can read: its kv range widened to whole
  // softmax steps (rows outside it are masked, but P.V would multiply a
  // stale row by 0, and a stale inf or nan by 0 is nan)
  const int step = 8 * NK;
  const int row_lo = kv_lo / step * step, row_hi = (kv_hi + step - 1) / step * step;

  // the warp's rows: m16 tile r_lo..r_lo+15, this thread's g and g + 8
  const int r_lo = c_r0 + 16 * wm;
  const int w_pos_lo = q0 + r_lo / G, w_pos_hi = q0 + (min(r_lo + 15, R - 1)) / G;
  const int ra = r_lo + gid, rb = ra + 8;
  const bool in_a = ra < R, in_b = rb < R;
  const int pos_a = q0 + ra / G, pos_b = q0 + rb / G;
  const long long row_a = in_a ? ((long long)(b * H + kvh * G + ra % G) * S + pos_a) * D : 0;
  const long long row_b = in_b ? ((long long)(b * H + kvh * G + rb % G) * S + pos_b) * D : 0;

  int t0, cnt;
  split_run(n_t, tiles, run, t0, cnt);
  t0 += t_lo;

  // start copying round r (tile start + r of every run that has one, the
  // rows between row_lo and row_hi) into stage st, one copy group
  auto load_round = [&](int r, int st) {
    for (int s = 0; s < tiles; ++s) {
      int start, count;
      split_run(n_t, tiles, s, start, count);
      if (r >= count) continue;
      const int key_t = (t_lo + start + r) * bkv;
      const int r0 = max(0, row_lo - key_t), r1 = min(bkv, row_hi - key_t);
      const long long g0 = ((long long)key_t + r0) * D;
      float* ks = smem + st * stage_floats + s * 2 * tile + r0 * ld;
      float* vs = ks + tile;
      if (vec) {
        constexpr int dv = D / 4;
        for (int e = threadIdx.x; e < (r1 - r0) * dv; e += blockDim.x) {
          const int row = e / dv, c = (e - row * dv) * 4;
          cp_async16(ks + row * ld + c, kb + g0 + row * D + c);
          cp_async16(vs + row * ld + c, vb + g0 + row * D + c);
        }
      } else {
        for (int e = threadIdx.x; e < (r1 - r0) * D; e += blockDim.x) {
          const int row = e / D, c = e - row * D;
          cp_async4(ks + row * ld + c, kb + g0 + e);
          cp_async4(vs + row * ld + c, vb + g0 + e);
        }
      }
    }
    cp_async_commit();
  };

  // Q's rows (mw m16 tiles of D + kTcPad floats, before the ring) are
  // copied once for the CTA's warps, in a copy group ahead of the first
  // round's; then each warp reads its A fragments, a0 (g, t), a1 (g + 8,
  // t), a2 (g, t + 4), a3 (g + 8, t + 4) of each 8-wide d step, and splits
  // them once.  Padded rows are zero
  for (int e = threadIdx.x; e < mw * 16 * D / 4; e += blockDim.x) {
    const int row = e / (D / 4), c = (e - row * (D / 4)) * 4;
    const int r = c_r0 + row;
    float* dst = qs + row * ld + c;
    if (r >= R) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* src = q + ((long long)(b * H + kvh * G + r % G) * S + q0 + r / G) * D + c;
    if (vec) {
      cp_async16(dst, src);
    } else {
      for (int i = 0; i < 4; ++i) cp_async4(dst + i, src + i);
    }
  }
  cp_async_commit();
  load_round(0, 0);
  cp_async_wait(1);
  __syncthreads();
  uint32_t qhi[ND][4], qlo[ND][4];
  {
    const float* qa = qs + (16 * wm + gid) * ld + tig;
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      split_tf32(qa[8 * ks], qhi[ks][0], qlo[ks][0]);
      split_tf32(qa[8 * ks + 8 * ld], qhi[ks][1], qlo[ks][1]);
      split_tf32(qa[8 * ks + 4], qhi[ks][2], qlo[ks][2]);
      split_tf32(qa[8 * ks + 8 * ld + 4], qhi[ks][3], qlo[ks][3]);
    }
  }

  // rows g and g + 8: running max and this thread's share of the sum;
  // acc[n][q]: row g + 8 * (q >> 1), column 8n + 2t + (q & 1)
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int r = 0; r < rounds; ++r) {
    const int st = stages == 2 ? (r & 1) : 0;
    if (stages == 2 && r + 1 < rounds) {
      load_round(r + 1, (r + 1) & 1);  // overlaps this round's math
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();
    if (r < cnt) {
      const float* ks = smem + st * stage_floats + run * 2 * tile;
      const float* vs = ks + tile;
      const int key_t = (t0 + r) * bkv;
      for (int c0 = part * span; c0 < (part + 1) * span; c0 += 8 * NK) {
        const int key0 = key_t + c0, key1 = key0 + 8 * NK - 1;
        if (causal && key0 > w_pos_hi) break;  // future for every row
        if (window > 0 && key1 < w_pos_lo - window + 1) continue;  // too old
        const bool edge = (causal && key1 > w_pos_lo) ||
                          (window > 0 && key0 <= w_pos_hi - window);

        // scores: sc[j][q] is row g + 8 * (q >> 1), key key0 + 8j + 2t + (q & 1).
        // Each 8-deep step's three products go to a t from zero, added to
        // sc in f32; the NK key tiles' chains are interleaved, as the mma
        // start in program order and a chain of three waits on each one
        float sc[NK][4] = {};
        const float* kr = ks + (c0 + gid) * ld + tig;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          uint32_t bb[NK][2], bs[NK][2];
          float t[NK][4] = {};
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            split_tf32(kr[8 * j * ld + 8 * d], bb[j][0], bs[j][0]);
            split_tf32(kr[8 * j * ld + 8 * d + 4], bb[j][1], bs[j][1]);
          }
#pragma unroll
          for (int j = 0; j < NK; ++j) mma_tf32(t[j], qlo[d], bb[j]);
#pragma unroll
          for (int j = 0; j < NK; ++j) mma_tf32(t[j], qhi[d], bs[j]);
#pragma unroll
          for (int j = 0; j < NK; ++j) mma_tf32(t[j], qhi[d], bb[j]);
#pragma unroll
          for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += t[j][e];
        }
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float s = sc[j][e] * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            if (edge) {
              const int kp = key0 + 8 * j + 2 * tig + (e & 1);
              const int qp = e < 2 ? pos_a : pos_b;
              bool keep = true;
              if (causal) keep = kp <= qp;
              if (window > 0) keep = keep && (qp - kp < window);
              if (!keep) s = kNegInf;
            }
            sc[j][e] = s;
          }
          mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          sc[j][0] = expf(sc[j][0] - mn_a);
          sc[j][1] = expf(sc[j][1] - mn_a);
          sc[j][2] = expf(sc[j][2] - mn_b);
          sc[j][3] = expf(sc[j][3] - mn_b);
          sum_a += sc[j][0] + sc[j][1];
          sum_b += sc[j][2] + sc[j][3];
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= al_a;
          acc[n][1] *= al_a;
          acc[n][2] *= al_b;
          acc[n][3] *= al_b;
        }

        // P.V: P's A fragment is (c0, c2, c1, c3) of the score fragment:
        // its k index t stands for key 2t and t + 4 for key 2t + 1, so V's
        // B fragment is read at kv rows 2t and 2t + 1
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          uint32_t phi[4], plo[4];
          split_tf32(sc[j][0], phi[0], plo[0]);
          split_tf32(sc[j][2], phi[1], plo[1]);
          split_tf32(sc[j][1], phi[2], plo[2]);
          split_tf32(sc[j][3], phi[3], plo[3]);
          const float* vr = vs + (c0 + 8 * j + 2 * tig) * ld + gid;
          // NG d tiles' chains interleaved at a time
          constexpr int NG = ND < 4 ? ND : 4;
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += NG) {
            uint32_t bb[NG][2], bs[NG][2];
            float t[NG][4] = {};
#pragma unroll
            for (int n = 0; n < NG; ++n) {
              split_tf32(vr[8 * (n0 + n)], bb[n][0], bs[n][0]);
              split_tf32(vr[ld + 8 * (n0 + n)], bb[n][1], bs[n][1]);
            }
#pragma unroll
            for (int n = 0; n < NG; ++n) mma_tf32(t[n], plo, bb[n]);
#pragma unroll
            for (int n = 0; n < NG; ++n) mma_tf32(t[n], phi, bs[n]);
#pragma unroll
            for (int n = 0; n < NG; ++n) mma_tf32(t[n], phi, bb[n]);
#pragma unroll
            for (int n = 0; n < NG; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[n0 + n][e] += t[n][e];
          }
        }
      }
    }
    __syncthreads();
    if (stages == 1 && r + 1 < rounds) load_round(r + 1, 0);
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  // each thread's rows: 1 / max(l, 1e-30) by one IEEE division, then
  // products, within an ulp of dividing each element (a division an
  // element calls the division subroutine for each, most of the stores'
  // time)
  if (ns == 1) {
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) store_rows(o, row_a, row_b, in_a, in_b, 8 * n + 2 * tig,
                                             acc[n], inv_a, inv_b);
    return;
  }

  // every split hands its partials to the others through shared memory
  // (the ring is free: the loop ended on a barrier); then the warps of an
  // m16 tile share its columns, 8 of them to each split in turn, and sum
  // each column's partials in split order
  float* partial = smem;                       // [ns][mw][16][ld]
  float* ml = smem + ns * mw * 16 * ld;        // [ns][mw][m 16, l 16]
  {
    float* pr = partial + (split * mw + wm) * 16 * ld + gid * ld + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(pr + 8 * n) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(pr + 8 * ld + 8 * n) = make_float2(acc[n][2], acc[n][3]);
    }
    if (tig == 0) {
      float* mls = ml + (split * mw + wm) * 32;
      mls[gid] = m_a;
      mls[gid + 8] = m_b;
      mls[16 + gid] = l_a;
      mls[24 + gid] = l_b;
    }
  }
  __syncthreads();
  float mt_a = kNegInf, mt_b = kNegInf;
  for (int s = 0; s < ns; ++s) {
    const float* mls = ml + (s * mw + wm) * 32;
    mt_a = fmaxf(mt_a, mls[gid]);
    mt_b = fmaxf(mt_b, mls[gid + 8]);
  }
  float sl_a = 0.f, sl_b = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* mls = ml + (s * mw + wm) * 32;
    sl_a += expf(mls[gid] - mt_a) * mls[16 + gid];
    sl_b += expf(mls[gid + 8] - mt_b) * mls[24 + gid];
  }
  const float inv_a = 1.f / fmaxf(sl_a, 1e-30f), inv_b = 1.f / fmaxf(sl_b, 1e-30f);
  for (int n = split; n < ND; n += ns) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) {
      const float* mls = ml + (s * mw + wm) * 32;
      const float w_a = expf(mls[gid] - mt_a), w_b = expf(mls[gid + 8] - mt_b);
      const float* pr = partial + (s * mw + wm) * 16 * ld + gid * ld + 8 * n + 2 * tig;
      const float2 pa = *reinterpret_cast<const float2*>(pr);
      const float2 pb = *reinterpret_cast<const float2*>(pr + 8 * ld);
      sum[0] += w_a * pa.x;
      sum[1] += w_a * pa.y;
      sum[2] += w_b * pb.x;
      sum[3] += w_b * pb.y;
    }
    store_rows(o, row_a, row_b, in_a, in_b, 8 * n + 2 * tig, sum, inv_a, inv_b);
  }
}

template <int NK, int ND>
int launch_tc(const float* q, const float* k, const float* v, float* o, int B,
              int H, int KVH, int S, int bq, int bkv, int groups, int mw,
              int tiles, int sub, int stages, int vec, float scale, int causal,
              int window, float softcap, int smem, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<NK, ND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const unsigned ctas = (unsigned)(S / bq) * B * KVH * groups;
  flash_attention_tc_kernel<NK, ND><<<ctas, 32 * mw * tiles * sub, smem, stream>>>(
      q, k, v, o, B, H, KVH, S, bq, bkv, groups, mw, tiles, sub, stages, vec,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, D) contiguous; k, v: (B, KVH, S, D) contiguous; f32.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KVH, int S, int D, int bq, int bkv,
                                     float scale, int causal, int window,
                                     float softcap, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * bq * D + (size_t)bkv * (D + 1) +
                       (size_t)bkv * D + (size_t)bq * bkv + 3 * (size_t)bq);
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  const dim3 grid(S / bq, B * H);
  flash_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KVH, S, D, bq,
      bkv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

// The tc variant with the plan of kernels/flash_attention.py
// (`launch_config`): `groups` CTAs a q block of `mw` m16 tiles each, kv
// tiles in `tiles` runs of `sub` parts (the kv splits), `stages` (1 or 2),
// kv steps of `kv_step` (8, 16 or 32) keys, D 8, 16, 32 or 64, 16-byte
// copies when `vec`;
// q, o: (B, H, S, D), k, v: (B, KVH, S, D), contiguous f32.
extern "C" int repro_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int S, int D, int bq, int bkv, int groups, int mw, int tiles,
    int sub, int stages, int kv_step, int vec, float scale, int causal,
    int window, float softcap, int smem, void* stream) {
  if (bkv % (sub * kv_step) || mw * tiles * sub > kTcMaxWarps || stages < 1 ||
      stages > 2 || S % bq || S % bkv)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto nk, auto nd) {
    return launch_tc<decltype(nk)::value, decltype(nd)::value>(
        qf, kf, vf, of, B, H, KVH, S, bq, bkv, groups, mw, tiles, sub, stages,
        vec, scale, causal, window, softcap, smem, st);
  };
  auto by_d = [&](auto nk) {
    switch (D) {
      case 8: return launch(nk, std::integral_constant<int, 1>());
      case 16: return launch(nk, std::integral_constant<int, 2>());
      case 32: return launch(nk, std::integral_constant<int, 4>());
      case 64: return launch(nk, std::integral_constant<int, 8>());
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (kv_step) {
    case 8: return by_d(std::integral_constant<int, 1>());
    case 16: return by_d(std::integral_constant<int, 2>());
    case 32: return by_d(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}
