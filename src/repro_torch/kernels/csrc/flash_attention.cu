// K3: online-softmax prefill attention with runtime (block_q, block_kv).
//
// Replaces the Pallas kernel in src/repro/kernels/flash_attention.py
// (`flash_attention`).  There the kv grid axis was sequential and the
// running (m, l, acc) statistics lived in VMEM scratch; here one CTA owns one
// (batch*head, block of bq query rows) and loops over the kv blocks itself,
// keeping m, l and acc in shared memory.  The GQA index map (q head h reads kv
// head h // G) becomes an offset computed from blockIdx.  Scores are scaled
// by `scale`, soft-capped (cap * tanh(s / cap)) before the causal / sliding
// window mask, masked to -1e30, and the output divides by max(l, 1e-30) —
// the reference's numerics exactly.  A kv block that every row of the tile
// masks out is skipped; the running statistics are unchanged by it.
//
// Bound on an H100: at the smollm-135m prefill shape (B=1, H=9, S=256,
// D=64) the work is 4*B*H*S*S*D flops (halved by the causal skip) on
// 1.6 MB of q/k/v/o, so it is bound by operations against the card's
// 67 TFLOP/s non-tensor-core f32 peak.  This first version computes the
// score and value products with plain FMAs out of shared memory; its K tile
// is padded to D+1 floats a row so the score loop reads it without bank
// conflicts.  Tensor cores (wgmma) and TMA come later.

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
