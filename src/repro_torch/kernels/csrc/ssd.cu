// K7 (ssd): the Mamba-2 chunked SSD scan (state-space duality), computed in
// f32 with an (N, P) f32 state carried across the chunks of a sequence.
//
// Replaces the Pallas kernel `ssd` in src/repro/kernels/ssd.py.  There the
// grid was (batch * H, chunks) with the chunk axis "arbitrary": the TPU ran
// the chunks of one (batch, head) in order and carried the state in a VMEM
// scratch.  Blocks of a CUDA grid run in no order, so here one CTA owns one
// (batch, head) pair and loops over its chunks itself, with the state in
// shared memory.  Per chunk of L steps it stages x (L x P), B (transposed,
// N x L) and C (L x N) as f32 and cum = cumsum(log_a) (L), then:
//   G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j, else 0
//             (the branch is taken before expf: above the diagonal
//             cum_i - cum_j > 0 may overflow, and inf * 0 would be NaN);
//   y_i     = sum_{j <= i} G[i][j] x_j + exp(cum_i) (C_i . h)   (stored);
//   h       = exp(cum_{L-1}) h + sum_j exp(cum_{L-1} - cum_j) B_j x_j^T,
//             after a barrier, with the decay folded into B first.
// After the last chunk the state is written out when the caller asks for it
// (the prefill -> decode handoff).  The chunk length is a runtime argument,
// so a 48-token prompt (chunk 48) runs as it is.  x is read through its
// strides (no transposed copy); log_a, B and C are contiguous.  x, B and C
// are f32 or bf16 (all three the same); y is stored in that type.
//
// Bound on an H100: at mamba2-370m's forward shape (batch 1, S 256, H 32,
// P 64, N 128, chunk 64) the four contractions of a chunk are 3.67 MFLOP per
// (batch, head), 470 MFLOP a launch: 7.0 us at 67 TFLOP/s (f32 outside the
// tensor cores), against about 1 us for its 3.3 MB at 3.35 TB/s, so it is
// bound by operations.  This first version is plain: one output element per
// thread iteration with conflict-free shared-memory reads (the lane-varying
// operand contiguous, the other a broadcast), no register tiling, no tensor
// cores, C.B^T recomputed by every head, and only batch * H CTAs (32 on 132
// SMs at the main shape).  wgmma tiles and a head-parallel split come in a
// later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void ssd_kernel(const T* __restrict__ x, long long sx0, long long sx1,
                           long long sx2, long long sx3,
                           const float* __restrict__ log_a,
                           const T* __restrict__ Bm, const T* __restrict__ Cm,
                           T* __restrict__ y, float* __restrict__ state_out,
                           int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  float* xs = smem;         // L x P
  float* bt = xs + L * P;   // N x L: B transposed, later scaled by the decay
  float* cs = bt + N * L;   // L x N
  float* g = cs + L * N;    // L x L: the decay-masked C.B^T
  float* h = g + L * L;     // N x P: the state
  float* cum = h + N * P;   // L

  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* xb = x + bb * sx0 + hh * sx2;

  for (int e = tid; e < N * P; e += nt) h[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    for (int e = tid; e < L * P; e += nt) {
      const int j = e / P, p = e % P;
      xs[e] = to_f32(xb[(c0 + j) * sx1 + p * sx3]);
    }
    const size_t bc = ((size_t)bb * S + c0) * N;
    for (int e = tid; e < L * N; e += nt) {
      const int j = e / N, n = e % N;
      bt[n * L + j] = to_f32(Bm[bc + e]);
      cs[e] = to_f32(Cm[bc + e]);
    }
    if (tid == 0) {
      const float* la = log_a + ((size_t)bb * S + c0) * H + hh;
      float s = 0.f;
      for (int j = 0; j < L; ++j) {
        s += la[(size_t)j * H];
        cum[j] = s;
      }
    }
    __syncthreads();

    for (int e = tid; e < L * L; e += nt) {
      const int i = e / L, j = e % L;
      float v = 0.f;
      if (i >= j) {
        float d = 0.f;
        for (int n = 0; n < N; ++n) d += cs[i * N + n] * bt[n * L + j];
        v = d * expf(cum[i] - cum[j]);
      }
      g[e] = v;
    }
    __syncthreads();

    for (int e = tid; e < L * P; e += nt) {
      const int i = e / P, p = e % P;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra += g[i * L + j] * xs[j * P + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += cs[i * N + n] * h[n * P + p];
      store(y + (((size_t)bb * S + c0 + i) * H + hh) * P + p,
            intra + expf(cum[i]) * inter);
    }
    __syncthreads();  // every read of the old state is done

    const float total = cum[L - 1];
    for (int e = tid; e < N * L; e += nt) bt[e] *= expf(total - cum[e % L]);
    __syncthreads();

    const float keep = expf(total);
    for (int e = tid; e < N * P; e += nt) {
      const int n = e / P, p = e % P;
      float a = 0.f;
      for (int j = 0; j < L; ++j) a += bt[n * L + j] * xs[j * P + p];
      h[e] = keep * h[e] + a;
    }
    __syncthreads();  // the next chunk's staging overwrites xs and bt
  }

  if (state_out != nullptr) {
    for (int e = tid; e < N * P; e += nt) state_out[(size_t)bh * N * P + e] = h[e];
  }
}

template <typename T>
int launch(const void* x, const long long* xs, const float* log_a, const void* Bm,
           const void* Cm, void* y, float* state, int batch, int S, int H, int P,
           int N, int L, int threads, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)L * P + 2 * (size_t)L * N + (size_t)L * L +
                       (size_t)N * P + L);
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  ssd_kernel<T><<<batch * H, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), xs[0], xs[1], xs[2], xs[3], log_a,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      state, S, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, S, H, P) with element strides x_strides[4]; log_a: (batch, S, H)
// f32; B, C: (batch, S, N); y: (batch, S, H, P) contiguous; state: (batch, H,
// N, P) f32 or null.  dtype 0 = f32, 1 = bf16 for x, B, C and y.  L divides S.
extern "C" int repro_ssd(const void* x, const long long* x_strides,
                         const void* log_a, const void* Bm, const void* Cm,
                         void* y, void* state, int batch, int S, int H, int P,
                         int N, int L, int threads, int dtype, void* stream) {
  const float* la = static_cast<const float*>(log_a);
  float* st = static_cast<float*>(state);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, x_strides, la, Bm, Cm, y, st, batch, S, H, P,
                                 N, L, threads, stream);
  return launch<float>(x, x_strides, la, Bm, Cm, y, st, batch, S, H, P, N, L,
                       threads, stream);
}
