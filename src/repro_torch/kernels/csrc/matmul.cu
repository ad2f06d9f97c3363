// K1 (matmul) and K2 (batch_matmul): a tiled f32 matrix product whose tile
// (bm, bn, bk) is a runtime argument, so the tile the search sampled is the
// tile that runs.
//
// Replaces the Pallas kernels in src/repro/kernels/matmul.py (`matmul`,
// `batch_matmul`).  There the sequential k grid axis carried an f32 VMEM
// accumulator; here one CTA owns one bm x bn output tile and loops over K in
// steps of bk, staging x[bm, bk] and w[bk, bn] in dynamic shared memory and
// keeping the accumulators in registers (T x T outputs per thread).  The
// epilogue (bias, relu, exact gelu, silu, softcap) runs once after the last
// k step.  blockIdx.z is the batch for K2.
//
// Bound on an H100: at the smollm-135m shapes (M = 256, K <= 1536) the
// product does 2*M*N*K f32 FMAs-as-flops against the card's 67 TFLOP/s
// non-tensor-core f32 peak, and moves each operand once; it is bound by
// operations.  This first version uses plain FMAs from shared memory (no
// tensor cores, no TMA, no pipelining); it is meant to be right and to follow
// the sampled tile, not to be fast.
//
// Every operand is read through explicit strides, so the tied unembed reads
// the (vocab, d) table as a transposed (d, vocab) operand without a copy.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_SOFTCAP = 4 };

__device__ __forceinline__ float apply_act(float v, int act, float softcap) {
  switch (act) {
    case ACT_RELU:
      return v > 0.f ? v : 0.f;
    case ACT_GELU:
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
    case ACT_SILU:
      return v / (1.f + expf(-v));
    case ACT_SOFTCAP:
      return softcap * tanhf(v / softcap);
    default:
      return v;
  }
}

// One CTA computes y[b, m0:m0+bm, n0:n0+bn].  Thread (ty, tx) owns rows
// ty + i*TY and columns tx + j*TX (i, j < T): neighbouring threads own
// neighbouring columns, so shared-memory reads of the w tile and the final
// global stores are contiguous across a warp.
// T = 8 keeps 64 accumulators a thread; bounding its CTA at 512 threads lets
// the compiler keep them all in registers (<= 128 a thread).
template <int T>
__global__ void __launch_bounds__(T >= 8 ? 512 : 1024) matmul_tile_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y,
    int K, int bm, int bn, int bk,
    long long sxb, long long sxm, long long sxk,
    long long swb, long long swk, long long swn,
    long long syb, long long sym,
    int act, float softcap) {
  extern __shared__ float smem[];
  float* xs = smem;            // [bm][bk]
  float* ws = smem + bm * bk;  // [bk][bn]

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  const int TX = (bn + T - 1) / T;
  const int TY = (bm + T - 1) / T;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const float* xb = x + (long long)b * sxb + (long long)m0 * sxm;
  const float* wb = w + (long long)b * swb + (long long)n0 * swn;

  float acc[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    // stage the tiles; walk the unit-stride axis fastest so global reads
    // coalesce whichever way the operand is laid out
    if (sxk == 1) {
      for (int e = threadIdx.x; e < bm * bk; e += blockDim.x) {
        const int r = e / bk, c = e - r * bk;
        xs[e] = xb[(long long)r * sxm + (k0 + c)];
      }
    } else {
      for (int e = threadIdx.x; e < bm * bk; e += blockDim.x) {
        const int c = e / bm, r = e - c * bm;
        xs[r * bk + c] = xb[(long long)r * sxm + (long long)(k0 + c) * sxk];
      }
    }
    if (swn == 1) {
      for (int e = threadIdx.x; e < bk * bn; e += blockDim.x) {
        const int r = e / bn, c = e - r * bn;
        ws[e] = wb[(long long)(k0 + r) * swk + c];
      }
    } else {
      for (int e = threadIdx.x; e < bk * bn; e += blockDim.x) {
        const int c = e / bk, r = e - c * bk;
        ws[r * bn + c] = wb[(long long)(k0 + r) * swk + (long long)c * swn];
      }
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[T], bv[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int r = ty + i * TY;
        a[i] = r < bm ? xs[r * bk + kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int c = tx + j * TX;
        bv[j] = c < bn ? ws[kk * bn + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* yb = y + (long long)b * syb + (long long)m0 * sym + n0;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int r = ty + i * TY;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int c = tx + j * TX;
      if (c >= bn) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n0 + c];
      yb[(long long)r * sym + c] = apply_act(v, act, softcap);
    }
  }
}

template <int T>
int launch_tile(const float* x, const float* w, const float* bias, float* y,
                int B, int M, int N, int K, int bm, int bn, int bk,
                long long sxb, long long sxm, long long sxk,
                long long swb, long long swk, long long swn,
                long long syb, long long sym,
                int act, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)bm * bk + (size_t)bk * bn);
  const int threads = ((bm + T - 1) / T) * ((bn + T - 1) / T);
  const dim3 grid(N / bn, M / bm, B);
  // above 48 KB dynamic shared memory must be opted into, once per size
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  matmul_tile_kernel<T><<<grid, threads, smem, stream>>>(
      x, w, bias, y, K, bm, bn, bk, sxb, sxm, sxk, swb, swk, swn, syb, sym,
      act, softcap);
  return (int)cudaGetLastError();
}

int launch(const float* x, const float* w, const float* bias, float* y,
           int B, int M, int N, int K, int bm, int bn, int bk,
           long long sxb, long long sxm, long long sxk,
           long long swb, long long swk, long long swn,
           long long syb, long long sym,
           int act, float softcap, int micro, cudaStream_t stream) {
#define REPRO_MM_CASE(TT)                                                  \
  case TT:                                                                 \
    return launch_tile<TT>(x, w, bias, y, B, M, N, K, bm, bn, bk, sxb, sxm, \
                           sxk, swb, swk, swn, syb, sym, act, softcap,     \
                           stream);
  switch (micro) {
    REPRO_MM_CASE(1)
    REPRO_MM_CASE(2)
    REPRO_MM_CASE(4)
    REPRO_MM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MM_CASE
}

}  // namespace

// y (M, N) contiguous = act(x @ w + bias); x and w strided, bias (N,) or null.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            void* y, int M, int N, int K, int bm, int bn,
                            int bk, long long sxm, long long sxk,
                            long long swk, long long swn, int act,
                            float softcap, int micro, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<float*>(y), 1, M,
                N, K, bm, bn, bk, 0, sxm, sxk, 0, swk, swn, 0, N, act, softcap,
                micro, static_cast<cudaStream_t>(stream));
}

// y (B, M, N) contiguous; y[b] = x[b] @ w[b]; x and w strided.
extern "C" int repro_batch_matmul(const void* x, const void* w, void* y,
                                  int B, int M, int N, int K, int bm, int bn,
                                  int bk, long long sxb, long long sxm,
                                  long long sxk, long long swb, long long swk,
                                  long long swn, int micro, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                nullptr, static_cast<float*>(y), B, M, N, K, bm, bn, bk, sxb,
                sxm, sxk, swb, swk, swn, (long long)M * N, N, ACT_NONE, 0.f,
                micro, static_cast<cudaStream_t>(stream));
}
