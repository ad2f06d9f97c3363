// K4 (row_softmax): a numerically stable softmax over the last axis of an
// (M, N) matrix, computed in f32 and stored in the input's type (f32 or
// bf16), with a runtime row block `bm`.
//
// Replaces the Pallas kernel `row_softmax` in src/repro/kernels/softmax.py.
// There one grid step held a (bm, N) block of rows in VMEM and fused the
// max / exp / sum / divide chain of the four-block `sfm` program into one
// pass.  Here one CTA owns one block of bm rows (grid M / bm): its threads
// copy the block into dynamic shared memory as f32 (bm * N * 4 bytes, opted
// in above 48 KB), then each warp takes one row at a time: a strided max
// over the row and a warp-shuffle reduction, exp(x - max) written back in
// place with its sum, a second warp-shuffle reduction, and e / sum stored.
// The tuned row block is a runtime argument, so non-power-of-two blocks
// (36, 72, 144 at M = 2304) run as sampled.
//
// Bound on an H100: at the smollm-135m attention shape (M = 2304, N = 256,
// f32) the call reads 2.36 MB and writes 2.36 MB and does about 5 operations
// an element, so it is bound by bytes (1.41 us at 3.35 TB/s).  This first
// version reads and writes each element once (coalesced across a warp) but
// stages every row through shared memory and keeps at most 8 warps a CTA; a
// block of bm rows as one CTA leaves few CTAs per SM at large bm.  Register
// -resident rows and vectorised loads come in a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void row_softmax_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   int N, int bm) {
  extern __shared__ float rows[];  // bm x N, f32
  const size_t base = (size_t)blockIdx.x * bm * N;
  const int total = bm * N;
  for (int e = threadIdx.x; e < total; e += blockDim.x) rows[e] = to_f32(x[base + e]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < bm; r += nwarps) {
    float* row = rows + (size_t)r * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    T* out = y + base + (size_t)r * N;
    for (int j = lane; j < N; j += 32) store(out + j, row[j] / s);
  }
}

template <typename T>
int launch(const void* x, void* y, int M, int N, int bm, int threads,
           void* stream) {
  const size_t smem = sizeof(float) * (size_t)bm * N;
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        row_softmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  row_softmax_kernel<T><<<M / bm, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (M, N) contiguous, dtype 0 = f32, 1 = bf16; bm divides M.
extern "C" int repro_row_softmax(const void* x, void* y, int M, int N, int bm,
                                 int threads, int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, M, N, bm, threads, stream);
  return launch<float>(x, y, M, N, bm, threads, stream);
}
