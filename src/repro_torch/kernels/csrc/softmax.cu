// K4 (row_softmax): a numerically stable softmax over the last axis of an
// (M, N) matrix, computed in f32 and stored in the input's type (f32 or
// bf16), with a runtime row block `bm`.
//
// Replaces the Pallas kernel `row_softmax` in src/repro/kernels/softmax.py.
// There one grid step held a (bm, N) block of rows in VMEM and fused the
// max / exp / sum / divide chain of the four-block `sfm` program into one
// pass.  Here one CTA owns one block of bm rows (grid M / bm), so the tuned
// row block is the block that runs, and one of two variants, chosen in
// Python (kernels/softmax.py, `variant`) from N alone, computes its rows:
//
// * `registers` (N % 4 == 0, N <= 1024; every N the main path has): a row
//   lives in one warp's registers.  32 * min(bm, 32) threads; warp w takes
//   rows w, w + warps, ...  A lane holds V groups of 4 values (V = 2 at
//   N = 256) and issues all its loads, 16 bytes each in f32 (8 in bf16),
//   before any math; then the max by warp shuffles, exp(x - max) in
//   registers, the sum by warp shuffles, and e / sum stored with 16-byte
//   (8-byte) stores.  No shared memory and no __syncthreads, so bm is not
//   limited by shared memory.  4-byte loads where a base is not aligned,
//   with the same values in the same lanes, so the same bits.
// * `shared` (any other N): the first version of this kernel.  The CTA
//   copies its block into dynamic shared memory as f32 (4 * bm * N bytes,
//   opted in above 48 KB, so bm is limited by it), then each of at most 8
//   warps takes one row at a time with strided passes and warp-shuffle
//   reductions.
//
// Both divide (e / sum) as the plain version and the Pallas kernel do.
// Bound on an H100: at the smollm-135m attention shape (M = 2304, N = 256,
// f32) the call reads 2.36 MB and writes 2.36 MB and does about 5
// operations an element, so it is bound by bytes (1.41 us at 3.35 TB/s);
// at that size one launch (a few us) is the floor in practice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// four consecutive values as f32: one 16-byte (f32) or 8-byte (bf16) load
// when vec, else four element loads
__device__ __forceinline__ void load4(const float* p, bool vec, float (&v)[4]) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec, float (&v)[4]) {
  if (vec) {
    // a bf16 is the high half of the f32 with the same value
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(p[k]);
  }
}

__device__ __forceinline__ void store4(float* p, bool vec, const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, bool vec, const float (&v)[4]) {
  if (vec) {
    uint32_t h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __bfloat16_as_ushort(__float2bfloat16(v[k]));
    *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __float2bfloat16(v[k]);
  }
}

// registers: lane `lane` of a warp holds the row's 4-value groups
// lane, lane + 32, ..., V of them (groups past N / 4 hold -inf and are not
// stored).
template <typename T, int V>
__global__ void __launch_bounds__(1024) row_softmax_regs_kernel(
    const T* __restrict__ x, T* __restrict__ y, int N, int bm, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, groups = N >> 2;
  for (int r = warp; r < bm; r += warps) {
    const size_t row = ((size_t)blockIdx.x * bm + r) * N;
    float v[V][4];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int g = i * 32 + lane;
      if (g < groups) {
        load4(x + row + 4 * g, vec, v[i]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[i][k] = -INFINITY;
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) m = fmaxf(m, v[i][k]);
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i][k] = expf(v[i][k] - m);
        s += v[i][k];
      }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int g = i * 32 + lane;
      if (g < groups) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = v[i][k] / s;
        store4(y + row + 4 * g, vec, o);
      }
    }
  }
}

template <typename T>
__global__ void row_softmax_shared_kernel(const T* __restrict__ x,
                                          T* __restrict__ y, int N, int bm) {
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
int launch_shared(const void* x, void* y, int M, int N, int bm, int threads,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)bm * N;
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        row_softmax_shared_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  row_softmax_shared_kernel<T><<<M / bm, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N, bm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_regs(const void* x, void* y, int M, int N, int bm, int threads,
                int groups, cudaStream_t stream) {
  // every row starts a multiple of 4 values in, so aligned bases keep every
  // 4-value group aligned
  const uintptr_t align = 4 * sizeof(T) - 1;
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
                   align) == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define REPRO_REGS_CASE(VV)                                                \
  if (groups == VV) {                                                      \
    row_softmax_regs_kernel<T, VV><<<M / bm, threads, 0, stream>>>(        \
        xt, yt, N, bm, vec);                                               \
    return (int)cudaGetLastError();                                        \
  }
  REPRO_REGS_CASE(1)
  REPRO_REGS_CASE(2)
  REPRO_REGS_CASE(4)
  REPRO_REGS_CASE(8)
#undef REPRO_REGS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (M, N) contiguous, dtype 0 = f32, 1 = bf16; bm divides M.
// groups: the 4-value groups a lane holds (1, 2, 4 or 8) for the registers
// variant, 0 for the shared-memory one.
extern "C" int repro_row_softmax(const void* x, void* y, int M, int N, int bm,
                                 int threads, int dtype, int groups,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups > 0) {
    if (N % 4 != 0 || N > 32 * 4 * groups) return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return launch_regs<__nv_bfloat16>(x, y, M, N, bm, threads, groups, st);
    return launch_regs<float>(x, y, M, N, bm, threads, groups, st);
  }
  if (dtype == 1)
    return launch_shared<__nv_bfloat16>(x, y, M, N, bm, threads, st);
  return launch_shared<float>(x, y, M, N, bm, threads, st);
}
