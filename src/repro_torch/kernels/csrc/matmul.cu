// K1 (matmul) and K2 (batch_matmul): f32 matrix products whose tile
// (bm, bn, bk) is a runtime argument, so the tile the search sampled is the
// tile that runs.
//
// Replaces the Pallas kernels in src/repro/kernels/matmul.py (`matmul`,
// `batch_matmul`).  There the sequential k grid axis carried an f32 VMEM
// accumulator, and K2's batch was one more parallel grid axis.  Here both
// products share three kernels, each with a batch axis (K1 is batch 1,
// batch stride 0), and one rule picks the variant (kernels/matmul.py,
// `variant`) from M and the tile alone:
//
// * `splitk` (M < 16, every decode task): bound by bytes.  Each weight
//   byte is used M times, far below the ~20 FLOP/byte at which f32 FMAs
//   would be the limit, so what matters is keeping HBM busy.  The grid is
//   (N/bn, B*M/bm, K/bk): grid y is batch-major over the row tiles, and
//   every CTA reduces one bk slice of K, so the tuned bk sets the split and
//   small shapes still fill the 132 SMs.  A CTA stages x's (bm, bk) slice
//   in shared memory and streams w's (bk, bn) slice once from global
//   memory, with 16-byte loads along w's unit-stride axis where alignment
//   allows (n for the projections, k for the tied unembed), then reduces
//   in the warp (shuffles) and across warps (shared memory) in a fixed
//   order.  With K/bk > 1 the CTAs write f32 partials to a (K/bk, B, M, N)
//   scratch the wrapper allocates; the last CTA of an output tile to
//   arrive (a per-tile counter, reset by that CTA) sums the partials in
//   split order and applies bias and epilogue once: one launch, the same
//   bits every run.
// * `tc` (M >= 16, bm % 16 == 0, bn % 8 == 0, bk % 8 == 0, the forward and
//   prefill tiles): bound by operations.  Tensor cores through
//   `mma.sync.m16n8k8` on TF32 with the 3xTF32 split (a = big + small, big
//   and small both TF32; big*big + big*small + small*big in f32), which keeps
//   f32 accuracy where one TF32 pass keeps ~3 digits.  The tensor cores'
//   accumulator truncates, so each 8-deep step is summed from zero and
//   added to an f32 accumulator: summing all of K in the tensor cores gave
//   errors 20x the plain f32 product's at K = 576 on an H100.  x and w tiles are
//   staged with `cp.async` (16-byte copies where the unit-stride axis and
//   the alignment of every batch's base allow, 4-byte otherwise), in two
//   stages when two fit in shared memory, each operand in its own layout
//   with rows padded so the fragment loads do not conflict on banks.  Each
//   warp owns WM x WN m16n8 fragments; bias and activation are applied
//   from the accumulator registers.  blockIdx.z is the batch.  No wgmma,
//   TMA or persistent schedule yet.
// * `fma` (every other tile, e.g. bk = 36 or bm = 24): one CTA owns one
//   bm x bn output tile and loops over K in steps of bk, staging x[bm, bk]
//   and w[bk, bn] in dynamic shared memory, T x T f32 accumulators a
//   thread, plain FMAs (67 TFLOP/s at most), no pipelining.  blockIdx.z is
//   the batch.
//
// The epilogue (bias, relu, exact gelu, silu, softcap) runs once per
// output.  Every operand is read through explicit strides, so the tied
// unembed reads the (vocab, d) table as a transposed (d, vocab) operand
// without a copy.  y is (B, M, N) contiguous.  Tiles divide the problem
// (the wrapper rejects others), so no variant has a ragged edge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// splitk: M < 16, bound by bytes
// ---------------------------------------------------------------------------

constexpr int SPLITK_WARPS = 4;

// Sum v over the lanes whose ids differ in the bits from..to-1 (powers of
// two): an xor butterfly, the same order on every run.
__device__ __forceinline__ float warp_sum(float v, int from, int to) {
  for (int off = from; off < to; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One CTA reduces x[b, m0:m0+bm, k0:k0+bk] @ w[b, k0:k0+bk, n0:n0+bn],
// blockIdx.y = b * (M / bm) + m0 / bm, k0 = blockIdx.z * bk.  MR >= bm rows
// of accumulators; V = 4 reads w 16 bytes at a time along its unit-stride
// axis, V = 1 one float through both strides.
// KMAJ: w's unit stride is along k (the transposed unembed).
//   !KMAJ: a warp's lanes are C column vectors x G k-lanes, warps split k;
//          each output is summed over the G lanes (shuffles), then over the
//          warps (shared memory, in warp order).
//   KMAJ:  a warp's lanes are G <= 8 k-vectors x C columns, warps split n;
//          each output is summed over the G lanes (shuffles).
// Then either y = act(sum + bias) (one split), or the sum goes to
// part[split, b] and the last CTA of the output tile sums part[0..splits, b]
// in order and writes y[b].
template <int MR, int V, bool KMAJ>
__global__ void __launch_bounds__(SPLITK_WARPS * 32) matmul_splitk_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y,
    float* __restrict__ part, int* __restrict__ counters,
    int B, int M, int N, int bm, int bn, int bk,
    long long sxb, long long sxm, long long sxk,
    long long swb, long long swk, long long swn,
    int act, float softcap) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [bm][bk]
  float* red = smem + bm * bk;  // [SPLITK_WARPS][bm][bn]
  __shared__ int last_cta;

  // y and part hold B * M rows of N, so the output's first row is
  // blockIdx.y * bm; only x and w need the batch itself
  const int tiles_m = M / bm;
  const int b = B > 1 ? blockIdx.y / tiles_m : 0;
  const int n0 = blockIdx.x * bn, m0 = (blockIdx.y - b * tiles_m) * bm;
  const long long row0 = (long long)blockIdx.y * bm, rows = (long long)gridDim.y * bm;
  const int split = blockIdx.z, splits = gridDim.z;
  const long long k0 = (long long)split * bk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < bm * bk; e += blockDim.x) {
    const int r = e / bk, c = e - r * bk;
    xs[e] = x[b * sxb + (m0 + r) * sxm + (k0 + c) * sxk];
  }
  __syncthreads();

  int slots;  // partial sums of each output in `red`
  if (!KMAJ) {
    const int U = bn / V;  // column vectors of the tile
    int C = 1;
    while (C < U && C < 32) C <<= 1;
    const int G = 32 / C, KL = G * SPLITK_WARPS;
    const int c = lane % C, kl = lane / C + G * warp;
    for (int u0 = 0; u0 < U; u0 += C) {
      const int u = u0 + c;
      float acc[MR][V];
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
      if (u < U) {
        const float* wp = w + b * swb + k0 * swk + (long long)(n0 + u * V) * swn;
#pragma unroll 4
        for (int k = kl; k < bk; k += KL) {
          float wv[V];
          if constexpr (V == 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(wp + k * swk));
            wv[0] = t.x;
            wv[1] = t.y;
            wv[2] = t.z;
            wv[3] = t.w;
          } else {
            wv[0] = __ldg(wp + k * swk);
          }
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            if (m < bm) {
              const float xv = xs[m * bk + k];
#pragma unroll
              for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xv, wv[v], acc[m][v]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = warp_sum(acc[m][v], C, 32);
      if (lane < C && u < U) {
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < bm)
#pragma unroll
            for (int v = 0; v < V; ++v)
              red[(warp * bm + m) * bn + u * V + v] = acc[m][v];
      }
    }
    slots = SPLITK_WARPS;
  } else {
    // at most 8 lanes a column (128 contiguous bytes), so each lane has
    // several independent loads in flight and one shuffle serves 4+ columns
    const int U = bk / V;  // k vectors of a column
    int G = 1;
    while (G < U && G < 8) G <<= 1;
    const int C = 32 / G;
    const int g = lane % G, c = lane / G;
    for (int nb = warp * C; nb < bn; nb += SPLITK_WARPS * C) {
      const int n = nb + c;
      float acc[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] = 0.f;
      if (n < bn) {
        const float* wp = w + b * swb + (long long)(n0 + n) * swn + k0 * swk;
#pragma unroll 4
        for (int kv = g; kv < U; kv += G) {
          if constexpr (V == 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(wp + kv * 4));
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              if (m < bm) {
                const float4 xv = *reinterpret_cast<const float4*>(xs + m * bk + kv * 4);
                float a = acc[m];
                a = fmaf(xv.x, t.x, a);
                a = fmaf(xv.y, t.y, a);
                a = fmaf(xv.z, t.z, a);
                acc[m] = fmaf(xv.w, t.w, a);
              }
            }
          } else {
            const float t = __ldg(wp + kv * swk);
#pragma unroll
            for (int m = 0; m < MR; ++m)
              if (m < bm) acc[m] = fmaf(xs[m * bk + kv], t, acc[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] = warp_sum(acc[m], 1, G);
      if (g == 0 && n < bn) {
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < bm) red[m * bn + n] = acc[m];
      }
    }
    slots = 1;
  }
  __syncthreads();

  for (int e = tid; e < bm * bn; e += blockDim.x) {
    const int m = e / bn, n = e - m * bn;
    float v = red[m * bn + n];
    for (int s = 1; s < slots; ++s) v += red[(s * bm + m) * bn + n];
    if (splits == 1) {
      if (bias != nullptr) v += bias[n0 + n];
      y[(row0 + m) * N + n0 + n] = apply_act(v, act, softcap);
    } else {
      part[((long long)split * rows + row0 + m) * N + n0 + n] = v;
    }
  }
  if (splits == 1) return;

  // the last CTA of this output tile to arrive sums the splits in order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_cta = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  for (int e = tid; e < bm * bn; e += blockDim.x) {
    const int m = e / bn, n = e - m * bn;
    const float* p = part + (row0 + m) * N + n0 + n;
    float v = __ldcg(p);
    for (int s = 1; s < splits; ++s) v += __ldcg(p + s * rows * N);
    if (bias != nullptr) v += bias[n0 + n];
    y[(row0 + m) * N + n0 + n] = apply_act(v, act, softcap);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

template <int MR, int V, bool KMAJ>
int launch_splitk_t(const float* x, const float* w, const float* bias, float* y,
                    float* part, int* counters, int B, int M, int N, int K,
                    int bm, int bn, int bk, long long sxb, long long sxm,
                    long long sxk, long long swb, long long swk, long long swn,
                    int act, float softcap, size_t smem, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_splitk_kernel<MR, V, KMAJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  const dim3 grid(N / bn, B * (M / bm), K / bk);
  matmul_splitk_kernel<MR, V, KMAJ><<<grid, SPLITK_WARPS * 32, smem, stream>>>(
      x, w, bias, y, part, counters, B, M, N, bm, bn, bk, sxb, sxm, sxk, swb,
      swk, swn, act, softcap);
  return (int)cudaGetLastError();
}

template <int MR>
int launch_splitk_mr(const float* x, const float* w, const float* bias,
                     float* y, float* part, int* counters, int B, int M, int N,
                     int K, int bm, int bn, int bk, long long sxb,
                     long long sxm, long long sxk, long long swb, long long swk,
                     long long swn, int act, float softcap, size_t smem,
                     cudaStream_t stream) {
  const bool kmaj = swk == 1 && swn != 1;
  // every batch's base stays 16-byte aligned too
  const bool vec = aligned16(w) && swb % 4 == 0 &&
                   (kmaj ? (bk % 4 == 0 && swn % 4 == 0)
                         : (swn == 1 && bn % 4 == 0 && swk % 4 == 0));
#define REPRO_SPLITK(VV, KM)                                                  \
  return launch_splitk_t<MR, VV, KM>(x, w, bias, y, part, counters, B, M, N, \
                                     K, bm, bn, bk, sxb, sxm, sxk, swb, swk,  \
                                     swn, act, softcap, smem, stream);
  if (kmaj) {
    if (vec) REPRO_SPLITK(4, true)
    REPRO_SPLITK(1, true)
  }
  if (vec) REPRO_SPLITK(4, false)
  REPRO_SPLITK(1, false)
#undef REPRO_SPLITK
}

// ---------------------------------------------------------------------------
// tc: M >= 16, bound by operations; 3xTF32 on mma.sync, cp.async staging
// ---------------------------------------------------------------------------

constexpr int TC_MAX_WARPS = 16;

// split_tf32, mma_tf32 and the cp.async helpers: tf32_mma.cuh.

// Start copying an R x C tile, element (r, c) at g[r*gr + c*gc], to shared
// memory s[r*sp + c].  vec: gc == 1, C % 4 == 0 and every row 16-byte
// aligned, so a thread copies four floats at a time; otherwise one, the
// unit-stride axis (if any) fastest across threads.
__device__ __forceinline__ void load_tile_async(float* s, const float* g, int R,
                                                int C, long long gr,
                                                long long gc, int sp,
                                                bool vec) {
  if (vec) {
    const int cv = C >> 2;
    for (int e = threadIdx.x; e < R * cv; e += blockDim.x) {
      const int r = e / cv, c = (e - r * cv) << 2;
      cp_async16(s + r * sp + c, g + r * gr + c);
    }
  } else if (gc == 1) {
    for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C;
      cp_async4(s + r * sp + c, g + r * gr + c);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
      const int c = e / R, r = e - c * R;
      cp_async4(s + r * sp + c, g + r * gr + c * gc);
    }
  }
}

// Shared-memory layout of one stage (floats), the same whichever way the
// operands lie: x as [bm][bk + 4] (k unit-stride) or [bk][bm + 8] (m
// unit-stride), w as [bk][bn + pad] (n unit-stride) or [bn][bk + 4] (k
// unit-stride); each operand's region is the larger of its two.  The pads
// make the fragment loads of a warp hit 32 distinct banks.
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int tc_pad_n(int bn) { return bn % 16 == 0 ? 8 : 0; }
__host__ __device__ inline int tc_x_floats(int bm, int bk) {
  return imax(bm * (bk + 4), bk * (bm + 8));
}
__host__ __device__ inline int tc_w_floats(int bn, int bk) {
  return imax(bk * (bn + tc_pad_n(bn)), bn * (bk + 4));
}

// One CTA computes y[b, m0:m0+bm, n0:n0+bn], b = blockIdx.z; warp (wy, wx)
// owns rows wy*16*WM.. and columns wx*8*WN.., WM x WN m16n8 fragments.
template <int WM, int WN>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32) matmul_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y,
    int M, int N, int K, int bm, int bn, int bk,
    long long sxb, long long sxm, long long sxk,
    long long swb, long long swk, long long swn,
    int x_mmaj, int w_kmaj, int x_vec, int w_vec, int stages,
    int act, float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int x_floats = tc_x_floats(bm, bk);
  const int stage_floats = x_floats + tc_w_floats(bn, bk);
  const int px = x_mmaj ? bm + 8 : bk + 4;
  const int pw = w_kmaj ? bk + 4 : bn + tc_pad_n(bn);
  // shared-memory strides of x's (m, k) and w's (k, n)
  const int xr = x_mmaj ? 1 : px, xk = x_mmaj ? px : 1;
  const int wk = w_kmaj ? 1 : pw, wn = w_kmaj ? pw : 1;

  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  // offsets of this CTA's x and w tiles and its first row of the (B * M,
  // N) output
  const long long xo = blockIdx.z * sxb + m0 * sxm, wo = blockIdx.z * swb + n0 * swn;
  const long long row0 = (long long)blockIdx.z * M + m0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int warps_n = bn / (8 * WN);
  const int wm0 = (warp / warps_n) * WM * 16, wn0 = (warp % warps_n) * WN * 8;

  auto load_stage = [&](int st, int k0) {
    float* xs = smem + st * stage_floats;
    float* ws = xs + x_floats;
    const float* xg = x + xo + k0 * sxk;
    const float* wg = w + wo + k0 * swk;
    if (x_mmaj)
      load_tile_async(xs, xg, bk, bm, sxk, sxm, px, x_vec);
    else
      load_tile_async(xs, xg, bm, bk, sxm, sxk, px, x_vec);
    if (w_kmaj)
      load_tile_async(ws, wg, bn, bk, swn, swk, pw, w_vec);
    else
      load_tile_async(ws, wg, bk, bn, swk, swn, pw, w_vec);
    cp_async_commit();
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int KT = K / bk;
  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (stages == 2 && kt + 1 < KT) {
      load_stage((kt + 1) & 1, (kt + 1) * bk);  // overlaps this step's math
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();
    const float* xs = smem + (stages == 2 ? (kt & 1) : 0) * stage_floats;
    const float* ws = xs + x_floats;
    for (int kk = 0; kk < bk; kk += 8) {
      uint32_t bb[WN][2], bs[WN][2];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float* wc = ws + (wn0 + j * 8 + gid) * wn + (kk + tig) * wk;
        split_tf32(wc[0], bb[j][0], bs[j][0]);
        split_tf32(wc[4 * wk], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const float* xc = xs + (wm0 + i * 16 + gid) * xr + (kk + tig) * xk;
        uint32_t ab[4], as[4];
        split_tf32(xc[0], ab[0], as[0]);
        split_tf32(xc[8 * xr], ab[1], as[1]);
        split_tf32(xc[4 * xk], ab[2], as[2]);
        split_tf32(xc[8 * xr + 4 * xk], ab[3], as[3]);
        // the tensor cores add into their accumulator with truncation, an
        // error that would grow with K if the sum over K stayed there; each
        // 8-deep step starts from zero and is added to acc in f32 instead
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, as, bb[j]);
          mma_tf32(t, ab, bs[j]);
          mma_tf32(t, ab, bb[j]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += t[q];
        }
      }
    }
    __syncthreads();
    if (stages == 1 && kt + 1 < KT) load_stage(0, (kt + 1) * bk);
  }

  // accumulator (i, j, q): row gid + 8*(q >> 1), column 2*tig + (q & 1)
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int c = n0 + wn0 + j * 8 + 2 * tig;
      const float b0 = bias != nullptr ? bias[c] : 0.f;
      const float b1 = bias != nullptr ? bias[c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + wm0 + i * 16 + gid + 8 * h;
        *reinterpret_cast<float2*>(y + r * N + c) =
            make_float2(apply_act(acc[i][j][2 * h] + b0, act, softcap),
                        apply_act(acc[i][j][2 * h + 1] + b1, act, softcap));
      }
    }
  }
}

template <int WM, int WN>
int launch_tc_t(const float* x, const float* w, const float* bias, float* y,
                int B, int M, int N, int K, int bm, int bn, int bk,
                long long sxb, long long sxm, long long sxk, long long swb,
                long long swk, long long swn, int x_mmaj, int w_kmaj,
                int x_vec, int w_vec, int stages, int act, float softcap,
                size_t smem, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_tc_kernel<WM, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  const dim3 grid(N / bn, M / bm, B);
  const int threads = 32 * (bm / (16 * WM)) * (bn / (8 * WN));
  matmul_tc_kernel<WM, WN><<<grid, threads, smem, stream>>>(
      x, w, bias, y, M, N, K, bm, bn, bk, sxb, sxm, sxk, swb, swk, swn, x_mmaj,
      w_kmaj, x_vec, w_vec, stages, act, softcap);
  return (int)cudaGetLastError();
}

int launch_fma(const float* x, const float* w, const float* bias, float* y,
               int B, int M, int N, int K, int bm, int bn, int bk,
               long long sxb, long long sxm, long long sxk,
               long long swb, long long swk, long long swn,
               int act, float softcap, int micro, cudaStream_t stream) {
#define REPRO_MM_CASE(TT)                                                  \
  case TT:                                                                 \
    return launch_tile<TT>(x, w, bias, y, B, M, N, K, bm, bn, bk, sxb, sxm, \
                           sxk, swb, swk, swn, (long long)M * N, N, act,   \
                           softcap, stream);
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

// Every entry point computes y[b] = act(x[b] @ w[b] + bias) for b < B: y
// (B, M, N) contiguous, x and w strided (batch strides sxb and swb; 0 for
// K1, which is batch 1), bias (N,) or null.  Each returns the launch's CUDA
// error code.

// The FMA variant, with a T x T (micro) output tile a thread.
extern "C" int repro_matmul_fma(const void* x, const void* w, const void* bias,
                                void* y, int B, int M, int N, int K, int bm,
                                int bn, int bk, long long sxb, long long sxm,
                                long long sxk, long long swb, long long swk,
                                long long swn, int act, float softcap,
                                int micro, void* stream) {
  return launch_fma(static_cast<const float*>(x), static_cast<const float*>(w),
                    static_cast<const float*>(bias), static_cast<float*>(y), B,
                    M, N, K, bm, bn, bk, sxb, sxm, sxk, swb, swk, swn, act,
                    softcap, micro, static_cast<cudaStream_t>(stream));
}

// The split-K variant, M < 16.  part: (K/bk, B, M, N) f32 scratch when
// K/bk > 1 (else null); counters: one int per output tile (B*M/bm*N/bn),
// zero, left zero.  smem: the wrapper's figure, checked.
extern "C" int repro_matmul_splitk(const void* x, const void* w,
                                   const void* bias, void* y, void* part,
                                   void* counters, int B, int M, int N, int K,
                                   int bm, int bn, int bk, long long sxb,
                                   long long sxm, long long sxk, long long swb,
                                   long long swk, long long swn, int act,
                                   float softcap, long long smem,
                                   void* stream) {
  if (smem != (long long)sizeof(float) * (bm * bk + SPLITK_WARPS * bm * bn))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  int* cf = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SPLITK_MR(R)                                                    \
  return launch_splitk_mr<R>(xf, wf, bf, yf, pf, cf, B, M, N, K, bm, bn, bk, \
                             sxb, sxm, sxk, swb, swk, swn, act, softcap,     \
                             (size_t)smem, st);
  if (bm <= 1) REPRO_SPLITK_MR(1)
  if (bm <= 2) REPRO_SPLITK_MR(2)
  if (bm <= 4) REPRO_SPLITK_MR(4)
  if (bm <= 8) REPRO_SPLITK_MR(8)
  if (bm <= 16) REPRO_SPLITK_MR(16)
#undef REPRO_SPLITK_MR
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant with (wm, wn) fragments a warp and `stages`
// shared-memory stages.  16-byte copies need the operand's base, every
// batch's base and every row to be 16-byte aligned.
extern "C" int repro_matmul_tc(const void* x, const void* w, const void* bias,
                               void* y, int B, int M, int N, int K, int bm,
                               int bn, int bk, long long sxb, long long sxm,
                               long long sxk, long long swb, long long swk,
                               long long swn, int wm, int wn, int stages,
                               int act, float softcap, long long smem,
                               void* stream) {
  if (smem != (long long)sizeof(float) * stages *
                  (tc_x_floats(bm, bk) + tc_w_floats(bn, bk)))
    return (int)cudaErrorInvalidValue;
  const int x_mmaj = sxm == 1 && sxk != 1;
  const int w_kmaj = swk == 1 && swn != 1;
  const int x_vec = aligned16(x) && sxb % 4 == 0 &&
                    (x_mmaj ? sxk % 4 == 0 : (sxk == 1 && sxm % 4 == 0));
  const int w_vec = aligned16(w) && swb % 4 == 0 &&
                    (w_kmaj ? swn % 4 == 0 : (swn == 1 && swk % 4 == 0));
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TC_CASE(A, C)                                                   \
  if (wm == A && wn == C)                                                     \
    return launch_tc_t<A, C>(xf, wf, bf, yf, B, M, N, K, bm, bn, bk, sxb, sxm, \
                             sxk, swb, swk, swn, x_mmaj, w_kmaj, x_vec, w_vec, \
                             stages, act, softcap, (size_t)smem, st);
  REPRO_TC_CASE(1, 1)
  REPRO_TC_CASE(1, 2)
  REPRO_TC_CASE(2, 1)
  REPRO_TC_CASE(2, 2)
  REPRO_TC_CASE(1, 4)
  REPRO_TC_CASE(4, 1)
  REPRO_TC_CASE(2, 4)
  REPRO_TC_CASE(4, 2)
  REPRO_TC_CASE(4, 4)
#undef REPRO_TC_CASE
  return (int)cudaErrorInvalidValue;
}
