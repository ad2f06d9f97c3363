// K7 (ssd): the Mamba-2 chunked SSD scan (state-space duality), computed in
// f32 with an (N, P) f32 state carried across the chunks of a sequence.
//
// Replaces the Pallas kernel `ssd` in src/repro/kernels/ssd.py.  There the
// grid was (batch * H, chunks) with the chunk axis "arbitrary": the TPU ran
// the chunks of one (batch, head) in order and carried the state in a VMEM
// scratch.  Only the pass of the state from chunk to chunk is sequential,
// so here two kernels split the work:
//
// * `ssd_chunk_kernel`, grid (head groups, chunks, batch): everything that
//   needs no earlier chunk.  A CTA copies its chunk's B and C (L x N) and
//   its first head's x (L x P) into shared memory with cp.async, computes
//   each head's cum = cumsum(log_a) (one thread a head, in order: the order
//   of torch.cumsum over that axis on the card), computes G = C.B^T once
//   for every head it owns (B and C are shared across heads), and then per
//   head, while the next head's x is copied in:
//     y_intra = (G * exp(cum_i - cum_j) * [i >= j]) . x   (the branch is
//               taken before expf: above the diagonal cum_i - cum_j > 0 may
//               overflow, and inf * 0 would be NaN),
//     s_c     = sum_j exp(cum_{L-1} - cum_j) B_j x_j^T      (N x P),
//   both written as f32 to scratch with cum.  The head group is chosen
//   from the shape (kernels/ssd.py, `head_group`) so that the grid fills
//   the card: one head a CTA, 128 CTAs, at mamba2-370m's forward shape.
// * `ssd_pass_kernel`, grid (slices of P, heads, batch): the pass over
//   chunks.  A CTA keeps an (N, P-slice) state in shared memory and walks
//   its chunks in order: y = y_intra + exp(cum_i) (C_i . h) is stored in
//   x's type (a warp for each 16 rows and 8 columns), then
//   h = exp(cum_{L-1}) h + s_c; after the last chunk the state is written
//   when the caller asks for it (the prefill -> decode handoff).  Each
//   chunk's C, y_intra slice, state slice and cum are copied in with
//   cp.async several chunks ahead (a ring of stages), so the walk waits on
//   memory about once, not once a chunk.  The slice is the widest that
//   still gives half a wave of CTAs (kernels/ssd.py, `p_slice`): every CTA
//   copies each chunk's C, so wider slices copy it fewer times.
//
// A sequence of one chunk (every slot-arena prefill) needs no pass: the
// chunk kernel writes y and the state itself, and the pass kernel is not
// launched.  All four contractions (C.B^T, scores . x, the state's
// (w x)^T . B, C . h) run on the tensor cores through mma.sync.m16n8k8 in
// 3xTF32 (v = big + small, both TF32; big*big + big*small + small*big
// summed in f32), the helpers of tf32_mma.cuh.  The tensor
// cores' accumulator truncates, so each 8-deep step is summed from zero
// and added to f32 registers.  A bf16 operand is exact in TF32, so its
// small part is zero and that product is skipped.  x, B and C stay in
// shared memory in their own type and are widened as the fragments are
// read.  Chunks that do not fill the mma tiles (a 37-token prompt is one
// chunk of 37) are padded in shared memory to multiples of 16 with zero
// rows and columns, and the padded cum repeats cum_{L-1}, so every exp
// stays finite.  Rows are padded so that a warp's fragment loads hit
// distinct banks (in f32, B is held twice, once for each way it is read).
// Each output element is summed in a fixed order by one thread: no
// atomics, the same bits every run.  x is read through its strides
// (16-byte copies where the strides and alignment allow, plain loads
// otherwise); log_a, B and C are contiguous.  x, B and C are f32 or bf16
// (all three the same); y is stored in that type.
//
// Bound on an H100: at mamba2-370m's forward shape (batch 1, S 256, H 32,
// P 64, N 128, chunk 64, bf16) the function needs 0.24 GFLOP (C.B^T once a
// chunk, the rest per head; the state of the last chunk and C.h of the
// first are not needed), 0.95 us at the rates of its operand types (C.B^T,
// bf16 by bf16, at 989 TFLOP/s; the other three, f32 by bf16, two TF32
// products each as here, at 495 / 2), against 2.3 MB read and written
// once, 0.7 us at 3.35 TB/s: bound by operations.  The first kernel (one
// CTA per (batch, head) walking its chunks with scalar FMAs, 32 CTAs on
// 132 SMs) ran 0.45 ms; these two run about 13 us each there (PERF.md).
// What is left is latency: a chunk-kernel CTA waits for its copies, then
// each warp runs a chain of dependent mma steps; a pass CTA still walks
// the chunks in order, with two barriers a chunk.  The scratch (y_intra
// 2 MB, states 4 MB at that shape) stays in the 50 MB L2.  wgmma and TMA
// come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kChunkThreads = 384;
constexpr int kMaxStages = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a bf16 value is exact in TF32 (8 of its 10 mantissa bits)
template <typename T>
struct ExactTF32 {
  static constexpr bool value = false;
};
template <>
struct ExactTF32<__nv_bfloat16> {
  static constexpr bool value = true;
};

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// The row pad of a shared-memory copy of B or C (and the second of x's):
// 4 floats or 8 bf16, so that a row is 4 x odd 32-bit words when the
// width is a multiple of 16, and 16-byte copies stay aligned.
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return sizeof(T) == 4 ? 4 : 8;
}

// Start copying an R x C block of T, element (r, c) at g[r*gr + c*gc], to
// shared memory s[r*ds + c] in the same type.  vec: gc == 1 and C, gr and
// g's address allow 16-byte copies (ds keeps them aligned); otherwise a
// plain copy, done when this returns.  Nothing outside R x C is written.
template <typename T>
__device__ __forceinline__ void copy_block(T* s, int ds, const T* g, long long gr,
                                           long long gc, int R, int C, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int cv = C / V;
    for (int e = threadIdx.x; e < R * cv; e += blockDim.x) {
      const int r = e / cv, c = (e - r * cv) * V;
      cp_async16(s + r * ds + c, g + r * gr + c);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C;
      s[r * ds + c] = g[r * gr + c * gc];
    }
  }
}

// Zero the padding of an Rp x Cp shared-memory block holding R x C values:
// rows R.. and columns C.. (copies never write there).
template <typename T>
__device__ __forceinline__ void zero_pad(T* s, int ds, int R, int C, int Rp, int Cp) {
  const T z = T(0.f);
  for (int e = threadIdx.x; e < (Rp - R) * Cp; e += blockDim.x) {
    const int r = e / Cp;
    s[(R + r) * ds + e - r * Cp] = z;
  }
  const int pc = Cp - C;
  for (int e = threadIdx.x; e < R * pc; e += blockDim.x) {
    const int r = e / pc;
    s[r * ds + C + e - r * pc] = z;
  }
}

// One warp: acc = sum_{k < K} A(m, k) B(k, n) for the 16 x 8*NT block,
// a(m, k) and b(k, n) reading shared memory as f32 (m < 16, n < 8*NT).
// K is a multiple of 16 (every caller pads to 16), and two 8-deep steps
// are unrolled so that their loads and mma chains overlap.  EA / EB: that
// operand is exact in TF32, so the product with its (zero) small part is
// skipped.  acc[j][q] is row gid + 8*(q >> 1), column 8*j + 2*tig + (q & 1).
template <int NT, bool EA, bool EB, typename FA, typename FB>
__device__ __forceinline__ void warp_tile(float (&acc)[NT][4], int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(a(gid, k0 + tig), ab[0], as[0]);
    split_tf32(a(gid + 8, k0 + tig), ab[1], as[1]);
    split_tf32(a(gid, k0 + tig + 4), ab[2], as[2]);
    split_tf32(a(gid + 8, k0 + tig + 4), ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2], bs[2];
      split_tf32(b(k0 + tig, 8 * j + gid), bb[0], bs[0]);
      split_tf32(b(k0 + tig + 4, 8 * j + gid), bb[1], bs[1]);
      // each 8-deep step from zero, then into f32 registers
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      if (!EA) mma_tf32(t, as, bb);
      if (!EB) mma_tf32(t, ab, bs);
      mma_tf32(t, ab, bb);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += t[q];
    }
  }
}

// Shared memory of the chunk kernel, in bytes (Lp, Np, Pp: L, N and P
// padded to 16): C and B in T (Lp x (Np + pad) each), in f32 B again
// (Lp x (Np + 8): the state contraction reads it with k = the row), x in T
// (Lp x (Pp + 8), twice when the CTA owns more than one head: the next
// head's copy lands while this one's is read), then in f32 G = C.B^T and
// one head's decayed scores (Lp x (Lp + 4) each), cum (group x Lp) and the
// decay to the chunk's end (Lp).  Each region is a multiple of 16 bytes.
template <typename T>
__host__ __device__ inline long long chunk_smem_bytes(int L, int N, int P, int group) {
  const long long Lp = pad16(L), Np = pad16(N), Pp = pad16(P);
  const long long t_elems = 2 * Lp * (Np + row_pad<T>()) +
                            (group > 1 ? 2 : 1) * Lp * (Pp + 8);
  const long long f_elems = (sizeof(T) == 4 ? Lp * (Np + 8) : 0) +
                            2 * Lp * (Lp + 4) + group * Lp + Lp;
  return (long long)sizeof(T) * t_elems + 4 * f_elems;
}

// h's row stride in the pass kernel: 8 x odd floats
__host__ __device__ inline int pass_h_stride(int ps) {
  return (ps / 8) % 2 ? ps : ps + 8;
}

// One stage of the pass kernel, in bytes: a chunk's C in T (Lp x (Np +
// pad)), its y_intra slice (Lp x ps f32), its state slice (Np x ps f32)
// and its cum (Lp f32).  A multiple of 16 bytes.
template <typename T>
__host__ __device__ inline long long pass_stage_bytes(int L, int N, int ps) {
  const long long Lp = pad16(L), Np = pad16(N);
  return (long long)sizeof(T) * Lp * (Np + row_pad<T>()) +
         4 * (Lp * ps + Np * ps + Lp);
}

template <typename T>
__host__ __device__ inline long long pass_smem_bytes(int L, int N, int ps, int stages) {
  return stages * pass_stage_bytes<T>(L, N, ps) +
         4LL * pad16(N) * pass_h_stride(ps);
}

// grid (head groups, chunks, batch).  yi: y_intra in YT (f32 scratch, or y
// itself when the sequence is one chunk), (batch, S, H, P); st: the chunk
// states, (batch, chunks, H, N, P) f32 (the final state when one chunk), or
// null; cum_out: (batch, H, S) f32 or null.  last_state: the last chunk's
// state is wanted.
template <typename T, typename YT>
__global__ void __launch_bounds__(kChunkThreads) ssd_chunk_kernel(
    const T* __restrict__ x, long long sx0, long long sx1, long long sx2,
    long long sx3, const float* __restrict__ log_a, const T* __restrict__ Bm,
    const T* __restrict__ Cm, YT* __restrict__ yi, float* __restrict__ st,
    float* __restrict__ cum_out, int S, int H, int P, int N, int L, int group,
    int last_state, int x_vec, int bc_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool EX = ExactTF32<T>::value;
  const int Lp = pad16(L), Np = pad16(N), Pp = pad16(P);
  const int sc = Np + row_pad<T>(), sk = Np + 8, sx = Pp + 8, sg = Lp + 4;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int h0 = blockIdx.x * group;
  const int gh = min(group, H - h0);
  T* cs = reinterpret_cast<T*>(smem_raw);  // [Lp][sc] C
  T* bs = cs + Lp * sc;                    // [Lp][sc] B
  T* xs0 = bs + Lp * sc;                   // [Lp][sx] x, even heads
  T* xs1 = xs0 + (group > 1 ? Lp * sx : 0);  // [Lp][sx] x, odd heads
  float* bk = reinterpret_cast<float*>(xs1 + Lp * sx);  // f32: [Lp][sk] B
  float* g = bk + (F32 ? Lp * sk : 0);     // [Lp][sg] C.B^T, lower 16 x 16 blocks
  float* sd = g + Lp * sg;                 // [Lp][sg] one head's decayed scores
  float* cum = sd + Lp * sg;               // [group][Lp]
  float* w = cum + group * Lp;             // [Lp] exp(cum_{L-1} - cum_j), 0 past L

  const long long row0 = (long long)b * S + (long long)c * L;
  const int tid = threadIdx.x, warp = tid >> 5, nw = blockDim.x >> 5;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const T* xc = x + b * sx0 + (long long)c * L * sx1;

  // B, C and the first head's x in flight, then log_a while they land
  zero_pad(cs, sc, L, N, Lp, Np);
  zero_pad(bs, sc, L, N, Lp, Np);
  zero_pad(xs0, sx, L, P, Lp, Pp);
  if (group > 1) zero_pad(xs1, sx, L, P, Lp, Pp);
  copy_block(cs, sc, Cm + row0 * N, N, 1, L, N, bc_vec);
  copy_block(bs, sc, Bm + row0 * N, N, 1, L, N, bc_vec);
  if constexpr (F32) {
    zero_pad(reinterpret_cast<T*>(bk), sk, L, N, Lp, Np);
    copy_block(reinterpret_cast<T*>(bk), sk, Bm + row0 * N, N, 1, L, N, bc_vec);
  }
  copy_block(xs0, sx, xc + h0 * sx2, sx1, sx3, L, P, x_vec);
  cp_async_commit();
  for (int e = tid; e < L * gh; e += blockDim.x) {
    const int j = e / gh, hl = e - j * gh;
    cum[hl * Lp + j] = log_a[(row0 + j) * H + h0 + hl];
  }
  cp_async_wait(0);
  __syncthreads();

  if (tid < gh) {
    float* cr = cum + tid * Lp;
    float s = 0.f;
    for (int j = 0; j < L; ++j) {
      s += cr[j];
      cr[j] = s;
    }
    for (int j = L; j < Lp; ++j) cr[j] = s;  // finite padding
    if (cum_out != nullptr) {
      float* co = cum_out + ((long long)b * H + h0 + tid) * S + (long long)c * L;
      for (int j = 0; j < L; ++j) co[j] = cr[j];
    }
  }
  __syncwarp();  // mma.sync below needs the whole warp
  // G = C.B^T on the 16 x 16 blocks at or below the diagonal (the scores
  // read no other), shared by the group's heads
  const int mt = Lp / 16;
  for (int t = warp; t < mt * (mt + 1) / 2; t += nw) {
    int mi = 0;
    while ((mi + 1) * (mi + 2) / 2 <= t) ++mi;
    const int ni = t - mi * (mi + 1) / 2;
    const T* ca = cs + mi * 16 * sc;
    const T* ba = bs + ni * 16 * sc;
    float acc[2][4];
    warp_tile<2, EX, EX>(acc, Np, [&](int i, int k) { return to_f32(ca[i * sc + k]); },
                         [&](int k, int j) { return to_f32(ba[j * sc + k]); });
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[(mi * 16 + gid + 8 * (q >> 1)) * sg + ni * 16 + 8 * j + 2 * tig + (q & 1)] =
            acc[j][q];
  }
  __syncthreads();

  // the state contraction reads B with k = the row: bf16 rows of 4 x odd
  // words serve both reads, f32 ones need the copy of 8 x odd floats
  const float* bkf = bk;
  const T* bst = bs;
  const bool want_state = c + 1 < nc || last_state;
  const int pt = Pp / 16, nt = Np / 16;
  const int tasks_y = mt * pt, tasks = tasks_y + (want_state ? pt * nt : 0);
  for (int hl = 0; hl < gh; ++hl) {
    const int h = h0 + hl;
    const float* ch = cum + hl * Lp;
    const T* xs = (hl & 1) ? xs1 : xs0;
    if (hl + 1 < gh) {  // the next head's x lands while this one is read
      copy_block((hl & 1) ? xs0 : xs1, sx, xc + (h + 1) * sx2, sx1, sx3, L, P, x_vec);
      cp_async_commit();
    }
    const float total = ch[L - 1];
    for (int j = tid; j < Lp; j += blockDim.x) w[j] = j < L ? expf(total - ch[j]) : 0.f;
    for (int e = tid; e < Lp * Lp; e += blockDim.x) {
      const int i = e / Lp, j = e - i * Lp;
      sd[i * sg + j] = i >= j ? g[i * sg + j] * expf(ch[i] - ch[j]) : 0.f;
    }
    __syncthreads();

    for (int t = warp; t < tasks; t += nw) {
      float acc[2][4];
      if (t < tasks_y) {
        // y_intra rows mi*16.., columns pi*16..: the scores vanish past the
        // diagonal, so k stops at the row block's end
        const int mi = t / pt, pi = t - mi * pt;
        const float* sa = sd + mi * 16 * sg;
        const T* xb = xs + pi * 16;
        warp_tile<2, false, EX>(acc, (mi + 1) * 16,
                                [&](int i, int k) { return sa[i * sg + k]; },
                                [&](int k, int p) { return to_f32(xb[k * sx + p]); });
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = mi * 16 + gid + 8 * (q >> 1);
            const int p = pi * 16 + 8 * j + 2 * tig + (q & 1);
            if (i < L && p < P) store(yi + ((row0 + i) * H + h) * P + p, acc[j][q]);
          }
      } else {
        // the chunk's state, transposed: s^T = (w x)^T . B, rows p, columns n
        const int u = t - tasks_y, pi = u / nt, ni = u - pi * nt;
        const T* xa = xs + pi * 16;
        const int n0 = ni * 16;
        if constexpr (F32) {
          warp_tile<2, false, EX>(
              acc, Lp, [&](int p, int k) { return to_f32(xa[k * sx + p]) * w[k]; },
              [&](int k, int n) { return bkf[k * sk + n0 + n]; });
        } else {
          warp_tile<2, false, EX>(
              acc, Lp, [&](int p, int k) { return to_f32(xa[k * sx + p]) * w[k]; },
              [&](int k, int n) { return to_f32(bst[k * sc + n0 + n]); });
        }
        float* so = st + (((long long)b * nc + c) * H + h) * (long long)N * P;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = pi * 16 + gid + 8 * (q >> 1);
            const int n = n0 + 8 * j + 2 * tig + (q & 1);
            if (p < P && n < N) so[(long long)n * P + p] = acc[j][q];
          }
      }
    }
    cp_async_wait(0);  // the next head's x has landed
    __syncthreads();   // and this head's reads of xs, sd and w are done
  }
}

// grid (Pp / ps slices, H, batch), 32 * (Lp / 16) * (ps / 8) threads:
// warp w owns the rows 16 * (w % (Lp / 16)).. and the 8 columns
// 8 * (w / (Lp / 16)).. of its slice in every chunk.  yi, st, cum: the
// chunk kernel's scratch; y (batch, S, H, P) contiguous; state_out (batch,
// H, N, P) f32 or null.  stages (1..kMaxStages, at most the chunks): chunks
// in flight.  c_vec: C allows 16-byte copies; p_vec: P % 4 == 0, so
// y_intra's and the states' slices do.
template <typename T>
__global__ void __launch_bounds__(512) ssd_pass_kernel(
    const float* __restrict__ yi, const float* __restrict__ st,
    const float* __restrict__ cum, const T* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int P, int N, int L, int ps,
    int stages, int c_vec, int p_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = pad16(L), Np = pad16(N), sc = Np + row_pad<T>();
  const int hstride = pass_h_stride(ps);
  const long long stage_bytes = pass_stage_bytes<T>(L, N, ps);
  float* hs = reinterpret_cast<float*>(smem_raw + stages * stage_bytes);  // [Np][hstride]

  const int p0 = blockIdx.x * ps, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int mt = Lp / 16;
  const int m0 = 16 * (warp % mt), n0 = 8 * (warp / mt);
  const float* cum_bh = cum + ((long long)b * H + h) * S;
  auto c_of = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * stage_bytes); };
  auto yr_of = [&](int s) { return reinterpret_cast<float*>(c_of(s) + Lp * sc); };
  auto sr_of = [&](int s) { return yr_of(s) + Lp * ps; };
  auto cr_of = [&](int s) { return sr_of(s) + Np * ps; };

  for (int s = 0; s < stages; ++s) zero_pad(c_of(s), sc, L, N, Lp, Np);
  for (int e = tid; e < Np * hstride; e += blockDim.x) hs[e] = 0.f;

  auto fetch = [&](int c) {
    const int s = c % stages;
    const long long row0 = (long long)b * S + (long long)c * L;
    // the first chunk's C meets a zero state: it is not read
    if (c > 0) copy_block(c_of(s), sc, Cm + row0 * N, N, 1, L, N, c_vec);
    const int pw = min(ps, P - p0);  // columns of this slice that exist
    copy_block(yr_of(s), ps, yi + (row0 * H + h) * P + p0, (long long)H * P, 1, L,
               pw, p_vec);
    if (c + 1 < nc || state_out != nullptr)
      copy_block(sr_of(s), ps,
                 st + (((long long)b * nc + c) * H + h) * (long long)N * P + p0, P, 1,
                 N, pw, p_vec);
    for (int i = tid; i < L; i += blockDim.x)
      cp_async4(cr_of(s) + i, cum_bh + (long long)c * L + i);
  };

  for (int c = 0; c < stages - 1; ++c) {
    fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    if (c + stages - 1 < nc) fetch(c + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);  // chunk c has landed
    __syncthreads();
    const int s = c % stages;
    const T* cs = c_of(s);
    const float* yr = yr_of(s);
    const float* cr = cr_of(s);

    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    if (c > 0)  // the state before the first chunk is zero
      warp_tile<1, ExactTF32<T>::value, false>(
          acc, Np, [&](int i, int k) { return to_f32(cs[(m0 + i) * sc + k]); },
          [&](int k, int p) { return hs[k * hstride + n0 + p]; });
    const long long row0 = (long long)b * S + (long long)c * L;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = m0 + gid + 8 * (q >> 1);
      const int p = n0 + 2 * tig + (q & 1);
      if (i < L && p0 + p < P)
        store(y + ((row0 + i) * H + h) * P + p0 + p,
              yr[i * ps + p] + expf(cr[i]) * acc[0][q]);
    }

    if (c + 1 < nc || state_out != nullptr) {
      __syncthreads();  // every read of the old state is done
      // four columns at a time; a column past P holds what it holds, and
      // only its own (discarded) outputs read it
      const float keep = expf(cr[L - 1]);
      const float* sr = sr_of(s);
      const int pv = ps / 4;
      for (int e = tid; e < N * pv; e += blockDim.x) {
        const int n = e / pv, p = (e - n * pv) * 4;
        float4* hp = reinterpret_cast<float4*>(hs + n * hstride + p);
        const float4 sv = *reinterpret_cast<const float4*>(sr + n * ps + p);
        float4 hv = *hp;
        hv.x = keep * hv.x + sv.x;
        hv.y = keep * hv.y + sv.y;
        hv.z = keep * hv.z + sv.z;
        hv.w = keep * hv.w + sv.w;
        *hp = hv;
      }
    }
    __syncthreads();  // stage s is refilled next; the state is settled
  }
  if (state_out != nullptr) {
    float* so = state_out + ((long long)b * H + h) * (long long)N * P;
    for (int e = tid; e < N * ps; e += blockDim.x) {
      const int n = e / ps, p = e - n * ps;
      if (p0 + p < P) so[(long long)n * P + p0 + p] = hs[n * hstride + p];
    }
  }
}

template <typename K>
int opt_in(K kernel, size_t smem, int& opted_in) {
  if ((int)smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)smem;
  }
  return 0;
}

template <typename T, typename YT>
int launch_chunk(const T* x, const long long* xs, const float* la, const T* Bm,
                 const T* Cm, YT* yi, float* st, float* cum, int batch, int S,
                 int H, int P, int N, int L, int group, int last_state,
                 int x_vec, int bc_vec, size_t smem, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  const int err = opt_in(ssd_chunk_kernel<T, YT>, smem, opted_in);
  if (err) return err;
  const dim3 grid((H + group - 1) / group, S / L, batch);
  ssd_chunk_kernel<T, YT><<<grid, kChunkThreads, smem, stream>>>(
      x, xs[0], xs[1], xs[2], xs[3], la, Bm, Cm, yi, st, cum, S, H, P, N, L,
      group, last_state, x_vec, bc_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pass(const float* yi, const float* st, const float* cum, const T* Cm,
                T* y, float* state, int batch, int S, int H, int P, int N, int L,
                int ps, int stages, int c_vec, int p_vec, size_t smem,
                cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  const int err = opt_in(ssd_pass_kernel<T>, smem, opted_in);
  if (err) return err;
  const dim3 grid(pad16(P) / ps, H, batch);
  const int threads = 32 * (pad16(L) / 16) * (ps / 8);
  ssd_pass_kernel<T><<<grid, threads, smem, stream>>>(
      yi, st, cum, Cm, y, state, S, H, P, N, L, ps, stages, c_vec, p_vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long round4(long long v) { return (v + 3) & ~3LL; }

template <typename T>
int launch(const void* x, const long long* xs, const float* la, const void* Bv,
           const void* Cv, void* yv, float* state, float* scratch, int batch,
           int S, int H, int P, int N, int L, int group, int p_slice,
           int stages, long long smem_a, long long smem_b, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  T* y = static_cast<T*>(yv);
  const int x_vec = xs[3] == 1 && xs[0] % V == 0 && xs[1] % V == 0 &&
                    xs[2] % V == 0 && P % V == 0 && aligned16(x);
  const int bc_vec = N % V == 0 && aligned16(Bv) && aligned16(Cv);
  const int nc = S / L;
  if (smem_a != chunk_smem_bytes<T>(L, N, P, group)) return (int)cudaErrorInvalidValue;
  if (nc == 1)  // one chunk: y and the state straight from the chunk kernel
    return launch_chunk<T, T>(xt, xs, la, Bm, Cm, y, state, nullptr, batch, S,
                              H, P, N, L, group, state != nullptr, x_vec,
                              bc_vec, (size_t)smem_a, stream);
  if (stages < 1 || stages > kMaxStages || stages > nc || scratch == nullptr ||
      smem_b != pass_smem_bytes<T>(L, N, p_slice, stages))
    return (int)cudaErrorInvalidValue;
  float* yi = scratch;
  float* st = yi + round4((long long)batch * S * H * P);
  float* cum = st + round4((long long)batch * nc * H * N * P);
  int err = launch_chunk<T, float>(xt, xs, la, Bm, Cm, yi, st, cum, batch, S,
                                   H, P, N, L, group, state != nullptr, x_vec,
                                   bc_vec, (size_t)smem_a, stream);
  if (err) return err;
  const int threads = 32 * (pad16(L) / 16) * (p_slice / 8);
  if (p_slice % 8 || pad16(P) % p_slice || threads > 512) return (int)cudaErrorInvalidValue;
  return launch_pass<T>(yi, st, cum, Cm, y, state, batch, S, H, P, N, L, p_slice,
                        stages, bc_vec, P % 4 == 0, (size_t)smem_b, stream);
}

}  // namespace

// x: (batch, S, H, P) with element strides x_strides[4]; log_a: (batch, S, H)
// f32; B, C: (batch, S, N); y: (batch, S, H, P) contiguous; state: (batch, H,
// N, P) f32 or null; scratch: f32, y_intra (batch*S*H*P), the chunk states
// (batch*chunks*H*N*P) and cum (batch*H*S), each rounded up to 4 floats, or
// null for one chunk.  dtype 0 = f32, 1 = bf16 for x, B, C and y.  L divides
// S; group heads a chunk-kernel CTA; p_slice columns of P (a multiple of 8
// that divides P padded to 16, with at most 16 warps) and stages chunks in
// flight a pass-kernel CTA; smem_a and smem_b: the wrapper's figures,
// checked.  Returns the first launch error.
extern "C" int repro_ssd(const void* x, const long long* x_strides,
                         const void* log_a, const void* Bm, const void* Cm,
                         void* y, void* state, void* scratch, int batch, int S,
                         int H, int P, int N, int L, int group, int p_slice,
                         int stages, long long smem_a, long long smem_b,
                         int dtype, void* stream) {
  const float* la = static_cast<const float*>(log_a);
  float* st = static_cast<float*>(state);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, x_strides, la, Bm, Cm, y, st, sc, batch, S,
                                 H, P, N, L, group, p_slice, stages, smem_a,
                                 smem_b, s);
  return launch<float>(x, x_strides, la, Bm, Cm, y, st, sc, batch, S, H, P, N,
                       L, group, p_slice, stages, smem_a, smem_b, s);
}
