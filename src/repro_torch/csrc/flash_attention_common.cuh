// Device code shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu and flash_attention_bwd.cu.
//
// Tiles are 64 query rows by 64 keys.  Masks are the JAX package's:
// causal and sliding-window, aligned on suffixes (q_off = Skv - Sq), plus
// the ragged tails, so Sq and Skv need not be multiples of the tile.  Two
// routes by dtype: bf16 on the tensor cores through mma.sync m16n8k16
// (f32 accumulation, fragments through ldmatrix, tiles through cp.async),
// f32 on CUDA-core FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr float NEG_INF = -1e30f;

// The KV tiles [kt_lo, kt_end) that meet the band of the q tile starting at
// row q0 (_band of the TPU kernel); empty when no row of it sees a key.
__device__ __forceinline__ void kv_band(int q0, int Sq, int Skv, int causal,
                                        int window, int& kt_lo,
                                        int& kt_end) {
  const int q_off = Skv - Sq;
  int key_lo = 0;
  int key_hi = Skv - 1;
  if (window >= 0) key_lo = max(key_lo, q0 + q_off - window + 1);
  if (causal) key_hi = min(key_hi, min(q0 + BQ, Sq) - 1 + q_off);
  kt_lo = key_lo / BK;
  kt_end = key_hi >= key_lo ? key_hi / BK + 1 : kt_lo;
}

// Whether query row r (of Sq) sees key c (of Skv): suffix-aligned causal
// and window masks, and the ragged tails.
__device__ __forceinline__ bool visible(int r, int c, int Sq, int Skv,
                                        int causal, int window) {
  const int ra = r + Skv - Sq;
  return r < Sq && c < Skv && (!causal || c <= ra) &&
         (window < 0 || c > ra - window);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;     // 16 x 16: tx picks columns, ty rows
constexpr int LDP = BK + 4;      // row stride of a 64 x 64 f32 tile (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [row0, row0 + 64) of a [rows, D] matrix with row stride `ss`
// (elements) into shared memory with row stride `ld`; rows at or past
// `nrows` read as zeros, so a ragged tail contributes nothing (and never
// NaN: P is 0 there, and 0 * garbage could be NaN).
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int row0, int nrows,
                                          int D, int ld) {
  const int vecs = D / 4;
  for (int idx = threadIdx.x; idx < 64 * vecs; idx += THREADS) {
    const int r = idx / vecs;
    const int c = (idx - r * vecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) val = load4(src + (long long)(row0 + r) * ss + c);
    store4(dst + r * ld + c, val);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = row (ty + 16 i) of A . row (tx + 16 j) of B, over D lanes, for
// two 64-row tiles in shared memory with row stride `ld`.
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A,
                                          const float* Bt, int D, int ld,
                                          int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(Bt + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        s[i][j] = a;
      }
  }
}

// acc[i][g] += P[ty + 16 i, :] . X[:, g * 64 + tx * 4 + (0..3)] for a
// 64 x 64 P (row stride LDP) and a 64-row X (row stride ld), both in
// shared memory.
template <int NG>
__device__ __forceinline__ void tile_pv(float (&acc)[4][NG][4],
                                        const float* P, const float* X,
                                        int D, int ld, int tx, int ty) {
  for (int c = 0; c < BK; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = load4(P + (ty + 16 * i) * LDP + c);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * 64 + tx * 4;
      if (col < D) {
        const float4 v0 = load4(X + (c + 0) * ld + col);
        const float4 v1 = load4(X + (c + 1) * ld + col);
        const float4 v2 = load4(X + (c + 2) * ld + col);
        const float4 v3 = load4(X + (c + 3) * ld + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i][g];
          a[0] = fmaf(pv[i].x, v0.x, a[0]);
          a[1] = fmaf(pv[i].x, v0.y, a[1]);
          a[2] = fmaf(pv[i].x, v0.z, a[2]);
          a[3] = fmaf(pv[i].x, v0.w, a[3]);
          a[0] = fmaf(pv[i].y, v1.x, a[0]);
          a[1] = fmaf(pv[i].y, v1.y, a[1]);
          a[2] = fmaf(pv[i].y, v1.z, a[2]);
          a[3] = fmaf(pv[i].y, v1.w, a[3]);
          a[0] = fmaf(pv[i].z, v2.x, a[0]);
          a[1] = fmaf(pv[i].z, v2.y, a[1]);
          a[2] = fmaf(pv[i].z, v2.z, a[2]);
          a[3] = fmaf(pv[i].z, v2.w, a[3]);
          a[0] = fmaf(pv[i].w, v3.x, a[0]);
          a[1] = fmaf(pv[i].w, v3.y, a[1]);
          a[2] = fmaf(pv[i].w, v3.z, a[2]);
          a[3] = fmaf(pv[i].w, v3.w, a[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 rows = one 64-row tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j.
// Lane t receives row t/4, columns 2(t%4) and 2(t%4)+1 of each matrix
// (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B (column
// fragment) and a 16x8 f32 C: lane t holds C rows t/4 and t/4 + 8, columns
// 2(t%4) and 2(t%4)+1.
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [rows, D] bf16 matrix with row stride `ss`
// (elements) into shared memory with row stride D + 8 (so the eight rows an
// ldmatrix phase reads fall in distinct banks), 16 bytes per cp.async;
// rows at or past `nrows` are zero-filled.  Commits one group.
template <int D>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long ss, int row0, int nrows) {
  constexpr int VECS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * VECS; idx += MMA_THREADS) {
    const int r = idx / VECS;
    const int c = (idx - r * VECS) * 8;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * ss + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * (D + 8) + c)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// s[n] (n < 8) += A[rows arow0 .. +16) . B[rows 0 .. 64)^T over D lanes:
// A and B bf16 tiles in shared memory with row stride D + 8; the 16 x 64
// product in 8 accumulator tiles of 16 x 8 (B's fragments two tiles per
// ldmatrix).
template <int D>
__device__ __forceinline__ void mma_rows_dot(float (&s)[8][4],
                                             const __nv_bfloat16* A,
                                             const __nv_bfloat16* Bm,
                                             int arow0, int li, int lj) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (arow0 + li + 8 * (lj & 1)) * LD + kk * 16 +
                   8 * (lj >> 1));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, Bm + (np * 16 + li + 8 * (lj >> 1)) * LD + kk * 16 +
                      8 * (lj & 1));
      mma16816(s[2 * np], a, bf[0], bf[1]);
      mma16816(s[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc[n] (n < D / 8) += P . X for a 16 x 64 P held in accumulator layout
// (s[8][4], rounded to bf16 here) and a 64 x D bf16 X in shared memory
// with row stride D + 8 (B fragments transposed by ldmatrix).
template <int D>
__device__ __forceinline__ void mma_acc_pv(float (&acc)[D / 8][4],
                                           const float (&s)[8][4],
                                           const __nv_bfloat16* X, int li,
                                           int lj) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t xf[4];
      ldsm_x4_trans(xf, X + (kk * 16 + li + 8 * (lj & 1)) * LD + dp * 16 +
                            8 * (lj >> 1));
      mma16816(acc[2 * dp], a, xf[0], xf[1]);
      mma16816(acc[2 * dp + 1], a, xf[2], xf[3]);
    }
  }
}

}  // namespace
