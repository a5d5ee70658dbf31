// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_fwd (body _fwd_kernel).
// It computes what that kernel computes: blockwise online-softmax attention
// with GQA (query head h reads KV head h / (H / KH)), causal and/or
// sliding-window masking aligned on suffixes (q_off = Skv - Sq), KV tiles
// outside the band skipped, masked scores at -1e30, and the row statistics
// m (largest scaled score) and l (sum of exp(s - m)) written beside the
// output.  Unlike the TPU kernel it masks ragged tails: Sq and Skv need not
// be multiples of the tile.
//
// What bounds it: causal attention at the LM's prefill shape (B 4, H 24,
// KH 8, S 4000, D 128, bf16) does 4*B*H*D*S^2/2 = 3.9e11 FLOP against
// 0.26 GB of q/k/v/o, so it is bound by operations (0.40 ms at the tensor
// cores' 989 TFLOP/s bf16), not bytes (0.08 ms).
//
// What the design does about it: this is the simple first version.  The
// TPU kernel's sequential kv grid dimension becomes a loop inside the block;
// each block owns one (b, h, 64-row q tile) and walks the KV tiles of its
// band, with q, k and v tiles staged in shared memory and the scores, the
// running m / l and the output accumulator in f32 registers, so nothing but
// q, k, v and the outputs touches device memory.  Two routes by dtype:
//  * bf16 runs on the tensor cores: mma.sync m16n8k16 with f32
//    accumulation, 4 warps x 16 query rows, fragments through ldmatrix
//    (V transposed by it), tiles through cp.async.  The score accumulators
//    become P V's A fragment in registers; P enters that product rounded
//    to bf16, while l sums P in f32.
//  * f32 runs on CUDA-core FMAs (a 4 x 4 register tile per thread for
//    Q K^T, 4 x 4 columns per 64-column group for P V), exact to f32.
// TMA, a pipelined multi-stage ring, wgmma and warp specialisation are
// later work.  q tiles are issued heaviest first (the causal band grows
// with the tile index) so the last wave is short.
//
// Built by nvcc into a shared library with a plain C interface
// (src/repro_torch/kernels/_build.py) and called through ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per KV tile
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
constexpr int LDP = BK + 4;      // row stride of the P tile (floats)

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

// NG = number of 64-column groups of the head dim (ceil(D / 64)).
template <int NG>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int KH, int Sq, int Skv, int D,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4;          // 16-byte rows, conflict-free float4 reads
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;

  int kt_lo, kt_end;
  kv_band(q0, Sq, Skv, causal, window, kt_lo, kt_end);

  load_tile(Qs, qb, q_ss, q0, Sq, D, ld);

  float acc[4][NG][4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done (and Qs landed)
    load_tile(Ks, kb, k_ss, k0, Skv, D, ld);
    load_tile(Vs, vb, v_ss, k0, Skv, D, ld);
    __syncthreads();

    // Scores for rows ty + 16 i and keys tx + 16 j of the tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // Mask, online softmax, P into shared memory.  The 16 threads of a
    // half-warp share rows, so row reductions are half-warp shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      unsigned vis = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(r, k0 + tx + 16 * j, Sq, Skv, causal, window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        vis |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (vis >> j & 1u) ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l_i[i] = corr * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns g * 64 + tx * 4 + (0..3).
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(Ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = g * 64 + tx * 4;
        if (col < D) {
          const float4 v0 = load4(Vs + (c + 0) * ld + col);
          const float4 v1 = load4(Vs + (c + 1) * ld + col);
          const float4 v2 = load4(Vs + (c + 2) * ld + col);
          const float4 v3 = load4(Vs + (c + 3) * ld + col);
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

  // out = acc / l (rows that saw no key read 0), m and l beside it.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = l_i[i] > 0.f ? l_i[i] : 1.f;
    float* orow = o + b * o_sb + (long long)r * o_ss + h * o_sh;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * 64 + tx * 4;
      if (col < D)
        store4(orow + col,
               make_float4(acc[i][g][0] / den, acc[i][g][1] / den,
                           acc[i][g][2] / den, acc[i][g][3] / den));
    }
    if (tx == 0) {
      const long long row = ((long long)b * H + h) * Sq + r;
      m_out[row] = m_i[i];
      l_out[row] = l_i[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows = one q tile

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
// rows at or past `nrows` are zero-filled.
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int KH, int Sq, int Skv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int causal, int window, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;        // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t4 = lane & 3;         // fragment column pair
  const int li = lane & 7;         // ldmatrix: row within a matrix
  const int lj = lane >> 3;        // ldmatrix: which matrix
  const int wrow = warp * 16;      // this warp's first row in the q tile

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;

  int kt_lo, kt_end;
  kv_band(q0, Sq, Skv, causal, window, kt_lo, kt_end);

  cp_tile<D>(Qs, qb, q_ss, q0, Sq);   // waited for with the first K/V tile

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    cp_tile<D>(Ks, kb, k_ss, k0, Skv);
    cp_tile<D>(Vs, vb, v_ss, k0, Skv);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys: 8 tiles of
    // 16 x 8, K's B fragments two tiles per ldmatrix.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (wrow + li + 8 * (lj & 1)) * LD + kk * 16 +
                     8 * (lj >> 1));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, Ks + (np * 16 + li + 8 * (lj >> 1)) * LD + kk * 16 +
                        8 * (lj & 1));
        mma16816(s[2 * np], a, kf[0], kf[1]);
        mma16816(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // Mask and online softmax for rows g (hr = 0) and g + 8 (hr = 1); the
    // four lanes of a quad share a row.  l sums p in f32; P enters the
    // P V product rounded to bf16.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + wrow + g + 8 * hr;
      unsigned vis = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = visible(r, k0 + n * 8 + 2 * t4 + e, Sq, Skv,
                                  causal, window);
          float& x = s[n][2 * hr + e];
          x = ok ? x * scale : NEG_INF;
          vis |= (ok ? 1u : 0u) << (2 * n + e);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float corr = expf(m_r[hr] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = (vis >> (2 * n + e) & 1u) ? expf(x - m_new) : 0.f;
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[hr] = corr * l_r[hr] + rs;
      m_r[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // acc += P V: the score accumulators of key tiles 2kk and 2kk + 1 are
    // the A fragment of keys [16 kk, 16 kk + 16); V's B fragments come
    // transposed by ldmatrix, two output tiles per load.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (kk * 16 + li + 8 * (lj & 1)) * LD +
                              dp * 16 + 8 * (lj >> 1));
        mma16816(acc[2 * dp], a, vf[0], vf[1]);
        mma16816(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wrow + g + 8 * hr;
    if (r >= Sq) continue;
    const float den = l_r[hr] > 0.f ? l_r[hr] : 1.f;
    __nv_bfloat16* orow = o + b * o_sb + (long long)r * o_ss + h * o_sh;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * hr] / den, acc[n][2 * hr + 1] / den);
    if (t4 == 0) {
      const long long row = ((long long)b * H + h) * Sq + r;
      m_out[row] = m_r[hr];
      l_out[row] = l_r[hr];
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* m, void* l, int B, int H, int KH, int Sq, int Skv,
               const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = (size_t)3 * 64 * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, KH, Sq, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

// The mma kernel instantiated for every head dim that is a multiple of 16
// up to 256.
template <int D>
int launch_mma_d(int d, const void* q, const void* k, const void* v,
                 void* o, void* m, void* l, int B, int H, int KH, int Sq,
                 int Skv, const long long* st, int causal, int window,
                 float scale, cudaStream_t stream) {
  if (d == D)
    return launch_mma<D>(q, k, v, o, m, l, B, H, KH, Sq, Skv, st, causal,
                         window, scale, stream);
  if constexpr (D < 256)
    return launch_mma_d<D + 16>(d, q, k, v, o, m, l, B, H, KH, Sq, Skv, st,
                                causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <int NG>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* m,
               void* l, int B, int H, int KH, int Sq, int Skv, int D,
               const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * 64 * (D + 4) + BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<NG><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, KH, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_f32_d(int D, const void* q, const void* k, const void* v,
                 void* o, void* m, void* l, int B, int H, int KH, int Sq,
                 int Skv, const long long* st, int causal, int window,
                 float scale, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1:
      return launch_f32<1>(q, k, v, o, m, l, B, H, KH, Sq, Skv, D, st,
                           causal, window, scale, stream);
    case 2:
      return launch_f32<2>(q, k, v, o, m, l, B, H, KH, Sq, Skv, D, st,
                           causal, window, scale, stream);
    case 3:
      return launch_f32<3>(q, k, v, o, m, l, B, H, KH, Sq, Skv, D, st,
                           causal, window, scale, stream);
    case 4:
      return launch_f32<4>(q, k, v, o, m, l, B, H, KH, Sq, Skv, D, st,
                           causal, window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides are in elements, (batch, seq, head)
// for q, k, v and o in turn; the head dim is contiguous.  window < 0 means
// no window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int dtype, int B, int H, int KH, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 256 || KH <= 0 || H % KH != 0 ||
      H > 65535 || B > 65535 || Sq <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_d(D, q, k, v, o, m, l, B, H, KH, Sq, Skv, st, causal,
                        window, scale, s);
  if (dtype == 1)
    return launch_mma_d<16>(D, q, k, v, o, m, l, B, H, KH, Sq, Skv, st,
                            causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
