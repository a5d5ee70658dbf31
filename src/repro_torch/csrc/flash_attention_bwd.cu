// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV
// kernels.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel.py::flash_bwd_dq
//     (body _bwd_dq_kernel) and
//   src/repro/kernels/flash_attention/kernel.py::flash_bwd_dkv
//     (body _bwd_dkv_kernel), with the GQA group sum of ops.py folded in.
// They compute what those kernels compute from the forward's row
// statistics m (largest scaled score) and l (sum of exp(s - m)) and
// delta = rowsum(dO * O), which the caller computes:
//   P  = exp(S * scale - m) / l, 0 where masked or where l = 0,
//   dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dK = scale * sum over the group dS^T Q,
//   dV = sum over the group P^T dO.
// Masks are the forward's (causal and window aligned on suffixes); unlike
// the TPU kernels, ragged tails are masked, so Sq and Skv need not be
// multiples of the tile.
//
// What bounds them: at the LM's microbatch shape (B 4, H 24, KH 8,
// S 4096, D 128, bf16, causal) dQ does three half-triangle products
// (S, dP, dS K: 6.2e11 FLOP) and dK/dV four (8.2e11) against under 0.5 GB
// of inputs and outputs, so both are bound by operations (0.626 and
// 0.834 ms at the 989 TFLOP/s of an H100 SXM's bf16 tensor cores, data
// sheet, 700 W), not bytes.
//
// What the design does about it.  The TPU kernels' sequential grid
// dimension becomes a loop inside the block:
//  * dQ, wgmma route (bf16, D 64 and 128; the main path): dK/dV's design
//    below with the roles of queries and keys swapped.  One block per (h,
//    b, 128-row q tile), highest q tiles (the heaviest under a causal
//    mask) first, three warpgroups.  Q and dO are loaded once by TMA and
//    stay in shared memory; the consumers hold their rows' m log2 e, 1 / l
//    and delta in registers.  The producer warpgroup gives up its
//    registers (setmaxnreg); one thread streams the K and V tiles of 64
//    keys of the band through a two-slot ring of 128-byte-swizzled shared
//    memory (full and empty mbarriers).  Each of the two consumer
//    warpgroups owns 64 rows: S = Q K^T and dP = dO V^T by wgmma from
//    shared memory; P and dS in f32 registers, masked only on edge tiles,
//    by each row's key bounds; dQ += dS K by wgmma with dS as the bf16
//    register A operand, packed straight from the accumulators 16 keys
//    at a time, and K read MN-major.  Both warpgroups take every tile of
//    the band (a branch around the tiles one of them does not see, or a
//    per-element visible(), made ptxas serialise the products, C7520).
//    dQ stays in f32 registers and is written once, no atomics.
//  * dQ, mma route (bf16, other D; the first version): one block per (b,
//    h, 64-row q tile) walks the KV tiles of its band; Q and dO stay in
//    shared memory, dQ accumulates in f32 registers and is written once.
//  * dK/dV, wgmma route (bf16, D 64 and 128; the main path): one block
//    per (KV head, b, 128-key tile), lowest key tiles (the heaviest under
//    a causal mask) first, three warpgroups.  K and V are loaded once by
//    TMA and stay in shared memory.  The producer warpgroup gives up its
//    registers (setmaxnreg); its first warp streams the (Q, dO) tiles of
//    64 queries of every query head of the group and q tile of the band,
//    with their m log2 e, 1 / l and delta, through a two-slot ring of
//    128-byte-swizzled shared memory (full and empty mbarriers) that
//    runs on from one head to the next.  Each of the two consumer
//    warpgroups owns 64 keys: S^T = K Q^T and dP^T = V dO^T by wgmma from
//    shared memory; P^T = exp2(S^T scale log2 e - m log2 e) / l and dS^T =
//    P^T (dP^T - delta) in f32 registers, masked only on tiles that the
//    causal diagonal, the window edge or a ragged tail crosses; dV +=
//    P^T dO and dK += dS^T Q by wgmma with P^T and dS^T as bf16 register
//    A operands and dO, Q read MN-major from shared memory.  dK and dV
//    stay in f32 registers over the whole group and are written once in
//    k's layout: no per-head [B, H, Skv, D] buffer, no atomics, so two
//    launches give the same bits.
//  * dK/dV, mma route (bf16, other D): the first version, one block per
//    (b, KV head, 64-key tile) with one cp.async stage, mma.sync.
//  * f32 on CUDA-core FMAs for both.
// P and dS enter their products rounded to bf16 on both bf16 routes.
//
// Built by nvcc into a shared library with a plain C interface
// (src/repro_torch/kernels/_build.py) and called through ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.

#include "flash_attention_common.cuh"
#include "hopper_wgmma.cuh"

namespace {

// Element strides, (batch, seq, head) for each tensor in turn, passed by
// value: q, k, v, dO, then dq (15 used) or dk and dv (18).
struct Strides {
  long long s[18];
};

// The q tiles [qt_lo, qt_end) that meet the band of the KV tile starting at
// key k0: the rows that see at least one of its keys.
__device__ __forceinline__ void q_band(int k0, int Sq, int Skv, int causal,
                                       int window, int& qt_lo, int& qt_end) {
  const int q_off = Skv - Sq;
  const int key_hi = min(k0 + BK, Skv) - 1;
  int r_lo = 0;
  int r_hi = Sq - 1;
  if (causal) r_lo = max(r_lo, k0 - q_off);
  if (window >= 0) r_hi = min(r_hi, key_hi + window - 1 - q_off);
  qt_lo = r_lo / BQ;
  qt_end = r_hi >= r_lo ? r_hi / BQ + 1 : qt_lo;
}

// Row statistics of query row r: m, 1 / l (0 where l = 0 or past Sq) and
// delta.
__device__ __forceinline__ void row_stats(const float* m, const float* l,
                                          const float* delta, long long base,
                                          int r, int Sq, float& mr,
                                          float& il, float& dl) {
  mr = 0.f;
  il = 0.f;
  dl = 0.f;
  if (r < Sq) {
    const float lv = l[base + r];
    mr = m[base + r];
    il = lv > 0.f ? 1.f / lv : 0.f;
    dl = delta[base + r];
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

// dQ.  NG = number of 64-column groups of the head dim (ceil(D / 64)).
template <int NG>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int KH, int Sq,
                        int Skv, int D, const Strides st,
                        int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* dSs = Vs + BK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + b * st.s[0] + h * st.s[2];
  const float* kb = k + b * st.s[3] + kh * st.s[5];
  const float* vb = v + b * st.s[6] + kh * st.s[8];
  const float* dob = dO + b * st.s[9] + h * st.s[11];
  const long long base = ((long long)b * H + h) * Sq;

  int kt_lo, kt_end;
  kv_band(q0, Sq, Skv, causal, window, kt_lo, kt_end);

  load_tile(Qs, qb, st.s[1], q0, Sq, D, ld);
  load_tile(dOs, dob, st.s[10], q0, Sq, D, ld);

  float mr[4], il[4], dl[4];
  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_stats(m, l, delta, base, q0 + ty + 16 * i, Sq, mr[i], il[i], dl[i]);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile(Ks, kb, st.s[4], k0, Skv, D, ld);
    load_tile(Vs, vb, st.s[7], k0, Skv, D, ld);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots(s, Qs, Ks, D, ld, tx, ty);
    tile_dots(dp, dOs, Vs, D, ld, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(r, k0 + tx + 16 * j, Sq, Skv, causal, window);
        const float p = ok ? expf(s[i][j] * scale - mr[i]) * il[i] : 0.f;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    tile_pv<NG>(acc, dSs, Ks, D, ld, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    float* row = dq + b * st.s[12] + (long long)r * st.s[13] + h * st.s[14];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * 64 + tx * 4;
      if (col < D)
        store4(row + col, make_float4(acc[i][g][0] * scale,
                                      acc[i][g][1] * scale,
                                      acc[i][g][2] * scale,
                                      acc[i][g][3] * scale));
    }
  }
}

// dK/dV: ty picks keys (rows of K^T-side tiles), tx picks query columns.
template <int NG>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dO,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int KH, int Sq, int Skv, int D,
                         const Strides st, int causal,
                         int window, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + BQ * ld;
  float* Pt = dOs + BQ * ld;
  float* dSt = Pt + BK * LDP;
  float* sm_m = dSt + BK * LDP;
  float* sm_il = sm_m + BQ;
  float* sm_d = sm_il + BQ;

  const int kt = blockIdx.x;                 // heaviest tiles first (causal)
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int k0 = kt * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* kb = k + b * st.s[3] + kh * st.s[5];
  const float* vb = v + b * st.s[6] + kh * st.s[8];

  int qt_lo, qt_end;
  q_band(k0, Sq, Skv, causal, window, qt_lo, qt_end);

  load_tile(Ks, kb, st.s[4], k0, Skv, D, ld);
  load_tile(Vs, vb, st.s[7], k0, Skv, D, ld);

  float dK[4][NG][4], dV[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dK[i][g][c] = 0.f;
        dV[i][g][c] = 0.f;
      }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* qb = q + b * st.s[0] + h * st.s[2];
    const float* dob = dO + b * st.s[9] + h * st.s[11];
    const long long base = ((long long)b * H + h) * Sq;
    for (int qt = qt_lo; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's readers are done
      load_tile(Qs, qb, st.s[1], q0, Sq, D, ld);
      load_tile(dOs, dob, st.s[10], q0, Sq, D, ld);
      if (threadIdx.x < BQ)
        row_stats(m, l, delta, base, q0 + threadIdx.x, Sq,
                  sm_m[threadIdx.x], sm_il[threadIdx.x], sm_d[threadIdx.x]);
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i and queries tx + 16 j.
      float s[4][4], dp[4][4];
      tile_dots(s, Ks, Qs, D, ld, tx, ty);
      tile_dots(dp, Vs, dOs, D, ld, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          const bool ok = visible(q0 + qi, c, Sq, Skv, causal, window);
          const float p =
              ok ? expf(s[i][j] * scale - sm_m[qi]) * sm_il[qi] : 0.f;
          Pt[(ty + 16 * i) * LDP + qi] = p;
          dSt[(ty + 16 * i) * LDP + qi] = p * (dp[i][j] - sm_d[qi]);
        }
      }
      __syncthreads();
      tile_pv<NG>(dV, Pt, dOs, D, ld, tx, ty);
      tile_pv<NG>(dK, dSt, Qs, D, ld, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Skv) continue;
    float* krow = dk + b * st.s[12] + (long long)c * st.s[13] + kh * st.s[14];
    float* vrow = dv + b * st.s[15] + (long long)c * st.s[16] + kh * st.s[17];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * 64 + tx * 4;
      if (col < D) {
        store4(krow + col, make_float4(dK[i][g][0] * scale,
                                       dK[i][g][1] * scale,
                                       dK[i][g][2] * scale,
                                       dK[i][g][3] * scale));
        store4(vrow + col, make_float4(dV[i][g][0], dV[i][g][1],
                                       dV[i][g][2], dV[i][g][3]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulation)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int KH,
                        int Sq, int Skv, const Strides st,
                        int causal, int window, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + 64 * LD;
  __nv_bfloat16* Ks = dOs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int li = lane & 7;
  const int lj = lane >> 3;
  const int wrow = warp * 16;

  const __nv_bfloat16* qb = q + b * st.s[0] + h * st.s[2];
  const __nv_bfloat16* kb = k + b * st.s[3] + kh * st.s[5];
  const __nv_bfloat16* vb = v + b * st.s[6] + kh * st.s[8];
  const __nv_bfloat16* dob = dO + b * st.s[9] + h * st.s[11];
  const long long base = ((long long)b * H + h) * Sq;

  int kt_lo, kt_end;
  kv_band(q0, Sq, Skv, causal, window, kt_lo, kt_end);

  cp_tile<D>(Qs, qb, st.s[1], q0, Sq);     // waited for with the first K/V
  cp_tile<D>(dOs, dob, st.s[10], q0, Sq);

  float mr[2], il[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    row_stats(m, l, delta, base, q0 + wrow + g + 8 * hr, Sq, mr[hr], il[hr],
              dl[hr]);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    cp_tile<D>(Ks, kb, st.s[4], k0, Skv);
    cp_tile<D>(Vs, vb, st.s[7], k0, Skv);
    cp_async_wait_all();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = 0.f;
        dp[n][c] = 0.f;
      }
    mma_rows_dot<D>(s, Qs, Ks, wrow, li, lj);    // S  = Q K^T
    mma_rows_dot<D>(dp, dOs, Vs, wrow, li, lj);  // dP = dO V^T

    // dS = P (dP - delta) for rows g (c < 2) and g + 8, in f32; it enters
    // dS K rounded to bf16.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hr = c >> 1;
        const bool ok = visible(q0 + wrow + g + 8 * hr,
                                k0 + n * 8 + 2 * t4 + (c & 1), Sq, Skv,
                                causal, window);
        const float p = ok ? expf(s[n][c] * scale - mr[hr]) * il[hr] : 0.f;
        s[n][c] = p * (dp[n][c] - dl[hr]);
      }
    mma_acc_pv<D>(acc, s, Ks, li, lj);           // dQ += dS K
  }
  cp_async_wait_all();   // an empty band never waited for Q and dO

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wrow + g + 8 * hr;
    if (r >= Sq) continue;
    __nv_bfloat16* row = dq + b * st.s[12] + (long long)r * st.s[13] +
                         h * st.s[14];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t4) = pack_bf16(
          acc[n][2 * hr] * scale, acc[n][2 * hr + 1] * scale);
  }
}

// dK/dV: each warp owns 16 keys of the 64-key tile; the accumulators hold
// them as rows (g, g + 8) and the queries as columns.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dO,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int KH,
                         int Sq, int Skv, const Strides st,
                         int causal, int window, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + 64 * LD;
  __nv_bfloat16* Qs = Vs + 64 * LD;
  __nv_bfloat16* dOs = Qs + 64 * LD;
  float* sm_m = reinterpret_cast<float*>(dOs + 64 * LD);
  float* sm_il = sm_m + BQ;
  float* sm_d = sm_il + BQ;

  const int kt = blockIdx.x;                 // heaviest tiles first (causal)
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int li = lane & 7;
  const int lj = lane >> 3;
  const int wrow = warp * 16;

  const __nv_bfloat16* kb = k + b * st.s[3] + kh * st.s[5];
  const __nv_bfloat16* vb = v + b * st.s[6] + kh * st.s[8];

  int qt_lo, qt_end;
  q_band(k0, Sq, Skv, causal, window, qt_lo, qt_end);

  cp_tile<D>(Ks, kb, st.s[4], k0, Skv);    // waited for with the first Q tile
  cp_tile<D>(Vs, vb, st.s[7], k0, Skv);

  float dK[NT][4], dV[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dK[n][c] = 0.f;
      dV[n][c] = 0.f;
    }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const __nv_bfloat16* qb = q + b * st.s[0] + h * st.s[2];
    const __nv_bfloat16* dob = dO + b * st.s[9] + h * st.s[11];
    const long long base = ((long long)b * H + h) * Sq;
    for (int qt = qt_lo; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's readers are done
      cp_tile<D>(Qs, qb, st.s[1], q0, Sq);
      cp_tile<D>(dOs, dob, st.s[10], q0, Sq);
      if (threadIdx.x < BQ)
        row_stats(m, l, delta, base, q0 + threadIdx.x, Sq,
                  sm_m[threadIdx.x], sm_il[threadIdx.x], sm_d[threadIdx.x]);
      cp_async_wait_all();
      __syncthreads();

      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = 0.f;
          dp[n][c] = 0.f;
        }
      mma_rows_dot<D>(s, Ks, Qs, wrow, li, lj);    // S^T  = K Q^T
      mma_rows_dot<D>(dp, Vs, dOs, wrow, li, lj);  // dP^T = V dO^T

      // P^T and dS^T for keys g (c < 2) and g + 8 and queries
      // n * 8 + 2 t4 + (c & 1) of the tile, in f32; each enters its
      // product rounded to bf16.
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = n * 8 + 2 * t4 + (c & 1);
          const bool ok = visible(q0 + qi, k0 + wrow + g + 8 * (c >> 1), Sq,
                                  Skv, causal, window);
          const float p =
              ok ? expf(s[n][c] * scale - sm_m[qi]) * sm_il[qi] : 0.f;
          s[n][c] = p;
          dp[n][c] = p * (dp[n][c] - sm_d[qi]);
        }
      mma_acc_pv<D>(dV, s, dOs, li, lj);    // dV += P^T dO
      mma_acc_pv<D>(dK, dp, Qs, li, lj);    // dK += dS^T Q
    }
  }
  cp_async_wait_all();   // an empty band never waited for K and V

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = k0 + wrow + g + 8 * hr;
    if (c >= Skv) continue;
    __nv_bfloat16* krow = dk + b * st.s[12] + (long long)c * st.s[13] +
                          kh * st.s[14];
    __nv_bfloat16* vrow = dv + b * st.s[15] + (long long)c * st.s[16] +
                          kh * st.s[17];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * t4) = pack_bf16(
          dK[n][2 * hr] * scale, dK[n][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * t4) =
          pack_bf16(dV[n][2 * hr], dV[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dO;
  const float *m, *l, *delta;
  void *d0, *d1;            // dq, or dk and dv
  int B, H, KH, Sq, Skv, D;
  Strides st;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_mma(const Args& a, bool dkv) {
  using bf = __nv_bfloat16;
  const size_t tiles = (size_t)4 * 64 * (D + 8) * sizeof(bf);
  if (!dkv) {
    int err = configure(flash_bwd_dq_mma_kernel<D>, tiles);
    if (err) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_mma_kernel<D><<<grid, MMA_THREADS, tiles, a.stream>>>(
        (const bf*)a.q, (const bf*)a.k, (const bf*)a.v, (const bf*)a.dO,
        a.m, a.l, a.delta, (bf*)a.d0, a.H, a.KH, a.Sq, a.Skv, a.st,
        a.causal, a.window, a.scale);
  } else {
    const size_t smem = tiles + 3 * BQ * sizeof(float);
    int err = configure(flash_bwd_dkv_mma_kernel<D>, smem);
    if (err) return err;
    const dim3 grid((a.Skv + BK - 1) / BK, a.KH, a.B);
    flash_bwd_dkv_mma_kernel<D><<<grid, MMA_THREADS, smem, a.stream>>>(
        (const bf*)a.q, (const bf*)a.k, (const bf*)a.v, (const bf*)a.dO,
        a.m, a.l, a.delta, (bf*)a.d0, (bf*)a.d1, a.H, a.KH, a.Sq, a.Skv,
        a.st, a.causal, a.window, a.scale);
  }
  return (int)cudaGetLastError();
}

// The mma kernels instantiated for every head dim that is a multiple of 16
// up to MAX_D.
constexpr int MAX_D = 160;

template <int D>
int launch_mma_d(const Args& a, bool dkv) {
  if (a.D == D) return launch_mma<D>(a, dkv);
  if constexpr (D < MAX_D) return launch_mma_d<D + 16>(a, dkv);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 dK/dV, D in {64, 128}: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WS_BK = 128;         // keys per block, 64 per consumer
constexpr int WS_BQ = 64;          // queries per ring slot

// Shared memory of dK/dV: K and V of the block's keys (resident), then
// STAGES slots of (Q, dO) tiles, each tile as D / 64 swizzled chunks; the
// slots' row statistics (m log2 e, 1 / l, delta, 0 as a float4 a query);
// the mbarriers.
template <int D, int STAGES>
struct DkvLayout {
  static constexpr int NC = D / 64;
  static constexpr int KV_CHUNK = WS_BK * 128;
  static constexpr int KV_BYTES = NC * KV_CHUNK;     // one of K or V
  static constexpr int Q_CHUNK = WS_BQ * 128;
  static constexpr int Q_BYTES = NC * Q_CHUNK;       // one of Q or dO
  static constexpr int RING = 2 * KV_BYTES;
  static constexpr int STATS = RING + STAGES * 2 * Q_BYTES;
  static constexpr int BAR = STATS + STAGES * WS_BQ * 16;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + SMEM_ALIGN;
};

// The first query of ring iteration `it` (head it / nq, q tile qt_lo +
// it % nq).
__device__ __forceinline__ int q_start(int it, int nq, int qt_lo) {
  return (qt_lo + it % nq) * WS_BQ;
}

// Whether some (key, query) pair of the 64 keys from kw and the 64
// queries from q0 is visible, and whether all are.
__device__ __forceinline__ bool sees_any(int kw, int q0, int Skv, int q_off,
                                         int causal, int window) {
  return kw < Skv && (!causal || q0 + WS_BQ - 1 + q_off >= kw) &&
         (window < 0 || kw + 63 > q0 + q_off - window);
}

__device__ __forceinline__ bool sees_all(int kw, int q0, int Skv, int q_off,
                                         int causal, int window) {
  return kw + 64 <= Skv && (!causal || kw + 63 <= q0 + q_off) &&
         (window < 0 || kw > q0 + WS_BQ - 1 + q_off - window);
}

// S = A0 B0^T and dP = A1 B1^T for the 64 rows of A0 and A1 from `a_row0`
// and the 64 rows of B0 and B1, all K-major (the head dim contiguous),
// issued as one wgmma group: S^T = K Q^T and dP^T = V dO^T in dK/dV, S =
// Q K^T and dP = dO V^T in dQ.
template <int D>
__device__ __forceinline__ void issue_sdp(float (&s)[32], float (&dp)[32],
                                          const uint8_t* A0,
                                          const uint8_t* A1, int a_chunk,
                                          int a_row0, const uint8_t* B0,
                                          const uint8_t* B1, int b_chunk) {
  wgmma_fence();
  wgmma_ss_n64_zero<0>(s, desc_k(A0, a_chunk, a_row0, 0),
                       desc_k(B0, b_chunk, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<64, 0>(s, desc_k(A0, a_chunk, a_row0, kk),
                    desc_k(B0, b_chunk, 0, kk), 1);
  wgmma_ss_n64_zero<0>(dp, desc_k(A1, a_chunk, a_row0, 0),
                       desc_k(B1, b_chunk, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<64, 0>(dp, desc_k(A1, a_chunk, a_row0, kk),
                    desc_k(B1, b_chunk, 0, kk), 1);
  wgmma_commit();
}

// One block per (KV head, b, 128-key tile), heaviest (lowest) key tiles
// first.  Warpgroups 0 and 1 own keys 64 wg .. 64 wg + 63 of the tile and
// keep their dK and dV in registers over the whole query-head group;
// warpgroup 2's first warp streams the (Q, dO) tiles of 64 queries of
// every head of the group and q tile of the band through a ring of STAGES
// slots, lane 0 by TMA and all 32 lanes writing the slot's row
// statistics (full: lane 0's arrival, after the warp's writes, and the
// bytes; empty: every consumer warp done).  The ring runs on from one
// head to the next.
template <int D, int STAGES>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int KH,
                           int Sq, int Skv, const Strides st, int causal,
                           int window, float scale, float scale_log2) {
  using L = DkvLayout<D, STAGES>;
  uint8_t* smem = aligned_smem();
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::KV_BYTES;
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * WS_BK;
  const int G = H / KH;
  const int q_off = Skv - Sq;
  // The q tiles whose rows see a key of this block.
  int r_lo = 0, r_hi = Sq - 1;
  if (causal) r_lo = max(r_lo, k0 - q_off);
  if (window >= 0)
    r_hi = min(r_hi, min(k0 + WS_BK, Skv) - 1 + window - 1 - q_off);
  const int qt_lo = r_lo / WS_BQ;
  const int nq = r_hi >= r_lo ? r_hi / WS_BQ + 1 - qt_lo : 0;
  const int n_it = G * nq;

  if (threadIdx.x == 0) ring_init<STAGES>(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (lane == 0 && n_it > 0) {
        mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int c = 0; c < L::NC; ++c) {
          tma_load(Ks + c * L::KV_CHUNK, &tk, kv_full, 64 * c, k0, kh, b);
          tma_load(Vs + c * L::KV_CHUNK, &tv, kv_full, 64 * c, k0, kh, b);
        }
      }
      RingPos<STAGES> pos;
      for (int it = 0; it < n_it; ++it, pos.next()) {
        const int gi = it / nq;
        const int h = kh * G + gi;
        const int q0 = (qt_lo + it - gi * nq) * WS_BQ;
        const long long base = ((long long)b * H + h) * Sq;
        // The slot's statistics, read before the slot is free.
        float mv[2], il[2], dl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = q0 + lane + 32 * i;
          mv[i] = il[i] = dl[i] = 0.f;
          if (r < Sq) {
            const float lv = l[base + r];
            if (lv > 0.f) {
              mv[i] = m[base + r] * LOG2E;
              il[i] = 1.f / lv;
            }
            dl[i] = delta[base + r];
          }
        }
        mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        float4* sm = reinterpret_cast<float4*>(stats) + pos.stage * WS_BQ;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          sm[lane + 32 * i] = make_float4(mv[i], il[i], dl[i], 0.f);
        __syncwarp();
        if (lane == 0) {
          uint8_t* Qs = smem + L::RING + pos.stage * 2 * L::Q_BYTES;
          uint8_t* dOs = Qs + L::Q_BYTES;
          uint64_t* bar = &full[pos.stage];
          mbar_expect_tx(bar, 2 * L::Q_BYTES);
          for (int c = 0; c < L::NC; ++c) {
            tma_load(Qs + c * L::Q_CHUNK, &tq, bar, 64 * c, q0, h, b);
            tma_load(dOs + c * L::Q_CHUNK, &tdo, bar, 64 * c, q0, h, b);
          }
        }
      }
    }
    return;
  }

  // Consumers: keys c0 and c0 + 8 of this thread's accumulator rows.
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kw = k0 + 64 * wg;               // this warpgroup's first key
  const int c0 = kw + warp * 16 + lane / 4;
  const int t2 = 2 * (lane % 4);

  float dK[D / 2], dV[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  if (n_it > 0) mbar_wait(kv_full, 0);
  RingPos<STAGES> pos;
  for (int it = 0; it < n_it; ++it, pos.next()) {
    const int q0 = q_start(it, nq, qt_lo);
    mbar_wait(&full[pos.stage], pos.phase);
    const uint8_t* Qs = smem + L::RING + pos.stage * 2 * L::Q_BYTES;
    const uint8_t* dOs = Qs + L::Q_BYTES;
    const float4* sm =
        reinterpret_cast<const float4*>(stats) + pos.stage * WS_BQ;
    if (sees_any(kw, q0, Skv, q_off, causal, window)) {
      float s[32], dp[32];
      issue_sdp<D>(s, dp, Ks, Vs, L::KV_CHUNK, 64 * wg, Qs, dOs,
                   L::Q_CHUNK);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // 16 queries at a time: P^T = exp2(S^T scale log2 e - m log2 e) / l
      // and dS^T = P^T (dP^T - delta) in f32, masked on edge tiles
      // (queries past Sq have 1 / l = 0 and need no mask), rounded to bf16
      // as A operands straight from the accumulators (never written
      // outside wgmma, so the products are not serialised), and at once
      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major, all one group:
      // the SFU and the tensor cores overlap.
      const bool interior = sees_all(kw, q0, Skv, q_off, causal, window);
      uint32_t pa[WS_BQ / 16][4], dsa[WS_BQ / 16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WS_BQ / 16; ++kk) {
        float pv[8], dv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = 8 * kk + e;
          const int qi = 8 * (j >> 2) + t2 + (j & 1);
          const float4 q = sm[qi];   // (m log2 e, 1 / l, delta, 0)
          float p = fast_exp2(s[j] * scale_log2 - q.x) * q.y;
          if (!interior && !visible(q0 + qi, c0 + 8 * ((j >> 1) & 1), Sq,
                                    Skv, causal, window))
            p = 0.f;
          pv[e] = p;
          dv[e] = p * (dp[j] - q.z);
        }
        a_pack(pa[kk], pv);
        a_pack(dsa[kk], dv);
        wgmma_rs<D, 1>(dV, pa[kk], desc_mn(dOs, L::Q_CHUNK, kk), 1);
        wgmma_rs<D, 1>(dK, dsa[kk], desc_mn(Qs, L::Q_CHUNK, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dK);
      fence_regs(dV);
    }
    if (lane == 0) mbar_arrive(&empty[pos.stage]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = c0 + 8 * hr;
    if (c >= Skv) continue;
    __nv_bfloat16* krow =
        dk + b * st.s[12] + (long long)c * st.s[13] + kh * st.s[14];
    __nv_bfloat16* vrow =
        dv + b * st.s[15] + (long long)c * st.s[16] + kh * st.s[17];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n + t2) = bf16x2(
          dK[4 * n + 2 * hr] * scale, dK[4 * n + 2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n + t2) =
          bf16x2(dV[4 * n + 2 * hr], dV[4 * n + 2 * hr + 1]);
    }
  }
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  constexpr int STAGES = 2;
  using L = DkvLayout<D, STAGES>;
  const long long* s = a.st.s;
  CUtensorMap tq, tk, tv, tdo;
  if ((a.Skv + WS_BK - 1) / WS_BK > 65535 ||
      !make_map(&tq, a.q, D, a.Sq, a.H, a.B, s[0], s[1], s[2], WS_BQ) ||
      !make_map(&tk, a.k, D, a.Skv, a.KH, a.B, s[3], s[4], s[5], WS_BK) ||
      !make_map(&tv, a.v, D, a.Skv, a.KH, a.B, s[6], s[7], s[8], WS_BK) ||
      !make_map(&tdo, a.dO, D, a.Sq, a.H, a.B, s[9], s[10], s[11], WS_BQ))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, STAGES>;
  int err = configure(kernel, L::BYTES);
  if (err) return err;
  const dim3 grid(a.KH, a.B, (a.Skv + WS_BK - 1) / WS_BK);
  kernel<<<grid, WS_THREADS, L::BYTES, a.stream>>>(
      tq, tk, tv, tdo, a.m, a.l, a.delta, (__nv_bfloat16*)a.d0,
      (__nv_bfloat16*)a.d1, a.H, a.KH, a.Sq, a.Skv, a.st, a.causal, a.window,
      a.scale, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dQ, D in {64, 128}: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WS_DQ_BM = 128;      // query rows per block, 64 per consumer
constexpr int WS_DQ_BN = 64;       // keys per ring slot

// Shared memory of dQ: Q and dO of the block's rows (resident), then
// STAGES slots of (K, V) tiles, each tile as D / 64 swizzled chunks; the
// mbarriers.
template <int D, int STAGES>
struct DqLayout {
  static constexpr int NC = D / 64;
  static constexpr int Q_CHUNK = WS_DQ_BM * 128;
  static constexpr int Q_BYTES = NC * Q_CHUNK;       // one of Q or dO
  static constexpr int KV_CHUNK = WS_DQ_BN * 128;
  static constexpr int KV_BYTES = NC * KV_CHUNK;     // one of K or V
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int BAR = RING + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + SMEM_ALIGN;
};

// One block per (h, b, 128-row q tile), heaviest (highest) q tiles first:
// dK/dV's kernel with the roles of queries and keys swapped.  Warpgroups 0
// and 1 own rows 64 wg .. 64 wg + 63 of the tile, hold their m log2 e,
// 1 / l and delta in registers and their dQ in f32 registers; warpgroup
// 2's first thread loads Q and dO once by TMA, then streams the K and V
// tiles of 64 keys of the band through a ring of STAGES slots (full: the
// bytes landed; empty: every consumer warp is done reading).
template <int D, int STAGES>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int H, int KH,
                          int Sq, int Skv, const Strides st, int causal,
                          int window, float scale, float scale_log2) {
  using L = DqLayout<D, STAGES>;
  uint8_t* smem = aligned_smem();
  uint8_t* Qs = smem;
  uint8_t* dOs = smem + L::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WS_DQ_BM;
  const int kh = h / (H / KH);
  const int q_off = Skv - Sq;
  // The KV tiles whose keys some row of this block sees.
  int key_lo = 0, key_hi = Skv - 1;
  if (window >= 0) key_lo = max(key_lo, q0 + q_off - window + 1);
  if (causal) key_hi = min(key_hi, min(q0 + WS_DQ_BM, Sq) - 1 + q_off);
  const int kt_lo = key_lo / WS_DQ_BN;
  const int kt_end = key_hi >= key_lo ? key_hi / WS_DQ_BN + 1 : kt_lo;

  if (threadIdx.x == 0) ring_init<STAGES>(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 256 && kt_end > kt_lo) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int c = 0; c < L::NC; ++c) {
        tma_load(Qs + c * L::Q_CHUNK, &tq, q_full, 64 * c, q0, h, b);
        tma_load(dOs + c * L::Q_CHUNK, &tdo, q_full, 64 * c, q0, h, b);
      }
      RingPos<STAGES> pos;
      for (int kt = kt_lo; kt < kt_end; ++kt, pos.next()) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        uint8_t* Ks = smem + L::RING + pos.stage * 2 * L::KV_BYTES;
        uint8_t* Vs = Ks + L::KV_BYTES;
        uint64_t* bar = &full[pos.stage];
        mbar_expect_tx(bar, 2 * L::KV_BYTES);
        for (int c = 0; c < L::NC; ++c) {
          tma_load(Ks + c * L::KV_CHUNK, &tk, bar, 64 * c, kt * WS_DQ_BN, kh,
                   b);
          tma_load(Vs + c * L::KV_CHUNK, &tv, bar, 64 * c, kt * WS_DQ_BN, kh,
                   b);
        }
      }
    }
    return;
  }

  // Consumers: rows r0 and r0 + 8 of this thread's accumulator rows.
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;               // this warpgroup's first row
  const int r0 = qw + warp * 16 + lane / 4;
  const int t2 = 2 * (lane % 4);
  const long long base = ((long long)b * H + h) * Sq;

  // m log2 e and 1 / l (both 0 where l = 0 or past Sq) and delta.
  float mr[2], il[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    mr[hr] = il[hr] = dl[hr] = 0.f;
    if (r < Sq) {
      const float lv = l[base + r];
      if (lv > 0.f) {
        mr[hr] = m[base + r] * LOG2E;
        il[hr] = 1.f / lv;
      }
      dl[hr] = delta[base + r];
    }
  }
  // The keys [klo, khi] each of the thread's rows sees (the forward's
  // masks as bounds: a per-element visible() here, whose row tests do not
  // change over the loop, made ptxas branch around the products).
  int klo[2], khi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ra = r0 + 8 * hr + q_off;
    khi[hr] = causal ? min(ra, Skv - 1) : Skv - 1;
    klo[hr] = window >= 0 ? ra - window + 1 : 0;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (kt_end > kt_lo) mbar_wait(q_full, 0);
  RingPos<STAGES> pos;
  for (int kt = kt_lo; kt < kt_end; ++kt, pos.next()) {
    const int k0 = kt * WS_DQ_BN;
    mbar_wait(&full[pos.stage], pos.phase);
    const uint8_t* Ks = smem + L::RING + pos.stage * 2 * L::KV_BYTES;
    const uint8_t* Vs = Ks + L::KV_BYTES;
    // Every tile of the band, also where this warpgroup's rows see none of
    // its keys (the mask zeroes P there): skipping those made ptxas
    // serialise the products (C7520).
    float s[32], dp[32];
    issue_sdp<D>(s, dp, Qs, dOs, L::Q_CHUNK, 64 * wg, Ks, Vs,
                 L::KV_CHUNK);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // 16 keys at a time: P = exp2(S scale log2 e - m log2 e) / l and
    // dS = P (dP - delta) in f32, masked on edge tiles (rows past Sq
    // have 1 / l = 0 and a zero Q row, so P = 0 there without a mask),
    // rounded to bf16 as A operands straight from the accumulators, and
    // at once dQ += dS K with K MN-major, all one group.
    const bool interior = sees_all(k0, qw, Skv, q_off, causal, window);
    uint32_t dsa[WS_DQ_BN / 16][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WS_DQ_BN / 16; ++kk) {
      float ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 8 * kk + e;
        const int hr = (j >> 1) & 1;
        const int c = k0 + 8 * (j >> 2) + t2 + (j & 1);
        float p = fast_exp2(s[j] * scale_log2 - mr[hr]) * il[hr];
        if (!interior && (c < klo[hr] || c > khi[hr])) p = 0.f;
        ds[e] = p * (dp[j] - dl[hr]);
      }
      a_pack(dsa[kk], ds);
      wgmma_rs<D, 1>(acc, dsa[kk], desc_mn(Ks, L::KV_CHUNK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[pos.stage]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= Sq) continue;
    __nv_bfloat16* row =
        dq + b * st.s[12] + (long long)r * st.s[13] + h * st.s[14];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n + t2) =
          bf16x2(acc[4 * n + 2 * hr] * scale, acc[4 * n + 2 * hr + 1] * scale);
  }
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  constexpr int STAGES = 2;
  using L = DqLayout<D, STAGES>;
  const long long* s = a.st.s;
  CUtensorMap tq, tk, tv, tdo;
  if ((a.Sq + WS_DQ_BM - 1) / WS_DQ_BM > 65535 ||
      !make_map(&tq, a.q, D, a.Sq, a.H, a.B, s[0], s[1], s[2], WS_DQ_BM) ||
      !make_map(&tk, a.k, D, a.Skv, a.KH, a.B, s[3], s[4], s[5], WS_DQ_BN) ||
      !make_map(&tv, a.v, D, a.Skv, a.KH, a.B, s[6], s[7], s[8], WS_DQ_BN) ||
      !make_map(&tdo, a.dO, D, a.Sq, a.H, a.B, s[9], s[10], s[11], WS_DQ_BM))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, STAGES>;
  int err = configure(kernel, L::BYTES);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.Sq + WS_DQ_BM - 1) / WS_DQ_BM);
  kernel<<<grid, WS_THREADS, L::BYTES, a.stream>>>(
      tq, tk, tv, tdo, a.m, a.l, a.delta, (__nv_bfloat16*)a.d0, a.H, a.KH,
      a.Sq, a.Skv, a.st, a.causal, a.window, a.scale, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_f32(const Args& a, bool dkv) {
  const size_t tiles = (size_t)4 * 64 * (a.D + 4) * sizeof(float);
  if (!dkv) {
    const size_t smem = tiles + (size_t)BK * LDP * sizeof(float);
    int err = configure(flash_bwd_dq_f32_kernel<NG>, smem);
    if (err) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_f32_kernel<NG><<<grid, THREADS, smem, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.m, a.l, a.delta, (float*)a.d0, a.H, a.KH,
        a.Sq, a.Skv, a.D, a.st, a.causal, a.window, a.scale);
  } else {
    const size_t smem =
        tiles + (size_t)(2 * BK * LDP + 3 * BQ) * sizeof(float);
    int err = configure(flash_bwd_dkv_f32_kernel<NG>, smem);
    if (err) return err;
    const dim3 grid((a.Skv + BK - 1) / BK, a.KH, a.B);
    flash_bwd_dkv_f32_kernel<NG><<<grid, THREADS, smem, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.m, a.l, a.delta, (float*)a.d0, (float*)a.d1,
        a.H, a.KH, a.Sq, a.Skv, a.D, a.st, a.causal, a.window, a.scale);
  }
  return (int)cudaGetLastError();
}

// route: 0 = f32 on CUDA cores, 1 = bf16 mma.sync (any D), 2 = bf16
// wgmma (D 64 or 128).
int launch(const Args& a, int route, bool dkv) {
  if (a.D % 16 != 0 || a.D < 16 || a.D > MAX_D || a.KH <= 0 ||
      a.H % a.KH != 0 || a.H > 65535 || a.KH > 65535 || a.B > 65535 ||
      a.Sq <= 0 || a.Skv <= 0)
    return (int)cudaErrorInvalidValue;
  if (route == 1) return launch_mma_d<16>(a, dkv);
  if (route == 2 && a.D == 64)
    return dkv ? launch_dkv_wgmma<64>(a) : launch_dq_wgmma<64>(a);
  if (route == 2 && a.D == 128)
    return dkv ? launch_dkv_wgmma<128>(a) : launch_dq_wgmma<128>(a);
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch ((a.D + 63) / 64) {
    case 1: return launch_f32<1>(a, dkv);
    case 2: return launch_f32<2>(a, dkv);
    case 3: return launch_f32<3>(a, dkv);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// route: as launch() above.  `strides` points to host memory holding the
// (batch, seq, head) element strides of q, k, v, dO and dq in turn (15
// values); the head dim is contiguous.  m, l and delta are f32 [B, H, Sq].
// window < 0 means no window.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const void* m, const void* l, const void* delta, void* dq, int route,
    int B, int H, int KH, int Sq, int Skv, int D, const long long* strides,
    int causal, int window, float scale, void* stream) {
  Strides st{};
  for (int i = 0; i < 15; ++i) st.s[i] = strides[i];
  const Args a{q, k, v, dO, (const float*)m, (const float*)l,
               (const float*)delta, dq, nullptr, B, H, KH, Sq, Skv, D,
               st, causal, window, scale, (cudaStream_t)stream};
  return launch(a, route, false);
}

// As above, with the strides of q, k, v, dO, dk and dv (18 values); dk and
// dv are [B, KH, Skv, D]-shaped in k's layout, summed over the query-head
// group.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const void* m, const void* l, const void* delta, void* dk, void* dv,
    int route, int B, int H, int KH, int Sq, int Skv, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  Strides st{};
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
  const Args a{q, k, v, dO, (const float*)m, (const float*)l,
               (const float*)delta, dk, dv, B, H, KH, Sq, Skv, D,
               st, causal, window, scale, (cudaStream_t)stream};
  return launch(a, route, true);
}
