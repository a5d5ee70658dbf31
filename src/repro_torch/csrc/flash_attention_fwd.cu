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
// The masks, tiles and mma/ldmatrix/cp.async helpers live in
// flash_attention_common.cuh, shared with the backward kernels.
//
// Built by nvcc into a shared library with a plain C interface
// (src/repro_torch/kernels/_build.py) and called through ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.

#include "flash_attention_common.cuh"

namespace {

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
    tile_dots(s, Qs, Ks, D, ld, tx, ty);

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
    tile_pv<NG>(acc, Ps, Vs, D, ld, tx, ty);
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

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    mma_rows_dot<D>(s, Qs, Ks, wrow, li, lj);

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
    // the A fragment of keys [16 kk, 16 kk + 16), rounded to bf16; V's B
    // fragments come transposed by ldmatrix.
    mma_acc_pv<D>(acc, s, Vs, li, lj);
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
