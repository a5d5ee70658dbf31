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
// 0.26 GB of q/k/v/o, so it is bound by operations (0.398 ms at the tensor
// cores' 989 TFLOP/s bf16, H100 SXM data sheet), not bytes (0.08 ms).
//
// What the design does about it.  The TPU kernel's sequential kv grid
// dimension becomes a loop inside the block, and nothing but q, k, v and
// the outputs touches device memory.  Three routes, picked by
// kernel.route() from the dtype and head dim:
//  * wgmma (bf16, D 64 and 128; the main path): one block per (h, b,
//    128-row q tile), heaviest q tiles first, three warpgroups.  The
//    producer warpgroup gives up its registers (setmaxnreg) and one thread
//    issues TMA loads: Q once, then K and V tiles of 128 keys through a
//    two-slot ring of 128-byte-swizzled shared memory guarded by full and
//    empty mbarriers, so the next tile lands while this one is computed.
//    Each of the two consumer warpgroups owns 64 rows: S = Q K^T by wgmma
//    from shared memory, the online softmax in base 2 (scores times
//    scale log2 e, exp2) in the accumulator's registers, masks only on
//    tiles that the causal diagonal, the window edge or a ragged tail
//    crosses, then O += P V by wgmma with P as the register A operand
//    (rounded to bf16; l sums P in f32) and V read MN-major from shared
//    memory.  m leaves in natural-log units, -1e30 (and l = 0) for a row
//    that sees no key.  TMA zero-fills the ragged tails.
//  * mma (bf16, every other D): the first version, one block per (b, h,
//    64-row q tile), mma.sync m16n8k16 fed by ldmatrix from tiles copied
//    by one cp.async stage.
//  * f32 on CUDA-core FMAs (a 4 x 4 register tile per thread for Q K^T,
//    4 x 4 columns per 64-column group for P V), exact to f32.
// Tiles of the mma and f32 routes, the masks and the mma/ldmatrix/cp.async
// helpers live in flash_attention_common.cuh, shared with the backward
// kernels; the TMA, mbarrier, wgmma and setmaxnreg helpers in
// hopper_wgmma.cuh.
//
// Built by nvcc into a shared library with a plain C interface
// (src/repro_torch/kernels/_build.py) and called through ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.

#include "flash_attention_common.cuh"
#include "hopper_wgmma.cuh"

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
// bf16, any D: tensor cores through mma.sync.m16n8k16 (f32 accumulation)
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
  const int err = configure(flash_fwd_mma_kernel<D>, smem);
  if (err) return err;
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

// ---------------------------------------------------------------------------
// bf16, D in {64, 128}: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WS_BM = 128;         // query rows per block, 64 per consumer
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of the forward: the q tile, then STAGES (K, V) tiles of BN
// keys, each as D / 64 swizzled chunks; then the mbarriers.
template <int D, int BN, int STAGES>
struct FwdLayout {
  static constexpr int NC = D / 64;
  static constexpr int Q_CHUNK = WS_BM * 128;
  static constexpr int KV_CHUNK = BN * 128;
  static constexpr int Q_BYTES = NC * Q_CHUNK;
  static constexpr int KV_BYTES = NC * KV_CHUNK;     // one of K or V
  static constexpr int BAR = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + SMEM_ALIGN;
};

// The keys [lo, hi] that rows [r0, r1] see (suffix-aligned masks); empty
// when hi < lo.
__device__ __forceinline__ void band_keys(int r0, int r1, int Sq, int Skv,
                                          int causal, int window, int& lo,
                                          int& hi) {
  const int q_off = Skv - Sq;
  lo = 0;
  hi = Skv - 1;
  if (window >= 0) lo = max(lo, r0 + q_off - window + 1);
  if (causal) hi = min(hi, r1 + q_off);
}

// One block per (h, b, 128-row q tile), heaviest tiles first.  Warpgroups
// 0 and 1 own rows 64 wg .. 64 wg + 63 of the tile; warpgroup 2's first
// thread issues the TMA loads: Q once, then K and V of each tile of the
// band through a ring of STAGES slots (full: the bytes landed; empty:
// every consumer warp is done reading).
template <int D, int BN, int STAGES>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int H, int KH, int Sq, int Skv, long long o_sb,
                       long long o_ss, long long o_sh, int causal,
                       int window, float scale_log2) {
  using L = FwdLayout<D, BN, STAGES>;
  uint8_t* smem = aligned_smem();
  uint8_t* Qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WS_BM;
  const int kh = h / (H / KH);
  int key_lo, key_hi;
  band_keys(q0, min(q0 + WS_BM, Sq) - 1, Sq, Skv, causal, window, key_lo,
            key_hi);
  const int kt_lo = key_lo / BN;
  const int kt_end = key_hi >= key_lo ? key_hi / BN + 1 : kt_lo;

  if (threadIdx.x == 0) ring_init<STAGES>(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every load.
    reg_dealloc<24>();
    if (threadIdx.x == 256 && kt_end > kt_lo) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < L::NC; ++c)
        tma_load(Qs + c * L::Q_CHUNK, &tq, q_full, 64 * c, q0, h, b);
      RingPos<STAGES> pos;
      for (int kt = kt_lo; kt < kt_end; ++kt, pos.next()) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        uint8_t* Ks = smem + L::Q_BYTES + pos.stage * 2 * L::KV_BYTES;
        uint8_t* Vs = Ks + L::KV_BYTES;
        uint64_t* bar = &full[pos.stage];
        mbar_expect_tx(bar, 2 * L::KV_BYTES);
        for (int c = 0; c < L::NC; ++c) {
          tma_load(Ks + c * L::KV_CHUNK, &tk, bar, 64 * c, kt * BN, kh, b);
          tma_load(Vs + c * L::KV_CHUNK, &tv, bar, 64 * c, kt * BN, kh, b);
        }
      }
    }
    return;
  }

  // Consumers.
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;               // this warpgroup's first row
  const int r0 = qw + warp * 16 + lane / 4;  // rows r0 and r0 + 8
  const int t2 = 2 * (lane % 4);
  const int q_off = Skv - Sq;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // Running max of the scaled scores in base-2 units, and this thread's
  // share of the row sums (the quad's four shares are summed at the end).
  float mx[2] = {-INFINITY, -INFINITY};
  float ls[2] = {0.f, 0.f};

  if (kt_end > kt_lo) mbar_wait(q_full, 0);
  RingPos<STAGES> pos;
  int prev = 0;
  for (int kt = kt_lo; kt < kt_end; ++kt, pos.next()) {
    const int k0 = kt * BN;
    mbar_wait(&full[pos.stage], pos.phase);
    const uint8_t* Ks = smem + L::Q_BYTES + pos.stage * 2 * L::KV_BYTES;
    const uint8_t* Vs = Ks + L::KV_BYTES;
    // Whether every (row, key) of this warpgroup's rows and the tile is
    // visible (rows past Sq are never stored, so they need no mask).
    const bool interior =
        k0 + BN <= Skv && (!causal || k0 + BN - 1 <= qw + q_off) &&
        (window < 0 || k0 > qw + 63 + q_off - window);

    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, 0>(s, desc_k(Qs, L::Q_CHUNK, 64 * wg, kk),
                      desc_k(Ks, L::KV_CHUNK, 0, kk), kk > 0);
    wgmma_commit();
    // The previous tile's P V ran behind this S: once it is done, its
    // slot goes back to the producer.
    if (kt > kt_lo) {
      wgmma_wait<1>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    wgmma_wait<0>();
    fence_regs(s);

    // Scores in base-2 units; masks on edge tiles only.
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] *= scale_log2;
    if (!interior) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const int r = r0 + 8 * ((j >> 1) & 1);
        const int c = k0 + 8 * (j >> 2) + t2 + (j & 1);
        if (!visible(r, c, Sq, Skv, causal, window)) s[j] = -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = mx[hr];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        m = fmaxf(m, fmaxf(s[4 * n + 2 * hr], s[4 * n + 2 * hr + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // A row that has seen no key yet keeps -inf and reads p = 0.
      const float base = m == -INFINITY ? 0.f : m;
      corr[hr] = fast_exp2(mx[hr] - base);
      mx[hr] = m;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * hr + e];
          x = fast_exp2(x - base);
          sum += x;
        }
      ls[hr] = ls[hr] * corr[hr] + sum;
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];

    // O += P V: P from registers, rounded to bf16; V MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a_frag(a, s, kk);
      wgmma_rs<D, 1>(acc, a, desc_mn(Vs, L::KV_CHUNK, kk), 1);
    }
    wgmma_commit();
    prev = pos.stage;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // out = acc / l (rows that saw no key read 0); m back in natural-log
  // units (-1e30 and l = 0 for a row that saw no key, as the plain
  // version leaves them).
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = ls[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * hr;
    if (r >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 1.f;
    __nv_bfloat16* orow = o + b * o_sb + (long long)r * o_ss + h * o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + t2) = bf16x2(
          acc[4 * n + 2 * hr] * inv, acc[4 * n + 2 * hr + 1] * inv);
    if (lane % 4 == 0) {
      const long long row = ((long long)b * H + h) * Sq + r;
      m_out[row] = mx[hr] == -INFINITY ? NEG_INF : mx[hr] * LN2;
      l_out[row] = l;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* m, void* l, int B, int H, int KH, int Sq, int Skv,
                 const long long* st, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr int BN = 128, STAGES = 2;
  using L = FwdLayout<D, BN, STAGES>;
  CUtensorMap tq, tk, tv;
  if ((Sq + WS_BM - 1) / WS_BM > 65535 || !make_map(&tq, q, D, Sq, H, B, st[0], st[1], st[2], WS_BM) ||
      !make_map(&tk, k, D, Skv, KH, B, st[3], st[4], st[5], BN) ||
      !make_map(&tv, v, D, Skv, KH, B, st[6], st[7], st[8], BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D, BN, STAGES>;
  const int err = configure(kernel, L::BYTES);
  if (err) return err;
  const dim3 grid(H, B, (Sq + WS_BM - 1) / WS_BM);
  kernel<<<grid, WS_THREADS, L::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), H, KH, Sq, Skv, st[9], st[10], st[11], causal,
      window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* m,
               void* l, int B, int H, int KH, int Sq, int Skv, int D,
               const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * 64 * (D + 4) + BQ * LDP) * sizeof(float);
  const int err = configure(flash_fwd_f32_kernel<NG>, smem);
  if (err) return err;
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

// route: 0 = f32 on CUDA cores, 1 = bf16 mma.sync (any D), 2 = bf16
// wgmma (D 64 or 128).  Strides are in elements, (batch, seq, head) for q,
// k, v and o in turn; the head dim is contiguous.  window < 0 means no
// window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int route, int B, int H, int KH, int Sq, int Skv, int D,
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
  if (route == 0)
    return launch_f32_d(D, q, k, v, o, m, l, B, H, KH, Sq, Skv, st, causal,
                        window, scale, s);
  if (route == 1)
    return launch_mma_d<16>(D, q, k, v, o, m, l, B, H, KH, Sq, Skv, st,
                            causal, window, scale, s);
  if (route == 2 && D == 64)
    return launch_wgmma<64>(q, k, v, o, m, l, B, H, KH, Sq, Skv, st, causal,
                            window, scale, s);
  if (route == 2 && D == 128)
    return launch_wgmma<128>(q, k, v, o, m, l, B, H, KH, Sq, Skv, st,
                             causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
