// Sorted segment combine (sum / max / min) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_combine/kernel.py::segment_combine_pallas
// (body `_kernel`), the combine under every Pregel connector.
//
// Computes, for values[E, F] (f32 or bf16), segment_ids int32[E] and an
// optional edge_active bool[E]:
//   out[s, f] = op over {rows r : ids[r] == s, active[r]} of values[r, f]
// accumulated in f32 and cast back to the payload type.  A row is *valid*
// when it is active and 0 <= id < n; other rows are dropped.  Valid ids are
// non-decreasing in row order; invalid rows may sit anywhere (padding at
// either end, inactive rows in the middle).  max/min start from -1e30 /
// +1e30 and a result equal to that identity reads 0, as on the TPU.
//
// Bound: memory.  The combine reads E*(4F + 4 + 1) bytes (values, ids, the
// active byte) and writes n*4F; it does E*F operations, far below the card's
// rate.  At 3.35 TB/s that is the floor the kernel is held against.
//
// Design: deterministic sorted segmented reduction, no float atomics.  Rows
// go in chunks of 1024 (one edge block), 4 consecutive rows a thread;
// output segments in tiles of min(8192 / F, 1024).  A tile whose rows span
// more than K = kPieceChunks = 8 chunks (8192 rows) is cut into pieces of
// at most K chunks, one block each, so a hub segment (3.25e6 rows, 3,176
// chunks, on the PageRank graph) is spread over the card instead of walked
// by one block.
//   pass 1  one block per edge block writes the largest valid id in it
//           (-1 for none): blocks wholly inactive or wholly below a tile
//           are skipped later, as the TPU kernel's active bitmap does.
//   pass 2  a scan turns those into running maxima (within groups of 1024
//           edge blocks, then over the groups), which are monotone even
//           where blocks are empty, so a binary search finds each tile's
//           first and last edge block b0, b1.  (The ids themselves cannot
//           be searched: invalid rows break their order.)
//   pass 3  one thread per tile: b0, b1 and the piece count p =
//           ceil((b1 - b0 + 1) / K) (1 when it fits in K chunks), and a
//   pass 4  scan of the counts (within groups of 1024 tiles, then over the
//           groups): each tile's first piece, its first scratch slot
//           (split tiles only) and the piece -> tile map.
//   pass 5  one block per piece walks its chunks in row order.  Each chunk
//           gives every row the key of the last valid row at or before it
//           (a max-scan in the thread, over the lanes, over the warps, and
//           carried across the chunks of the piece), so keys are
//           non-decreasing and invalid rows carry the identity inside a
//           run.  A thread folds its own rows' runs in row order; a
//           segmented scan in a fixed warp-shuffle tree folds the threads'
//           last runs over the lanes, and the run's last row folds in the
//           lanes before it, then the tails of earlier warps, then adds
//           the total into the piece's accumulator in shared memory.  The
//           next chunk's ids, flags and first payload column are loaded
//           while this one folds, and a chunk costs one barrier for its
//           keys and one per payload column (double-buffered summaries).
//           A piece of an unsplit tile writes the tile; a piece of a split
//           tile writes its whole accumulator to its scratch slot.
//   pass 6  (split tiles) a grid-stride loop over (tile, 256 elements)
//           folds each split tile's slots in piece order, a fixed chain,
//           and writes the tile once.
// The order of every addition is fixed, so two launches give
// bit-identical output.  Summation depth of a term of a segment whose
// valid rows lie in c chunks and p pieces: at most 16 in its chunk (3 in
// the thread, 5 warp-scan levels, 1 for the lanes before, up to 7 earlier
// warps' tails), at most min(c, K) chunk totals into its piece's
// accumulator, and p - 1 folds of the pieces: 16 + min(c, K) + p - 1
// (kernels/segment_combine/kernel.py::sum_depth).
// Scratch (sized by segment_combine_scratch_bytes from E, n, F and K
// alone, no host sync): about 4 (2 nb + 5 tiles + (nb - 1) / K) bytes of
// ints and floor(2 (nb - 1) / K) slots of tile_n * F floats, nb =
// ceil(E / 1024): a split tile spans c > K chunks in ceil(c / K) <=
// 2 (c - 1) / K pieces, and the tiles' c - 1 sum to at most nb - 1.  The
// slots hold at most a quarter of the values' bytes (E bytes at F = 1).
// Not done: rows staged through shared memory by cp.async / TMA,
// vectorised loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                       // consecutive rows a thread
constexpr int kChunkRows = kThreads * kRows;   // rows a chunk (edge block)
constexpr int kScanThreads = 1024;
constexpr int kAccFloats = 8192;   // 32 KB of shared accumulator per tile
constexpr int kPieceChunks = 8;    // K: chunks a piece folds at most
constexpr int kFoldBlocks = 1024;  // grid of pass 6
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMax = 1, kMin = 2 };

__device__ __forceinline__ float identity_of(int op) {
  return op == kSum ? 0.0f : (op == kMax ? -1e30f : 1e30f);
}

__device__ __forceinline__ float fold(int op, float a, float b) {
  return op == kSum ? a + b : (op == kMax ? fmaxf(a, b) : fminf(a, b));
}

__device__ __forceinline__ float load_value(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_value(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_value(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_value(__nv_bfloat16* p, long long i,
                                            float v) {
  p[i] = __float2bfloat16(v);
}

// The row's segment id when the row is valid, else -1.
__device__ __forceinline__ int row_key(const int* ids, const uint8_t* active,
                                       long long r, long long E, int n) {
  if (r >= E) return -1;
  const int id = ids[r];
  if (id < 0 || id >= n) return -1;
  if (active != nullptr && active[r] == 0) return -1;
  return id;
}

// First index i in [0, nb) with a[i] >= x, or nb.
__device__ __forceinline__ int lower_bound(const int* a, int nb, int x) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 1: the largest valid id of each edge block (one a CTA, kRows rows
// a thread, kRows loads in flight).
__global__ void __launch_bounds__(kThreads)
block_max_kernel(const int* __restrict__ ids,
                 const uint8_t* __restrict__ active, long long E, int n,
                 int* __restrict__ blk_max) {
  __shared__ int s_max[kWarps];
  const long long r0 = (long long)blockIdx.x * kChunkRows + threadIdx.x;
  int k[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    k[i] = row_key(ids, active, r0 + i * kThreads, E, n);
  int m = k[0];
#pragma unroll
  for (int i = 1; i < kRows; ++i) m = max(m, k[i]);
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(kFull, m, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, s_max[w]);
    blk_max[blockIdx.x] = m;
  }
}

// Pass 2, in three steps: the running maximum of blk_max within each group
// of kScanThreads edge blocks, and the group's maximum; the running maximum
// over the groups (one block); each group's carry folded in.
__global__ void __launch_bounds__(kScanThreads)
group_scan_kernel(const int* __restrict__ blk_max, int nb,
                  int* __restrict__ pref, int* __restrict__ gmax) {
  __shared__ int s_w[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  int v = i < nb ? blk_max[i] : -1;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) s_w[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_w[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = max(w, y);
    }
    s_w[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, s_w[warp - 1]);
  if (i < nb) pref[i] = v;
  if (threadIdx.x == kScanThreads - 1) gmax[blockIdx.x] = v;
}

// gmax[g] becomes the running maximum of the groups before g (-1 for none).
__global__ void __launch_bounds__(kScanThreads)
group_carry_kernel(int* __restrict__ gmax, int ng) {
  __shared__ int s[kScanThreads];
  const int t = threadIdx.x;
  const int per = (ng + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, ng), hi = min(lo + per, ng);
  int m = -1;
  for (int i = lo; i < hi; ++i) m = max(m, gmax[i]);
  s[t] = m;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int v = t >= o ? s[t - o] : -1;
    __syncthreads();
    s[t] = max(s[t], v);
    __syncthreads();
  }
  int run = t > 0 ? s[t - 1] : -1;
  for (int i = lo; i < hi; ++i) {
    const int g = gmax[i];
    gmax[i] = run;
    run = max(run, g);
  }
}

__global__ void __launch_bounds__(kScanThreads)
group_fix_kernel(const int* __restrict__ carry, int nb,
                 int* __restrict__ pref) {
  const int i = (blockIdx.x + 1) * kScanThreads + threadIdx.x;
  if (i < nb) pref[i] = max(pref[i], carry[blockIdx.x + 1]);
}

// Passes 3 and 4, in three steps.  Each tile's first and last edge block
// and its piece count p (split = 0: one piece a tile, however long), and,
// within each group of kScanThreads tiles, the exclusive sums of p and of
// the split tiles' p, with the group's totals in gsum; then the exclusive
// sums over the groups (one block), the total pieces into start[tiles];
// then each group's carry added and the piece -> tile map written.
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const int* __restrict__ pref, int nb, int n, int tile_n,
                 int tiles, int split, int* __restrict__ tb0,
                 int* __restrict__ tb1, int* __restrict__ cnt,
                 int* __restrict__ start, int* __restrict__ slot,
                 int* __restrict__ gsum) {
  __shared__ int s_a[kScanThreads / 32];
  __shared__ int s_b[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kScanThreads + threadIdx.x;
  int p = 0;
  if (t < tiles) {
    const int lo = t * tile_n;
    const int hi = (int)min((long long)lo + tile_n, (long long)n);
    const int b0 = lower_bound(pref, nb, lo);
    const int b1 = min(lower_bound(pref, nb, hi), nb - 1);
    const int c = b1 - b0 + 1;
    p = split > 0 && c > split ? (c + split - 1) / split : 1;
    tb0[t] = b0;
    tb1[t] = b1;
    cnt[t] = p;
  }
  int a = p, b = p > 1 ? p : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(kFull, a, o);
    const int yb = __shfl_up_sync(kFull, b, o);
    if (lane >= o) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 31) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = s_a[lane], wb = s_b[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(kFull, wa, o);
      const int yb = __shfl_up_sync(kFull, wb, o);
      if (lane >= o) {
        wa += ya;
        wb += yb;
      }
    }
    s_a[lane] = wa;
    s_b[lane] = wb;
  }
  __syncthreads();
  if (warp > 0) {
    a += s_a[warp - 1];
    b += s_b[warp - 1];
  }
  if (t < tiles) {
    start[t] = a - p;
    slot[t] = b - (p > 1 ? p : 0);
  }
  if (threadIdx.x == kScanThreads - 1) {
    gsum[2 * blockIdx.x] = a;
    gsum[2 * blockIdx.x + 1] = b;
  }
}

__global__ void __launch_bounds__(kScanThreads)
tile_carry_kernel(int* __restrict__ gsum, int groups, int tiles,
                  int* __restrict__ start) {
  __shared__ int s_a[kScanThreads];
  __shared__ int s_b[kScanThreads];
  const int t = threadIdx.x;
  const int per = (groups + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, groups), hi = min(lo + per, groups);
  int a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    a += gsum[2 * i];
    b += gsum[2 * i + 1];
  }
  s_a[t] = a;
  s_b[t] = b;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int va = t >= o ? s_a[t - o] : 0;
    const int vb = t >= o ? s_b[t - o] : 0;
    __syncthreads();
    s_a[t] += va;
    s_b[t] += vb;
    __syncthreads();
  }
  int ra = t > 0 ? s_a[t - 1] : 0;
  int rb = t > 0 ? s_b[t - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int ga = gsum[2 * i], gb = gsum[2 * i + 1];
    gsum[2 * i] = ra;
    gsum[2 * i + 1] = rb;
    ra += ga;
    rb += gb;
  }
  if (t == kScanThreads - 1) start[tiles] = ra;
}

__global__ void __launch_bounds__(kScanThreads)
tile_fix_kernel(const int* __restrict__ cnt, const int* __restrict__ gsum,
                int tiles, int* __restrict__ start, int* __restrict__ slot,
                int* __restrict__ piece_tile) {
  const int t = blockIdx.x * kScanThreads + threadIdx.x;
  if (t >= tiles) return;
  const int s0 = start[t] + gsum[2 * blockIdx.x];
  start[t] = s0;
  slot[t] += gsum[2 * blockIdx.x + 1];
  const int p = cnt[t];
  for (int j = 0; j < p; ++j) piece_tile[s0 + j] = t;
}

// Pass 5: one block per piece (see the header).  Thread tid holds rows
// 4 tid .. 4 tid + 3 of each chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ values, const int* __restrict__ ids,
               const uint8_t* __restrict__ active,
               const int* __restrict__ blk_max, const int* __restrict__ tb0,
               const int* __restrict__ tb1, const int* __restrict__ cnt,
               const int* __restrict__ start, const int* __restrict__ slot,
               const int* __restrict__ piece_tile, float* __restrict__ part,
               long long E, int F, int n, int tile_n, int tiles, int split,
               int op, T* __restrict__ out) {
  extern __shared__ float acc[];  // [tile_n, F]
  // Double-buffered by chunk: each warp's inclusive max of the raw keys,
  // and the raw key of its first row.
  __shared__ int s_last[2][kWarps];
  __shared__ int s_first[2][kWarps];
  // The same with the carry: each warp's last and first key.
  __shared__ int s_wlast[2][kWarps];
  __shared__ int s_wfirst[2][kWarps];
  // Double-buffered by payload column: each warp's scan value at lane 31.
  __shared__ float s_tail[2][kWarps];

  if (blockIdx.x >= start[tiles]) return;  // spare block of the grid bound
  const int t = piece_tile[blockIdx.x];
  const int j = blockIdx.x - start[t];
  const int p = cnt[t];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_lo = t * tile_n;
  const int tile_hi = (int)min((long long)tile_lo + tile_n, (long long)n);
  const int width = tile_hi - tile_lo;
  const float ident = identity_of(op);

  for (int i = tid; i < width * F; i += kThreads) acc[i] = ident;
  int lo = tb0[t], hi = tb1[t];
  if (p > 1) {
    lo += j * split;
    hi = min(hi, lo + split - 1);
  }
  // The next chunk's ids, flags and first payload column, loaded with no
  // test of the row (an invalid row's value is never used).
  int id_n[kRows];
  uint8_t act_n[kRows];
  float v_n[kRows];
  auto prefetch = [&](long long r0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long r = r0 + i;
      id_n[i] = -1;
      act_n[i] = 1;
      if (r < E) {
        id_n[i] = ids[r];
        if (active != nullptr) act_n[i] = active[r];
        v_n[i] = load_value(values, r * F);
      }
    }
  };
  if (lo <= hi) prefetch((long long)lo * kChunkRows + kRows * tid);
  __syncthreads();

  int carry = -1;  // last valid key of the chunks before
  int par = 0;     // buffer of s_last / s_first
  int tp = 0;      // buffer of s_tail
  for (int b = lo; b <= hi; ++b) {
    const long long r0 = (long long)b * kChunkRows + kRows * tid;
    int k[kRows];
    float v0[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      k[i] = id_n[i] >= 0 && id_n[i] < n && act_n[i] != 0 ? id_n[i] : -1;
      v0[i] = v_n[i];
    }
    if (b < hi) prefetch(r0 + kChunkRows);
    // Wholly inactive, or every valid row below this tile.
    if (blk_max[b] < tile_lo) continue;

    // key = last valid id at or before each row: a max-scan in the
    // thread, over the lanes, then over the warps with the carry.
    int key[kRows];
    key[0] = k[0];
#pragma unroll
    for (int i = 1; i < kRows; ++i) key[i] = max(key[i - 1], k[i]);
    int wkey = key[kRows - 1];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wkey, o);
      if (lane >= o) wkey = max(wkey, y);
    }
    if (lane == 31) s_last[par][warp] = wkey;
    if (lane == 0) s_first[par][warp] = k[0];
    __syncthreads();
    // The carry into this warp, and into the next chunk.
    int before = carry, last = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = s_last[par][w];
      if (w < warp) before = max(before, x);
      last = max(last, x);
    }
    // Each warp's last and first key with the carry, for the tail folds
    // (read after the payload column's barrier).
    if (tid < kWarps) {
      int into = carry;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w < tid) into = max(into, s_last[par][w]);
      s_wlast[par][tid] = max(into, s_last[par][tid]);
      s_wfirst[par][tid] = max(into, s_first[par][tid]);
    }
    int lane_before = __shfl_up_sync(kFull, wkey, 1);
    if (lane == 0) lane_before = -1;
    const int cin = max(before, lane_before);
#pragma unroll
    for (int i = 0; i < kRows; ++i) key[i] = max(key[i], cin);
    // The key after the thread's last row: the next lane's first, or the
    // next warp's first row's.
    int next = __shfl_down_sync(kFull, key[0], 1);
    if (lane == 31)
      next = warp + 1 < kWarps ? max(key[kRows - 1], s_first[par][warp + 1])
                               : -2;
    // The run of the thread's first row continues from the lane before.
    const int key_prev = __shfl_up_sync(kFull, key[kRows - 1], 1);
    const bool cont = lane > 0 && key_prev == key[0];
    // Rows whose run ends at them and whose key is this tile's.
    bool mine[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      mine[i] = key[i] >= tile_lo && key[i] < tile_hi;
#pragma unroll
    for (int i = 0; i + 1 < kRows; ++i)
      mine[i] = mine[i] && key[i + 1] != key[i];
    mine[kRows - 1] = mine[kRows - 1] && next != key[kRows - 1];

    for (int f = 0; f < F; ++f) {
      // Segmented fold of the thread's rows, in row order.
      float a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = ident;
        if (k[i] >= 0)
          a[i] = f == 0 ? v0[i] : load_value(values, (r0 + i) * F + f);
      }
#pragma unroll
      for (int i = 1; i < kRows; ++i)
        if (key[i] == key[i - 1]) a[i] = fold(op, a[i - 1], a[i]);
      // Segmented scan of the threads' last runs over the lanes.
      float wv = a[kRows - 1];
      const int wk = key[kRows - 1];
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, wv, o);
        const int ky = __shfl_up_sync(kFull, wk, o);
        if (lane >= o && ky == wk) wv = fold(op, y, wv);
      }
      const float x = __shfl_up_sync(kFull, wv, 1);
      if (lane == 31) s_tail[tp][warp] = wv;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!mine[i]) continue;
        float total = a[i];
        if (cont && key[i] == key[0]) total = fold(op, x, total);
        // Fold in the tails of earlier warps that the run spans, nearest
        // first: a fixed order, so the sum is the same on every launch.
        for (int w = warp; w > 0 && s_wlast[par][w - 1] == key[i]; --w) {
          total = fold(op, s_tail[tp][w - 1], total);
          if (s_wfirst[par][w - 1] != key[i]) break;
        }
        const int ai = (key[i] - tile_lo) * F + f;
        acc[ai] = fold(op, acc[ai], total);
      }
      tp ^= 1;
    }
    carry = last;
    par ^= 1;
    if (carry >= tile_hi) break;
  }
  __syncthreads();

  if (p == 1) {
    for (int i = tid; i < width * F; i += kThreads) {
      float a = acc[i];
      if (op != kSum && a == ident) a = 0.0f;
      store_value(out, (long long)tile_lo * F + i, a);
    }
  } else {
    float* dst = part + ((long long)slot[t] + j) * tile_n * F;
    for (int i = tid; i < width * F; i += kThreads) dst[i] = acc[i];
  }
}

// Pass 6: each split tile's pieces folded in piece order, written once;
// the work items are (tile, kThreads elements of it), one element a
// thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int* __restrict__ cnt, const int* __restrict__ slot,
            const float* __restrict__ part, int F, int n, int tile_n,
            int tiles, int op, T* __restrict__ out) {
  const float ident = identity_of(op);
  const long long stride = (long long)tile_n * F;
  const int slices = (int)((stride + kThreads - 1) / kThreads);
  const long long items = (long long)tiles * slices;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = (int)(w / slices);
    const int p = cnt[t];
    if (p < 2) continue;
    const int tile_lo = t * tile_n;
    const int width =
        (int)min((long long)tile_lo + tile_n, (long long)n) - tile_lo;
    const int i = (int)(w % slices) * kThreads + threadIdx.x;
    if (i >= width * F) continue;
    const float* src = part + (long long)slot[t] * stride + i;
    float a = src[0];
#pragma unroll 16
    for (int q = 1; q < p; ++q) a = fold(op, a, src[q * stride]);
    if (op != kSum && a == ident) a = 0.0f;
    store_value(out, (long long)tile_lo * F + i, a);
  }
}

// Where each array lives in the scratch: ints first, then the slots.
struct Layout {
  long long nb, groups, tiles, tgroups, pieces, slots;
  int tile_n;
  long long part_offset, bytes;
};

Layout layout_of(long long E, int F, int n, int split) {
  Layout L;
  L.nb = (E + kChunkRows - 1) / kChunkRows;
  L.tile_n = kAccFloats / F < kChunkRows ? kAccFloats / F : kChunkRows;
  L.tiles = (n + L.tile_n - 1) / L.tile_n;
  const long long extra = split > 0 && L.nb > 1 ? (L.nb - 1) / split : 0;
  L.pieces = L.tiles + extra;
  L.slots = 2 * extra;
  L.groups = (L.nb + kScanThreads - 1) / kScanThreads;
  L.tgroups = (L.tiles + kScanThreads - 1) / kScanThreads;
  const long long ints = 2 * L.nb + L.groups + 4 * L.tiles + (L.tiles + 1) +
                         2 * L.tgroups + L.pieces;
  L.part_offset = (ints * 4 + 15) / 16 * 16;
  L.bytes = L.part_offset + L.slots * L.tile_n * F * 4;
  return L;
}

}  // namespace

extern "C" {

// Rows per chunk (one edge block).
int segment_combine_block_rows() { return kChunkRows; }

// Largest payload width one tile's accumulator holds.
int segment_combine_max_width() { return kAccFloats; }

// K: the most chunks one block folds (the split length the wrapper
// passes).
int segment_combine_piece_chunks() { return kPieceChunks; }

// Bytes of scratch a launch with these sizes and split length needs:
// arithmetic on the sizes alone.
long long segment_combine_scratch_bytes(long long E, int F, int n,
                                        int split) {
  if (F < 1 || F > kAccFloats || n < 1 || E < 0) return 0;
  return layout_of(E, F, n, split).bytes;
}

// dtype: 0 = f32, 1 = bf16.  op: 0 = sum, 1 = max, 2 = min.  active may be
// null.  split: the most chunks a block folds (0: one block a tile, however
// long).  scratch holds segment_combine_scratch_bytes(E, F, n, split)
// bytes.  Returns cudaGetLastError().
int segment_combine_launch(const void* values, int dtype, const void* ids,
                           const void* active, long long E, int F, int n,
                           int op, int split, void* scratch, void* out,
                           void* stream) {
  if (F < 1 || F > kAccFloats || n < 1 || E < 0 || split < 0)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(E, F, n, split);
  if (L.nb >= (1ll << 31) || L.pieces >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)L.nb, tiles = (int)L.tiles;
  const int groups = (int)L.groups;
  int* blk_max = static_cast<int*>(scratch);
  int* pref = blk_max + nb;
  int* gmax = pref + nb;
  int* tb0 = gmax + groups;
  int* tb1 = tb0 + tiles;
  int* cnt = tb1 + tiles;
  int* slot = cnt + tiles;
  int* start = slot + tiles;
  int* gsum = start + tiles + 1;
  int* piece_tile = gsum + 2 * L.tgroups;
  float* part = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                         L.part_offset);
  const int* id_p = static_cast<const int*>(ids);
  const uint8_t* act_p = static_cast<const uint8_t*>(active);
  if (nb > 0) {
    block_max_kernel<<<nb, kThreads, 0, s>>>(id_p, act_p, E, n, blk_max);
    group_scan_kernel<<<groups, kScanThreads, 0, s>>>(blk_max, nb, pref,
                                                      gmax);
    if (groups > 1) {
      group_carry_kernel<<<1, kScanThreads, 0, s>>>(gmax, groups);
      group_fix_kernel<<<groups - 1, kScanThreads, 0, s>>>(gmax, nb, pref);
    }
  }
  const int tgroups = (int)L.tgroups;
  tile_scan_kernel<<<tgroups, kScanThreads, 0, s>>>(
      pref, nb, n, L.tile_n, tiles, split, tb0, tb1, cnt, start, slot, gsum);
  tile_carry_kernel<<<1, kScanThreads, 0, s>>>(gsum, tgroups, tiles, start);
  tile_fix_kernel<<<tgroups, kScanThreads, 0, s>>>(cnt, gsum, tiles, start,
                                                   slot, piece_tile);
  const size_t smem = static_cast<size_t>(L.tile_n) * F * sizeof(float);
  const int grid = (int)L.pieces;
  const int folds = kFoldBlocks;
  if (dtype == 0) {
    float* o = static_cast<float*>(out);
    combine_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(values), id_p, act_p, blk_max, tb0, tb1,
        cnt, start, slot, piece_tile, part, E, F, n, L.tile_n, tiles, split,
        op, o);
    if (L.slots > 0)
      fold_kernel<float><<<folds, kThreads, 0, s>>>(cnt, slot, part, F, n,
                                                     L.tile_n, tiles, op, o);
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    combine_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(values), id_p, act_p, blk_max, tb0,
        tb1, cnt, start, slot, piece_tile, part, E, F, n, L.tile_n, tiles,
        split, op, o);
    if (L.slots > 0)
      fold_kernel<__nv_bfloat16><<<folds, kThreads, 0, s>>>(
          cnt, slot, part, F, n, L.tile_n, tiles, op, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
