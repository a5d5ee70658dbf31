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
// Design: deterministic sorted segmented reduction, no float atomics.
//   pass 1  one block per edge block of 256 rows writes the largest valid id
//           in it (-1 for none): blocks wholly inactive or wholly below a
//           tile are skipped later, as the TPU kernel's active bitmap does.
//   pass 2  one block turns those into running maxima, which are monotone
//           even where blocks are empty, so a binary search finds each
//           output tile's first and last edge block.  (The ids themselves
//           cannot be searched: invalid rows break their order.)
//   pass 3  one block per tile of output segments walks its edge blocks in
//           row order, 256 rows at a time.  Each chunk gives every row the
//           key of the last valid row at or before it (a max-scan), so keys
//           are non-decreasing and invalid rows carry the identity inside a
//           run; a segmented scan in a fixed warp-shuffle tree then folds
//           each run, and the run's last row folds the total into the
//           tile's accumulator in shared memory.  Each segment has one run
//           per chunk and chunks go in order, so the order of every
//           addition is fixed: two launches give bit-identical output.  The
//           tile is written once.
// The kernel reads each valid row once (plus the rows of an edge block that
// a tile shares with its neighbour).  What it does not yet do: split a hub
// segment across blocks (one block walks all its rows), or stage rows
// through shared memory with cp.async / TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per chunk == rows per edge block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kAccFloats = 8192;  // 32 KB of shared accumulator per tile
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

__global__ void block_max_kernel(const int* __restrict__ ids,
                                 const uint8_t* __restrict__ active,
                                 long long E, int n, int* __restrict__ blk_max) {
  __shared__ int s_max[kWarps];
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  int k = row_key(ids, active, r, E, n);
  for (int o = 16; o > 0; o >>= 1) k = max(k, __shfl_xor_sync(kFull, k, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = s_max[0];
    for (int w = 1; w < kWarps; ++w) m = max(m, s_max[w]);
    blk_max[blockIdx.x] = m;
  }
}

__global__ void prefix_max_kernel(const int* __restrict__ blk_max, int nb,
                                  int* __restrict__ pref) {
  __shared__ int s[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  int m = -1;
  for (int i = lo; i < hi; ++i) m = max(m, blk_max[i]);
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
    run = max(run, blk_max[i]);
    pref[i] = run;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ values, const int* __restrict__ ids,
               const uint8_t* __restrict__ active,
               const int* __restrict__ blk_max, const int* __restrict__ pref,
               long long E, int F, int n, int nb, int tile_n, int op,
               T* __restrict__ out) {
  extern __shared__ float acc[];  // [tile_n, F]
  __shared__ int s_last[kWarps];   // key of each warp's last row
  __shared__ int s_first[kWarps];  // key of each warp's first row
  __shared__ float s_tail[kWarps]; // each warp's scan value at lane 31
  __shared__ int s_carry;          // last valid key of the chunks before

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_lo = blockIdx.x * tile_n;
  const int tile_hi = min(tile_lo + tile_n, n);
  const int width = tile_hi - tile_lo;
  const float ident = identity_of(op);

  for (int i = tid; i < width * F; i += kThreads) acc[i] = ident;
  if (tid == 0) s_carry = -1;
  const int b0 = lower_bound(pref, nb, tile_lo);
  const int b1 = min(lower_bound(pref, nb, tile_hi), nb - 1);
  __syncthreads();

  for (int b = b0; b <= b1; ++b) {
    // Wholly inactive, or every valid row below this tile.
    if (blk_max[b] < tile_lo) continue;
    const long long r = (long long)b * kThreads + tid;
    const int k = row_key(ids, active, r, E, n);
    const bool valid = k >= 0;

    // key = last valid id at or before this row (max-scan with carry).
    int key = k;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, key, o);
      if (lane >= o) key = max(key, y);
    }
    if (lane == 31) s_last[warp] = key;
    __syncthreads();
    int before = s_carry;
    for (int w = 0; w < warp; ++w) before = max(before, s_last[w]);
    key = max(key, before);
    __syncthreads();
    if (lane == 0) s_first[warp] = key;
    if (lane == 31) s_last[warp] = key;
    __syncthreads();
    int next = __shfl_down_sync(kFull, key, 1);
    if (lane == 31) next = warp + 1 < kWarps ? s_first[warp + 1] : -2;
    const bool run_end = next != key;
    const bool mine = run_end && key >= tile_lo && key < tile_hi;

    for (int f = 0; f < F; ++f) {
      float v = valid ? load_value(values, r * F + f) : ident;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, v, o);
        const int ky = __shfl_up_sync(kFull, key, o);
        if (lane >= o && ky == key) v = fold(op, y, v);
      }
      if (lane == 31) s_tail[warp] = v;
      __syncthreads();
      if (mine) {
        // Fold in the tails of earlier warps that the run spans, nearest
        // first: a fixed order, so the sum is the same on every launch.
        float total = v;
        for (int w = warp; w > 0 && s_last[w - 1] == key; --w) {
          total = fold(op, s_tail[w - 1], total);
          if (s_first[w - 1] != key) break;
        }
        const int a = (key - tile_lo) * F + f;
        acc[a] = fold(op, acc[a], total);
      }
      __syncthreads();
    }
    if (tid == kThreads - 1) s_carry = key;
    __syncthreads();
    if (s_carry >= tile_hi) break;
  }

  for (int i = tid; i < width * F; i += kThreads) {
    float a = acc[i];
    if (op != kSum && a == ident) a = 0.0f;
    store_value(out, (long long)tile_lo * F + i, a);
  }
}

}  // namespace

extern "C" {

// Rows per edge block: the wrapper sizes its scratch (2 ints per block).
int segment_combine_block_rows() { return kThreads; }

// Largest payload width one tile's accumulator holds.
int segment_combine_max_width() { return kAccFloats; }

// dtype: 0 = f32, 1 = bf16.  op: 0 = sum, 1 = max, 2 = min.  active may be
// null.  scratch holds 2 * ceil(E / 256) int32.  Returns cudaGetLastError().
int segment_combine_launch(const void* values, int dtype, const void* ids,
                           const void* active, long long E, int F, int n,
                           int op, void* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>((E + kThreads - 1) / kThreads);
  int* blk_max = static_cast<int*>(scratch);
  int* pref = blk_max + nb;
  const int* id_p = static_cast<const int*>(ids);
  const uint8_t* act_p = static_cast<const uint8_t*>(active);
  if (nb > 0) {
    block_max_kernel<<<nb, kThreads, 0, s>>>(id_p, act_p, E, n, blk_max);
    prefix_max_kernel<<<1, kScanThreads, 0, s>>>(blk_max, nb, pref);
  }
  int tile_n = kAccFloats / F;
  if (tile_n > kThreads) tile_n = kThreads;
  const int tiles = (n + tile_n - 1) / tile_n;
  const size_t smem = static_cast<size_t>(tile_n) * F * sizeof(float);
  if (dtype == 0) {
    combine_kernel<float><<<tiles, kThreads, smem, s>>>(
        static_cast<const float*>(values), id_p, act_p, blk_max, pref, E, F,
        n, nb, tile_n, op, static_cast<float*>(out));
  } else {
    combine_kernel<__nv_bfloat16><<<tiles, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(values), id_p, act_p, blk_max,
        pref, E, F, n, nb, tile_n, op, static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
