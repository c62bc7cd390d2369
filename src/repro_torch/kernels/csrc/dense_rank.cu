// Dense ranks of a sorted sequence of rows in one pass, for Hopper.
//
// Replaces the Pallas kernel `_seg_kernel` of src/repro/kernels/seg_boundary.py
// (launched by `seg_boundary_pallas`) together with the stitch of
// `repro.kernels.ops.dense_rank_sorted`: the Pallas grid cannot carry a
// prefix from one block to the next, so the TPU kernel forces a boundary at
// the first row of every block and the wrapper corrects the ranks with an
// exclusive cumsum of the block totals and a compare of the rows on either
// side of each block edge. Here the prefix crosses tiles inside the kernel,
// so the ranks come out final and nothing runs after it.
//
// One function, two loaders (a template parameter, as in radix_hist.cu):
//
// * rows (`repro_dense_rank_rows`): int32[N, W] rows sorted by their first
//   `num_keys` columns. Row i starts a run iff it differs from row i-1 there.
// * gathered (`repro_dense_rank_gather`): row i is the tuple
//   (words[0][pos[i]], ..., words[K-1][pos[i]]) of int64 words; it starts a
//   run iff some word differs from row i-1's. The K word pointers travel by
//   value in the kernel's parameter (a `__grid_constant__` struct, read in
//   place from the constant bank), copied from the host array of the entry
//   point: no stacking of the words, no host-to-device copy.
//
// Both write ranks[i] = (number of run starts in rows 0..i) - 1 as int32,
// and the number of runs into *n_distinct; the gathered form also writes
// is_start[i]. Row 0 always starts a run.
//
// What bounds it on the card: bytes. The rows form reads N * W * 4 bytes and
// writes N * 4 (at the main path's level-0 samples, int32[9,786,710, 3]:
// 117.4 + 39.1 MB, 0.047 ms at 3.35 TB/s) against one compare a key and a
// scan step a row. The gathered form reads pos (N * 8) and one 32-byte sector
// for every gathered word of a row in random order, and writes N * 5.
//
// What the design does about it: a single-pass scan with decoupled
// look-back (Merrill and Garland, as CUB's single-pass scan), so each row is
// read once and each rank written once, in one launch.
//
// * A block takes its tile (kTile rows) from an atomic counter, not from
//   blockIdx, so every tile before it belongs to a block that is already
//   running: the look-back never waits on a block that was never scheduled.
// * Loading. The rows form copies its tile, one contiguous range, into
//   shared memory with 16-byte loads (a row of 12 bytes is not aligned on
//   its own); rows too wide for shared memory are compared in place. The
//   gathered form reads pos coalesced, gathers each word once a row into
//   shared memory, and each row compares with its neighbour's copy there: a
//   word is gathered once, not twice. A tile whose rows all start runs
//   stops gathering.
// * The tile's first row compares with the last row of the tile before,
//   read from device memory: no boundary is forced.
// * One block a tile, resident blocks overlapping one another's look-back.
//   A persistent grid that copies its next tile while it looks back, and a
//   look-back by the whole block (256 tiles a step), both measured slower.
// * Thread t takes rows t, t + 256, ...: a warp's 32 flags are one ballot,
//   and a row's rank in its tile is a popcount of the ballots before it.
// * The tile publishes (status, count) packed in one 64-bit word, so a
//   reader never sees a torn pair. Status: not ready, the tile's own count
//   (aggregate), or the count of every row up to the tile's end (inclusive
//   prefix). The word is all a reader takes from the writer (ranks and
//   n_distinct are read only after the launch), so the stores and loads are
//   relaxed atomics at GPU scope, coherent and single-copy atomic; release
//   and acquire would order nothing more and measured slower.
//   Warp 0 looks back over its predecessors 32 at a time, waits while any
//   is not ready, and sums back to the nearest inclusive prefix.
// * The tile that holds row N-1 writes *n_distinct. The wrapper allocates
//   the zeroed scratch (the counter, n_distinct, the tile words) in one
//   tensor; the kernel allocates nothing.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // rows a thread
constexpr int kTile = kThreads * kItems;     // rows a tile: 2,048
constexpr int kMasks = kTile / 32;           // ballots a tile
constexpr int kMasksPerLane = kMasks / 32;   // ballots warp 0 scans a lane
// Shared memory the rows form stages a tile in: W <= 5 at 2,048 rows. With
// the static arrays below it stays within the 48 KB a block gets without
// opting in.
constexpr int kStageBytes = 40 * 1024;
// Most words of a gathered row: the largest K that the accelerated
// v-schedule gives a level at the largest input the port accepts (N below
// 2^31, alphabet up to 2^31; kernels/dense_rank.py MAX_WORDS, checked by
// the tests against `accelerated_next_v`). 9,312 bytes of parameter space.
constexpr int kMaxWords = 1164;

constexpr unsigned long long kNotReady = 0;
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kInclusive = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long status,
                                        unsigned count) {
  const unsigned long long v = (status << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(word)
               : "memory");
  return v;
}

// Copies 16 bytes from device to shared memory, asynchronously.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// True iff the rows differ on their first num_keys columns; a missing
// predecessor (row 0) counts as a difference.
__device__ __forceinline__ bool differ(const int32_t* a, const int32_t* b,
                                       int num_keys) {
  if (b == nullptr) return true;
  for (int c = 0; c < num_keys; ++c) {
    if (a[c] != b[c]) return true;
  }
  return false;
}

struct RowsLoader {
  static constexpr int kMinBlocks = 8;  // a whole SM of threads at W = 3
  const int32_t* rows;
  int w;
  int num_keys;
  bool staged;  // kTile rows of W columns fit kStageBytes
  bool vec;     // rows start on a 16-byte boundary

  // flag[i] of row r = i * kThreads + threadIdx.x of the tile at `start`
  // (len rows; a row past them gets false).
  __device__ void flags(long long start, int len, bool (&flag)[kItems],
                        unsigned char* smem) const {
    const int32_t* before = start > 0 ? rows + (start - 1) * w : nullptr;
    if (!staged) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = i * kThreads + threadIdx.x;
        const int32_t* a = rows + (start + r) * w;
        flag[i] = r < len && differ(a, start + r > 0 ? a - w : nullptr,
                                    num_keys);
      }
      return;
    }
    int32_t* buf = reinterpret_cast<int32_t*>(smem);
    const int32_t* src = rows + start * w;
    const int count = len * w;
    int done = 0;
    if (vec) {
      // a tile starts at a multiple of kTile * W * 4 bytes: 16-byte aligned.
      // cp.async moves each 16 bytes to shared memory without registers.
      const int n_vec = count / 4;
      for (int j = threadIdx.x; j < n_vec; j += kThreads) {
        copy16(buf + 4 * j, src + 4 * j);
      }
      done = n_vec * 4;
    }
    for (int j = done + threadIdx.x; j < count; j += kThreads) buf[j] = src[j];
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int r = i * kThreads + threadIdx.x;
      flag[i] = r < len && differ(buf + r * w,
                                  r > 0 ? buf + (r - 1) * w : before,
                                  num_keys);
    }
  }
};

struct Words {
  const int64_t* word[kMaxWords];
};

struct GatherLoader {
  static constexpr int kMinBlocks = 4;
  Words words;
  int k;
  const int64_t* pos;

  __device__ void flags(long long start, int len, bool (&flag)[kItems],
                        unsigned char* smem) const {
    // val[0]: the previous tile's last row; val[1 + r]: row r of this tile,
    // so row r compares with val[r].
    int64_t* val = reinterpret_cast<int64_t*>(smem);
    long long p[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int r = i * kThreads + threadIdx.x;
      p[i] = r < len ? pos[start + r] : 0;
      flag[i] = r < len && start + r == 0;
    }
    const long long p_before = start > 0 ? pos[start - 1] : 0;
    for (int j = 0; j < k; ++j) {
      const int64_t* wd = words.word[j];
      int64_t v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = i * kThreads + threadIdx.x;
        v[i] = r < len ? __ldg(wd + p[i]) : 0;
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = i * kThreads + threadIdx.x;
        if (r < len) val[1 + r] = v[i];
      }
      if (threadIdx.x == 0 && start > 0) val[0] = __ldg(wd + p_before);
      __syncthreads();
      bool all = true;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = i * kThreads + threadIdx.x;
        if (r < len) {
          flag[i] = flag[i] || v[i] != val[r];
          all = all && flag[i];
        }
      }
      // every row of the tile starts a run: later words change nothing
      if (__syncthreads_and(all)) break;
    }
  }
};

// The exclusive prefix of tile `tile` (> 0): warp 0 sums its predecessors'
// counts back to the nearest inclusive prefix, 32 tiles a step.
__device__ unsigned look_back(const unsigned long long* tiles, long long tile,
                              int lane) {
  unsigned excl = 0;
  long long last = tile - 1;
  while (true) {
    const long long t = last - lane;
    unsigned long long v;
    do {
      v = t >= 0 ? peek(tiles + t) : (kInclusive << 32);
    } while (__any_sync(kFull, (v >> 32) == kNotReady));
    const unsigned inclusive = __ballot_sync(kFull, (v >> 32) == kInclusive);
    const unsigned count = static_cast<unsigned>(v);
    if (inclusive) {
      const int nearest = __ffs(inclusive) - 1;
      return excl + __reduce_add_sync(kFull, lane <= nearest ? count : 0u);
    }
    excl += __reduce_add_sync(kFull, count);
    last -= 32;
  }
}

template <class Loader>
__global__ void __launch_bounds__(kThreads, Loader::kMinBlocks)
    dense_rank_kernel(const __grid_constant__ Loader loader, long long n,
                      int32_t* __restrict__ ranks, bool* __restrict__ is_start,
                      int32_t* __restrict__ n_distinct,
                      unsigned long long* __restrict__ tiles,
                      unsigned* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned masks[kMasks];
  __shared__ unsigned before[kMasks];  // run starts in the tile before a mask
  __shared__ unsigned tile_id;
  __shared__ unsigned prefix;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = tile_id;
  const long long start = tile * kTile;
  const long long left = n - start;
  const int len = left < kTile ? static_cast<int>(left) : kTile;
  bool flag[kItems];
  loader.flags(start, len, flag, smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned m = __ballot_sync(kFull, flag[i]);
    if (lane == 0) masks[i * kWarps + warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned c[kMasksPerLane];
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < kMasksPerLane; ++j) {
      c[j] = __popc(masks[lane * kMasksPerLane + j]);
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    unsigned run = incl - sum;
#pragma unroll
    for (int j = 0; j < kMasksPerLane; ++j) {
      before[lane * kMasksPerLane + j] = run;
      run += c[j];
    }
    const unsigned aggregate = __shfl_sync(kFull, incl, 31);
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(tiles, kInclusive, aggregate);
    } else {
      if (lane == 0) publish(tiles + tile, kAggregate, aggregate);
      excl = look_back(tiles, tile, lane);
      if (lane == 0) publish(tiles + tile, kInclusive, excl + aggregate);
    }
    if (lane == 0) {
      prefix = excl;
      if (start + len == n) {
        *n_distinct = static_cast<int32_t>(excl + aggregate);
      }
    }
  }
  __syncthreads();
  const unsigned base = prefix;
  const unsigned upto = kFull >> (31 - lane);  // lanes 0 .. lane
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = i * kThreads + threadIdx.x;
    if (r < len) {
      const int mi = i * kWarps + warp;
      ranks[start + r] = static_cast<int32_t>(
          base + before[mi] + __popc(masks[mi] & upto) - 1);
      if (is_start != nullptr) is_start[start + r] = flag[i];
    }
  }
}

// scratch: int64[ceil(n / kTile) + 2] of zeros. Word 0 holds the tile
// counter and word 1 n_distinct (each in its low 32 bits), the rest one
// status word a tile.
template <class Loader>
int launch(const Loader& loader, size_t smem, long long n, void* ranks,
           void* is_start, void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (n + kTile - 1) / kTile;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  if (n_tiles > 0) {
    dense_rank_kernel<Loader>
        <<<static_cast<unsigned int>(n_tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
            loader, n, static_cast<int32_t*>(ranks),
            static_cast<bool*>(is_start),
            reinterpret_cast<int32_t*>(words + 1), words + 2,
            reinterpret_cast<unsigned*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows form. rows: int32[n, w] contiguous, sorted by the first num_keys
// columns (1 <= num_keys <= w); ranks: int32[n]; scratch as `launch` says;
// n < 2^31. The wrapper checks all of it. Returns cudaGetLastError() after
// the launch.
extern "C" int repro_dense_rank_rows(const void* rows, long long n, int w,
                                     int num_keys, void* ranks, void* scratch,
                                     int device, void* stream) {
  RowsLoader loader;
  loader.rows = static_cast<const int32_t*>(rows);
  loader.w = w;
  loader.num_keys = num_keys;
  loader.staged = static_cast<long long>(kTile) * w * 4 <= kStageBytes;
  loader.vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const size_t smem = loader.staged ? static_cast<size_t>(kTile) * w * 4 : 0;
  return launch(loader, smem, n, ranks, nullptr, scratch, device, stream);
}

// The gathered form. words: host array of k device pointers to int64 words
// (1 <= k <= kMaxWords), each indexed by every pos[i]; pos: int64[n];
// ranks: int32[n]; is_start: bool[n]; scratch as `launch` says; n < 2^31.
// Returns cudaErrorInvalidValue for k outside its range, else
// cudaGetLastError() after the launch.
extern "C" int repro_dense_rank_gather(const void* const* words, int k,
                                       const void* pos, long long n,
                                       void* ranks, void* is_start,
                                       void* scratch, int device,
                                       void* stream) {
  if (k < 1 || k > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  GatherLoader loader;
  for (int j = 0; j < k; ++j) {
    loader.words.word[j] = static_cast<const int64_t*>(words[j]);
  }
  loader.k = k;
  loader.pos = static_cast<const int64_t*>(pos);
  const size_t smem = static_cast<size_t>(kTile + 1) * sizeof(int64_t);
  return launch(loader, smem, n, ranks, is_start, scratch, device, stream);
}
