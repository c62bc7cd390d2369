// Runs of bitonic compare-exchange stages over int32[N, W] rows on chip, for
// Hopper: the launches of `repro_torch.kernels.ops.bitonic_sort`.
//
// Replaces the Pallas kernels `_cross_tile_kernel` (src/repro/kernels/
// bitonic_stage.py:34) and `_in_tile_kernel` (bitonic_stage.py:52), which
// `bitonic_sort_pallas` launches once per stage (k, j). Each stage is the one
// of `bitonic_stage.cu` and `bitonic_stages_ref`: row i exchanges with row
// i^j, ascending iff (i & k) == 0; rows compare lexicographically on their
// first `num_keys` columns, and a row keeps its own value iff
// (lt(self, partner) == self_is_lower) == ascending. Rows whose keys are equal
// but whose other columns differ follow that element-wise rule too (one row
// is copied over the other), so a launch equals its stages applied one by one.
//
// What bounds it on the card: bytes moved between HBM and the SMs. One stage
// per launch reads and writes every row, and a sort of N rows has
// log2(N)*(log2(N)+1)/2 stages (300 at N = 2^24), against a few integer
// compares per row and stage. Once stages are fused, the compares themselves
// (about 30 instructions per pair of 4-column rows) come next.
//
// What the design does about it: a CUDA block loads a set of S rows whose
// partners, for a run of consecutive stages, all lie inside the set; it
// applies the whole run on chip and writes the rows back once.
// * `bitonic_tile_kernel`: S consecutive rows (a tile). One launch with
//   k = 2 .. S sorts every tile; for each k > S one launch runs the stages
//   j = S/2 .. 1 of that k.
// * `bitonic_cross_kernel`: the stages j = j_hi .. j_lo of one k, r levels
//   with j_lo >= S. A block holds 2^r runs of S / 2^r consecutive rows,
//   j_lo rows apart; every partner i^j of such a stage is in the set. The
//   wrapper keeps runs at 512 bytes or more, so HBM reads and writes stay
//   coalesced.
// The wrapper picks S (the tile) from a shared-memory budget of 112 KB a
// block, so that two blocks fit on an SM: at W = 4, S = 4096, r <= 7, and a
// sort of 2^24 rows takes 30 launches in place of 300. Rows come in by
// cp.async, every word of the block in flight at once, and go out by plain
// stores; consecutive threads move consecutive words.
//
// Inside a block, rows of up to 16 columns (blocks of 1,024 rows or more) run
// in register passes. A pass takes the longest run of consecutive stages
// whose strides lie on g local row bits, all below bit 5 or all from bit 5
// up; each lane loads the 2^g rows that differ in those bits from shared
// memory, applies the stages between its own registers and stores them back,
// so one shared-memory round trip serves up to g stages (g = 4 up to 4
// columns, 3 up to 8, 2 above; at W = 4 the tile sort's 78 stages take 27
// passes). The lanes of a warp take bits 5..9 when the pass's bits are low
// and bits 0..4 otherwise; rows sit at an odd pitch (W | 1 words) with bits
// 5..9 XORed into the row's low five, so both lane patterns reach 32
// different banks. The widths of the main path's levels (W = 4, 5, 6, 9, 15)
// get kernels of that exact width; other widths up to 16 a bound of 4, 8 or
// 16 columns with the run-time W masked inside it. Wider rows (W reaches
// v + 1 = 187 on repetitive texts, where the tile falls to 128 rows) and
// small blocks run one stage at a time on pairs in shared memory.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kPairThreads = 512;  // threads of the one-stage-at-a-time path
constexpr int kPassThreads = 256;  // threads of the register-pass path
// The shared-memory budget of one block; the wrapper sizes tiles by it
// (`SMEM_BUDGET` in bitonic_sort.py).
constexpr int kSmemBudget = 112 * 1024;

// Shared-memory slot of local row l. The pair path flips the five low bits
// when bit 5 is set; the register path XORs bits 5..9 into the low five.
template <bool kPairs>
__device__ __forceinline__ int swizzle(int l) {
  return kPairs ? l ^ (((l >> 5) & 1) * 31) : l ^ ((l >> 5) & 31);
}

// Which global rows a block holds. Local bits [0, cb) are global bits
// [0, cb); local bits [cb, cb + r) are global bits [a, a + r) (a >= cb); the
// block index fills global bits [cb, a) and [a + r, ...).
struct Layout {
  int cb;
  int a;
  int r;

  __device__ __forceinline__ int row(int l) const {
    const int low = a - cb;
    const int block = static_cast<int>(blockIdx.x);
    const int high = block >> low;
    const int mid = block & ((1 << low) - 1);
    return (high << (a + r)) | ((l >> cb) << a) | (mid << cb) |
           (l & ((1 << cb) - 1));
  }

  // Local bit of the global stride j (a power of two with its bit inside
  // the local set).
  __device__ __forceinline__ int bit(int j) const {
    const int e = __ffs(j) - 1;
    return e < cb ? e : e - a + cb;
  }
};

// The stages of a launch, in order: k = k_first .. k_last (doubling) and,
// for each k, j = min(k / 2, j_hi) .. j_lo (halving).
struct Stages {
  unsigned k;  // reaches 2^31 once the last k is done
  int j;
  unsigned k_last;
  int j_hi;
  int j_lo;

  __device__ __forceinline__ static int first_j(unsigned k, int j_hi) {
    const int half = static_cast<int>(k >> 1);
    return half < j_hi ? half : j_hi;
  }

  __device__ __forceinline__ Stages(unsigned k_first, unsigned k_last_,
                                    int j_hi_, int j_lo_)
      : k(k_first), j(first_j(k_first, j_hi_)), k_last(k_last_),
        j_hi(j_hi_), j_lo(j_lo_) {}

  __device__ __forceinline__ bool done() const { return k > k_last; }

  __device__ __forceinline__ void next() {
    j >>= 1;
    if (j < j_lo) {
      k <<= 1;
      j = first_j(k, j_hi);
    }
  }
};

// ------------------------------------------------ HBM <-> shared memory
// One word from HBM into shared memory by cp.async: no register staging, so
// every load of the block is in flight at once.
__device__ __forceinline__ void load_async(int32_t* dst, const int32_t* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

// Copy the block's S rows between HBM and shared memory: consecutive threads
// take consecutive words, so every warp access is one contiguous run; the
// row of word q is q * ceil(2^32 / w) >> 32, exact for q < 2^32 / w. Loads
// end with the wait for all of them; the caller synchronises the block.
template <bool kPairs, bool kLoad>
__device__ __forceinline__ void copy_block(int32_t* rows, int32_t* sm, int w,
                                           const Layout& lay, int s) {
  const int wp = w | 1;
  const unsigned words = static_cast<unsigned>(s * w);
  const unsigned long long magic = ((1ULL << 32) + w - 1) / w;
#pragma unroll 4
  for (unsigned q = threadIdx.x; q < words; q += blockDim.x) {
    const int l = static_cast<int>((q * magic) >> 32);
    const int c = static_cast<int>(q) - l * w;
    int32_t* g = rows + static_cast<long long>(lay.row(l)) * w + c;
    int32_t* slot = sm + swizzle<kPairs>(l) * wp + c;
    if (kLoad) {
      load_async(slot, g);
    } else {
      *g = *slot;
    }
  }
  if (kLoad) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------ one stage at a time, any width
__device__ __forceinline__ void exchange(int32_t* a, int32_t* b, int w,
                                         int num_keys, bool up) {
  int cmp = 0;
  for (int c = 0; c < num_keys; ++c) {
    const int32_t x = a[c];
    const int32_t y = b[c];
    if (x != y) {
      cmp = x < y ? -1 : 1;
      break;
    }
  }
  const bool keep_lo = (cmp < 0) == up;   // lt(a, b) == lower(true) == up
  const bool keep_hi = (cmp <= 0) == up;  // (lt(b, a) == lower(false)) == up
  if (keep_lo && keep_hi) return;
  for (int c = 0; c < w; ++c) {
    const int32_t x = a[c];
    const int32_t y = b[c];
    a[c] = keep_lo ? x : y;
    b[c] = keep_hi ? y : x;
  }
}

__device__ void pair_stages(int32_t* sm, int w, int num_keys,
                            const Layout& lay, int s, Stages st) {
  const int wp = w | 1;
  while (!st.done()) {
    const int lj = 1 << lay.bit(st.j);
    const unsigned k = st.k;
    for (int p = threadIdx.x; p < s / 2; p += blockDim.x) {
      const int lo = ((p & ~(lj - 1)) << 1) | (p & (lj - 1));
      exchange(sm + swizzle<true>(lo) * wp, sm + swizzle<true>(lo | lj) * wp,
               w, num_keys, (static_cast<unsigned>(lay.row(lo)) & k) == 0);
    }
    st.next();
    // a stage of local stride < 32 pairs rows inside one warp's 64 rows
    if (!st.done() && lj < 32 && lay.bit(st.j) < 5) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
}

// ------------------------------------------- register passes, W <= 16
// Whether row a compares below (lt) or above (gt) row b on the first
// num_keys columns; neither when those columns are equal. Taken from the
// last column back, so each column costs two compares and two predicate
// operations.
template <int kW>
__device__ __forceinline__ void compare(const int32_t (&a)[kW],
                                        const int32_t (&b)[kW], int num_keys,
                                        bool& lt, bool& gt) {
  lt = false;
  gt = false;
#pragma unroll
  for (int c = kW - 1; c >= 0; --c) {
    if (c < num_keys) {
      const bool l = a[c] < b[c];
      const bool g = a[c] > b[c];
      lt = l || (lt && !g);
      gt = g || (gt && !l);
    }
  }
}

// A stage whose stride is register bit kT: rows m and m | 2^kT of one lane.
template <int kW, int kG, int kT>
__device__ __forceinline__ void register_stage(int32_t (&rw)[1 << kG][kW],
                                               const int (&grow)[1 << kG],
                                               unsigned k, int num_keys) {
  constexpr int kBit = 1 << kT;
#pragma unroll
  for (int m = 0; m < (1 << kG); ++m) {
    if (m & kBit) continue;
    const int p = m | kBit;
    const bool up = (static_cast<unsigned>(grow[m]) & k) == 0;
    bool lt;
    bool gt;
    compare<kW>(rw[m], rw[p], num_keys, lt, gt);
    const bool keep_lo = lt == up;   // lt(a, b) == lower(true) == up
    const bool keep_hi = !gt == up;  // (lt(b, a) == lower(false)) == up
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const int32_t x = rw[m][c];
      const int32_t y = rw[p][c];
      rw[m][c] = keep_lo ? x : y;
      rw[p][c] = keep_hi ? y : x;
    }
  }
}

// One pass: `count` stages from `st`, each with its stride on a bit of
// `regmask` (kG local bits). A lane holds the 2^kG rows that differ in those
// bits; lanes take bits 5..9 when the register bits are below 5, else bits
// 0..4; the other bits number the groups a warp walks.
template <int kW, bool kExact, int kG>
__device__ void register_pass(int32_t* sm, int w_, int num_keys,
                              const Layout& lay, int s, int regmask,
                              Stages st, int count) {
  const int w = kExact ? kW : w_;
  const int wp = w | 1;
  int regbits[kG];
  int rest_mask = regmask;
#pragma unroll
  for (int t = 0; t < kG; ++t) {
    regbits[t] = __ffs(rest_mask) - 1;
    rest_mask &= rest_mask - 1;
  }
  const int lane_shift = regmask < 32 ? 5 : 0;
  const int free_mask = (s - 1) & ~(31 << lane_shift) & ~regmask;
  const int groups = s >> (5 + kG);
  const int lane_bits = static_cast<int>(threadIdx.x & 31) << lane_shift;
  for (int grp = threadIdx.x >> 5; grp < groups;
       grp += static_cast<int>(blockDim.x >> 5)) {
    // deposit the group index into the free bits, lowest first
    int base = lane_bits;
    int rest = grp;
    for (int b = 0; rest != 0; ++b) {
      if (free_mask & (1 << b)) {
        base |= (rest & 1) << b;
        rest >>= 1;
      }
    }
    int lrow[1 << kG];
    int grow[1 << kG];
    int32_t rw[1 << kG][kW];
#pragma unroll
    for (int m = 0; m < (1 << kG); ++m) {
      int l = base;
#pragma unroll
      for (int t = 0; t < kG; ++t) l |= ((m >> t) & 1) << regbits[t];
      lrow[m] = swizzle<false>(l) * wp;
      grow[m] = lay.row(l);
#pragma unroll
      for (int c = 0; c < kW; ++c) rw[m][c] = c < w ? sm[lrow[m] + c] : 0;
    }
    Stages it = st;
    for (int i = 0; i < count; ++i, it.next()) {
      const int e = lay.bit(it.j);
      if (e == regbits[0]) {
        register_stage<kW, kG, 0>(rw, grow, it.k, num_keys);
      } else if (e == regbits[1]) {
        register_stage<kW, kG, 1>(rw, grow, it.k, num_keys);
      } else if constexpr (kG > 2) {
        if (e == regbits[2]) {
          register_stage<kW, kG, 2>(rw, grow, it.k, num_keys);
        } else if constexpr (kG > 3) {
          register_stage<kW, kG, 3>(rw, grow, it.k, num_keys);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < (1 << kG); ++m) {
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        if (c < w) sm[lrow[m] + c] = rw[m][c];
      }
    }
  }
}

// Every stage of the launch in register passes: each pass takes the longest
// run of consecutive stages whose strides lie on at most kG bits, all below
// bit 5 or all from bit 5 up, padded to kG bits of the same side.
template <int kW, bool kExact, int kG>
__device__ void register_stages(int32_t* sm, int w, int num_keys,
                                const Layout& lay, int s, Stages st) {
  const int log_s = __ffs(s) - 1;
  while (!st.done()) {
    const bool low = lay.bit(st.j) < 5;
    int regmask = 0;
    int count = 0;
    Stages probe = st;
    while (!probe.done()) {
      const int b = lay.bit(probe.j);
      const int grown = regmask | (1 << b);
      if ((b < 5) != low || __popc(grown) > kG) break;
      regmask = grown;
      ++count;
      probe.next();
    }
    for (int b = low ? 0 : 5; __popc(regmask) < kG && b < log_s; ++b) {
      regmask |= 1 << b;
    }
    register_pass<kW, kExact, kG>(sm, w, num_keys, lay, s, regmask, st,
                                  count);
    __syncthreads();
    st = probe;
  }
}

// ------------------------------------------------------------- the kernels
// kW = 0: the pair path; otherwise the register path for rows of at most kW
// columns, exactly kW when kExact.
template <int kW, bool kExact>
__device__ __forceinline__ void run_launch(int32_t* rows, int w,
                                           int num_keys, const Layout& lay,
                                           Stages st) {
  extern __shared__ int32_t sm[];
  const int s = 1 << (lay.cb + lay.r);
  copy_block<kW == 0, true>(rows, sm, w, lay, s);
  __syncthreads();
  if constexpr (kW == 0) {
    pair_stages(sm, w, num_keys, lay, s, st);
  } else {
    // rows a lane holds: 16 up to 4 columns, 8 up to 8, 4 above
    constexpr int kG = kW <= 4 ? 4 : (kW <= 8 ? 3 : 2);
    register_stages<kW, kExact, kG>(sm, w, num_keys, lay, s, st);
  }
  copy_block<kW == 0, false>(rows, sm, w, lay, s);
}

template <int kW, bool kExact>
__global__ void __launch_bounds__(kW == 0 ? kPairThreads : kPassThreads,
                                  kW == 0 ? 1 : 2)
    bitonic_tile_kernel(int32_t* __restrict__ rows, int w, int num_keys,
                        int log_s, unsigned k_first, unsigned k_last) {
  const Layout lay{0, 0, log_s};
  run_launch<kW, kExact>(rows, w, num_keys, lay,
                         Stages(k_first, k_last, (1 << log_s) >> 1, 1));
}

template <int kW, bool kExact>
__global__ void __launch_bounds__(kW == 0 ? kPairThreads : kPassThreads,
                                  kW == 0 ? 1 : 2)
    bitonic_cross_kernel(int32_t* __restrict__ rows, int w, int num_keys,
                         unsigned k, int j_hi, int r, int cb) {
  const int a = (__ffs(j_hi) - 1) - (r - 1);
  const Layout lay{cb, a, r};
  run_launch<kW, kExact>(rows, w, num_keys, lay,
                         Stages(k, k, j_hi, j_hi >> (r - 1)));
}

// The kernel for W rows in blocks of s: the exact-width register path for
// the window widths of the main path (v + 1 for v = 3, 4, 5, 8, 14), the
// masked one up to 16 columns, else the pair path. Returns the column bound
// (0 for the pair path) and sets `exact`.
int width_class(int w, int s, bool& exact) {
  exact = w == 4 || w == 5 || w == 6 || w == 9 || w == 15;
  if (s < 1024 || w > 16) return 0;
  if (exact) return w;
  return w <= 4 ? 4 : (w <= 8 ? 8 : 16);
}

int threads_for(int kw, int s) {
  if (kw) return kPassThreads;
  const int half = s / 2;
  return half < 32 ? 32 : (half > kPairThreads ? kPairThreads : half);
}

template <int V>
using Int = std::integral_constant<int, V>;
template <bool V>
using Bool = std::integral_constant<bool, V>;

// Calls launch(Int<kW>(), Bool<kExact>()) for the kernel `width_class` picks.
template <typename Launch>
cudaError_t dispatch(Launch launch, int w, int s) {
  bool exact = false;
  switch (width_class(w, s, exact)) {
    case 4:
      return exact ? launch(Int<4>(), Bool<true>())
                   : launch(Int<4>(), Bool<false>());
    case 5:
      return launch(Int<5>(), Bool<true>());
    case 6:
      return launch(Int<6>(), Bool<true>());
    case 8:
      return launch(Int<8>(), Bool<false>());
    case 9:
      return launch(Int<9>(), Bool<true>());
    case 15:
      return launch(Int<15>(), Bool<true>());
    case 16:
      return launch(Int<16>(), Bool<false>());
    default:
      return launch(Int<0>(), Bool<false>());
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kW, bool kExact>
cudaError_t launch_tile(void* rows, long long n, int w, int num_keys,
                        int log_s, unsigned k_first, unsigned k_last,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(bitonic_tile_kernel<kW, kExact>, smem);
  if (err != cudaSuccess) return err;
  bitonic_tile_kernel<kW, kExact>
      <<<static_cast<unsigned int>(n >> log_s), threads_for(kW, 1 << log_s),
         smem, stream>>>(static_cast<int32_t*>(rows), w, num_keys, log_s,
                         k_first, k_last);
  return cudaSuccess;
}

template <int kW, bool kExact>
cudaError_t launch_cross(void* rows, long long n, int w, int num_keys,
                         unsigned k, int j_hi, int r, int cb, size_t smem,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem(bitonic_cross_kernel<kW, kExact>, smem);
  if (err != cudaSuccess) return err;
  const int s = 1 << (cb + r);
  bitonic_cross_kernel<kW, kExact>
      <<<static_cast<unsigned int>(n / s), threads_for(kW, s), smem,
         stream>>>(static_cast<int32_t*>(rows), w, num_keys, k, j_hi, r, cb);
  return cudaSuccess;
}

}  // namespace

// rows: device pointer to int32[n, w], row-major; n < 2^31 a multiple of the
// tile 2^log_s (2 <= 2^log_s <= n, powers of two); the tile's rows, at a
// pitch of w | 1 words, fit kSmemBudget. Runs stages k = k_first .. k_last,
// j = min(k / 2, 2^log_s / 2) .. 1 on every tile. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_bitonic_tile(void* rows, long long n, int w,
                                  int num_keys, int log_s, long long k_first,
                                  long long k_last, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int s = 1 << log_s;
  const size_t smem = static_cast<size_t>(s) * (w | 1) * sizeof(int32_t);
  if (smem > kSmemBudget || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n >= s) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned kf = static_cast<unsigned>(k_first);
    const unsigned kl = static_cast<unsigned>(k_last);
    err = dispatch(
        [&](auto kw, auto exact) {
          return launch_tile<decltype(kw)::value, decltype(exact)::value>(
              rows, n, w, num_keys, log_s, kf, kl, smem, st);
        },
        w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The r stages (k, j_hi), (k, j_hi / 2) .. (k, j_hi / 2^(r-1)) on blocks of
// 2^r runs of 2^cb rows; j_hi / 2^(r-1) >= 2^cb, k > j_hi, n < 2^31 a
// multiple of 2 * j_hi. Returns cudaGetLastError() after the launch.
extern "C" int repro_bitonic_cross(void* rows, long long n, int w,
                                   int num_keys, long long k, long long j_hi,
                                   int r, int cb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int s = 1 << (cb + r);
  const size_t smem = static_cast<size_t>(s) * (w | 1) * sizeof(int32_t);
  if (smem > kSmemBudget || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n >= s) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned ki = static_cast<unsigned>(k);
    const int ji = static_cast<int>(j_hi);
    err = dispatch(
        [&](auto kw, auto exact) {
          return launch_cross<decltype(kw)::value, decltype(exact)::value>(
              rows, n, w, num_keys, ki, ji, r, cb, smem, st);
        },
        w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
