// The Lemma-1 tie merge of the DC-v build, for Hopper, in one launch.
//
// Replaces no TPU kernel: the JAX package breaks the ties of a level with
// a comparator-bitonic network in plain jnp (src/repro/core/dcv_jax.py,
// `_lambda_tiebreak_jit` and `_lambda_tiebreak_host`), and the port ran the
// same networks in torch ops: log2(U) * (log2(U) + 1) / 2 stages over U
// tied rows, each stage gathering the whole tie payload. This kernel places
// every tied row in one pass instead.
//
// Input: the U tied rows of a level (or of a BSP rank's local sort), sorted
// by (group, class, key, p), where a group is the rows that share their
// v-character window, a row's class is its position mod v and its key is
// its sample rank rvals[i, lam1[k][k]]. Row i's group holds the slice
// [i - lane[i], i - lane[i] + width[i]). Row j precedes row i, of classes b
// and a, iff (rvals[j, lam1[b][a]], p[j]) < (rvals[i, lam2[b][a]], p[i]),
// the paper's Lemma 1 with ties to the position. Inside one class segment
// the key order is that order too, so the rows of class b that precede i
// are a prefix of b's segment, found by binary search.
//
// One thread a row: it walks the class segments of its group (a binary
// search on the class column finds each one's end), adds its own offset in
// its own segment and, for each other class, the length of that prefix,
// and writes p[i] to out[group start + the sum]. The v x v column tables
// sit in shared memory when v <= 64 and are read from device memory
// otherwise (the deep levels, whose payloads are small). Every destination
// lies in the row's own slice. Only ranks that follow no suffix order (a
// failed BSP exchange's) can make two rows collide; the wrapper fills out
// with p first, so a slot left unwritten still holds a position.
//
// What bounds it on the card: bytes. A row reads p, its class, lane and
// width (32 bytes), the rvals entries it compares, and writes 8 bytes: at
// least 40 + 8 * |D| bytes a row counting its whole rvals row once. The
// probes stay inside the row's own group, a slice that neighbouring
// threads share, so they hit L1 and L2.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Entries of each column table kept in shared memory: v <= 64.
constexpr int kSmemTable = 64 * 64;

__global__ void __launch_bounds__(kThreads)
lemma1_merge_kernel(const int64_t* __restrict__ p,
                    const int64_t* __restrict__ klass,
                    const int64_t* __restrict__ rvals,
                    const int64_t* __restrict__ lane,
                    const int64_t* __restrict__ width,
                    const int64_t* __restrict__ lam1,
                    const int64_t* __restrict__ lam2, long long n, int v,
                    int d, int64_t* __restrict__ out) {
  __shared__ uint16_t s_lam1[kSmemTable];
  __shared__ uint16_t s_lam2[kSmemTable];
  const bool in_smem = v * v <= kSmemTable;
  if (in_smem) {
    for (int e = threadIdx.x; e < v * v; e += kThreads) {
      s_lam1[e] = static_cast<uint16_t>(lam1[e]);
      s_lam2[e] = static_cast<uint16_t>(lam2[e]);
    }
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long start = i - lane[i];
  const long long end = start + width[i];
  const int64_t a = klass[i];
  const int64_t pi = p[i];
  const int64_t* row = rvals + i * d;
  long long dest = start;
  long long seg = start;
  while (seg < end) {
    const int64_t b = klass[seg];
    long long lo = seg + 1, hi = end;  // the segment's end: first class > b
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (klass[mid] <= b) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long seg_end = lo;
    if (b == a) {
      dest += i - seg;
    } else {
      const int e = static_cast<int>(b) * v + static_cast<int>(a);
      const int c1 = in_smem ? s_lam1[e] : static_cast<int>(lam1[e]);
      const int c2 = in_smem ? s_lam2[e] : static_cast<int>(lam2[e]);
      const int64_t target = row[c2];
      lo = seg;
      hi = seg_end;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        const int64_t c = rvals[mid * d + c1];
        if (c < target || (c == target && p[mid] < pi)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      dest += lo - seg;
    }
    seg = seg_end;
  }
  out[dest] = pi;
}

}  // namespace

// p, klass, lane, width, out: int64[n]; rvals: int64[n, d]; lam1, lam2:
// int64[v, v] with entries in [0, d). Every pointer on `device`; the
// wrapper checks shapes, types and devices. Returns cudaGetLastError()
// after the launch.
extern "C" int repro_lemma1_merge(const void* p, const void* klass,
                                  const void* rvals, const void* lane,
                                  const void* width, const void* lam1,
                                  const void* lam2, long long n, int v, int d,
                                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    lemma1_merge_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(p), static_cast<const int64_t*>(klass),
        static_cast<const int64_t*>(rvals), static_cast<const int64_t*>(lane),
        static_cast<const int64_t*>(width),
        static_cast<const int64_t*>(lam1), static_cast<const int64_t*>(lam2),
        n, v, d, static_cast<int64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
