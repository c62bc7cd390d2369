// One bitonic compare-exchange stage (k, j) over int32[N, W] rows, for Hopper.
//
// Replaces the Pallas kernels `_in_tile_kernel` and `_cross_tile_kernel` of
// src/repro/kernels/bitonic_stage.py (launched by `bitonic_stage_pallas`).
// Row i exchanges with row i^j, ascending iff (i & k) == 0; rows compare
// lexicographically on their first `num_keys` columns. The element-wise rule
// is that of `bitonic_stage_ref`: a row keeps its own value iff
// (lt(self, partner) == self_is_lower) == ascending. For rows whose keys are
// equal but whose other columns differ this copies one row over the other,
// exactly as the reference does; callers make the order strict with a unique
// index column.
//
// What bounds it on the card: bytes. A stage reads every row once and writes
// back the rows that move, 2*N*W*4 bytes at most, against a few integer
// compares per row, so HBM bandwidth (3.35 TB/s on an H100 SXM) is the limit.
// It serves one-stage calls (`ops.bitonic_stage`); a full sort runs its
// stages in fused launches instead (`bitonic_sort.cu`).
//
// What the design does about it: one thread owns one pair, so a stage needs
// no synchronisation and runs in place. Consecutive threads own consecutive
// lower rows whenever j >= 32, so a warp's loads cover contiguous rows.
// A pair whose order is already right is not written back. W and num_keys
// are runtime arguments (the window width reaches v + 1 = 186 on repetitive
// texts), so the column loops are not unrolled at compile time.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void bitonic_stage_kernel(int32_t* __restrict__ rows,
                                     long long n_pairs, int w, int num_keys,
                                     long long k, long long j) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n_pairs) return;
  // t enumerates the lower row of each pair: insert a zero bit at bit j.
  const long long lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const long long hi = lo | j;
  int32_t* a = rows + lo * w;
  int32_t* b = rows + hi * w;
  int cmp = 0;
  for (int c = 0; c < num_keys; ++c) {
    const int32_t x = a[c];
    const int32_t y = b[c];
    if (x != y) {
      cmp = x < y ? -1 : 1;
      break;
    }
  }
  const bool up = (lo & k) == 0;
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

}  // namespace

// rows: device pointer to int32[n, w], row-major; n a power of two.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bitonic_stage(void* rows, long long n, int w,
                                   int num_keys, long long k, long long j,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_pairs = n / 2;
  if (n_pairs > 0) {
    const int threads = 256;
    const long long blocks = (n_pairs + threads - 1) / threads;
    bitonic_stage_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(rows), n_pairs, w, num_keys, k, j);
  }
  return static_cast<int>(cudaGetLastError());
}
