// Segment boundaries and block-inclusive prefix sums over sorted int32[N, W]
// rows, for Hopper.
//
// Replaces the Pallas kernel `_seg_kernel` of src/repro/kernels/seg_boundary.py
// (launched by `seg_boundary_pallas`) with the same contract: for every block
// of `block` rows, flag[i] = 1 iff row i differs from row i-1 on the first
// `num_keys` columns (the first row of each block is forced to 1), csum is
// the inclusive prefix sum of the flags inside the block, and total[b] is the
// block's flag count. `dense_rank_sorted` stitches the blocks into global
// dense ranks with a few PyTorch ops.
//
// What bounds it on the card: bytes. It reads the N*num_keys key columns once
// (each row is also read by its successor's thread, which L1/L2 serves) and
// writes 2*N + N/block int32, against one compare per key and a scan step
// per row.
//
// What the design does about it: one CUDA block per row block, one thread per
// row, so the rows a warp reads are contiguous. The scan stays on chip: a
// warp-shuffle inclusive scan, then one warp scans the per-warp totals held
// in shared memory. Nothing but the three outputs goes back to device memory.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void seg_boundary_kernel(const int32_t* __restrict__ rows,
                                    int32_t* __restrict__ flags,
                                    int32_t* __restrict__ csum,
                                    int32_t* __restrict__ totals, int w,
                                    int num_keys) {
  __shared__ int32_t warp_sums[32];
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  int f = 1;
  if (tid != 0) {
    const int32_t* r = rows + row * w;
    const int32_t* p = r - w;
    f = 0;
    for (int c = 0; c < num_keys; ++c) {
      if (r[c] != p[c]) {
        f = 1;
        break;
      }
    }
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int s = f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += y;
  }
  if (lane == 31) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ws, off);
      if (lane >= off) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  if (warp > 0) s += warp_sums[warp - 1];
  flags[row] = f;
  csum[row] = s;
  if (tid == blockDim.x - 1) totals[blockIdx.x] = s;
}

}  // namespace

// rows: device pointer to sorted int32[n, w]; n a multiple of `block`;
// block a power of two in [32, 1024]. flags, csum: int32[n]; totals:
// int32[n / block]. Returns cudaGetLastError() after the launch.
extern "C" int repro_seg_boundary(const void* rows, void* flags, void* csum,
                                  void* totals, long long n, int w,
                                  int num_keys, int block, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_blocks = n / block;
  if (n_blocks > 0) {
    seg_boundary_kernel<<<static_cast<unsigned int>(n_blocks), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<int32_t*>(flags),
        static_cast<int32_t*>(csum), static_cast<int32_t*>(totals), w,
        num_keys);
  }
  return static_cast<int>(cudaGetLastError());
}
