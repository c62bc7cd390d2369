// Per-block digit histograms over int32 digits, for Hopper.
//
// Replaces the Pallas kernel `_hist_kernel` of src/repro/kernels/radix_hist.py
// (launched by `radix_histogram_pallas`) with the same contract: digits
// int32[N], N a multiple of `block`, go to int32[N / block, n_bins], row b
// counting the digits of block b that equal each bin. A digit outside
// [0, n_bins) is counted nowhere, as in the one-hot reference. The LSD radix
// sort of `repro_torch.kernels.ops.radix_argsort` runs it once per 8-bit pass
// and scans its rows into the scatter offsets.
//
// What bounds it on the card: bytes. It reads N int32 digits and writes
// (N / block) * n_bins int32 counts, against one shared-memory atomic per
// digit; at block = 1024 and 256 bins the output is a quarter of the input.
//
// What the design does about it: one CUDA block per digit block. The TPU
// kernel's ones @ one-hot matmul is a workaround for the TPU's slow scatter;
// here the block keeps its histogram in shared memory, every thread adds its
// digits to it with `atomicAdd` (neighbouring threads read neighbouring
// digits), and the block writes the histogram once. Skewed blocks (every
// digit in one bin) serialise their atomics on one address: correct, slower.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void radix_hist_kernel(const int32_t* __restrict__ digits,
                                  int32_t* __restrict__ out, int block,
                                  int n_bins) {
  extern __shared__ int32_t hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int32_t* d = digits + static_cast<long long>(blockIdx.x) * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const int32_t x = d[i];
    if (x >= 0 && x < n_bins) atomicAdd(&hist[x], 1);
  }
  __syncthreads();
  int32_t* row = out + static_cast<long long>(blockIdx.x) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) row[b] = hist[b];
}

}  // namespace

// digits: device pointer to int32[n], n a multiple of `block`; out:
// int32[n / block, n_bins]. n_bins * 4 bytes must fit the 48 KB of shared
// memory a block gets without opting in (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_radix_hist(const void* digits, void* out, long long n,
                                int block, int n_bins, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_blocks = n / block;
  if (n_blocks > 0) {
    radix_hist_kernel<<<static_cast<unsigned int>(n_blocks), kThreads,
                        static_cast<size_t>(n_bins) * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(digits), static_cast<int32_t*>(out),
        block, n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
