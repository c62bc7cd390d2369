// Per-block digit counts for Hopper: the LSD radix sort's pass counter, and
// the per-block histograms of the TPU kernel's contract.
//
// Replaces the Pallas kernel `_hist_kernel` of src/repro/kernels/radix_hist.py
// (launched by `radix_histogram_pallas`), which counts the digits of each
// block with a ones @ one-hot matmul on the MXU. One kernel, two loaders,
// chosen by the element type:
//
// * The key loader (`repro_radix_pass_counts`, one launch per pass of
//   `repro_torch.kernels.ops.radix_argsort`): keys int64[N], non-negative,
//   and a shift in [0, 56]. Each thread takes d = (key >> shift) & 255 in
//   registers. With nb = ceil(N / block), it writes the bin-major counts
//   out[1 + d * nb + b] = #{i in block b, i < N : digit(i) == d} and
//   out[0] = 0, so one inclusive scan of `out` gives at d * nb + b the
//   exclusive offsets that `radix_scatter.cu` takes. The ragged last block
//   is masked by index: no pad digit, no scratch bin, no digit buffer.
// * The digit loader (`repro_radix_hist`, the TPU kernel's contract): int32
//   digits[N], N a multiple of `block`, to int32[N / block, n_bins]
//   block-major; a digit outside [0, n_bins) counts nowhere.
//
// What bounds it on the card: bytes. The key loader reads N * 8 bytes and
// writes 256 * nb * 4 (at block 4,096 the counts are 1/256 of the keys:
// 3.7 MB against 117 MB at the main path's level 0), against one
// shared-memory increment per element.
//
// What the design does about it: one CUDA block of 256 threads per `block`
// elements. A full block is read in 16-byte loads, neighbouring threads on
// neighbouring addresses, and each thread starts all of its loads (8 at
// block 4,096) before it counts any, so the block's bytes are in flight
// together; only the ragged last block, or a source that is not 16-byte
// aligned, is read an element a thread. Counts go to a histogram in shared
// memory, one shared-memory atomic per element into one histogram: on an
// H100 SXM at the main path's level 0 (PERF.md) that took the same time as
// one histogram a warp on random, constant and top-pass keys, and
// `__match_any_sync` groups took 2.5-2.6x as long on random keys. Then
// consecutive threads write consecutive bins: a stride of nb int32s in the
// bin-major layout, which L2 merges into whole sectors (a level-0 pass's
// counts are 3.7 MB).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPassBins = 256;  // digits of one 8-bit pass
constexpr int kUnroll = 8;      // 16-byte loads a thread keeps in flight

__device__ __forceinline__ int digit_of(int64_t key, int shift) {
  return static_cast<int>((static_cast<unsigned long long>(key) >> shift) &
                          0xFFu);
}

__device__ __forceinline__ int digit_of(int32_t digit, int) { return digit; }

// Counts `d` if it lies in [0, n_bins).
__device__ __forceinline__ void count(int32_t* hist, int d, int n_bins) {
  if (static_cast<unsigned>(d) < static_cast<unsigned>(n_bins)) {
    atomicAdd(&hist[d], 1);
  }
}

// Block b counts src[b * block, min((b + 1) * block, n)) and writes the
// count of bin d to out[d * bin_stride + b * block_stride]. `vec` says that
// src is 16-byte aligned and a block is a whole number of 16-byte vectors.
// With `lead`, block 0 also writes *lead = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    radix_hist_kernel(const T* __restrict__ src, int32_t* __restrict__ out,
                      int32_t* __restrict__ lead, long long n, int block,
                      int n_bins, int shift, long long bin_stride,
                      long long block_stride, bool vec) {
  extern __shared__ int32_t hist[];
  for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;
  if (lead != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *lead = 0;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const long long left = n - first;
  const int len = left < block ? static_cast<int>(left) : block;
  const T* s = src + first;
  constexpr int kPer = 16 / sizeof(T);
  if (vec && len == block) {
    const int4* v = reinterpret_cast<const int4*>(s);
    const int n_vec = block / kPer;
    for (int v0 = 0; v0 < n_vec; v0 += kThreads * kUnroll) {
      int4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = v0 + u * kThreads + threadIdx.x;
        buf[u] = j < n_vec ? v[j] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool here = v0 + u * kThreads + threadIdx.x < n_vec;
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          count(hist, here ? digit_of(e[k], shift) : -1, n_bins);
        }
      }
    }
  } else {
    for (int i0 = 0; i0 < len; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      count(hist, i < len ? digit_of(s[i], shift) : -1, n_bins);
    }
  }
  __syncthreads();
  int32_t* o = out + static_cast<long long>(blockIdx.x) * block_stride;
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    o[b * bin_stride] = hist[b];
  }
}

template <typename T>
void launch(const void* src, void* out, int32_t* lead, long long n,
            int block, int n_bins, int shift, long long bin_stride,
            long long block_stride, cudaStream_t stream) {
  const long long n_blocks = (n + block - 1) / block;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   block % (16 / sizeof(T)) == 0;
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
  radix_hist_kernel<T>
      <<<static_cast<unsigned int>(n_blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(src), static_cast<int32_t*>(out), lead, n,
          block, n_bins, shift, bin_stride, block_stride, vec);
}

}  // namespace

// The key loader. keys: int64[n], n > 0, non-negative; out:
// int32[256 * nb + 1], nb = ceil(n / block); shift in [0, 56]. The wrapper
// checks all of it. Returns cudaGetLastError() after the launch.
extern "C" int repro_radix_pass_counts(const void* keys, void* out,
                                       long long n, int block, int shift,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* lead = static_cast<int32_t*>(out);
  launch<int64_t>(keys, lead + 1, lead, n, block, kPassBins, shift,
                  (n + block - 1) / block, 1,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The digit loader. digits: int32[n], n > 0 a multiple of `block`; out:
// int32[n / block, n_bins]. n_bins * 4 bytes must fit the 48 KB of shared
// memory a block gets without opting in (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_radix_hist(const void* digits, void* out, long long n,
                                int block, int n_bins, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch<int32_t>(digits, out, nullptr, n, block, n_bins, 0, 1, n_bins,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
