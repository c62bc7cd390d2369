// The sentinel-separator layout of a multi-document corpus, placed on the
// card in one launch.
//
// Replaces no TPU kernel: the JAX package encodes the corpus on the host
// (src/repro/api/index.py, `encode_docs`), one numpy shift and one
// separator array a document, and so did the port. Here the host copies the
// raw documents back to back into one pinned buffer, and this kernel makes
// the encoded text from that copy on the device.
//
// Input: flat int64[n], the documents' tokens back to back, and ends
// int64[d], the documents' cumulative ends (ends[k] = the tokens of
// documents 0..k). Output: text int64[n + d] with
//   text[j + doc(j)] = flat[j] + d   for every data position j, where
//                                    doc(j) is the first k with ends[k] > j;
//   text[ends[k] + k] = k            for every document k (its separator),
// and *flag = 1 if any flat[j] < 0 (the entry point zeroes it first).
//
// Each block takes a tile of kThreads * kItems consecutive data positions.
// Thread 0 finds the documents of the tile's first and last positions by
// binary search over the ends (2 MB for 2^18 documents: they stay in L2);
// every thread then takes its positions j = tile + t, tile + t + kThreads,
// ... in order, and finds each one's document by a binary search that starts
// at the previous one's and ends at the tile's last, a few steps through L1
// when documents are long and never more than log2 of the tile's documents
// when they are short or empty. Block b also writes the separators of
// documents b * kThreads .. b * kThreads + kThreads - 1; the grid has
// enough blocks for both.
//
// What bounds it on the card: bytes. Each token is read once (8 bytes) and
// written once (8 bytes), so 16 bytes a token, plus 16 bytes a document for
// its end and its separator. The loads of a thread's kItems positions are
// started before any store, neighbouring threads on neighbouring addresses;
// the stores land on neighbouring addresses too, shifted by one slot at
// each document boundary.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;

// First k in [lo, hi) with ends[k] > j, or hi if there is none.
__device__ __forceinline__ long long upper_bound(
    const int64_t* __restrict__ ends, long long lo, long long hi,
    long long j) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
encode_place_kernel(const int64_t* __restrict__ flat,
                    const int64_t* __restrict__ ends, long long n,
                    long long d, int64_t* __restrict__ text,
                    int* __restrict__ flag) {
  __shared__ long long s_first, s_last;
  const long long tile = static_cast<long long>(blockIdx.x) * kTile;
  bool negative = false;
  if (tile < n) {  // uniform across the block
    const long long tile_end = tile + kTile < n ? tile + kTile : n;
    if (threadIdx.x == 0) {
      s_first = upper_bound(ends, 0, d, tile);
      s_last = upper_bound(ends, s_first, d, tile_end - 1);
    }
    __syncthreads();
    const long long last = s_last;
    int64_t value[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = tile + i * kThreads + threadIdx.x;
      value[i] = j < tile_end ? flat[j] : 0;
    }
    long long doc = s_first;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = tile + i * kThreads + threadIdx.x;
      if (j < tile_end) {
        doc = upper_bound(ends, doc, last + 1, j);
        negative |= value[i] < 0;
        text[j + doc] = value[i] + d;
      }
    }
  }
  const long long sep = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (sep < d) {
    text[__ldg(ends + sep) + sep] = sep;
  }
  if (__syncthreads_or(negative) && threadIdx.x == 0) {
    *flag = 1;
  }
}

}  // namespace

// flat: int64[n]; ends: int64[d], non-decreasing, ends[d - 1] == n; text:
// int64[n + d]; flag: int32[1]. Every pointer on `device`; the wrapper
// checks shapes, types and devices. Returns the first CUDA error of the
// flag's reset and the launch.
extern "C" int repro_encode_place(const void* flat, const void* ends,
                                  long long n, long long d, void* text,
                                  void* flag, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long data_blocks = (n + kTile - 1) / kTile;
  const long long sep_blocks = (d + kThreads - 1) / kThreads;
  const long long blocks =
      data_blocks > sep_blocks ? data_blocks : sep_blocks;
  if (blocks > 0) {
    encode_place_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          s>>>(
        static_cast<const int64_t*>(flat), static_cast<const int64_t*>(ends),
        n, d, static_cast<int64_t*>(text), static_cast<int*>(flag));
  }
  return static_cast<int>(cudaGetLastError());
}
