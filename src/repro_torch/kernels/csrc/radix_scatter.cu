// One stable scatter pass of an LSD radix sort over int64 keys, for Hopper.
//
// The second half of one 8-bit pass of `repro_torch.kernels.ops.radix_argsort`,
// after `radix_hist.cu` has counted each block's digits and the wrapper has
// scanned the counts into `offsets`. It has no TPU counterpart: the JAX
// package's "radix" window sort runs its passes in numpy on the host.
//
// Contract: with digit(i) = (keys[i] >> shift) & 0xFF and block(i) =
// i / block, element i (key and payload) goes to
//   offsets[digit(i), block(i)] + #{j < i in block(i) : digit(j) == digit(i)}.
// `offsets` is int32[256, ceil(n / block)], the exclusive scan of the
// per-block histograms in bin-major, block-minor order, so the pass is a
// stable counting sort by digit. Stability inside a block is what makes LSD
// right: equal digits must keep their input order.
//
// What bounds it on the card: bytes. A pass reads an int64 key and a payload
// per element and writes both back, against a few integer operations. The
// writes land in runs of about block / 256 elements, so they are poorly
// coalesced; reordering a block in shared memory before it writes is left
// for later work.
//
// What the design does about it: one CUDA block of 8 warps per `block`
// elements; warp w owns a contiguous eighth of them and walks it 32 at a
// time, in order. In each step `__match_any_sync` groups the lanes that hold
// the same digit; a lane's rank among its group is the popcount of the group
// below it, and the group's lowest lane adds the group size to the warp's
// count for that digit in shared memory, so no atomics are needed and ranks
// follow element order. Then one thread per digit turns the 8 warps' counts
// into exclusive prefixes and adds the block's offset, and every element is
// written once. Keys and payloads stay in registers between the two phases.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxItems = 8;  // block <= kThreads * kMaxItems = 2048

template <typename P>
__global__ void radix_scatter_kernel(const int64_t* __restrict__ keys,
                                     const P* __restrict__ payload,
                                     int64_t* __restrict__ keys_out,
                                     P* __restrict__ payload_out,
                                     const int32_t* __restrict__ offsets,
                                     long long n, long long n_blocks,
                                     int block, int items, int shift) {
  __shared__ int32_t base[kWarps][kBins];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&base[0][0])[i] = 0;
  }
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * block +
                          static_cast<long long>(warp) * items * 32;
  const unsigned below = (1u << lane) - 1u;
  int64_t key[kMaxItems];
  P pay[kMaxItems];
  int digit[kMaxItems];
  int rank[kMaxItems];
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    key[r] = 0;
    pay[r] = 0;
    digit[r] = kBins;  // no element: a value no real digit takes
    rank[r] = 0;
    if (r < items) {  // uniform across the block
      const long long i = start + r * 32 + lane;
      if (i < n) {
        key[r] = keys[i];
        pay[r] = payload[i];
        digit[r] = static_cast<int>(
            (static_cast<unsigned long long>(key[r]) >> shift) & 0xFFu);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit[r]);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader && digit[r] < kBins) {
        before = base[warp][digit[r]];
        base[warp][digit[r]] = before + __popc(peers);
      }
      before = __shfl_sync(0xffffffffu, before, leader);
      __syncwarp();
      rank[r] = before + __popc(peers & below);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    int32_t run = offsets[static_cast<long long>(b) * n_blocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = base[w][b];
      base[w][b] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    if (r < items && digit[r] < kBins) {
      const long long dst = base[warp][digit[r]] + rank[r];
      if (keys_out != nullptr) keys_out[dst] = key[r];
      payload_out[dst] = pay[r];
    }
  }
}

template <typename P>
void launch(const void* keys, const void* payload, void* keys_out,
            void* payload_out, const void* offsets, long long n,
            long long n_blocks, int block, int shift, cudaStream_t stream) {
  radix_scatter_kernel<P><<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                            stream>>>(
      static_cast<const int64_t*>(keys), static_cast<const P*>(payload),
      static_cast<int64_t*>(keys_out), static_cast<P*>(payload_out),
      static_cast<const int32_t*>(offsets), n, n_blocks, block,
      block / kThreads, shift);
}

}  // namespace

// keys: int64[n], non-negative; payload: int32[n] (payload_bytes 4) or
// int64[n] (8); keys_out (may be null: keys are then not written) and
// payload_out of the same types; offsets: int32[256, ceil(n / block)].
// block a multiple of 256 in [256, 2048]; shift in [0, 56]. The wrapper
// checks all of it. Returns cudaGetLastError() after the launch.
extern "C" int repro_radix_scatter(const void* keys, const void* payload,
                                   void* keys_out, void* payload_out,
                                   const void* offsets, long long n,
                                   int block, int shift, int payload_bytes,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_blocks = (n + block - 1) / block;
  if (n_blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (payload_bytes == 4) {
      launch<int32_t>(keys, payload, keys_out, payload_out, offsets, n,
                      n_blocks, block, shift, s);
    } else {
      launch<int64_t>(keys, payload, keys_out, payload_out, offsets, n,
                      n_blocks, block, shift, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
