// One stable scatter pass of an LSD radix sort over int64 keys, for Hopper.
//
// The second half of one 8-bit pass of `repro_torch.kernels.ops.radix_argsort`,
// after `radix_hist.cu` has counted each block's digits and the wrapper has
// scanned the counts into `offsets`. It replaces no TPU kernel: the JAX
// radix impl sorts in numpy at src/repro/core/dcv_jax.py:170.
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
// writes are the hard part: each element goes to its digit's range, so a
// block's writes split into 256 runs, and lanes that write straight from
// their input position fill only a few elements of each 32-byte sector.
//
// What the design does about it: one CUDA block of 8 warps per `block`
// elements (4,096 on the sort's path, up to 16 an thread); warp w owns a
// contiguous eighth of them. First every lane loads all of its elements, so
// many loads are in flight. Then the warp walks its slice 32 at a time, in
// order: `__match_any_sync` groups the lanes that hold the same digit; a
// lane's rank among its group is the popcount of the group below it, and the
// group's lowest lane adds the group size to the warp's count for that digit
// in shared memory, so no atomics are needed and ranks follow element order.
// One thread per digit turns the 8 warps' counts into exclusive prefixes and
// a block-wide scan over the digits gives each digit's first slot, so every
// element has a slot in (digit, position) order: a local counting sort. The
// block writes keys and payloads to those slots in shared memory, then
// consecutive threads take consecutive slots and write them out to
// offsets[d, block] + (slot - first slot of d). The writes run along each
// digit's range: about 16 elements a run at 4,096 elements and random digits.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxItems = 16;  // block <= kThreads * kMaxItems = 4096

static_assert(kThreads == kBins, "one thread per digit in the scan");

template <typename P>
__global__ void __launch_bounds__(kThreads)
    radix_scatter_kernel(const int64_t* __restrict__ keys,
                         const P* __restrict__ payload,
                         int64_t* __restrict__ keys_out,
                         P* __restrict__ payload_out,
                         const int32_t* __restrict__ offsets, long long n,
                         long long n_blocks, int block, int items,
                         int shift) {
  extern __shared__ int64_t slot_keys[];       // [block]
  P* slot_pay = reinterpret_cast<P*>(slot_keys + block);  // [block]
  __shared__ int32_t base[kWarps][kBins];
  __shared__ int32_t dest[kBins];  // global slot of the digit's local slot 0
  __shared__ int32_t warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&base[0][0])[i] = 0;
  }
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const long long start = first + static_cast<long long>(warp) * items * 32;
  int64_t key[kMaxItems];
  P pay[kMaxItems];
  int digit[kMaxItems];
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    key[r] = 0;
    pay[r] = 0;
    digit[r] = kBins;  // no element: a value no real digit takes
    const long long i = start + r * 32 + lane;
    if (r < items && i < n) {
      key[r] = keys[i];
      pay[r] = payload[i];
      digit[r] = static_cast<int>(
          (static_cast<unsigned long long>(key[r]) >> shift) & 0xFFu);
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int rank[kMaxItems];
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    rank[r] = 0;
    if (r < items) {  // uniform across the block
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
  // thread d: the warps' counts of digit d -> exclusive prefixes, then a
  // block-wide exclusive scan of the digit totals.
  const int d = threadIdx.x;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = base[w][d];
    base[w][d] = total;
    total += c;
  }
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int local_start = incl - total;
  for (int w = 0; w < warp; ++w) local_start += warp_total[w];
  for (int w = 0; w < kWarps; ++w) base[w][d] += local_start;
  dest[d] = offsets[static_cast<long long>(d) * n_blocks + blockIdx.x] -
            local_start;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    if (r < items && digit[r] < kBins) {
      const int slot = base[warp][digit[r]] + rank[r];
      slot_keys[slot] = key[r];
      slot_pay[slot] = pay[r];
    }
  }
  __syncthreads();
  const long long left = n - first;
  const int count = left < block ? static_cast<int>(left) : block;
  for (int s = threadIdx.x; s < count; s += kThreads) {
    const int64_t k = slot_keys[s];
    const int dg = static_cast<int>(
        (static_cast<unsigned long long>(k) >> shift) & 0xFFu);
    const long long dst = static_cast<long long>(dest[dg]) + s;
    if (keys_out != nullptr) keys_out[dst] = k;
    payload_out[dst] = slot_pay[s];
  }
}

template <typename P>
int launch(const void* keys, const void* payload, void* keys_out,
           void* payload_out, const void* offsets, long long n,
           long long n_blocks, int block, int shift, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block) * (sizeof(int64_t) +
                                                    sizeof(P));
  cudaError_t err = cudaFuncSetAttribute(
      radix_scatter_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scatter_kernel<P><<<static_cast<unsigned int>(n_blocks), kThreads,
                            smem, stream>>>(
      static_cast<const int64_t*>(keys), static_cast<const P*>(payload),
      static_cast<int64_t*>(keys_out), static_cast<P*>(payload_out),
      static_cast<const int32_t*>(offsets), n, n_blocks, block,
      block / kThreads, shift);
  return 0;
}

}  // namespace

// keys: int64[n], non-negative; payload: int32[n] (payload_bytes 4) or
// int64[n] (8); keys_out (may be null: keys are then not written) and
// payload_out of the same types; offsets: int32[256, ceil(n / block)].
// block a multiple of 256 in [256, 4096]; shift in [0, 56]. The wrapper
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
    const int status =
        payload_bytes == 4
            ? launch<int32_t>(keys, payload, keys_out, payload_out, offsets,
                              n, n_blocks, block, shift, s)
            : launch<int64_t>(keys, payload, keys_out, payload_out, offsets,
                              n, n_blocks, block, shift, s);
    if (status != 0) return status;
  }
  return static_cast<int>(cudaGetLastError());
}
