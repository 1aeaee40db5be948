// K8: the PACKED policy's widening, for Hopper (sm_90a). It replaces the
// reference package's in-trace unpack, engine/packing.py:70 `unpack_bits`
// and :158 `make_unpacker` (the `widen` of every packed or narrow leaf that
// engine.py, gang.py and preempt.py call at the top of their closures):
//
//   bits   int32 words [..., W] -> bool [..., n]: bit j of word w is lane
//          32 w + j; no lane at or past n is written, the tail word's
//          padding bits are never read into a lane;
//   int8   -> int32, sign-extended;
//   int16  -> int32, sign-extended (ids carry negative sentinels: -1, -2,
//          -3).
//
// One launch widens every packed or narrow leaf of one encoding. The leaves
// come from a device table, a row of 8 int64s a leaf (engine/cuda.py
// `pack_widen` writes it): source and destination addresses, kind, words a
// row (W), lanes (n), output elements, the leaf's first chunk, and a pad. The
// output of every leaf is cut into chunks of kChunk elements; a block walks
// the chunks in a grid-stride loop, finds a chunk's leaf by a binary search
// over the first-chunk column, and its threads write the chunk's elements
// (neighbouring threads, neighbouring outputs). Exact leaves never enter the
// table: the logical planes point at the same tensors. The wrapper leaves
// out empty leaves and launches nothing when no element is left (a grid of
// 0 blocks is an invalid launch).
//
// Bound on the card: bytes. Each call reads every packed and narrow leaf
// once and writes its widened form once (about 135 MB on the default cell,
// 40 us at 3.35 TB/s); it does no arithmetic to speak of. The design keeps
// every store coalesced and reads a bit plane's word once per 32 lanes
// from L1. It runs once a pass, at the pass's entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 1024;  // output elements a chunk
constexpr int kCols = 8;            // table columns
constexpr int kBits = 0, kInt8 = 1, kInt16 = 2;

__global__ void __launch_bounds__(kThreads)
pack_widen_kernel(const long long* __restrict__ table, int n_leaves, long long n_chunks) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the leaf of chunk c: the last row whose first chunk is <= c
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[(long long)mid * kCols + 6] <= c) lo = mid; else hi = mid - 1;
    }
    const long long* leaf = table + (long long)lo * kCols;
    const long long n = leaf[5];
    const long long e0 = (c - leaf[6]) * kChunk;
    const long long e1 = e0 + kChunk < n ? e0 + kChunk : n;
    const int kind = (int)leaf[2];
    if (kind == kBits) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(leaf[0]);
      uint8_t* dst = reinterpret_cast<uint8_t*>(leaf[1]);
      const long long w = leaf[3], lanes = leaf[4];
      for (long long t = e0 + threadIdx.x; t < e1; t += blockDim.x) {
        const long long r = t / lanes, j = t - r * lanes;
        // the word as uint32_t: a logical shift, whatever bit 31 holds
        dst[t] = (uint8_t)((src[r * w + (j >> 5)] >> (unsigned)(j & 31)) & 1u);
      }
    } else if (kind == kInt8) {
      const int8_t* src = reinterpret_cast<const int8_t*>(leaf[0]);
      int32_t* dst = reinterpret_cast<int32_t*>(leaf[1]);
      for (long long t = e0 + threadIdx.x; t < e1; t += blockDim.x) dst[t] = (int32_t)src[t];
    } else {
      const int16_t* src = reinterpret_cast<const int16_t*>(leaf[0]);
      int32_t* dst = reinterpret_cast<int32_t*>(leaf[1]);
      for (long long t = e0 + threadIdx.x; t < e1; t += blockDim.x) dst[t] = (int32_t)src[t];
    }
  }
}

}  // namespace

// The C interface (bound with ctypes): `table` is the device table of
// `n_leaves` rows, `n_chunks` the chunks of all of them (> 0), `n_blocks`
// the grid. Returns the launch's cudaError.
extern "C" int pack_widen(const void* table, int n_leaves, long long n_chunks, int n_blocks,
                          void* stream) {
  pack_widen_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves, n_chunks);
  return (int)cudaGetLastError();
}

// The chunk size, for the wrapper's table.
extern "C" long long pack_widen_chunk() { return kChunk; }
