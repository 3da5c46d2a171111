// Hierarchical leading-one detect (paper §II-B) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/lod.py: `lod` (_lod_kernel), `schedule_step`
// (_schedule_kernel) and `rotating_schedule_step`
// (_rotating_schedule_kernel). Semantics, for one PE row of W 32-bit RDY
// words: slot s lives at word s/32, bit 31 - s%32, so the first set flag in
// (word, MSB-first) order is the lowest slot, the most critical ready node.
//
//   lod_pick                    slot = first set slot, or -1 for an empty row
//   lod_schedule_step           the pick, plus a copy of the row with the
//                               picked bit cleared where gate != 0
//   lod_rotating_schedule_step  first set slot at or after ptr (words before
//                               ptr's word and bits above ptr's bit masked
//                               off), wrapping to the plain pick when that
//                               window is empty; gated clear as above
//
// Design. One warp per PE row, several rows per block. Lane l reads words
// l, l+32, ... and keys each nonzero word as word*32 + __clz(word) (INT_MAX
// for an empty word); one __reduce_min_sync gives the row's slot. Keeping a
// row inside one warp means the reduction needs no shared memory and no
// second pass. The lane that owns the picked word clears its bit.
//
// Bound. At the simulator's shapes (P = 256 PE rows, W <= 256 words) a call
// moves at most 256 KB, which takes well under a microsecond at the card's
// 3.35 TB/s: the kernel is bound by launch latency, not by device memory.
// So the engines do not launch it from the host once per cycle: on the card
// they replay each K-cycle chunk from a captured CUDA graph
// (core/overlay.py, ReplayedChunk), where a launch costs its node's time.
//
// Interface. Plain C entry points for ctypes. Pointers come from
// torch.Tensor.data_ptr(); RDY words are int32 storage holding the uint32
// bit pattern and are read here as uint32_t. `gate` is a bool (one byte)
// tensor or NULL for all rows on. Each entry point launches on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

__device__ __forceinline__ int word_key(uint32_t w, int word) {
  return w ? word * 32 + __clz(static_cast<int>(w)) : INT_MAX;
}

__device__ __forceinline__ int row_of_warp() {
  return blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
}

// Copies the row, clearing the bit of slot `best` when `clear` holds.
__device__ __forceinline__ void copy_clear(const uint32_t* __restrict__ r,
                                           uint32_t* __restrict__ out, int W,
                                           int lane, int best, bool clear) {
  const int pw = clear ? best / 32 : -1;
  const uint32_t m = 1u << (31 - (best & 31));
  for (int w = lane; w < W; w += 32) {
    uint32_t v = r[w];
    if (w == pw) v &= ~m;
    out[w] = v;
  }
}

__global__ void lod_pick_kernel(const uint32_t* __restrict__ bits,
                                int32_t* __restrict__ slot, int P, int W) {
  const int row = row_of_warp();
  if (row >= P) return;  // warp-uniform: the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const uint32_t* r = bits + static_cast<size_t>(row) * W;
  int best = INT_MAX;
  for (int w = lane; w < W; w += 32) best = min(best, word_key(r[w], w));
  best = __reduce_min_sync(kAllLanes, best);
  if (lane == 0) slot[row] = best == INT_MAX ? -1 : best;
}

__global__ void lod_schedule_kernel(const uint32_t* __restrict__ bits,
                                    const uint8_t* __restrict__ gate,
                                    int32_t* __restrict__ slot,
                                    uint32_t* __restrict__ new_bits, int P,
                                    int W) {
  const int row = row_of_warp();
  if (row >= P) return;
  const int lane = threadIdx.x % 32;
  const uint32_t* r = bits + static_cast<size_t>(row) * W;
  int best = INT_MAX;
  for (int w = lane; w < W; w += 32) best = min(best, word_key(r[w], w));
  best = __reduce_min_sync(kAllLanes, best);
  const bool have = best != INT_MAX;
  if (lane == 0) slot[row] = have ? best : -1;
  const bool clear = have && (gate == nullptr || gate[row] != 0);
  copy_clear(r, new_bits + static_cast<size_t>(row) * W, W, lane, best, clear);
}

__global__ void lod_rotating_kernel(const uint32_t* __restrict__ bits,
                                    const int32_t* __restrict__ ptr,
                                    const uint8_t* __restrict__ gate,
                                    int32_t* __restrict__ slot,
                                    uint32_t* __restrict__ new_bits, int P,
                                    int W) {
  const int row = row_of_warp();
  if (row >= P) return;
  const int lane = threadIdx.x % 32;
  const uint32_t* r = bits + static_cast<size_t>(row) * W;
  // Floor division and modulo, as the reference computes them for any ptr.
  const int p = ptr[row];
  const int pw = p >> 5;
  const uint32_t at_ptr_word = kAllLanes >> (p & 31);  // shift is < 32
  int best_hi = INT_MAX, best_all = INT_MAX;
  for (int w = lane; w < W; w += 32) {
    const uint32_t v = r[w];
    const uint32_t window = w > pw ? kAllLanes : (w < pw ? 0u : at_ptr_word);
    best_all = min(best_all, word_key(v, w));
    best_hi = min(best_hi, word_key(v & window, w));
  }
  best_all = __reduce_min_sync(kAllLanes, best_all);
  best_hi = __reduce_min_sync(kAllLanes, best_hi);
  const int best = best_hi != INT_MAX ? best_hi : best_all;
  const bool have = best_all != INT_MAX;
  if (lane == 0) slot[row] = have ? best : -1;
  const bool clear = have && (gate == nullptr || gate[row] != 0);
  copy_clear(r, new_bits + static_cast<size_t>(row) * W, W, lane, best, clear);
}

inline dim3 grid_for(int P) {
  return dim3((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

int lod_pick(const void* bits, void* slot, int P, int W, void* stream) {
  if (P > 0 && W > 0) {
    lod_pick_kernel<<<grid_for(P), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<int32_t*>(slot), P, W);
  }
  return static_cast<int>(cudaGetLastError());
}

int lod_schedule_step(const void* bits, const void* gate, void* slot,
                      void* new_bits, int P, int W, void* stream) {
  if (P > 0 && W > 0) {
    lod_schedule_kernel<<<grid_for(P), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<const uint8_t*>(gate),
        static_cast<int32_t*>(slot), static_cast<uint32_t*>(new_bits), P, W);
  }
  return static_cast<int>(cudaGetLastError());
}

int lod_rotating_schedule_step(const void* bits, const void* ptr,
                               const void* gate, void* slot, void* new_bits,
                               int P, int W, void* stream) {
  if (P > 0 && W > 0) {
    lod_rotating_kernel<<<grid_for(P), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(ptr),
        static_cast<const uint8_t*>(gate), static_cast<int32_t*>(slot),
        static_cast<uint32_t*>(new_bits), P, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
