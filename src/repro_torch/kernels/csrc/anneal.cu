// The placement annealer's rounds in one launch: the reference package's
// place/anneal.py::_anneal_jit (an XLA scan over rounds x steps, vmapped
// over replicas) for Hopper (sm_90a).
//
// One CTA runs one ladder (of Q, for anneal_tables_many) and one warp one
// replica; a CTA of W warps takes replicas w, w + W, ... in turn. Each step
// is serial in the replica's state, so the warp's lanes share it: every
// lane draws the proposal (the Threefry-2x32 blocks and JAX's randint,
// inline below, the same on every lane), the lanes split the item's padded
// incidence row and reduce the int64 traffic delta with shuffles (exact:
// integers), and lane 0 commits an accepted move. A CTA barrier ends each
// round for the best tracking and the parallel-tempering exchange.
//
// State in device memory: each ladder's R placements [R, N] (int32) and
// loads [R, P] (int64) sit in "slots"; the exchange permutes which slot a
// rung owns (shared memory) instead of copying rows. A slot's loads always
// equal the loads of its placement, so moving them with the placement gives
// the integers the reference gets by recomputing them from it. Costs ride
// with their rung's slot too; chain keys, thresholds and the best placement
// belong to the rung. Built with no fast math (integer code throughout).
#include <cuda_runtime.h>

#include <cstdint>

struct AnnealArgs {
  // the item set's tables, shared by the ladders, read only
  const int32_t* nbr;      // [N, D] neighbour item (0 in padding)
  const int32_t* w_inc;    // [N, D] edge weight (0 marks padding)
  const uint8_t* is_out;   // [N, D] bool: the item is the edge's source
  const int32_t* w_node;   // [N] item weight
  // per ladder, updated in place
  int32_t* pe;             // [Q, R, N] placements by slot (start: the init)
  int64_t* load;           // [Q, R, P] loads by slot
  int64_t* cost;           // [Q, R] costs by rung (start: the init's)
  uint32_t* keys;          // [Q, R, 2] chain keys by rung
  const int64_t* thresh;   // [Q, R] acceptance thresholds by rung
  int32_t* best_pe;        // [Q, R, N] best placement by rung (start: init)
  int64_t* best_cost;      // [Q, R] its cost (start: the init's)
  int n, d, nx, ny, replicas, rounds, steps;
  int64_t pw;              // pressure weight
};

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxReplicas = 1024;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// JAX's threefry2x32_p: 20 rounds, key injections every 4.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// jax.random.split(key, 2), non-partitionable layout: counters (0, 2) and
// (1, 3); new key 0 is both blocks' first word, new key 1 their second.
__device__ __forceinline__ void split2(uint32_t k0, uint32_t k1,
                                       uint32_t& a0, uint32_t& a1,
                                       uint32_t& b0, uint32_t& b1) {
  threefry(k0, k1, 0u, 2u, a0, b0);
  threefry(k0, k1, 1u, 3u, a1, b1);
}

// One 32-bit draw of shape (): the first word of block (0, 0).
__device__ __forceinline__ uint32_t bits1(uint32_t k0, uint32_t k1) {
  uint32_t y0, y1;
  threefry(k0, k1, 0u, 0u, y0, y1);
  return y0;
}

// jax.random.randint(key, (), 0, span, int32) for 0 < span < 2**31: two
// draws and the multiplier ((2**16 % span)**2 mod 2**32) % span, in uint32.
__device__ __forceinline__ int randint(uint32_t k0, uint32_t k1,
                                       uint32_t span) {
  uint32_t a0, a1, b0, b1;
  split2(k0, k1, a0, a1, b0, b1);
  const uint32_t higher = bits1(a0, a1);
  const uint32_t lower = bits1(b0, b1);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((higher % span) * mult + lower % span) % span;
  return static_cast<int>(off);
}

__device__ __forceinline__ int torus_hops(int s, int t, int nx, int ny) {
  const int sx = s / ny, sy = s % ny, tx = t / ny, ty = t % ny;
  return (tx - sx + nx) % nx + (ty - sy + ny) % ny;
}

__global__ void anneal_kernel(AnnealArgs a) {
  __shared__ int slot[kMaxReplicas];
  __shared__ int next_slot[kMaxReplicas];
  __shared__ long long cost[kMaxReplicas];
  __shared__ long long next_cost[kMaxReplicas];
  const int q = blockIdx.x;
  const int R = a.replicas, N = a.n, D = a.d, P = a.nx * a.ny;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long lad = static_cast<long long>(q) * R;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    slot[r] = r;
    cost[r] = a.cost[lad + r];
  }
  __syncthreads();
  for (int round = 0; round < a.rounds; ++round) {
    for (int r = warp; r < R; r += warps) {
      uint32_t k0 = a.keys[(lad + r) * 2], k1 = a.keys[(lad + r) * 2 + 1];
      const long long thr = a.thresh[lad + r];
      int32_t* pe = a.pe + (lad + slot[r]) * N;
      int64_t* load = a.load + (lad + slot[r]) * P;
      long long c = cost[r];
      for (int t = 0; t < a.steps; ++t) {
        uint32_t s0, s1, n0, n1, i0, i1, j0, j1;
        split2(k0, k1, s0, s1, n0, n1);   // (step key, next chain key)
        k0 = n0;
        k1 = n1;
        split2(s0, s1, i0, i1, j0, j1);   // (k1, k2)
        const int i = randint(i0, i1, static_cast<uint32_t>(N));
        const int to = randint(j0, j1, static_cast<uint32_t>(P));
        const int p = pe[i];
        long long dt = 0;
        const long long row = static_cast<long long>(i) * D;
        for (int e = lane; e < D; e += 32) {
          const int w = a.w_inc[row + e];
          if (w == 0) continue;   // padding: contributes 0
          const int nb_pe = pe[a.nbr[row + e]];
          const bool out = a.is_out[row + e] != 0;
          const int old_h = out ? torus_hops(p, nb_pe, a.nx, a.ny)
                                : torus_hops(nb_pe, p, a.nx, a.ny);
          const int new_h = out ? torus_hops(to, nb_pe, a.nx, a.ny)
                                : torus_hops(nb_pe, to, a.nx, a.ny);
          dt += static_cast<long long>(w) * (new_h - old_h);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dt += __shfl_xor_sync(0xffffffffu, dt, o);
        const long long wn = a.w_node[i];
        const long long delta =
            dt + a.pw * (2 * wn * (load[to] - load[p] + wn));
        const bool accept = delta <= thr && p != to;
        __syncwarp();   // every lane has read pe and load
        if (accept && lane == 0) {
          pe[i] = to;
          load[p] -= wn;
          load[to] += wn;
        }
        if (accept) c += delta;
        __syncwarp();   // the commit is visible to the next step's reads
      }
      if (lane == 0) {
        a.keys[(lad + r) * 2] = k0;
        a.keys[(lad + r) * 2 + 1] = k1;
        cost[r] = c;
      }
    }
    __syncthreads();
    // best tracking: a rung whose cost beat its best keeps its placement
    for (int r = warp; r < R; r += warps) {
      if (cost[r] < a.best_cost[lad + r]) {
        const int32_t* src = a.pe + (lad + slot[r]) * N;
        int32_t* dst = a.best_pe + (lad + r) * N;
        for (int v = lane; v < N; v += 32) dst[v] = src[v];
        __syncwarp();
        if (lane == 0) a.best_cost[lad + r] = cost[r];
      }
    }
    // parallel-tempering exchange (the reference's _pt_take): the lower
    // cost of each adjacent pair moves to the colder rung
    const int parity = round % 2;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const int off = r - parity;
      int partner = off < 0 ? r : (off % 2 == 0 ? r + 1 : r - 1);
      partner = partner < 0 ? 0 : (partner > R - 1 ? R - 1 : partner);
      const int lo = r < partner ? r : partner;
      const int hi = r < partner ? partner : r;
      const bool swap = partner != r && cost[hi] < cost[lo];
      const int take = swap ? partner : r;
      next_slot[r] = slot[take];
      next_cost[r] = cost[take];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      slot[r] = next_slot[r];
      cost[r] = next_cost[r];
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) a.cost[lad + r] = cost[r];
}

}  // namespace

extern "C" {

// One launch runs every round of Q ladders on the stream: Q CTAs of
// 32 * min(R, 32) threads.
int anneal_rounds(const AnnealArgs* args, int q, void* stream) {
  const AnnealArgs a = *args;
  if (q < 1 || a.replicas < 1 || a.replicas > kMaxReplicas || a.n < 1 ||
      a.d < 1 || a.nx < 1 || a.ny < 1 || a.rounds < 0 || a.steps < 0 ||
      static_cast<long long>(a.nx) * a.ny >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = a.replicas < kMaxWarps ? a.replicas : kMaxWarps;
  anneal_kernel<<<q, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
