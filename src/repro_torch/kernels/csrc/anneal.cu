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
//
// The GUIDED instantiation is the reference's _anneal_guided_jit: every
// proposal is first scored by the integer-quantized surrogate
// (surrogate/delta.py), and on the round's steps j with j % every == 0 only
// proposals with dscore <= margin reach the cost rule. Each slot also
// carries its guide state in device memory (int64: loads, counts, inject,
// eject [P], the depth histogram [8, P], ring_x [ny], ring_y [nx], the 29
// features), so the exchange's slot permutation moves it with its
// placement; the promising-proposal counts (evals) belong to the rung. A
// guided step: the lanes split the item's guide incidence row, apply the
// move's per-PE deltas tentatively with int64 atomics (exact and
// reversible), reduce the 29 features over P and 8P with shuffles, form
// dscore in unsigned 64-bit arithmetic (it wraps as XLA's int64 does, and
// signed overflow would be undefined), and lane 0 decides; a rejected move
// subtracts the same deltas again. The unguided instantiation compiles to
// the code it had before GUIDED existed.
#include <cuda_runtime.h>

#include <climits>
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

// The guided search's guide (surrogate/delta.py's GuideArrays) and state.
struct GuideArgs {
  const int32_t* nbr;      // [N, Dg] neighbour item (0 in padding)
  const uint8_t* is_out;   // [N, Dg] bool: the item is the edge's source
  const int64_t* w_inc;    // [N, Dg] edge weight (0 in padding)
  const int64_t* c_inc;    // [N, Dg] critical-edge multiplicity
  const int64_t* u_inc;    // [N, Dg] edge multiplicity
  const int64_t* w_node;   // [N] item weight
  const int64_t* n_unit;   // [N] nodes an item stands for
  const int64_t* w_bucket; // [N, 8] weight per depth bucket
  const int64_t* gamma;    // [29] quantized slopes
  int64_t* state;          // [Q, R, G] guide state by slot (layout above)
  int64_t* evals;          // [Q, R] promising proposals by rung
  int64_t margin;          // the gate: dscore <= margin
  int d, every;            // Dg; the gate's period within a round
};

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxReplicas = 1024;
constexpr int kBuckets = 8;    // surrogate/features.py DEPTH_BUCKETS
constexpr int kFeatures = 13 + 2 * kBuckets;

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

__device__ __forceinline__ void atomic_add(int64_t* at, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Sum of squares (wrapping, as XLA's int64) and maximum of one value.
__device__ __forceinline__ void sq_max(long long x, unsigned long long& s,
                                       long long& m) {
  s += static_cast<unsigned long long>(x) * static_cast<unsigned long long>(x);
  m = x > m ? x : m;
}

// The guide state's offsets in a slot's G words.
struct GuideLayout {
  int P, nx, ny;
  __device__ int counts() const { return P; }
  __device__ int inject() const { return 2 * P; }
  __device__ int eject() const { return 3 * P; }
  __device__ int lvl() const { return 4 * P; }
  __device__ int ring_x() const { return (4 + kBuckets) * P; }
  __device__ int ring_y() const { return (4 + kBuckets) * P + ny; }
  __device__ int feats() const { return (4 + kBuckets) * P + ny + nx; }
  __device__ long long words() const { return feats() + kFeatures; }
};

// Adds sign x the move i: p -> to's per-PE deltas of the guide state gs
// (this lane's share of i's incidence row, plus lane 0's loads and counts
// and lanes 0-7's depth-histogram entries); with sign +1 also returns this
// lane's share of the three traffic deltas. The atomics are exact, so
// sign -1 undoes sign +1.
__device__ __forceinline__ void guide_deltas(
    const GuideArgs& g, const GuideLayout& L, int64_t* gs, const int32_t* pe,
    int i, int p, int to, int lane, long long sign, long long& dtw,
    long long& dtu, long long& dtc) {
  const int nx = L.nx, ny = L.ny;
  const long long row = static_cast<long long>(i) * g.d;
  const int px = p / ny, py = p % ny, qx = to / ny, qy = to % ny;
  for (int e = lane; e < g.d; e += 32) {
    const long long w = g.w_inc[row + e], c = g.c_inc[row + e],
                    u = g.u_inc[row + e];
    if (w == 0 && c == 0 && u == 0) continue;   // padding: contributes 0
    const int o = pe[g.nbr[row + e]];
    const bool out = g.is_out[row + e] != 0;
    const int ox = o / ny, oy = o % ny;
    const int hxo = out ? (ox - px + nx) % nx : (px - ox + nx) % nx;
    const int hyo = out ? (oy - py + ny) % ny : (py - oy + ny) % ny;
    const int hxn = out ? (ox - qx + nx) % nx : (qx - ox + nx) % nx;
    const int hyn = out ? (oy - qy + ny) % ny : (qy - oy + ny) % ny;
    const long long dh = (hxn + hyn) - (hxo + hyo);
    dtw += w * dh;
    dtu += u * dh;
    dtc += c * dh;
    const int so = out ? p : o, sn = out ? to : o;
    const int de = out ? o : p, dn = out ? o : to;
    if (u != 0 && hxo + hyo > 0) {
      atomic_add(gs + L.inject() + so, -sign * u);
      atomic_add(gs + L.eject() + de, -sign * u);
    }
    if (u != 0 && hxn + hyn > 0) {
      atomic_add(gs + L.inject() + sn, sign * u);
      atomic_add(gs + L.eject() + dn, sign * u);
    }
    if (w != 0 && hxo != 0) atomic_add(gs + L.ring_x() + so % ny, -sign * w * hxo);
    if (w != 0 && hxn != 0) atomic_add(gs + L.ring_x() + sn % ny, sign * w * hxn);
    if (w != 0 && hyo != 0) atomic_add(gs + L.ring_y() + de / ny, -sign * w * hyo);
    if (w != 0 && hyn != 0) atomic_add(gs + L.ring_y() + dn / ny, sign * w * hyn);
  }
  // loads, counts and the histogram: entries no other lane touches
  if (lane == 0) {
    const long long wn = g.w_node[i], nu = g.n_unit[i];
    gs[p] -= sign * wn;
    gs[to] += sign * wn;
    gs[L.counts() + p] -= sign * nu;
    gs[L.counts() + to] += sign * nu;
  }
  if (lane < kBuckets) {
    const long long b = g.w_bucket[static_cast<long long>(i) * kBuckets + lane];
    int64_t* lvl = gs + L.lvl() + lane * L.P;
    lvl[p] -= sign * b;
    lvl[to] += sign * b;
  }
}

// The guided step's gate. Applies the move tentatively, reduces the new
// features, and returns whether the proposal is promising (every lane gets
// the same answer); sets accept_out to the two-stage accept and leaves the
// state committed (accepted) or restored (rejected).
__device__ __forceinline__ bool guided_gate(
    const GuideArgs& g, const GuideLayout& L, int64_t* gs, const int32_t* pe,
    int i, int p, int to, int lane, bool gated, bool& accept) {
  long long dtw = 0, dtu = 0, dtc = 0;
  guide_deltas(g, L, gs, pe, i, p, to, lane, 1, dtw, dtu, dtc);
  __syncwarp();   // the tentative deltas are visible to every lane
  const int P = L.P;
  unsigned long long s_ld = 0, s_ct = 0, s_in = 0, s_ej = 0, s_rg = 0;
  long long m_ld = LLONG_MIN, m_ct = LLONG_MIN, m_in = LLONG_MIN,
            m_ej = LLONG_MIN, m_rg = LLONG_MIN;
  unsigned long long s_lv[kBuckets];
  long long m_lv[kBuckets];
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) {
    s_lv[b] = 0;
    m_lv[b] = LLONG_MIN;
  }
  for (int v = lane; v < P; v += 32) {
    sq_max(gs[v], s_ld, m_ld);
    sq_max(gs[L.counts() + v], s_ct, m_ct);
    sq_max(gs[L.inject() + v], s_in, m_in);
    sq_max(gs[L.eject() + v], s_ej, m_ej);
#pragma unroll
    for (int b = 0; b < kBuckets; ++b)
      sq_max(gs[L.lvl() + b * P + v], s_lv[b], m_lv[b]);
  }
  for (int v = lane; v < L.ny; v += 32) sq_max(gs[L.ring_x() + v], s_rg, m_rg);
  for (int v = lane; v < L.nx; v += 32) sq_max(gs[L.ring_y() + v], s_rg, m_rg);
  const int64_t* of = gs + L.feats();
  long long nf[kFeatures];
  nf[0] = of[0] + warp_sum(dtw);
  nf[1] = of[1] + warp_sum(dtu);
  nf[2] = of[2] + warp_sum(dtc);
  nf[3] = warp_sum(static_cast<long long>(s_ld));
  nf[4] = warp_max(m_ld);
  nf[5] = warp_sum(static_cast<long long>(s_ct));
  nf[6] = warp_max(m_ct);
  nf[7] = warp_sum(static_cast<long long>(s_in));
  nf[8] = warp_max(m_in);
  nf[9] = warp_sum(static_cast<long long>(s_ej));
  nf[10] = warp_max(m_ej);
  nf[11] = warp_max(m_rg);
  nf[12] = warp_sum(static_cast<long long>(s_rg));
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) {
    nf[13 + b] = warp_max(m_lv[b]);
    nf[13 + kBuckets + b] = warp_sum(static_cast<long long>(s_lv[b]));
  }
  // dscore = sum(gamma_q * (f_new - f_old)), wrapping
  unsigned long long ds = 0;
#pragma unroll
  for (int f = 0; f < kFeatures; ++f)
    ds += static_cast<unsigned long long>(g.gamma[f]) *
          (static_cast<unsigned long long>(nf[f]) -
           static_cast<unsigned long long>(of[f]));
  const bool promising = !gated || static_cast<long long>(ds) <= g.margin;
  accept = accept && promising;
  __syncwarp();   // every lane has read the old features
  if (accept) {
    if (lane == 0) {
      int64_t* f_out = gs + L.feats();
#pragma unroll
      for (int f = 0; f < kFeatures; ++f) f_out[f] = nf[f];
    }
  } else {
    guide_deltas(g, L, gs, pe, i, p, to, lane, -1, dtw, dtu, dtc);
  }
  return promising;
}

template <bool GUIDED>
__global__ void anneal_kernel(AnnealArgs a, GuideArgs g) {
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
      long long ev = 0;   // GUIDED: this round's promising proposals
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
        bool accept = delta <= thr && p != to;
        if constexpr (GUIDED) {
          const bool gated = t % g.every == 0;
          // an ungated proposal that the cost rule rejects changes nothing
          if (gated || accept) {
            const GuideLayout L{P, a.nx, a.ny};
            int64_t* gs = g.state + (lad + slot[r]) * L.words();
            ev += guided_gate(g, L, gs, pe, i, p, to, lane, gated, accept);
          } else {
            ev += 1;
          }
        }
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
        if constexpr (GUIDED) g.evals[lad + r] += ev;
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

static bool valid(const AnnealArgs& a, int q) {
  return q >= 1 && a.replicas >= 1 && a.replicas <= kMaxReplicas &&
         a.n >= 1 && a.d >= 1 && a.nx >= 1 && a.ny >= 1 && a.rounds >= 0 &&
         a.steps >= 0 && static_cast<long long>(a.nx) * a.ny < (1LL << 31);
}

static int warps_of(const AnnealArgs& a) {
  return a.replicas < kMaxWarps ? a.replicas : kMaxWarps;
}

// One launch runs every round of Q ladders on the stream: Q CTAs of
// 32 * min(R, 32) threads.
int anneal_rounds(const AnnealArgs* args, int q, void* stream) {
  const AnnealArgs a = *args;
  if (!valid(a, q)) return static_cast<int>(cudaErrorInvalidValue);
  anneal_kernel<false><<<q, 32 * warps_of(a), 0,
                         static_cast<cudaStream_t>(stream)>>>(a, GuideArgs{});
  return static_cast<int>(cudaGetLastError());
}

// The surrogate-guided search: the same launch of the GUIDED instantiation.
int anneal_guided_rounds(const AnnealArgs* args, const GuideArgs* guide,
                         int q, void* stream) {
  const AnnealArgs a = *args;
  const GuideArgs g = *guide;
  if (!valid(a, q) || g.d < 1 || g.every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  anneal_kernel<true><<<q, 32 * warps_of(a), 0,
                        static_cast<cudaStream_t>(stream)>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
