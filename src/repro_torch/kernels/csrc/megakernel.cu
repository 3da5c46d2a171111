// The overlay's K-cycle chunk in one launch (the "megakernel") for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/megakernel.py::make_mega_chunk_fn (inner `kernel`),
// solo form. It computes what that kernel computes: K back-to-back cycles of
// the overlay's one-cycle transition (repro_torch/core/overlay.py
// make_cycle_fn: fanout inject, Hoplite route, eject scatters, fire and
// ALU, the policy's on_ready and step, termination), the per-cycle done
// trace [K], and the chunk repair of `cycle` and `done` at the end.
//
// Design. One persistent CTA per simulation, one thread per PE. Nearly
// every update of a cycle is local to one PE: inject reads the PE's own edge
// records and value, ejects land in the PE's own slot planes, on_ready and
// step touch the PE's own scheduler row. Only two things cross PEs: the
// Hoplite link registers (read from the west and north neighbour's previous
// cycle) and the termination predicate and stat counters (grid-wide sums).
// So the K cycles run as a loop inside one block: the links are
// double-buffered by cycle parity in a global scratch buffer (L1/L2
// resident), and one __syncthreads ends each cycle, after each warp has
// written its partial sums; warp 0 reduces them and thread 0 keeps the
// counters and writes the done trace. Each thread loops over its PEs (one
// up to 1024 PEs) and loads and stores a PE's own registers (active, cursor,
// scheduler head/size/pointer) around its cycle. Keeping those registers in
// the thread and the links in shared memory was timed at 16x16: no faster.
//
// Bound. A chunk's bytes are the graph leaves it reads (opcode, fanout
// ranges, edge records) read once and the state leaves read and written
// once: ~1.3 MB at 16x16 x 64 slots, 0.39 us at 3.35 TB/s.
// The kernel is bound instead by the latency of one SM's dependent loads of
// graph memory and slot planes (L2-resident at these sizes) and its per-cycle
// barrier. The design keeps all K cycles in one launch, so the ~175 host
// launches per cycle of the eager engine become one launch per chunk.
//
// Exactness. Every state leaf matches the eager engine bit for bit,
// including fields of invalid packets on the links and the sign of zero in
// the float planes (each eject port adds +0.0 at its clamped cell even when
// invalid, as the eager scatter does). Floats use __fadd_rn/__fmul_rn/
// __fdiv_rn, which are never contracted into FMAs. RDY words are int32
// storage of the uint32 pattern; slot s is bit 31 - s%32 of word s/32.
//
// Interface. A plain C entry point for ctypes: mega_chunk(args, policy,
// eject, stream) takes the tensors' pointers in one struct (MegaArgs), launches
// on the given stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Policy { kOoo = 0, kInorder = 1, kRotating = 2 };
enum Eject { kNFirst = 0, kPriority = 1, kCap2 = 2 };
enum Field { kValid = 0, kDstX, kDstY, kDstSlot, kOpidx, kValue, kFields };
enum Stat { kFired = 0, kDelivered, kDNoc, kDEj, kBusyPes, kStats };

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

constexpr int OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4;
constexpr float kDivEps = 1e-3f;

}  // namespace

// Field order mirrors kernels/megakernel.py::_Args.
struct MegaArgs {
  // graph memory, read only
  const int32_t* opcode;       // [P, L]
  const int32_t* fo_base;      // [P, L]
  const int32_t* fo_count;     // [P, L]
  const int32_t* e_dst_pe;     // [P, emax]
  const int32_t* e_dst_slot;   // [P, emax]
  const int32_t* e_dst_opidx;  // [P, emax]
  // state, updated in place
  int32_t* pending;    // [P, L]
  float* operands;     // [P, L, 2]
  uint8_t* computed;   // [P, L] bool
  float* value;        // [P, L]
  int32_t* remaining;  // 0-dim
  uint32_t* rdy;       // [P, W] (ooo, rotating)
  int32_t* ptr;        // [P] (rotating)
  int32_t* fifo;       // [P, L] (inorder)
  int32_t* head;       // [P] (inorder)
  int32_t* size;       // [P] (inorder)
  int32_t* active;     // [P]
  int32_t* cursor;     // [P]
  int32_t* cursor_end; // [P]
  const int32_t* sel_lat;  // 0-dim
  int32_t* sel_wait;   // [P]
  int32_t* link_e;     // [6, P]
  int32_t* link_s;     // [6, P]
  int32_t* cycle;      // 0-dim
  uint8_t* done;       // 0-dim bool
  int32_t* delivered;  // 0-dim counters
  int32_t* noc_deflections;
  int32_t* eject_deflections;
  int32_t* deflections;
  int32_t* busy_cycles;
  // scratch from the wrapper
  uint8_t* trace;          // [K] bool
  int32_t* link_scratch;   // [2, 2, 6, P] links of the cycle's two parities
  int32_t nx, ny, L, W, emax, K;
};

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Floor division and modulo, as torch's // and % compute them on ints.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}

__device__ __forceinline__ float alu(int op, float a, float b) {
  switch (op) {
    case OP_ADD: return __fadd_rn(a, b);
    case OP_SUB: return __fsub_rn(a, b);
    case OP_MUL: return __fmul_rn(a, b);
    case OP_DIV: return __fdiv_rn(a, __fadd_rn(b, b >= 0.0f ? kDivEps : -kDivEps));
    default: return 0.0f;
  }
}

struct Pkt {
  int f[kFields];
};

// pk_invalidate: only `valid` changes; every other field is kept.
__device__ __forceinline__ Pkt invalidated(Pkt p, bool keep) {
  if (!keep) p.f[kValid] = 0;
  return p;
}

// A PE's own registers, carried across cycles.
struct PeRegs {
  int active, cursor, cursor_end, sel_wait;
  int head, size, ptr;  // inorder head/size, rotating pointer
};

template <int POLICY>
__device__ __forceinline__ PeRegs load_regs(const MegaArgs& a, int p) {
  PeRegs r;
  r.active = a.active[p];
  r.cursor = a.cursor[p];
  r.cursor_end = a.cursor_end[p];
  r.sel_wait = a.sel_wait[p];
  r.head = POLICY == kInorder ? a.head[p] : 0;
  r.size = POLICY == kInorder ? a.size[p] : 0;
  r.ptr = POLICY == kRotating ? a.ptr[p] : 0;
  return r;
}

template <int POLICY>
__device__ __forceinline__ void store_regs(const MegaArgs& a, int p,
                                           const PeRegs& r) {
  a.active[p] = r.active;
  a.cursor[p] = r.cursor;
  a.cursor_end[p] = r.cursor_end;
  a.sel_wait[p] = r.sel_wait;
  if (POLICY == kInorder) {
    a.head[p] = r.head;
    a.size[p] = r.size;
  }
  if (POLICY == kRotating) a.ptr[p] = r.ptr;
}

// Leading-one picks over one PE's RDY row. `nonzero` counts the row's
// nonzero words, for the scheduler-empty test.
__device__ __forceinline__ int lod_row(const uint32_t* row, int W,
                                       int* nonzero) {
  int best = -1, nz = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t v = row[w];
    if (v) {
      ++nz;
      if (best < 0) best = w * 32 + __clz(static_cast<int>(v));
    }
  }
  *nonzero = nz;
  return best;
}

__device__ __forceinline__ int rotating_lod_row(const uint32_t* row, int W,
                                                int ptr, int* nonzero) {
  const int pw = ptr >> 5;
  const uint32_t at_ptr_word = kAllLanes >> (ptr & 31);
  int best_all = -1, best_hi = -1, nz = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t v = row[w];
    if (v) {
      ++nz;
      if (best_all < 0) best_all = w * 32 + __clz(static_cast<int>(v));
    }
    const uint32_t m = v & (w > pw ? kAllLanes : (w < pw ? 0u : at_ptr_word));
    if (m && best_hi < 0) best_hi = w * 32 + __clz(static_cast<int>(m));
  }
  *nonzero = nz;
  return best_hi >= 0 ? best_hi : best_all;
}

// One cycle of PE p. `in` holds the previous cycle's links, `out` receives
// this cycle's; both are [2 (E, S), 6, P]. Adds this PE's terms to `st`.
template <int POLICY, int EJECT>
__device__ __forceinline__ void pe_cycle(const MegaArgs& a, int p, PeRegs& r,
                                         const int* in, int* out, int sel_lat,
                                         int st[kStats]) {
  constexpr int E = EJECT == kCap2 ? 2 : 1;
  const int nx = a.nx, ny = a.ny, L = a.L, P = nx * ny;
  const int x = p / ny, y = p - (p / ny) * ny;
  const size_t row = static_cast<size_t>(p) * L;

  // ---- 1. the injection packet from the active node's fanout cursor
  const bool inj_valid = r.active >= 0 && r.cursor < r.cursor_end;
  const size_t eb = static_cast<size_t>(p) * a.emax + clampi(r.cursor, 0, a.emax - 1);
  Pkt inj;
  const int dst_pe = a.e_dst_pe[eb];
  inj.f[kValid] = inj_valid ? 1 : 0;
  inj.f[kDstX] = floordiv(dst_pe, ny);
  inj.f[kDstY] = floormod(dst_pe, ny);
  inj.f[kDstSlot] = a.e_dst_slot[eb];
  inj.f[kOpidx] = a.e_dst_opidx[eb];
  inj.f[kValue] = __float_as_int(a.value[row + clampi(r.active, 0, L - 1)]);

  // ---- 2. the Hoplite router
  const int pw = (x == 0 ? nx - 1 : x - 1) * ny + y;   // west neighbour
  const int pn = x * ny + (y == 0 ? ny - 1 : y - 1);   // north neighbour
  Pkt w, n;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    w.f[f] = in[f * P + pw];
    n.f[f] = in[(kFields + f) * P + pn];
  }
  const bool w_v = w.f[kValid] != 0, n_v = n.f[kValid] != 0;
  const bool w_xeq = w.f[kDstX] == x, n_xeq = n.f[kDstX] == x,
             i_xeq = inj.f[kDstX] == x;
  const bool w_at = w_v && w_xeq && w.f[kDstY] == y;
  const bool n_at = n_v && n_xeq && n.f[kDstY] == y;
  const bool inj_local = inj_valid && i_xeq && inj.f[kDstY] == y;
  const bool w_wants_e = w_v && !w_xeq, i_wants_e = inj_valid && !i_xeq;
  const bool w_wants_s = w_v && w_xeq && w.f[kDstY] != y;
  const bool i_wants_s = inj_valid && i_xeq && inj.f[kDstY] != y;

  bool n_ej, w_ej;
  if constexpr (EJECT == kCap2) {
    n_ej = n_at;
    w_ej = w_at;
  } else if constexpr (EJECT == kPriority) {
    const bool w_wins = w_at && n_at && w.f[kDstSlot] < n.f[kDstSlot];
    n_ej = n_at && !w_wins;
    w_ej = w_at && (!n_at || w_wins);
  } else {
    n_ej = n_at;
    w_ej = w_at && !n_ej;
  }
  Pkt ej[E];
  ej[0] = n_ej ? n : invalidated(w, w_ej && !n_ej);
  if constexpr (E == 2) ej[1] = invalidated(w, w_ej && n_ej);

  const bool n_takes_s = n_v && !n_ej;
  const bool w_takes_s = w_wants_s && !n_takes_s;
  const bool w_s_lost = w_wants_s && n_takes_s;
  const bool w_lost_ej = w_at && !w_ej;
  const bool w_takes_e = w_wants_e || w_s_lost || w_lost_ej;

  const bool inj_e = i_wants_e && !w_takes_e;
  const bool inj_s = i_wants_s && !n_takes_s && !w_takes_s;
  bool inj_ej;
  if constexpr (E == 2) {
    const bool taken = ej[0].f[kValid] != 0;
    inj_ej = inj_local && (!taken || ej[1].f[kValid] == 0);
    const bool to_slot2 = inj_ej && taken;
    if (to_slot2) ej[1] = inj;
    if (inj_ej && !to_slot2) ej[0] = inj;
  } else {
    inj_ej = inj_local && ej[0].f[kValid] == 0;
    if (inj_ej) ej[0] = inj;
  }
  const bool accepted = inj_e || inj_s || inj_ej;

  const Pkt new_e = w_takes_e ? w : invalidated(inj, inj_e);
  const Pkt new_s = n_takes_s ? n : (w_takes_s ? w : invalidated(inj, inj_s));
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    out[f * P + p] = new_e.f[f];
    out[(kFields + f) * P + p] = new_s.f[f];
  }
  st[kDNoc] += (w_s_lost ? 1 : 0) + (inj_valid && !accepted ? 1 : 0);
  st[kDEj] += (w_lost_ej ? 1 : 0) + (n_at && !n_ej ? 1 : 0);

  // ---- 3. advance the fanout cursor; retire a drained node
  r.cursor += accepted ? 1 : 0;
  if (r.active >= 0 && r.cursor >= r.cursor_end) {
    r.active = -1;
    r.sel_wait = sel_lat - 1;
  }

  // ---- 4. apply the ejected packets: every port adds to its clamped cells,
  // all adds and decrements before any fire test (both ports see the count
  // after both decrements; the ALU reads operands after both adds).
  int slot[E];
  bool valid[E];
  float* opnd = a.operands + 2 * row;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    valid[e] = ej[e].f[kValid] != 0;
    slot[e] = clampi(ej[e].f[kDstSlot], 0, L - 1);
    float* cell = opnd + 2 * slot[e] + clampi(ej[e].f[kOpidx], 0, 1);
    *cell = __fadd_rn(*cell, valid[e] ? __int_as_float(ej[e].f[kValue]) : 0.0f);
    if (valid[e]) a.pending[row + slot[e]] -= 1;
  }
  bool fired[E], was[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    was[e] = a.computed[row + slot[e]] != 0;
    fired[e] = valid[e] && a.pending[row + slot[e]] == 0 && !was[e];
  }
  bool same = false;
  if constexpr (E == 2) {
    same = slot[0] == slot[1];
    fired[1] = fired[1] && !(fired[0] && same);
  }
  float fval[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float* c = opnd + 2 * slot[e];
    fval[e] = alu(a.opcode[row + slot[e]], c[0], c[1]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float* v = a.value + row + slot[e];
    *v = __fadd_rn(*v, fired[e] ? fval[e] : 0.0f);
    st[kDelivered] += valid[e] ? 1 : 0;
    st[kFired] += fired[e] ? 1 : 0;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    // Both ports write the same flag when they share a slot.
    if (fired[e] || (fired[E - 1 - e] && same)) a.computed[row + slot[e]] = 1;
  }
  // on_ready, port 0 then port 1 (the inorder FIFO's arrival order)
  uint32_t* rdy =
      POLICY == kInorder ? nullptr : a.rdy + static_cast<size_t>(p) * a.W;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!(fired[e] && a.fo_count[row + slot[e]] > 0)) continue;
    if constexpr (POLICY == kInorder) {
      a.fifo[row + floormod(r.head + r.size, L)] = slot[e];
      r.size += 1;
    } else {
      rdy[slot[e] >> 5] |= 0x80000000u >> (slot[e] & 31);
    }
  }

  // ---- 5. scheduler: select (and consume) the next node on an idle PE
  const bool idle = r.active < 0;
  const bool gate = idle && r.sel_wait == 0;
  int cand;
  bool have, empty;
  if constexpr (POLICY == kInorder) {
    cand = a.fifo[row + clampi(r.head, 0, L - 1)];
    have = r.size > 0;
    if (gate && have) {
      r.head = floormod(r.head + 1, L);
      r.size -= 1;
    }
    empty = r.size == 0;
  } else {
    int nonzero;
    cand = POLICY == kOoo ? lod_row(rdy, a.W, &nonzero)
                          : rotating_lod_row(rdy, a.W, r.ptr, &nonzero);
    have = cand >= 0;
    if (gate && have) {
      rdy[cand >> 5] &= ~(0x80000000u >> (cand & 31));
      if (POLICY == kRotating) r.ptr = floormod(cand + 1, L);
    }
    // Counted before the clear: a PE that clears a bit takes the node and
    // is busy this cycle whatever is left in its row.
    empty = nonzero == 0;
  }
  if (idle && have && r.sel_wait > 0) r.sel_wait -= 1;
  if (gate && have) {
    const int c = clampi(cand, 0, L - 1);
    const int base = a.fo_base[row + c];
    r.active = cand;
    r.cursor = base;
    r.cursor_end = base + a.fo_count[row + c];
  }

  // ---- 6. this PE's share of the termination predicate
  const bool quiet = empty && r.active < 0 && new_e.f[kValid] == 0 &&
                     new_s.f[kValid] == 0;
  st[kBusyPes] += quiet ? 0 : 1;
}

template <int POLICY, int EJECT>
__global__ void __launch_bounds__(kMaxThreads, 1)
mega_chunk_kernel(const MegaArgs a) {
  __shared__ int partial[2][kMaxWarps][kStats];

  const int P = a.nx * a.ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int* links = a.link_scratch;
  const int sel_lat = *a.sel_lat;

  for (int p = tid; p < P; p += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      links[f * P + p] = a.link_e[f * P + p];
      links[(kFields + f) * P + p] = a.link_s[f * P + p];
    }
  }
  // Thread 0 keeps the grid-wide scalars.
  int remaining = 0, delivered = 0, d_noc = 0, d_ej = 0, deflections = 0,
      busy = 0, first = -1;
  if (tid == 0) {
    remaining = *a.remaining;
    delivered = *a.delivered;
    d_noc = *a.noc_deflections;
    d_ej = *a.eject_deflections;
    deflections = *a.deflections;
    busy = *a.busy_cycles;
  }
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    const int* in = links + (k & 1) * 2 * kFields * P;
    int* out = links + ((k + 1) & 1) * 2 * kFields * P;
    int st[kStats] = {0, 0, 0, 0, 0};
    for (int p = tid; p < P; p += blockDim.x) {
      PeRegs r = load_regs<POLICY>(a, p);
      pe_cycle<POLICY, EJECT>(a, p, r, in, out, sel_lat, st);
      store_regs<POLICY>(a, p, r);
    }
#pragma unroll
    for (int i = 0; i < kStats; ++i) {
      const int s = __reduce_add_sync(kAllLanes, st[i]);
      if (lane == 0) partial[k & 1][warp][i] = s;
    }
    __syncthreads();
    if (warp == 0) {
      int tot[kStats];
#pragma unroll
      for (int i = 0; i < kStats; ++i)
        tot[i] = __reduce_add_sync(
            kAllLanes, lane < nwarps ? partial[k & 1][lane][i] : 0);
      if (lane == 0) {
        remaining -= tot[kFired];
        delivered += tot[kDelivered];
        d_noc += tot[kDNoc];
        d_ej += tot[kDEj];
        deflections += tot[kDNoc] + tot[kDEj];
        busy += tot[kFired];
        const bool done = remaining == 0 && tot[kBusyPes] == 0;
        a.trace[k] = done ? 1 : 0;
        if (done && first < 0) first = k;
      }
    }
  }

  const int* last = links + (a.K & 1) * 2 * kFields * P;
  for (int p = tid; p < P; p += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      a.link_e[f * P + p] = last[f * P + p];
      a.link_s[f * P + p] = last[(kFields + f) * P + p];
    }
  }
  if (tid == 0) {
    // Chunk repair (make_chunk_fn): the exact completion cycle from the
    // first done entry of the trace; a chunk started done keeps its cycle.
    const int start_cycle = *a.cycle;
    const bool start_done = *a.done != 0;
    const int end_cycle = static_cast<int>(
        static_cast<unsigned>(start_cycle) + static_cast<unsigned>(a.K));
    *a.cycle = start_done ? start_cycle
                          : (first >= 0 ? start_cycle + first + 1 : end_cycle);
    *a.done = first >= 0 ? 1 : 0;
    *a.remaining = remaining;
    *a.delivered = delivered;
    *a.noc_deflections = d_noc;
    *a.eject_deflections = d_ej;
    *a.deflections = deflections;
    *a.busy_cycles = busy;
  }
}

template <int POLICY, int EJECT>
int launch(const MegaArgs& a, cudaStream_t stream) {
  const int P = a.nx * a.ny;
  const int threads = min((P + 31) / 32 * 32, kMaxThreads);
  mega_chunk_kernel<POLICY, EJECT><<<1, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int POLICY>
int launch_policy(const MegaArgs& a, int eject, cudaStream_t stream) {
  switch (eject) {
    case kNFirst: return launch<POLICY, kNFirst>(a, stream);
    case kPriority: return launch<POLICY, kPriority>(a, stream);
    case kCap2: return launch<POLICY, kCap2>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// policy: 0 ooo, 1 inorder, 2 rotating (scan, lru_flat).
// eject: 0 n_first at capacity 1, 1 priority at capacity 1, 2 capacity 2.
int mega_chunk(const MegaArgs* args, int policy, int eject, void* stream) {
  const MegaArgs& a = *args;
  if (a.K < 1 || a.nx < 1 || a.ny < 1 || a.L < 32 || a.emax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case kOoo: return launch_policy<kOoo>(a, eject, s);
    case kInorder: return launch_policy<kInorder>(a, eject, s);
    case kRotating: return launch_policy<kRotating>(a, eject, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
