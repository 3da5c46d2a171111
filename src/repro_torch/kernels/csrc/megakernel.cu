// The overlay's K-cycle chunk in one launch (the "megakernel") for Hopper
// (sm_90a), solo and batched.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/megakernel.py::make_mega_chunk_fn (inner `kernel`), in
// both its forms. It computes what that kernel computes: K back-to-back
// cycles of the overlay's one-cycle transition (repro_torch/core/overlay.py
// make_cycle_fn: fanout inject, Hoplite route, eject scatters, fire and
// ALU, the policy's on_ready and step, termination), the per-cycle done
// trace, and the chunk repair of `cycle` and `done` at the end. The batched
// form (`batched=True` in the reference) steps B configs of one graph: every
// state leaf has a leading [B] axis, the trace is [K, B] and the repair runs
// per element.
//
// Design. One CTA per simulation (blockIdx.x = batch element b; the solo
// form is B = 1 with one member policy), one thread per PE. Nearly every
// update of a cycle is local to one PE: inject reads the PE's own edge
// records and value, ejects land in the PE's own slot planes, on_ready and
// step touch the PE's own scheduler row. Only two things cross PEs: the
// Hoplite link registers (read from the west and north neighbour's previous
// cycle) and the termination predicate and stat counters (grid-wide sums).
// So the K cycles run as a loop inside one block: the links are
// double-buffered by cycle parity in the element's own global scratch
// (L1/L2 resident), and one __syncthreads ends each cycle, after each warp
// has written its partial sums; warp 0 reduces them and thread 0 keeps the
// counters and writes the done trace. Each thread loops over its PEs (one
// up to 512 PEs) and loads and stores a PE's own registers (active, cursor,
// scheduler head/size/pointer) around its cycle. Keeping those registers in
// the thread and the links in shared memory was timed at 16x16: no faster.
// The graph memory is shared by the batch and read only, so B CTAs read it
// from HBM into L2 once.
//
// Batched state. Each element's slice of a leaf is contiguous, at the
// element strides the wrapper passes (s_plane, s_pe, s_words, s_links);
// offsets are size_t. The scheduler state is a composite of member
// policies (repro_torch/core/schedulers.py BatchedScheduler): each CTA
// reads its element's policy_id and runs that member's pick, a CTA-uniform
// switch over the Policy template bodies, so nothing diverges inside a CTA;
// on_ready updates every member's state (set bits in each RDY row, push
// into each FIFO), step commits only the active member. With max_cycles
// set (the tail), a CTA whose element is done or at its own budget leaves
// every leaf untouched and writes its done flag into its trace column.
//
// Bound. A solo chunk's bytes are the graph leaves it reads (opcode, fanout
// ranges, edge records) read once and the state leaves read and written
// once: ~1.3 MB at 16x16 x 64 slots, 0.39 us at 3.35 TB/s; a batched chunk
// reads the graph once and B elements' state. The kernel is bound instead
// by the latency of one SM's dependent loads of graph memory and slot
// planes (L2-resident at these sizes) and its per-cycle barrier; a batch
// runs its B simulations on B SMs side by side. The design keeps all K
// cycles in one launch, so the ~175 host launches per cycle of the eager
// engine become one launch per chunk.
//
// Exactness. Every state leaf matches the eager engine bit for bit,
// including fields of invalid packets on the links and the sign of zero in
// the float planes (each eject port adds +0.0 at its clamped cell even when
// invalid, as the eager scatter does). Floats use __fadd_rn/__fmul_rn/
// __fdiv_rn, which are never contracted into FMAs. RDY words are int32
// storage of the uint32 pattern; slot s is bit 31 - s%32 of word s/32.
//
// Interface. A plain C entry point for ctypes: mega_chunk(args, eject,
// stream) takes the tensors' pointers in one struct (MegaArgs), launches B
// CTAs on the given stream, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Policy { kOoo = 0, kInorder = 1, kRotating = 2 };
enum Eject { kNFirst = 0, kPriority = 1, kCap2 = 2 };
enum Field { kValid = 0, kDstX, kDstY, kDstSlot, kOpidx, kValue, kFields };
enum Stat { kFired = 0, kDelivered, kDNoc, kDEj, kBusyPes, kStats };

// 512 threads a CTA leave a thread 128 registers (at 1024, 64 spilled);
// larger grids loop over PEs.
constexpr int kMaxThreads = 512;
constexpr int kMaxMembers = 4;  // the registered policies
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

constexpr int OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4;
constexpr float kDivEps = 1e-3f;

}  // namespace

// One member policy's scheduler state, [B, ...] (kernels/megakernel.py
// _Member).
struct Member {
  uint32_t* rdy;   // [B, P, W] (ooo, rotating)
  int32_t* ptr;    // [B, P] (rotating)
  int32_t* fifo;   // [B, P, L] (inorder)
  int32_t* head;   // [B, P] (inorder)
  int32_t* size;   // [B, P] (inorder)
  int32_t kind;    // Policy
  int32_t unused;
};

// Field order mirrors kernels/megakernel.py::_Args. Every state leaf has a
// leading [B] axis (B = 1 in the solo form); scalars are [B].
struct MegaArgs {
  // graph memory, read only, shared by the batch
  const int32_t* opcode;       // [P, L]
  const int32_t* fo_base;      // [P, L]
  const int32_t* fo_count;     // [P, L]
  const int32_t* e_dst_pe;     // [P, emax]
  const int32_t* e_dst_slot;   // [P, emax]
  const int32_t* e_dst_opidx;  // [P, emax]
  // state, updated in place
  int32_t* pending;    // [B, P, L]
  float* operands;     // [B, P, L, 2]
  uint8_t* computed;   // [B, P, L] bool
  float* value;        // [B, P, L]
  int32_t* remaining;  // [B]
  int32_t* active;     // [B, P]
  int32_t* cursor;     // [B, P]
  int32_t* cursor_end; // [B, P]
  const int32_t* sel_lat;  // [B]
  int32_t* sel_wait;   // [B, P]
  int32_t* link_e;     // [B, 6, P]
  int32_t* link_s;     // [B, 6, P]
  int32_t* cycle;      // [B]
  uint8_t* done;       // [B] bool
  int32_t* delivered;  // [B] counters
  int32_t* noc_deflections;
  int32_t* eject_deflections;
  int32_t* deflections;
  int32_t* busy_cycles;
  const int32_t* policy_id;   // [B] member index, or null: member 0
  const int32_t* max_cycles;  // [B] budgets, or null: no freeze
  // scratch from the wrapper
  uint8_t* trace;          // [K, B] bool
  int32_t* link_scratch;   // [B, 2, 2, 6, P] links of the cycle's two parities
  Member members[kMaxMembers];
  // element strides of the [B, ...] leaves, in elements
  int64_t s_plane, s_pe, s_words, s_links;
  int32_t nx, ny, L, W, emax, K, B, n_members;
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
  int head, size, ptr;  // the active member's inorder head/size or pointer
};

// gp: the PE's index in the [B, P] leaves.
template <int POLICY>
__device__ __forceinline__ PeRegs load_regs(const MegaArgs& a,
                                            const Member& m, size_t gp) {
  PeRegs r;
  r.active = a.active[gp];
  r.cursor = a.cursor[gp];
  r.cursor_end = a.cursor_end[gp];
  r.sel_wait = a.sel_wait[gp];
  r.head = POLICY == kInorder ? m.head[gp] : 0;
  r.size = POLICY == kInorder ? m.size[gp] : 0;
  r.ptr = POLICY == kRotating ? m.ptr[gp] : 0;
  return r;
}

template <int POLICY>
__device__ __forceinline__ void store_regs(const MegaArgs& a, const Member& m,
                                           size_t gp, const PeRegs& r) {
  a.active[gp] = r.active;
  a.cursor[gp] = r.cursor;
  a.cursor_end[gp] = r.cursor_end;
  a.sel_wait[gp] = r.sel_wait;
  if (POLICY == kInorder) {
    m.head[gp] = r.head;
    m.size[gp] = r.size;
  }
  if (POLICY == kRotating) m.ptr[gp] = r.ptr;
}

// on_ready of a member that is not the element's active policy: its state
// lives in device memory only. A FIFO takes the push at head + size; an RDY
// row gets the slot's bit.
__device__ __forceinline__ void member_on_ready(const Member& m, size_t gp,
                                                size_t row, size_t wrow,
                                                int L, int slot) {
  if (m.kind == kInorder) {
    const int size = m.size[gp];
    m.fifo[row + floormod(m.head[gp] + size, L)] = slot;
    m.size[gp] = size + 1;
  } else {
    m.rdy[wrow + (slot >> 5)] |= 0x80000000u >> (slot & 31);
  }
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

// One cycle of PE p of element b, whose active member is `am` (index act).
// `in` holds the previous cycle's links, `out` receives this cycle's; both
// are the element's [2 (E, S), 6, P]. Adds this PE's terms to `st`.
template <int POLICY, int EJECT>
__device__ __forceinline__ void pe_cycle(const MegaArgs& a, const Member& am,
                                         int act, int b, int p, PeRegs& r,
                                         const int* in, int* out, int sel_lat,
                                         int st[kStats]) {
  constexpr int E = EJECT == kCap2 ? 2 : 1;
  const int nx = a.nx, ny = a.ny, L = a.L, P = nx * ny;
  const int x = p / ny, y = p - (p / ny) * ny;
  const size_t grow = static_cast<size_t>(p) * L;             // graph planes
  const size_t row = static_cast<size_t>(b) * a.s_plane + grow;  // state
  const size_t wrow = static_cast<size_t>(b) * a.s_words +
                      static_cast<size_t>(p) * a.W;           // RDY rows

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
    fval[e] = alu(a.opcode[grow + slot[e]], c[0], c[1]);
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
  // on_ready, port 0 then port 1 (the inorder FIFO's arrival order), to
  // every member: the active one through the PE's registers, the others in
  // device memory.
  uint32_t* rdy = POLICY == kInorder ? nullptr : am.rdy + wrow;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!(fired[e] && a.fo_count[grow + slot[e]] > 0)) continue;
    if constexpr (POLICY == kInorder) {
      am.fifo[row + floormod(r.head + r.size, L)] = slot[e];
      r.size += 1;
    } else {
      rdy[slot[e] >> 5] |= 0x80000000u >> (slot[e] & 31);
    }
#pragma unroll
    for (int m = 0; m < kMaxMembers; ++m) {
      if (m < a.n_members && m != act)
        member_on_ready(a.members[m],
                        static_cast<size_t>(b) * a.s_pe + p, row, wrow, L,
                        slot[e]);
    }
  }

  // ---- 5. scheduler: select (and consume) the next node on an idle PE;
  // only the active member commits.
  const bool idle = r.active < 0;
  const bool gate = idle && r.sel_wait == 0;
  int cand;
  bool have, empty;
  if constexpr (POLICY == kInorder) {
    cand = am.fifo[row + clampi(r.head, 0, L - 1)];
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
    const int base = a.fo_base[grow + c];
    r.active = cand;
    r.cursor = base;
    r.cursor_end = base + a.fo_count[grow + c];
  }

  // ---- 6. this PE's share of the termination predicate
  const bool quiet = empty && r.active < 0 && new_e.f[kValid] == 0 &&
                     new_s.f[kValid] == 0;
  st[kBusyPes] += quiet ? 0 : 1;
}

// K cycles of element b under its active member `am` (a CTA-uniform
// policy), then the element's chunk repair.
template <int POLICY, int EJECT>
__device__ __forceinline__ void run_element(
    const MegaArgs& a, int b, int act, const Member& am,
    int (*partial)[kMaxWarps][kStats]) {
  const int P = a.nx * a.ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int* links = a.link_scratch + static_cast<size_t>(b) * 4 * kFields * P;
  int* link_e = a.link_e + static_cast<size_t>(b) * a.s_links;
  int* link_s = a.link_s + static_cast<size_t>(b) * a.s_links;
  const int sel_lat = a.sel_lat[b];

  for (int p = tid; p < P; p += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      links[f * P + p] = link_e[f * P + p];
      links[(kFields + f) * P + p] = link_s[f * P + p];
    }
  }
  // Thread 0 keeps the element's scalars.
  int remaining = 0, delivered = 0, d_noc = 0, d_ej = 0, deflections = 0,
      busy = 0, first = -1;
  if (tid == 0) {
    remaining = a.remaining[b];
    delivered = a.delivered[b];
    d_noc = a.noc_deflections[b];
    d_ej = a.eject_deflections[b];
    deflections = a.deflections[b];
    busy = a.busy_cycles[b];
  }
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    const int* in = links + (k & 1) * 2 * kFields * P;
    int* out = links + ((k + 1) & 1) * 2 * kFields * P;
    int st[kStats] = {0, 0, 0, 0, 0};
    for (int p = tid; p < P; p += blockDim.x) {
      const size_t gp = static_cast<size_t>(b) * a.s_pe + p;
      PeRegs r = load_regs<POLICY>(a, am, gp);
      pe_cycle<POLICY, EJECT>(a, am, act, b, p, r, in, out, sel_lat, st);
      store_regs<POLICY>(a, am, gp, r);
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
        a.trace[static_cast<size_t>(k) * a.B + b] = done ? 1 : 0;
        if (done && first < 0) first = k;
      }
    }
  }

  const int* last = links + (a.K & 1) * 2 * kFields * P;
  for (int p = tid; p < P; p += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      link_e[f * P + p] = last[f * P + p];
      link_s[f * P + p] = last[(kFields + f) * P + p];
    }
  }
  if (tid == 0) {
    // Chunk repair (make_chunk_fn): the exact completion cycle from the
    // first done entry of the trace; a chunk started done keeps its cycle.
    const int start_cycle = a.cycle[b];
    const bool start_done = a.done[b] != 0;
    const int end_cycle = static_cast<int>(
        static_cast<unsigned>(start_cycle) + static_cast<unsigned>(a.K));
    a.cycle[b] = start_done ? start_cycle
                            : (first >= 0 ? start_cycle + first + 1 : end_cycle);
    a.done[b] = first >= 0 ? 1 : 0;
    a.remaining[b] = remaining;
    a.delivered[b] = delivered;
    a.noc_deflections[b] = d_noc;
    a.eject_deflections[b] = d_ej;
    a.deflections[b] = deflections;
    a.busy_cycles[b] = busy;
  }
}

// One CTA per batch element.
template <int EJECT>
__global__ void __launch_bounds__(kMaxThreads, 1)
mega_chunk_kernel(const MegaArgs a) {
  __shared__ int partial[2][kMaxWarps][kStats];
  const int b = blockIdx.x;
  if (a.max_cycles != nullptr) {
    // The tail's freeze: a halted element stays as it is, leaf for leaf.
    const bool done = a.done[b] != 0;
    if (done || a.cycle[b] >= a.max_cycles[b]) {
      if (threadIdx.x == 0)
        for (int k = 0; k < a.K; ++k)
          a.trace[static_cast<size_t>(k) * a.B + b] = done ? 1 : 0;
      return;
    }
  }
  // The element's active member, picked with constant indices (a dynamic
  // index into the parameter struct would copy it to local memory).
  const int act = a.policy_id != nullptr ? a.policy_id[b] : 0;
  Member am = a.members[0];
#pragma unroll
  for (int m = 1; m < kMaxMembers; ++m)
    if (m == act) am = a.members[m];
  switch (am.kind) {
    case kOoo: run_element<kOoo, EJECT>(a, b, act, am, partial); break;
    case kInorder: run_element<kInorder, EJECT>(a, b, act, am, partial); break;
    default: run_element<kRotating, EJECT>(a, b, act, am, partial); break;
  }
}

template <int EJECT>
int launch(const MegaArgs& a, cudaStream_t stream) {
  const int P = a.nx * a.ny;
  const int threads = min((P + 31) / 32 * 32, kMaxThreads);
  mega_chunk_kernel<EJECT><<<a.B, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// eject: 0 n_first at capacity 1, 1 priority at capacity 1, 2 capacity 2.
// Each member's kind: 0 ooo, 1 inorder, 2 rotating (scan, lru_flat).
int mega_chunk(const MegaArgs* args, int eject, void* stream) {
  const MegaArgs& a = *args;
  if (a.K < 1 || a.nx < 1 || a.ny < 1 || a.L < 32 || a.emax < 1 || a.B < 1 ||
      a.n_members < 1 || a.n_members > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < a.n_members; ++m)
    if (a.members[m].kind < kOoo || a.members[m].kind > kRotating)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (eject) {
    case kNFirst: return launch<kNFirst>(a, s);
    case kPriority: return launch<kPriority>(a, s);
    case kCap2: return launch<kCap2>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
