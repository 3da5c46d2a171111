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
// What bounds it. A chunk moves ~1.3 MB at 16x16 x 64 slots (0.39 us at
// 3.35 TB/s), but a simulated cycle is a serial step: every PE's cycle needs
// its neighbours' links of the cycle before, so one CTA steps one simulation
// with a barrier per cycle. Within a cycle each thread touches its own PE's
// rows, so every lane of a global load or store hits its own cache line and
// costs the SM's L1 one wavefront: the number of such accesses a cycle, and
// the chain of dependent instructions between two barriers, set the pace
// (PERF.md). The design cuts both.
//
// Design. One CTA per simulation (blockIdx.x = batch element b; the solo
// form is B = 1), one PE a thread up to 512 PEs (four above), one barrier
// per cycle. Everything a cycle touches is local to one PE except the
// Hoplite links (read from the west and north neighbours of the cycle
// before) and the termination predicate.
//  * The PE's registers stay in registers for the whole chunk: active,
//    {cursor, cursor_end}, sel_wait, the inorder head/size with the FIFO's
//    head entry (and an inactive inorder member's head/size) or the rotating
//    pointer, the active node's value (the injection packet's payload) and
//    the edge record at the cursor. The injection packet and the router start
//    from registers and shared memory alone. What changes is reloaded at the
//    end of the cycle by predicated loads straight into the registers, only
//    in the lanes that need it, so nothing waits before the barrier.
//  * Links live in shared memory, double-buffered by cycle parity, a packet
//    as two int4, read from link_e/link_s at the start of the chunk and
//    written back at its end.
//  * The active member's RDY rows live in shared memory for the chunk (at an
//    odd stride, copied in and out coalesced), with a per-PE summary of the
//    non-zero words (the paper's OuterLOD) and a top word over the summary
//    words in a register. The ooo pick is the paper's two-level leading-one
//    detect: __clz of the top word, of one summary word and of one RDY word,
//    never a loop over the row. The rotating pick (scan, lru_flat) masks the
//    word at its pointer, then the summary and the top word past it, and
//    falls back to the first set slot. An inactive member's on_ready sets its
//    bit with an atomicOr that returns nothing.
//  * At eject capacity 1 the ejected packet is known from the link packets
//    before the router runs (unless the PE's own packet takes a free port),
//    so its cell is loaded then. An invalid packet only adds +0.0 to its
//    operand cell and to the slot's value: its lane loads those two (none
//    while it repeats a cell it already normalized) and stores only where the
//    bits change; a valid packet's lane loads the rest of the cell (pending,
//    computed, the other operand, and the slot's record of a graph table
//    packing fo_base, fo_base + fo_count, opcode and fo_count with the first
//    edge record, so a pick needs one record). Capacity 2 loads both ports'
//    cells whole and resolves a shared slot in registers. Graph tables go
//    through the read-only path.
//  * The termination predicate rides on the barrier (__syncthreads_or over
//    "this PE is busy"). A quiet overlay is a fixed point: nothing fires
//    after its first quiet cycle, so the cycle is done iff it is quiet and
//    the chunk's fired total leaves no node uncomputed. The stat counters
//    are summed in registers and reduced once per chunk. Thread 0 can also
//    write each element's done flag into pinned host memory (done_host), so
//    the host loop reads it behind an event with no copy.
//  * A chunk the host queued before it read the last chunk's done flags
//    (done_in, which that chunk wrote to done_out) leaves every leaf as it is
//    where every element was done: the host would not have launched it, and
//    a cycle past completion can still turn a -0.0 into +0.0.
// Where links, RDY rows and summaries do not fit in 227 KB of shared memory
// (e.g. 2,304 PEs at 48x48), or a row has more than 32 summary words (above
// 32,768 slots), the plan of kernels/megakernel.py (a function of the shapes
// alone) takes the `global` body: the same cycle with links in device
// scratch, RDY rows in the member's state tensor, the summaries and a level
// of words above them (one bit a summary word, so the top word covers 2^20
// slots) in device scratch, and each thread looping over PEs at the CTA's
// stride, a PE's registers kept in device scratch between cycles, so it runs
// any grid. Each body is its own instantiation.
//
// Batched state. Each element's slice of a leaf is contiguous, at the
// element strides the wrapper passes (s_plane, s_pe, s_words, s_links);
// offsets are size_t. The scheduler state is a composite of member
// policies (repro_torch/core/schedulers.py BatchedScheduler): each CTA
// reads its element's policy_id and runs that member's pick, a CTA-uniform
// switch, so nothing diverges inside a CTA; on_ready updates every member's
// state (set bits in each RDY row, push into each FIFO), step commits only
// the active member. With max_cycles set (the tail), a CTA whose element is
// done or at its own budget leaves every leaf untouched and writes its done
// flag into its trace column.
//
// Exactness. Every state leaf matches the eager engine bit for bit,
// including fields of invalid packets on the links and the sign of zero in
// the float planes (each eject port adds +0.0 at its clamped cell even when
// invalid, as the eager scatter does). Floats use __fadd_rn/__fmul_rn/
// __fdiv_rn, which are never contracted into FMAs. RDY words are int32
// storage of the uint32 pattern; slot s is bit 31 - s%32 of word s/32, and
// summary word j's bit 31 - w%32 marks RDY word w = 32 j + w%32.
//
// Telemetry (the TRACED variant). The reference traces inside its Pallas
// kernel because the trace leaves are state leaves; here the trace leaves
// ride in MegaArgs and each body has a traced instantiation, the untraced
// one compiling as before. Every trace increment is PE-local, so the thread
// that owns a PE owns its column of every leaf and needs no other thread's:
// it counts the current bucket's eight increments and the chunk's five
// totals in registers (Trc; the global body keeps them in device scratch
// between cycles, beside the PE's registers), adds the bucket's counts to
// the leaves (reductions that return nothing, so nothing waits on them)
// when the bucket changes and at the chunk's end, and adds the totals once
// at the end. The bucket is the element's pre-increment cycle over
// bucket_cycles, clamped to the last bucket. The ready-set depth of an RDY
// policy is the count of set flags in the PE's row, kept beside the row
// (+1 where on_ready sets a flag, -1 where the pick clears one; a slot
// fires once), so it costs no loads; inorder's is the FIFO's size. The only
// increment that is not zero at the completed-overlay fixed point is
// stall_no_ready (every PE idle, nothing ready): the chunk subtracts the
// cycles it ran past completion (0 while running, K - first - 1 where the
// element completes in the chunk, K where it was done already), as the
// reference's chunk repair does, so every leaf equals a check_every = 1
// run.
//
// Interface. A plain C entry point for ctypes: mega_chunk(args, eject,
// stream) takes the tensors' pointers in one struct (MegaArgs), launches B
// CTAs on the given stream, allocates nothing, does not synchronise and
// returns cudaGetLastError(). The traced variant runs where args.buckets is
// positive.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Policy { kOoo = 0, kInorder = 1, kRotating = 2 };
enum Eject { kNFirst = 0, kPriority = 1, kCap2 = 2 };
enum Body { kShared = 0, kGlobal = 1 };
enum Field { kValid = 0, kDstX, kDstY, kDstSlot, kOpidx, kValue, kFields };
enum Stat { kFired = 0, kDelivered, kDNoc, kDEj, kStats };
// The trace leaves (kernels/megakernel.py TELEM_LEAVES): eight bucketed,
// then five per-PE totals.
enum TrLeaf {
  kPeBusy = 0, kPeOcc, kLinkE, kLinkS, kDeflNoc, kDeflEj, kEjGrant, kRdyDepth,
  kBucketed,
  kPickPos = kBucketed, kPicks, kStallNoReady, kStallInject, kStallSelWait,
  kTelemLeaves
};

// The shared body: one PE a thread up to 512 threads (128 registers a
// thread, the cycle's state without spills); above, 4 PEs a thread on up to
// 576 threads. The global body loops over PEs on up to 576 threads.
constexpr int kMaxThreads = 576;
constexpr int kMaxThreadsPpt1 = 512;
constexpr int kMaxMembers = 4;  // the registered policies
constexpr int kMaxWarps = kMaxThreads / 32;
// A packet in shared memory (or the global body's scratch) is 8 ints, two
// int4: {valid, dst_x, dst_y, dst_slot}, {opidx, value, 0, 0}. Links are
// [2 parities][2 (E, S)][Pp][8]: 32 ints a PE.
constexpr int kPktInts = 8;
constexpr int kLinkInts = 2 * 2 * kPktInts;
constexpr int kMaxSummaryWords = 32;    // the top word's bits
constexpr int kPeInts = 32;             // a PE's registers in pe_scratch
constexpr int kTrInts = 16;             // a PE's trace counters in tr_scratch
constexpr int kSharedBytes = 232448;    // a CTA's shared memory on sm_90
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr unsigned kTop = 0x80000000u;

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
  // graph tables the wrapper builds from the graph leaves, read only,
  // shared by the batch
  const int4* slot_info;  // [P, L, 2]: {fo_base, fo_base + fo_count,
                          // opcode, fo_count}, then the edge record at
                          // clamp(fo_base, 0, emax - 1)
  const int4* edges;      // [P, emax]: {dst_x, dst_y, dst_slot, dst_opidx}
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
  int32_t* link_scratch;   // global body: [B, 2, 2, Pp, 8] links by parity
  uint32_t* sum_scratch;   // global body: [B, S + ceil(S / 32), Pp] RDY
                           // summaries, then the level above them
  int32_t* pe_scratch;     // global body: [B, Pp, kPeInts] PE registers
  // [B] pinned host memory that also receives each element's done flag at
  // the end of the chunk (the host loop reads it without a copy), or null
  uint8_t* done_host;
  // [B] each element's done flag after the chunk before this one, which this
  // chunk was queued behind (every element done: the chunk changes nothing),
  // or null; and [B] this chunk's flags for the chunk queued behind it
  const uint8_t* done_in;
  uint8_t* done_out;
  Member members[kMaxMembers];
  // element strides of the [B, ...] leaves, in elements
  int64_t s_plane, s_pe, s_words, s_links;
  int32_t nx, ny, L, W, emax, K, B, n_members;
  // the plan: body, PEs a thread (0: a loop, the global body), threads a
  // CTA, PE stride of the link, RDY and summary rows (P rounded up to 32),
  // summary words a PE, and the dynamic shared memory of the shared body
  int32_t body, ppt, threads, Pp, S, smem_bytes;
  int32_t eject;  // Eject; set by the entry point
  // Telemetry: buckets (0: the untraced variant) and cycles a bucket, the
  // element stride of a bucketed leaf (buckets * P), the global body's trace
  // counters [B, Pp, kTrInts], and the trace leaves in TrLeaf order,
  // [B, buckets, P] bucketed and [B, P] totals, each null where the spec
  // leaves its group out.
  int32_t buckets, bucket_cycles;
  int64_t s_telem;
  int32_t* tr_scratch;
  int32_t* telem[kTelemLeaves];
};

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Floor modulo, as torch's % computes it on ints.
__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// floormod(v, L) without a division where v is in [0, 2L), as it is in
// every state a run reaches (head, size and pointers stay in [0, L]).
__device__ __forceinline__ int wrap(int v, int L) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(2 * L))
    return v >= L ? v - L : v;
  return floormod(v, L);
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

__device__ __forceinline__ Pkt link_read(const int* buf, int p) {
  const int4 lo = reinterpret_cast<const int4*>(buf)[2 * p];
  const int4 hi = reinterpret_cast<const int4*>(buf)[2 * p + 1];
  return Pkt{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y}};
}

__device__ __forceinline__ void link_write(int* buf, int p, const Pkt& k) {
  reinterpret_cast<int4*>(buf)[2 * p] =
      make_int4(k.f[kValid], k.f[kDstX], k.f[kDstY], k.f[kDstSlot]);
  reinterpret_cast<int4*>(buf)[2 * p + 1] =
      make_int4(k.f[kOpidx], k.f[kValue], 0, 0);
}

// pk_invalidate: only `valid` changes; every other field is kept.
__device__ __forceinline__ Pkt invalidated(Pkt p, bool keep) {
  if (!keep) p.f[kValid] = 0;
  return p;
}

// A PE's registers for the chunk.
struct Pe {
  int p;             // the PE's index, or -1: this thread has no such PE
  int xy;            // x << 16 | y
  int active, sel_wait;
  int4 fo;           // {cursor, cursor_end, -, -}
  int hs;            // inorder head, or the rotating pointer
  int size;          // inorder FIFO size
  int fhead;         // inorder: the FIFO entry at clamp(head, 0, L - 1)
  int ihead, isize;  // an inactive inorder member's FIFO head and size
  int clean;         // 2 slot + opidx of the cell an invalid packet last
                     // normalized (neither it nor the slot's value is -0.0
                     // or NaN since), or -1
  uint32_t top;      // bit j: summary word j (deep rows: level-2 word j) is
                     // non-zero
  float aval;        // value at clamp(active, 0, L - 1)
  int4 cur;          // the edge record at clamp(cursor, 0, emax - 1)
};

// A PE's trace counters for the chunk: the current bucket's counts (the
// first kBucketed) and the chunk's totals, and the count of set flags in the
// PE's RDY row (RDY policies).
struct Trc {
  int c[kTelemLeaves];
  int depth;
};

// One eject cell's data: the operand pair, pending, computed, value and the
// slot's first table record.
struct Cell {
  float2 opnd;
  int pend;
  int was;
  float val;
  int4 info;
};

// The element's view of the state, the active member's RDY rows and
// summaries (in shared memory or device memory by body) and the chunk's
// per-thread sums.
struct Elem {
  int32_t* pending;
  float* operands;
  uint8_t* computed;
  float* value;
  const int4* info;
  const int4* edges;
  uint32_t* rdy;      // word w of PE p at rdy[w * rws + p * rps]
  uint32_t* sum;      // word j of PE p at sum[j * Pp + p]
  uint32_t* top2;     // deep rows: level-2 word t of PE p at top2[t * Pp + p]
  int32_t* fifo;      // the active member's FIFO (inorder)
  int rws, rps;
  int nx, ny, L, W, emax, Pp;
  int b, act, sel_lat;
  bool prio;          // eject arbitration at capacity 1: priority
  bool others;        // the batch has members besides the active one
  int32_t* ififo;     // an inactive inorder member's FIFO (element's), or null
  int st[kStats];
};

__device__ __forceinline__ int4 ldg4(const int4* p) { return __ldg(p); }

// Loads straight into a live register where `p` holds, in the lanes where
// it holds: a lane that keeps its register issues no access, and nothing
// waits until the register is next read. ldg_if reads a graph table
// (read-only path); ld_if a state leaf this kernel writes (ordered after
// the thread's stores).
__device__ __forceinline__ void ldg_if(bool p, int4& dst, const int4* src) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0; "
      "@q ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4]; }"
      : "+r"(dst.x), "+r"(dst.y), "+r"(dst.z), "+r"(dst.w)
      : "l"(src), "r"(static_cast<int>(p)));
}
__device__ __forceinline__ void ld_if(bool p, float& dst, const float* src) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.f32 %0, [%1]; }"
      : "+f"(dst)
      : "l"(src), "r"(static_cast<int>(p))
      : "memory");
}
__device__ __forceinline__ void ld_if(bool p, int& dst, const int* src) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.s32 %0, [%1]; }"
      : "+r"(dst)
      : "l"(src), "r"(static_cast<int>(p))
      : "memory");
}
__device__ __forceinline__ void ld_if(bool p, int& dst, const uint8_t* src) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.u8 %0, [%1]; }"
      : "+r"(dst)
      : "l"(src), "r"(static_cast<int>(p))
      : "memory");
}

// The leading one of a word: its count of leading zeros (32 for 0).
__device__ __forceinline__ int clz(uint32_t v) {
  return __clz(static_cast<int>(v));
}

// c: the cell's index in the element's [P, L] planes (P * L < 2^31).
__device__ __forceinline__ Cell load_cell(const Elem& el, int c) {
  Cell d;
  d.opnd = reinterpret_cast<const float2*>(el.operands)[c];
  d.pend = el.pending[c];
  d.was = el.computed[c];
  d.val = el.value[c];
  d.info = ldg4(el.info + 2 * c);
  return d;
}

// on_ready of an RDY member that is not the element's active policy: the
// slot's bit is or-ed into its row in device memory, with no value
// returned, so nothing waits on it.
__device__ __forceinline__ void member_set(const Member& m, size_t wrow,
                                          int slot) {
  atomicOr(m.rdy + wrow + (slot >> 5), kTop >> (slot & 31));
}

// The levels above a row: summary word j has bit w % 32 for each non-empty
// RDY word w of 32 j .. 32 j + 31; with DEEP (the global body), level-2 word
// t has bit j % 32 for each non-empty summary word of 32 t .. 32 t + 31, and
// the top word (a register) one bit for each non-empty level-2 word;
// otherwise the top word has one bit for each non-empty summary word.

// Set slot s of PE p's RDY row and its bits in the levels above.
template <bool DEEP>
__device__ __forceinline__ void rdy_set(const Elem& el, int Pp, int p, int s,
                                        uint32_t& top) {
  const int w = s >> 5, j = w >> 5;
  el.rdy[w * el.rws + p * el.rps] |= kTop >> (s & 31);
  el.sum[j * Pp + p] |= kTop >> (w & 31);
  if constexpr (DEEP) {
    el.top2[(j >> 5) * Pp + p] |= kTop >> (j & 31);
    top |= kTop >> (j >> 5);
  } else {
    top |= kTop >> j;
  }
}

// Clear slot s, whose RDY word is `word`; an empty word leaves its summary
// word, an empty summary word the level above.
template <bool DEEP>
__device__ __forceinline__ void rdy_clear(const Elem& el, int Pp, int p, int s,
                                          uint32_t word, uint32_t& top) {
  const int w = s >> 5, j = w >> 5;
  const uint32_t nw = word & ~(kTop >> (s & 31));
  el.rdy[w * el.rws + p * el.rps] = nw;
  if (nw == 0) {
    const uint32_t ns = el.sum[j * Pp + p] & ~(kTop >> (w & 31));
    el.sum[j * Pp + p] = ns;
    if (ns == 0) {
      if constexpr (DEEP) {
        const int t = j >> 5;
        const uint32_t nt = el.top2[t * Pp + p] & ~(kTop >> (j & 31));
        el.top2[t * Pp + p] = nt;
        if (nt == 0) top &= ~(kTop >> t);
      } else {
        top &= ~(kTop >> j);
      }
    }
  }
}

// The first set slot of a non-empty row (top != 0): a leading-one detect a
// level. Returns the slot and its RDY word.
template <bool DEEP>
__device__ __forceinline__ int rdy_first(const Elem& el, int Pp, int p,
                                         uint32_t top, uint32_t* word) {
  int j = clz(top);
  if constexpr (DEEP) j = j * 32 + clz(el.top2[j * Pp + p]);
  const int w = j * 32 + clz(el.sum[j * Pp + p]);
  *word = el.rdy[w * el.rws + p * el.rps];
  return w * 32 + clz(*word);
}

// The first set slot at or after ptr, wrapping: the word at ptr masked to
// the slots from ptr on, then the words after it through each level masked
// past ptr's bit; else the first set slot of the row.
template <bool DEEP>
__device__ __forceinline__ int rdy_rotating(const Elem& el, int Pp, int p,
                                            int L, int ptr, uint32_t top,
                                            uint32_t* word) {
  if (static_cast<unsigned>(ptr) < static_cast<unsigned>(L)) {
    const int pw = ptr >> 5, pj = pw >> 5;
    const uint32_t wv = el.rdy[pw * el.rws + p * el.rps];
    const uint32_t m = wv & (kAll >> (ptr & 31));
    if (m) {
      *word = wv;
      return pw * 32 + clz(m);
    }
    int w = -1;
    const uint32_t sv =
        (pw & 31) == 31 ? 0u : el.sum[pj * Pp + p] & (kAll >> ((pw & 31) + 1));
    if (sv) {
      w = pj * 32 + clz(sv);
    } else {
      int j = -1;  // the first non-empty summary word after pj
      if constexpr (DEEP) {
        const int pt = pj >> 5;
        const uint32_t t2 = (pj & 31) == 31
                                ? 0u
                                : el.top2[pt * Pp + p] & (kAll >> ((pj & 31) + 1));
        if (t2) {
          j = pt * 32 + clz(t2);
        } else {
          const uint32_t tv = pt == 31 ? 0u : top & (kAll >> (pt + 1));
          if (tv) {
            const int t = clz(tv);
            j = t * 32 + clz(el.top2[t * Pp + p]);
          }
        }
      } else {
        const uint32_t tv = pj == 31 ? 0u : top & (kAll >> (pj + 1));
        if (tv) j = clz(tv);
      }
      if (j >= 0) w = j * 32 + clz(el.sum[j * Pp + p]);
    }
    if (w >= 0) {
      *word = el.rdy[w * el.rws + p * el.rps];
      return w * 32 + clz(*word);
    }
  }
  return rdy_first<DEEP>(el, Pp, p, top, word);
}

// One cycle of PE r.p. `in` holds the previous cycle's links, `out`
// receives this cycle's; both are [2 (E, S)][Pp][8]. Returns whether the PE
// is busy (not quiet) at the end of the cycle. TRACED: the cycle's trace
// increments go to `t`.
template <int POLICY, bool CAP2, bool DEEP, bool TRACED>
__device__ __forceinline__ bool pe_cycle(const MegaArgs& a, Elem& el, Pe& r,
                                         Trc& t, const int* in, int* out) {
  constexpr int E = CAP2 ? 2 : 1;
  const int L = el.L, Pp = el.Pp, p = r.p;
  // traced: the PE's occupancy at the cycle's start, its fires and ejects
  const bool occupied = TRACED && r.active >= 0;
  int n_fired = 0, n_valid = 0;
  const int x = r.xy >> 16, y = r.xy & 0xFFFF;
  // the west and north neighbours on the torus (p = x ny + y)
  const int pw = x == 0 ? p + (el.nx - 1) * el.ny : p - el.ny;
  const int pn = y == 0 ? p + el.ny - 1 : p - 1;
  const int row = p * L;  // the PE's first cell in the element's planes

  // ---- 1. the packets on the links and the eject arbitration between
  // them, then the injection packet from the active node's fanout cursor
  // (in registers)
  const Pkt w = link_read(in, pw), n = link_read(in + kPktInts * Pp, pn);
  const bool w_v = w.f[kValid] != 0, n_v = n.f[kValid] != 0;
  const bool w_xeq = w.f[kDstX] == x, n_xeq = n.f[kDstX] == x;
  const bool w_at = w_v && w_xeq && w.f[kDstY] == y;
  const bool n_at = n_v && n_xeq && n.f[kDstY] == y;
  bool n_ej, w_ej;
  if constexpr (CAP2) {
    n_ej = n_at;
    w_ej = w_at;
  } else {
    // n_first: north wins; priority: the lower destination slot wins.
    const bool w_wins =
        el.prio && w_at && n_at && w.f[kDstSlot] < n.f[kDstSlot];
    n_ej = n_at && !w_wins;
    w_ej = w_at && (!n_at || w_wins);
  }
  Pkt ej[E];
  ej[0] = n_ej ? n : invalidated(w, w_ej && !n_ej);
  if constexpr (E == 2) ej[1] = invalidated(w, w_ej && n_ej);

  // At capacity 1 the port's packet is known now unless the PE's own
  // packet takes a free port (below), so its cell is loaded while the
  // router runs. Each lane's loads hit their own cache lines, so a cycle
  // is paced by the number of loads and stores: an invalid packet only adds
  // +0.0 to its operand cell and to the slot's value (which changes a -0.0
  // to +0.0), so every lane loads those two and a valid packet's lane the
  // rest of the cell.
  bool valid = ej[0].f[kValid] != 0;
  int s = clampi(ej[0].f[kDstSlot], 0, L - 1), c = row + s;
  int opi = clampi(ej[0].f[kOpidx], 0, 1);
  float xo = 0.0f, v = 0.0f, other = 0.0f;
  int pend = 1, was = 1;
  int4 info = make_int4(0, 0, 0, 0);
  // An invalid packet on a link keeps its cell while its sender's cursor
  // stands still: once normalized, the cell needs nothing more.
  const bool known_clean = !valid && 2 * s + opi == r.clean;
  if constexpr (E == 1) {
    ld_if(!known_clean, xo, el.operands + 2 * c + opi);
    ld_if(!known_clean, v, el.value + c);
    ld_if(valid, other, el.operands + 2 * c + 1 - opi);
    ld_if(valid, pend, el.pending + c);
    ld_if(valid, was, el.computed + c);
    ldg_if(valid, info, el.info + 2 * c);
  }

  const bool inj_valid = r.active >= 0 && r.fo.x < r.fo.y;
  Pkt inj;
  inj.f[kValid] = inj_valid ? 1 : 0;
  inj.f[kDstX] = r.cur.x;
  inj.f[kDstY] = r.cur.y;
  inj.f[kDstSlot] = r.cur.z;
  inj.f[kOpidx] = r.cur.w;
  inj.f[kValue] = __float_as_int(r.aval);

  // ---- 2. the Hoplite router
  const bool i_xeq = inj.f[kDstX] == x;
  const bool inj_local = inj_valid && i_xeq && inj.f[kDstY] == y;
  const bool w_wants_e = w_v && !w_xeq, i_wants_e = inj_valid && !i_xeq;
  const bool w_wants_s = w_v && w_xeq && w.f[kDstY] != y;
  const bool i_wants_s = inj_valid && i_xeq && inj.f[kDstY] != y;

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
  link_write(out, p, new_e);
  link_write(out + kPktInts * Pp, p, new_s);
  el.st[kDNoc] += (w_s_lost ? 1 : 0) + (inj_valid && !accepted ? 1 : 0);
  el.st[kDEj] += (w_lost_ej ? 1 : 0) + (n_at && !n_ej ? 1 : 0);

  // ---- 3. advance the fanout cursor; retire a drained node
  if (accepted) r.fo.x += 1;
  const int vslot = clampi(r.active, 0, L - 1);  // the injected payload's slot
  if (r.active >= 0 && r.fo.x >= r.fo.y) {
    r.active = -1;
    r.sel_wait = el.sel_lat - 1;
  }

  // ---- 4. apply the ejected packets, as the eager engine does: every port
  // adds to its clamped cell, all adds and decrements before any fire test
  // (both ports see the count after both decrements; the ALU reads operands
  // after both adds).
  int slot[E], fo_count[E];
  bool fired[E];
  if constexpr (E == 1) {
    bool skip = known_clean;
    if (inj_ej) {  // the PE's own packet, to its own slot
      skip = false;
      valid = true;
      s = clampi(ej[0].f[kDstSlot], 0, L - 1);
      c = row + s;
      opi = clampi(ej[0].f[kOpidx], 0, 1);
      xo = el.operands[2 * c + opi];
      v = el.value[c];
      other = el.operands[2 * c + 1 - opi];
      pend = el.pending[c];
      was = el.computed[c];
      info = ldg4(el.info + 2 * c);
    }
    // A cell is stored only where its bits change.
    float* const cell = el.operands + 2 * c + opi;
    const float xn =
        __fadd_rn(xo, valid ? __int_as_float(ej[0].f[kValue]) : 0.0f);
    const bool f = valid && pend == 1 && !was;
    const float fv = f ? alu(info.z, opi ? other : xn, opi ? xn : other)
                       : 0.0f;
    const float vn = __fadd_rn(v, fv);
    if (!skip) {
      if (valid || __float_as_int(xn) != __float_as_int(xo)) *cell = xn;
      if (__float_as_int(vn) != __float_as_int(v)) el.value[c] = vn;
    }
    if (valid) el.pending[c] = pend - 1;
    if (f) el.computed[c] = 1;
    if (!valid) r.clean = 2 * s + opi;
    else if (s == r.clean >> 1) r.clean = -1;
    el.st[kDelivered] += valid ? 1 : 0;
    el.st[kFired] += f ? 1 : 0;
    if constexpr (TRACED) {
      n_valid = valid ? 1 : 0;
      n_fired = f ? 1 : 0;
    }
    if (s == vslot && !skip) r.aval = vn;
    slot[0] = s;
    fired[0] = f;
    fo_count[0] = info.w;
  } else {
    // Capacity 2: both ports' cells whole; ports that share a slot are
    // resolved in registers.
    int opi[E];
    bool valid[E];
    float pay[E];
    Cell d[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      valid[e] = ej[e].f[kValid] != 0;
      slot[e] = clampi(ej[e].f[kDstSlot], 0, L - 1);
      opi[e] = clampi(ej[e].f[kOpidx], 0, 1);
      pay[e] = valid[e] ? __int_as_float(ej[e].f[kValue]) : 0.0f;
      d[e] = load_cell(el, row + slot[e]);
    }
    const bool same = slot[0] == slot[1];
    // port 0 adds first; a port 1 on the same slot adds to port 0's result
    // and both see the final pair and count
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e == 1 && same) {
        d[1].opnd = d[0].opnd;
        d[1].pend = d[0].pend;
      }
      if (opi[e]) d[e].opnd.y = __fadd_rn(d[e].opnd.y, pay[e]);
      else d[e].opnd.x = __fadd_rn(d[e].opnd.x, pay[e]);
      d[e].pend -= valid[e] ? 1 : 0;
    }
    if (same) {
      d[0].opnd = d[1].opnd;
      d[0].pend = d[1].pend;
    }
    float fval[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      fired[e] = valid[e] && d[e].pend == 0 && !d[e].was;
      fval[e] = fired[e] ? alu(d[e].info.z, d[e].opnd.x, d[e].opnd.y) : 0.0f;
    }
    fired[1] = fired[1] && !(fired[0] && same);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e == 1 && same) d[1].val = d[0].val;
      d[e].val = __fadd_rn(d[e].val, fval[e]);
    }
    if (same) d[0].val = d[1].val;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = row + slot[e];
      reinterpret_cast<float2*>(el.operands)[c] = d[e].opnd;
      el.pending[c] = d[e].pend;
      el.value[c] = d[e].val;
      // Both ports write the same flag when they share a slot.
      if (fired[e] || (fired[E - 1 - e] && same)) el.computed[c] = 1;
      el.st[kDelivered] += valid[e] ? 1 : 0;
      el.st[kFired] += fired[e] ? 1 : 0;
      if constexpr (TRACED) {
        n_valid += valid[e] ? 1 : 0;
        n_fired += fired[e] ? 1 : 0;
      }
      if (slot[e] == vslot) r.aval = d[e].val;
      fo_count[e] = d[e].info.w;
    }
  }
  // on_ready, port 0 then port 1 (the inorder FIFO's arrival order), to
  // every member: the active one in registers and its rows, the others in
  // device memory.
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!(fired[e] && fo_count[e] > 0)) continue;
    if constexpr (POLICY == kInorder) {
      const int pos = wrap(r.hs + r.size, L);
      el.fifo[row + pos] = slot[e];
      if (pos == clampi(r.hs, 0, L - 1)) r.fhead = slot[e];
      r.size += 1;
    } else {
      rdy_set<DEEP>(el, Pp, p, slot[e], r.top);
      if constexpr (TRACED) t.depth += 1;
    }
    if (el.others) {
      // The inactive members: an inorder FIFO takes the push at head + size
      // (both in registers), an RDY row the slot's bit.
      if (el.ififo != nullptr) {
        el.ififo[row + wrap(r.ihead + r.isize, L)] = slot[e];
        r.isize += 1;
      }
#pragma unroll
      for (int m = 0; m < kMaxMembers; ++m) {
        if (m < a.n_members && m != el.act && a.members[m].kind != kInorder)
          member_set(a.members[m],
                     static_cast<size_t>(el.b) * a.s_words +
                         static_cast<size_t>(p) * el.W,
                     slot[e]);
      }
    }
  }

  // ---- 5. scheduler: select (and consume) the next node on an idle PE;
  // only the active member commits.
  const bool idle = r.active < 0;
  const bool gate = idle && r.sel_wait == 0;
  const bool have = POLICY == kInorder ? r.size > 0 : r.top != 0;
  if constexpr (TRACED) {
    t.c[kPeBusy] += n_fired;
    t.c[kPeOcc] += occupied ? 1 : 0;
    t.c[kLinkE] += new_e.f[kValid] != 0 ? 1 : 0;
    t.c[kLinkS] += new_s.f[kValid] != 0 ? 1 : 0;
    t.c[kDeflNoc] += (w_s_lost ? 1 : 0) + (inj_valid && !accepted ? 1 : 0);
    t.c[kDeflEj] += (w_lost_ej ? 1 : 0) + (n_at && !n_ej ? 1 : 0);
    t.c[kEjGrant] += n_valid;
    // the depth as the pick sees it: after this cycle's on_ready
    t.c[kRdyDepth] += POLICY == kInorder ? r.size : t.depth;
    t.c[kStallNoReady] += idle && !have ? 1 : 0;
    t.c[kStallInject] += inj_valid && !accepted ? 1 : 0;
    t.c[kStallSelWait] += idle && have && r.sel_wait > 0 ? 1 : 0;
  }
  if (idle && have && r.sel_wait > 0) r.sel_wait -= 1;
  const bool picked = gate && have;
  if (picked) {
    int cand;
    if constexpr (POLICY == kInorder) {
      cand = r.fhead;
      r.hs = wrap(r.hs + 1, L);
      r.size -= 1;
    } else {
      uint32_t word;
      cand = POLICY == kOoo
                 ? rdy_first<DEEP>(el, Pp, p, r.top, &word)
                 : rdy_rotating<DEEP>(el, Pp, p, L, r.hs, r.top, &word);
      rdy_clear<DEEP>(el, Pp, p, cand, word, r.top);
      if (POLICY == kRotating) r.hs = wrap(cand + 1, L);
      if constexpr (TRACED) t.depth -= 1;
    }
    r.active = cand;
    if constexpr (TRACED) {
      t.c[kPickPos] += cand;
      t.c[kPicks] += 1;
    }
  }
  // The next cycle's inputs that changed, each loaded straight into its
  // register by the lanes that need it: the edge record at the cursor
  // (after an accept, or the picked node's first), the picked node's
  // {cursor, cursor_end}, the payload where its slot moved, and the FIFO's
  // new head entry. They land during the barrier.
  const int4* rec = el.info + 2 * (row + clampi(r.active, 0, L - 1));
  const int4* cur = picked ? rec + 1
                           : el.edges + p * el.emax +
                                 clampi(r.fo.x, 0, el.emax - 1);
  ldg_if(picked || accepted, r.cur, cur);
  ldg_if(picked, r.fo, rec);
  const int vnew = clampi(r.active, 0, L - 1);
  ld_if(vnew != vslot, r.aval, el.value + row + vnew);
  if constexpr (POLICY == kInorder)
    ld_if(picked, r.fhead, el.fifo + row + clampi(r.hs, 0, L - 1));

  // ---- 6. this PE's share of the termination predicate
  const bool empty = POLICY == kInorder ? r.size == 0 : r.top == 0;
  return !(empty && r.active < 0 && new_e.f[kValid] == 0 &&
           new_s.f[kValid] == 0);
}

// PE p's registers from the state at the start of the chunk, and its
// summaries (and, DEEP, the level above them) from its RDY row.
template <int POLICY, bool DEEP>
__device__ __forceinline__ Pe pe_load(const MegaArgs& a, Elem& el,
                                      const Member& am, const Member& im,
                                      int p) {
  constexpr bool RDY = POLICY != kInorder;
  const int ny = el.ny, L = el.L, W = el.W, Pp = el.Pp;
  Pe r;
  r.p = p;
  const int x = p / ny, y = p - x * ny;
  r.xy = x << 16 | y;
  const size_t gp = static_cast<size_t>(el.b) * a.s_pe + p;
  const int row = p * L;
  r.active = a.active[gp];
  r.fo = make_int4(a.cursor[gp], a.cursor_end[gp], 0, 0);
  r.sel_wait = a.sel_wait[gp];
  r.hs = POLICY == kInorder ? am.head[gp]
                            : (POLICY == kRotating ? am.ptr[gp] : 0);
  r.size = POLICY == kInorder ? am.size[gp] : 0;
  r.fhead = POLICY == kInorder ? el.fifo[row + clampi(r.hs, 0, L - 1)] : 0;
  r.clean = -1;
  r.ihead = el.ififo != nullptr ? im.head[gp] : 0;
  r.isize = el.ififo != nullptr ? im.size[gp] : 0;
  r.aval = el.value[row + clampi(r.active, 0, L - 1)];
  r.cur = ldg4(el.edges + p * el.emax + clampi(r.fo.x, 0, el.emax - 1));
  r.top = 0;
  if constexpr (RDY) {
    const int S = a.S, groups = DEEP ? (S + 31) >> 5 : 1;
    for (int t = 0; t < groups; ++t) {
      uint32_t tw = 0;
      for (int j = 32 * t; j < min(S, 32 * t + 32); ++j) {
        uint32_t sw = 0;
        for (int w = 32 * j; w < min(W, 32 * j + 32); ++w)
          if (el.rdy[w * el.rws + p * el.rps]) sw |= kTop >> (w & 31);
        el.sum[j * Pp + p] = sw;
        if (sw) tw |= kTop >> (j & 31);
      }
      if constexpr (DEEP) {
        el.top2[t * Pp + p] = tw;
        if (tw) r.top |= kTop >> t;
      } else {
        r.top = tw;
      }
    }
  }
  return r;
}

// A PE's trace counters at the chunk's start: no counts, and the count of
// set flags in its RDY row.
template <int POLICY>
__device__ __forceinline__ Trc trc_load(const Elem& el, int p) {
  Trc t;
#pragma unroll
  for (int i = 0; i < kTelemLeaves; ++i) t.c[i] = 0;
  t.depth = 0;
  if constexpr (POLICY != kInorder) {
    for (int w = 0; w < el.W; ++w)
      t.depth += __popc(el.rdy[w * el.rws + p * el.rps]);
  }
  return t;
}

// Add PE p's counts of bucket `bucket` to the bucketed leaves of element b
// and clear them. Each leaf's cell is this PE's alone; the adds return
// nothing, so nothing waits on them.
__device__ __forceinline__ void trc_flush(const MegaArgs& a, int b, int p,
                                          int bucket, Trc& t) {
  const size_t at = static_cast<size_t>(b) * a.s_telem +
                    static_cast<size_t>(bucket) * (a.nx * a.ny) + p;
#pragma unroll
  for (int i = 0; i < kBucketed; ++i) {
    if (t.c[i] != 0 && a.telem[i] != nullptr)
      atomicAdd(a.telem[i] + at, t.c[i]);
    t.c[i] = 0;
  }
}

// Add PE p's chunk totals to the total leaves of element b, stall_no_ready
// less the cycles the chunk ran past completion.
__device__ __forceinline__ void trc_totals(const MegaArgs& a, int b, int p,
                                           int overshoot, const Trc& t) {
  const size_t gp = static_cast<size_t>(b) * a.s_pe + p;
#pragma unroll
  for (int i = kBucketed; i < kTelemLeaves; ++i) {
    const int v = t.c[i] - (i == kStallNoReady ? overshoot : 0);
    if (v != 0 && a.telem[i] != nullptr) a.telem[i][gp] += v;
  }
}

// PE r.p's registers and links back to the state at the end of the chunk
// (`last` holds the last cycle's links).
template <int POLICY>
__device__ __forceinline__ void pe_store(const MegaArgs& a, const Elem& el,
                                         const Member& am, const Member& im,
                                         const Pe& r, const int* last,
                                         int* link_e, int* link_s) {
  const int p = r.p, P = el.nx * el.ny, Pp = el.Pp;
  const size_t gp = static_cast<size_t>(el.b) * a.s_pe + p;
  a.active[gp] = r.active;
  a.cursor[gp] = r.fo.x;
  a.cursor_end[gp] = r.fo.y;
  a.sel_wait[gp] = r.sel_wait;
  if (POLICY == kInorder) {
    am.head[gp] = r.hs;
    am.size[gp] = r.size;
  }
  if (POLICY == kRotating) am.ptr[gp] = r.hs;
  if (el.ififo != nullptr) im.size[gp] = r.isize;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    link_e[f * P + p] = last[p * kPktInts + f];
    link_s[f * P + p] = last[(Pp + p) * kPktInts + f];
  }
}

// The chunk's done flags of a CTA that changes no leaf (the tail's freeze,
// or a queued chunk behind a chunk that left every element done).
__device__ __forceinline__ void write_frozen(const MegaArgs& a, int b,
                                             bool done) {
  for (int k = 0; k < a.K; ++k)
    a.trace[static_cast<size_t>(k) * a.B + b] = done ? 1 : 0;
  if (a.done_host != nullptr) a.done_host[b] = done ? 1 : 0;
  if (a.done_out != nullptr) a.done_out[b] = done ? 1 : 0;
}

// K cycles of element b under its active member `am` (a CTA-uniform
// policy), then the element's chunk repair. PPT PEs a thread in registers
// (the shared body), or PPT = 0: a loop over PEs at the CTA's stride, each
// PE's registers in device scratch between cycles (the global body).
// TRACED: each PE's trace counters beside its registers.
template <int POLICY, bool CAP2, bool SHARED, int PPT, bool TRACED>
__device__ __forceinline__ void run_element(const MegaArgs& a, int b, int act,
                                            const Member& am, uint32_t* smem,
                                            int (*partial)[kStats]) {
  constexpr bool DEEP = !SHARED;
  const int nx = a.nx, ny = a.ny, P = nx * ny, L = a.L, W = a.W, Pp = a.Pp;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  constexpr bool RDY = POLICY != kInorder;

  Elem el;
  const size_t plane0 = static_cast<size_t>(b) * a.s_plane;
  el.pending = a.pending + plane0;
  el.operands = a.operands + 2 * plane0;
  el.computed = a.computed + plane0;
  el.value = a.value + plane0;
  el.info = a.slot_info;
  el.edges = a.edges;
  el.fifo = POLICY == kInorder ? am.fifo + plane0 : nullptr;
  el.nx = nx;
  el.ny = ny;
  el.L = L;
  el.W = W;
  el.emax = a.emax;
  el.Pp = Pp;
  el.b = b;
  el.act = act;
  el.others = a.n_members > 1;
  el.ififo = nullptr;
  Member im = am;  // the inactive inorder member, if any
#pragma unroll
  for (int m = 0; m < kMaxMembers; ++m) {
    if (m < a.n_members && m != act && a.members[m].kind == kInorder) {
      im = a.members[m];
      el.ififo = im.fifo + plane0;
    }
  }
  el.sel_lat = a.sel_lat[b];
  el.prio = a.eject == kPriority;
#pragma unroll
  for (int i = 0; i < kStats; ++i) el.st[i] = 0;

  // Links [2 parities][2 (E, S)][Pp][8], RDY rows [W][Pp + 1] (the odd
  // stride keeps both the coalesced copies and each PE's own accesses free
  // of bank conflicts) and summaries [S][Pp]: in shared memory (the shared
  // body) or device memory, with the level-2 words [ceil(S / 32)][Pp].
  uint32_t* const grdy = RDY ? am.rdy + static_cast<size_t>(b) * a.s_words
                             : nullptr;
  int* links;
  el.top2 = nullptr;
  if constexpr (SHARED) {
    links = reinterpret_cast<int*>(smem);
    el.rdy = smem + kLinkInts * Pp;
    el.sum = el.rdy + static_cast<size_t>(W) * (Pp + 1);
    el.rws = Pp + 1;
    el.rps = 1;
  } else {
    links = a.link_scratch + static_cast<size_t>(b) * kLinkInts * Pp;
    el.rdy = grdy;
    el.sum = a.sum_scratch +
             static_cast<size_t>(b) * (a.S + ((a.S + 31) >> 5)) * Pp;
    el.top2 = el.sum + static_cast<size_t>(a.S) * Pp;
    el.rws = 1;
    el.rps = W;
  }
  int* const link_e = a.link_e + static_cast<size_t>(b) * a.s_links;
  int* const link_s = a.link_s + static_cast<size_t>(b) * a.s_links;
  // the global body's PE registers, kPeInts ints a PE
  static_assert(sizeof(Pe) <= sizeof(int32_t) * kPeInts, "Pe > kPeInts");
  int32_t* const pes = a.pe_scratch + static_cast<size_t>(b) * Pp * kPeInts;
  auto pe_at = [pes](int p) {
    return reinterpret_cast<Pe*>(pes + static_cast<size_t>(p) * kPeInts);
  };
  // and, traced, its trace counters, kTrInts ints a PE
  static_assert(sizeof(Trc) <= sizeof(int32_t) * kTrInts, "Trc > kTrInts");
  int32_t* const trs =
      TRACED && !SHARED ? a.tr_scratch + static_cast<size_t>(b) * Pp * kTrInts
                        : nullptr;
  auto tr_at = [trs](int p) {
    return reinterpret_cast<Trc*>(trs + static_cast<size_t>(p) * kTrInts);
  };
  // traced: the element's cycle at the chunk's start, the buckets' clock
  const int first_cycle = TRACED ? a.cycle[b] : 0;

  // ---- chunk start: links, the RDY rows (coalesced), then each PE's
  // registers and summaries.
  for (int i = tid; i < kFields * P; i += T) {
    const int f = i / P, p = i - f * P;
    links[p * kPktInts + f] = link_e[i];
    links[(Pp + p) * kPktInts + f] = link_s[i];
  }
  if (SHARED && RDY) {
    for (int i = tid; i < P * W; i += T) {
      const int p = i / W, w = i - p * W;
      el.rdy[w * el.rws + p] = grdy[i];
    }
  }
  __syncthreads();

  constexpr int kRegs = PPT > 0 ? PPT : 1;
  Pe pe[kRegs];
  Trc tr[kRegs];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * T;
      if (p < P) {
        pe[i] = pe_load<POLICY, DEEP>(a, el, am, im, p);
        if constexpr (TRACED) tr[i] = trc_load<POLICY>(el, p);
      } else {
        pe[i].p = -1;
      }
    }
  } else {
    for (int p = tid; p < P; p += T) {
      *pe_at(p) = pe_load<POLICY, DEEP>(a, el, am, im, p);
      if constexpr (TRACED) *tr_at(p) = trc_load<POLICY>(el, p);
    }
  }

  // ---- K cycles, one barrier each. Traced, `bucket` is the bucket whose
  // counts the counters hold (CTA-uniform; -1 before the first cycle), and
  // a cycle in another bucket first adds them to the leaves (`done_bucket`).
  int first_quiet = -1;
  int bucket = -1;
  for (int k = 0; k < a.K; ++k) {
    const int* in = links + (k & 1) * (kLinkInts / 2) * Pp;
    int* out = links + ((k + 1) & 1) * (kLinkInts / 2) * Pp;
    bool busy = false;
    int done_bucket = -1;
    if constexpr (TRACED) {
      const int bk = min((first_cycle + k) / a.bucket_cycles, a.buckets - 1);
      if (bucket >= 0 && bk != bucket) done_bucket = bucket;
      bucket = bk;
    }
    if constexpr (PPT > 0) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (pe[i].p >= 0) {
          if (TRACED && done_bucket >= 0)
            trc_flush(a, b, pe[i].p, done_bucket, tr[i]);
          busy |= pe_cycle<POLICY, CAP2, DEEP, TRACED>(a, el, pe[i], tr[i],
                                                       in, out);
        }
    } else {
      for (int p = tid; p < P; p += T) {
        pe[0] = *pe_at(p);
        if constexpr (TRACED) {
          tr[0] = *tr_at(p);
          if (done_bucket >= 0) trc_flush(a, b, p, done_bucket, tr[0]);
        }
        busy |= pe_cycle<POLICY, CAP2, DEEP, TRACED>(a, el, pe[0], tr[0], in,
                                                     out);
        *pe_at(p) = pe[0];
        if constexpr (TRACED) *tr_at(p) = tr[0];
      }
    }
    if (!__syncthreads_or(busy) && first_quiet < 0) first_quiet = k;
  }

  // ---- chunk end: each PE's registers, links and RDY row back to the
  // state (a PE's entries were written by its own thread), then the sums.
  const int* last = links + (a.K & 1) * (kLinkInts / 2) * Pp;
  if constexpr (PPT > 0) {
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      if (pe[i].p >= 0)
        pe_store<POLICY>(a, el, am, im, pe[i], last, link_e, link_s);
  } else {
    for (int p = tid; p < P; p += T)
      pe_store<POLICY>(a, el, am, im, *pe_at(p), last, link_e, link_s);
  }
  // Every thread has passed the last cycle's barrier, so the RDY rows are
  // final: back to the state, coalesced.
  if (SHARED && RDY) {
    for (int i = tid; i < P * W; i += T) {
      const int p = i / W, w = i - p * W;
      grdy[i] = el.rdy[w * el.rws + p];
    }
  }
#pragma unroll
  for (int i = 0; i < kStats; ++i) {
    const int s = __reduce_add_sync(kAll, el.st[i]);
    if (lane == 0) partial[warp][i] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int tot[kStats];
#pragma unroll
    for (int i = 0; i < kStats; ++i)
      tot[i] = __reduce_add_sync(kAll, lane < nwarps ? partial[lane][i] : 0);
    if (lane == 0) {
      // A quiet overlay stays quiet and fires nothing more, so cycle k is
      // done iff it is at or after the first quiet cycle and the chunk left
      // no node uncomputed.
      const int remaining = a.remaining[b] - tot[kFired];
      const int first = remaining == 0 ? first_quiet : -1;
      for (int k = 0; k < a.K; ++k)
        a.trace[static_cast<size_t>(k) * a.B + b] =
            first >= 0 && k >= first ? 1 : 0;
      // Chunk repair (make_chunk_fn): the exact completion cycle from the
      // first done entry of the trace; a chunk started done keeps its cycle.
      const int start_cycle = a.cycle[b];
      const bool start_done = a.done[b] != 0;
      const int end_cycle = static_cast<int>(
          static_cast<unsigned>(start_cycle) + static_cast<unsigned>(a.K));
      a.cycle[b] = start_done ? start_cycle
                              : (first >= 0 ? start_cycle + first + 1
                                            : end_cycle);
      a.done[b] = first >= 0 ? 1 : 0;
      if (a.done_host != nullptr) a.done_host[b] = first >= 0 ? 1 : 0;
      if (a.done_out != nullptr) a.done_out[b] = first >= 0 ? 1 : 0;
      a.remaining[b] = remaining;
      a.delivered[b] += tot[kDelivered];
      a.noc_deflections[b] += tot[kDNoc];
      a.eject_deflections[b] += tot[kDEj];
      a.deflections[b] += tot[kDNoc] + tot[kDEj];
      a.busy_cycles[b] += tot[kFired];
      if constexpr (TRACED) {
        // the cycles run past completion, for every thread's totals (the
        // warp's other lanes are done reading `partial`)
        partial[0][0] = start_done ? a.K : (first >= 0 ? a.K - first - 1 : 0);
      }
    }
  }
  if constexpr (TRACED) {
    // ---- the trace: the last bucket's counts and the chunk's totals.
    __syncthreads();
    const int overshoot = partial[0][0];
    if constexpr (PPT > 0) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (pe[i].p >= 0) {
          trc_flush(a, b, pe[i].p, bucket, tr[i]);
          trc_totals(a, b, pe[i].p, overshoot, tr[i]);
        }
    } else {
      for (int p = tid; p < P; p += T) {
        Trc t = *tr_at(p);
        trc_flush(a, b, p, bucket, t);
        trc_totals(a, b, p, overshoot, t);
      }
    }
  }
}

// One CTA per batch element.
template <bool CAP2, bool SHARED, int PPT, bool TRACED>
__global__ void __launch_bounds__(PPT == 1 ? kMaxThreadsPpt1 : kMaxThreads, 1)
mega_chunk_kernel(const MegaArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ int partial[kMaxWarps][kStats];
  const int b = blockIdx.x;
  if (a.done_in != nullptr) {
    // Queued behind a chunk whose flags the host has not read: where that
    // chunk left every element done, the host would not have launched this
    // one.
    int all = 1;
    for (int i = threadIdx.x; i < a.B; i += blockDim.x)
      all &= a.done_in[i] != 0 ? 1 : 0;
    if (__syncthreads_and(all)) {
      if (threadIdx.x == 0) write_frozen(a, b, true);
      return;
    }
  }
  if (a.max_cycles != nullptr) {
    // The tail's freeze: a halted element stays as it is, leaf for leaf.
    const bool done = a.done[b] != 0;
    if (done || a.cycle[b] >= a.max_cycles[b]) {
      if (threadIdx.x == 0) write_frozen(a, b, done);
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
    case kOoo:
      run_element<kOoo, CAP2, SHARED, PPT, TRACED>(a, b, act, am, smem,
                                                   partial);
      break;
    case kInorder:
      run_element<kInorder, CAP2, SHARED, PPT, TRACED>(a, b, act, am, smem,
                                                       partial);
      break;
    default:
      run_element<kRotating, CAP2, SHARED, PPT, TRACED>(a, b, act, am, smem,
                                                        partial);
      break;
  }
}

template <bool CAP2, bool SHARED, int PPT, bool TRACED>
int launch(const MegaArgs& a, cudaStream_t stream) {
  auto* kernel = mega_chunk_kernel<CAP2, SHARED, PPT, TRACED>;
  // Above 48 KB (static and dynamic together) a kernel must opt in to its
  // dynamic shared memory. The attribute holds for the device current at
  // the call, so it is set at every such launch.
  constexpr int kStaticBytes = sizeof(int) * kMaxWarps * kStats;
  if (a.smem_bytes + kStaticBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.B, a.threads, a.smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAP2, bool TRACED>
int launch_body(const MegaArgs& a, cudaStream_t s) {
  if (a.body == kShared && a.ppt == 1)
    return launch<CAP2, true, 1, TRACED>(a, s);
  if (a.body == kShared && a.ppt == 4)
    return launch<CAP2, true, 4, TRACED>(a, s);
  if (a.body == kGlobal && a.ppt == 0)
    return launch<CAP2, false, 0, TRACED>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// eject: 0 n_first at capacity 1, 1 priority at capacity 1, 2 capacity 2.
// Each member's kind: 0 ooo, 1 inorder, 2 rotating (scan, lru_flat). The
// plan's fields (body, ppt, threads, Pp, S, smem_bytes) come from
// kernels/megakernel.py::plan; buckets > 0 launches the traced variant.
int mega_chunk(const MegaArgs* args, int eject, void* stream) {
  MegaArgs a = *args;
  const long long P = static_cast<long long>(a.nx) * a.ny;
  bool rdy = false;
  for (int m = 0; m < a.n_members && m < kMaxMembers; ++m) {
    if (a.members[m].kind < kOoo || a.members[m].kind > kRotating)
      return static_cast<int>(cudaErrorInvalidValue);
    rdy = rdy || a.members[m].kind != kInorder;
  }
  // The shared body holds both link buffers and, for RDY policies, the RDY
  // rows and summaries in shared memory, each PE in a thread's registers;
  // the global body keeps them in the scratch and loops over the PEs.
  const bool body_ok =
      a.body == kShared
          ? ((a.ppt == 1 || a.ppt == 4) &&
             a.threads <= (a.ppt == 1 ? kMaxThreadsPpt1 : kMaxThreads) &&
             static_cast<long long>(a.threads) * a.ppt >= P &&
             a.S <= kMaxSummaryWords &&
             a.smem_bytes ==
                 4LL * (a.Pp * kLinkInts +
                        (rdy ? a.Pp * a.S + a.W * (a.Pp + 1LL) : 0)))
          : (a.body == kGlobal && a.ppt == 0 && a.threads <= kMaxThreads &&
             a.S <= 32 * kMaxSummaryWords && a.smem_bytes == 0 &&
             a.link_scratch != nullptr && a.sum_scratch != nullptr &&
             a.pe_scratch != nullptr);
  if (a.K < 1 || a.nx < 1 || a.ny < 1 || a.nx >= (1 << 15) ||
      a.ny >= (1 << 15) || a.L < 32 || a.W * 32 != a.L ||
      2 * P * a.L >= (1LL << 31) || a.emax < 1 ||
      P * a.emax >= (1LL << 31) || a.B < 1 || a.n_members < 1 ||
      a.n_members > kMaxMembers || a.threads < 32 || a.threads % 32 != 0 ||
      a.Pp < P || a.Pp % 32 != 0 || a.S * 32 < a.W || !body_ok ||
      eject < kNFirst || eject > kCap2)
    return static_cast<int>(cudaErrorInvalidValue);
  // Traced: the bucketing, the element stride of a bucketed leaf, and the
  // global body's trace scratch.
  const bool traced = a.buckets > 0;
  if (traced && (a.bucket_cycles < 1 ||
                 a.s_telem != static_cast<long long>(a.buckets) * P ||
                 (a.body == kGlobal && a.tr_scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.eject = eject;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (traced)
    return eject == kCap2 ? launch_body<true, true>(a, s)
                          : launch_body<false, true>(a, s);
  return eject == kCap2 ? launch_body<true, false>(a, s)
                        : launch_body<false, false>(a, s);
}

}  // extern "C"
