// Blockwise (flash) attention for Hopper (sm_90a): online softmax over key
// tiles, f32 accumulation, output in the input's type (f32 or bf16).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention.py::flash_attention (`_kernel`), and is
// the model stack's attention (repro_torch/models/attention.py
// blockwise_attention, the twin of the reference's jnp blockwise version).
// It computes what both compute: for batch b and q head h, which reads kv
// head h / rep (GQA), row i of the output is
//     softmax_j(scale * q_i . k_j) v_j over the keys j < lim(b, i),
// lim = kv_len[b], or under `causal` (ends aligned, the decode convention)
// min(kv_len[b], i + kv_len[b] - Tq + 1). With kv_len = Tkv that is the
// Pallas kernel's function; kv_len < Tkv is the cache of a decode step.
// Keys at or past lim are masked as the reference masks them (score -1e30,
// then exp), so rows match its arithmetic; keys at or past the block's
// largest lim are never loaded: no work is spent on them.
//
// Layout. q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D], o like q, each with its
// own element strides for batch, token and head (D is contiguous), so the
// token-major layout of the model stack, the head-major layout of the Pallas
// kernel and views of a KV cache all launch without a copy. D is any
// multiple of 8 up to 256; tiles are padded with zeros in shared memory.
//
// Rows. Every body groups the rows of one (b, kv head g) together: they
// are the flattened (q position, q head of the group) pairs, position
// major, so the rep q heads that share kv head g read each K/V tile from
// device memory once and not rep times.
//
// Three bodies; the wrapper's plan (flash_attention.py `plan`) picks one by
// dtype and shape and names it in FlashArgs::body. Nothing here picks.
//
//  * mma (bf16, more than 16 rows per (b, g): prefill). Bound by
//    operations: 4 * D flops per visible (row, key) pair, ~60 GFLOP per
//    layer of qwen2-0.5b at batch 8 x 2048 tokens, ~61 us at the H100's 989
//    TFLOP/s in bf16, a rate only the tensor cores reach. A CTA takes 64
//    rows per warpgroup, one wgmma M tile: one warpgroup and K/V tiles of 64
//    keys at head_dim 64, two warpgroups above (tiles of 128 keys at 128,
//    of 64 at 256). Q and a ring of two K/V stages are bf16 in shared memory
//    in the 128-byte swizzled layout that wgmma's descriptors read;
//    asynchronous copies (cp.async, 16 bytes a thread) fill the next stage
//    while the current one is multiplied. S = Q K^T is one wgmma chain per
//    warpgroup (A and B from shared memory, K-major); the online softmax
//    runs on S in registers in f32 (scale in f32, -1e30 masks; the
//    exponential is ex2.approx on scores scaled by scale * log2 e; its
//    departure from expf is measured by flash_attention_ex2_error below and
//    lies far under the bf16 rounding of P; PERF.md); P is rounded to bf16
//    in registers and is wgmma's A operand for O += P V, with V read from
//    shared memory through the transpose bit (V stays [keys][D]). That rounding of P is where
//    this body departs from the reference's f32 P V (the row sums l stay
//    in f32). Row tiles run heaviest first (the last causal tile of a
//    sequence is scheduled first), so the last wave is short.
//  * split (either dtype, at most 16 rows per (b, g): decode). Bound by
//    bytes: K and V of the visible cache, read once per kv head. The keys
//    are cut into `splits` chunks of `chunk` keys (a multiple of 64), so
//    B * Hkv * splits CTAs fill the card; each CTA streams its K/V tiles
//    through a cp.async double buffer in their input type, computes its
//    rows on the CUDA cores (one row per warp) and writes a partial
//    (m, l, acc) in f32 to the scratch the wrapper allocated. A row that
//    sees none of a chunk's keys writes m = -1e30, l = 0, acc = 0 (masked
//    keys there would otherwise each count exp(0) = 1). A second kernel,
//    combine, merges the chunks of each row in a fixed order
//    (bit-deterministic) and writes o. Measured, the CTA's arithmetic and
//    not the bytes sets its time: each K/V element is loaded and widened
//    for one row (PERF.md).
//  * simt (f32, more than 16 rows: prefill in f32). The CUDA-core body of
//    the first port: both products in f32 on the CUDA cores (67 TFLOP/s at
//    most), which the f32 reference's 1e-4 tolerances need (TF32 would
//    break them). It takes f32 only.
//
// The exponential is expf in the simt and split bodies and the combine
// (the build never uses fast math), ex2.approx in the mma body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments, passed by pointer from the wrapper (ctypes
// structure `_Args` in repro_torch/kernels/flash_attention.py, field for field).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* kv_len;        // [B] valid keys per batch row, or null
  float* scratch;               // split body: partial (m, l) and acc, f32
  int64_t q_sb, q_st, q_sh;     // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int32_t B, Tq, Tkv, Hq, Hkv, D;
  int32_t kv_len_all;           // kv_len of every row when kv_len is null
  int32_t causal;
  int32_t dtype;                // 0 = float32, 1 = bfloat16
  int32_t body;                 // 0 = simt, 1 = mma, 2 = split
  int32_t splits, chunk;        // split body: `splits` chunks of `chunk` keys
  float scale;
};

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BK = 64;          // keys per tile of the simt body
constexpr float NEG = -1e30f;   // the reference's mask value
constexpr int kSplitRows = 16;  // the split body's rows per (b, kv head)
constexpr int kSplitWarps = 8;  // ... dealt out to this many warps
constexpr int kSplitThreads = 32 * kSplitWarps;

// The rows of one (b, kv head): their count and each row's key limit.
struct RowMap {
  int rep, rows, kvl, off, causal;
  __device__ __forceinline__ int lim(int fr) const {
    if (fr >= rows) return 0;
    int l = causal ? min(kvl, fr / rep + off + 1) : kvl;
    return max(l, 0);
  }
};

__device__ __forceinline__ RowMap row_map(const FlashArgs& a, int b) {
  RowMap m;
  m.rep = a.Hq / a.Hkv;
  m.rows = a.Tq * m.rep;
  int kvl = a.kv_len != nullptr ? a.kv_len[b] : a.kv_len_all;
  m.kvl = min(max(kvl, 0), a.Tkv);
  m.off = m.kvl - a.Tq;                               // ends-aligned offset
  m.causal = a.causal;
  return m;
}

// Eight consecutive elements (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One 16-byte chunk of shared memory as f32 (4 floats or 8 bf16).
__device__ __forceinline__ void chunk_f32(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void put8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float dot4(float4 a, const float* b, float s) {
  s = fmaf(a.x, b[0], s);
  s = fmaf(a.y, b[1], s);
  s = fmaf(a.z, b[2], s);
  return fmaf(a.w, b[3], s);
}

// Asynchronous copies: 16 bytes from device to shared memory, or 16 zero
// bytes where !valid (then nothing is read).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// simt body: the CUDA-core kernel of the first port (f32 prefill).
// ---------------------------------------------------------------------------
//
// One CTA of 4 warps per (b, g, tile of R rows). A loop over key tiles of
// BK = 64 takes the place of the Pallas grid's sequential fourth axis: each
// tile is converted to f32 into shared memory, then every warp updates its
// RW rows. A CTA's rows are dealt out to the warps in turn. Running max m,
// normaliser l and the accumulator (DP / 32 values per lane and row) stay
// in registers. Scores: lane j owns keys j and j + 32 of the tile and takes
// the dot products with float4 reads (the q row is a broadcast, the K rows
// are padded by 4 floats so a quarter-warp's 16-byte reads hit 32 distinct
// banks). Softmax: warp shuffles for the row max and sum; p goes to the
// warp's own rows of shared memory. P V: lane owns dims lane + 32 t, reads
// p four keys at a time as a broadcast float4 and V rows conflict-free.

// Rows per warp: the accumulator holds RW * DL floats per lane.
template <int DL>
struct Tile {
  static constexpr int DP = 32 * DL;                    // padded head dim
  static constexpr int KS = DP + 4;                     // K row stride
  static constexpr int RW = DL <= 2 ? 16 : (DL <= 4 ? 8 : 4);
  static constexpr int R = kWarps * RW;                 // rows per CTA
  static constexpr int SMEM_FLOATS = R * DP + BK * KS + BK * DP + R * BK;
};

template <int DL>
__global__ void __launch_bounds__(kThreads)
simt_kernel(FlashArgs a) {
  using TL = Tile<DL>;
  constexpr int DP = TL::DP, KS = TL::KS, RW = TL::RW, R = TL::R;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);          // [R][DP]
  float* Ks = Qs + R * DP;                              // [BK][KS]
  float* Vs = Ks + BK * KS;                             // [BK][DP]
  float* Ps = Vs + BK * DP;                             // [R][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y;
  const RowMap rm = row_map(a, b);
  const int rep = rm.rep, rows = rm.rows;
  const int r0 = blockIdx.x * R;
  const int D = a.D;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  // Q rows of this CTA, zero-padded to DP (inactive rows all zero).
  for (int idx = tid; idx < R * (DP / 8); idx += kThreads) {
    int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    int fr = r0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (fr < rows && c < D) {
      int i = fr / rep, h = g * rep + fr % rep;
      load8(q + b * a.q_sb + i * a.q_st + h * a.q_sh + c, x);
    }
    put8(Qs + r * DP + c, x);
  }

  // Keys this CTA needs: the limit of its last active row is the largest.
  const int last = min(r0 + R, rows) - 1;
  const int hi = rm.lim(last);
  const int ntiles = (hi + BK - 1) / BK;

  // Per-row state of this warp's rows: slot rr is the CTA's row
  // rr * kWarps + warp, so the few rows of a decode step (rep of them) are
  // spread over the warps. Slots from `active` on hold no row and are
  // skipped (a warp-uniform test).
  const int active = (min(R, rows - r0) - warp + kWarps - 1) / kWarps;
  float* Pw = Ps + warp * RW * BK;                      // this warp's p rows
  float m[RW], l[RW], acc[RW][DL];
  int lim[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = NEG;
    l[rr] = 0.f;
    lim[rr] = rm.lim(r0 + rr * kWarps + warp);
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }

  const float* kb = k + b * a.k_sb + g * a.k_sh;
  const float* vb = v + b * a.v_sb + g * a.v_sh;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                                    // done with the last tile
    for (int idx = tid; idx < BK * (DP / 8); idx += kThreads) {
      int j = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
      float xk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < hi && c < D) {
        load8(kb + (int64_t)(k0 + j) * a.k_st + c, xk);
        load8(vb + (int64_t)(k0 + j) * a.v_st + c, xv);
      }
      put8(Ks + j * KS + c, xk);
      put8(Vs + j * DP + c, xv);
    }
    __syncthreads();

    // Scores, masks and the online-softmax update, four rows at a time.
#pragma unroll
    for (int sub = 0; sub < RW; sub += 4) {
      if (sub >= active) break;
      float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      const float* ka = Ks + lane * KS;
      const float* kb2 = Ks + (lane + 32) * KS;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        float4 x0 = *reinterpret_cast<const float4*>(ka + d);
        float4 x1 = *reinterpret_cast<const float4*>(kb2 + d);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float4 qq = *reinterpret_cast<const float4*>(Qs + ((sub + rr) * kWarps + warp) * DP + d);
          s[rr][0] = dot4(qq, x0, s[rr][0]);
          s[rr][1] = dot4(qq, x1, s[rr][1]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int row = sub + rr;
        float x0 = k0 + lane < lim[row] ? s[rr][0] * a.scale : NEG;
        float x1 = k0 + lane + 32 < lim[row] ? s[rr][1] * a.scale : NEG;
        float m_new = fmaxf(m[row], warp_max(fmaxf(x0, x1)));
        float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        float alpha = expf(m[row] - m_new);
        l[row] = l[row] * alpha + warp_sum(p0 + p1);
        m[row] = m_new;
        Pw[row * BK + lane] = p0;
        Pw[row * BK + lane + 32] = p1;
#pragma unroll
        for (int t = 0; t < DL; ++t) acc[row][t] *= alpha;
      }
    }
    __syncwarp();

    // acc += P V over the tile's keys, four at a time.
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < DL; ++t) vv[jj][t] = Vs[(j + jj) * DP + lane + 32 * t];
#pragma unroll
      for (int row = 0; row < RW; ++row) {
        if (row % 4 == 0 && row >= active) break;       // by groups of 4
        float4 p = *reinterpret_cast<const float4*>(Pw + row * BK + j);
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          float x = acc[row][t];
          x = fmaf(p.x, vv[0][t], x);
          x = fmaf(p.y, vv[1][t], x);
          x = fmaf(p.z, vv[2][t], x);
          acc[row][t] = fmaf(p.w, vv[3][t], x);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int row = 0; row < RW; ++row) {
    if (row >= active) break;
    int fr = r0 + row * kWarps + warp;
    int i = fr / rep, h = g * rep + fr % rep;
    float* orow = o + b * a.o_sb + i * a.o_st + h * a.o_sh;
    float inv = 1.f / fmaxf(l[row], 1e-30f);
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      int d = lane + 32 * t;
      if (d < D) orow[d] = acc[row][t] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// split body and combine: decode, keys split over CTAs.
// ---------------------------------------------------------------------------
//
// Grid (splits, Hkv, B), 8 warps. The <= 16 rows are dealt out to the warps
// (slot rr of warp w is row rr * 8 + w); lane j owns keys j + 32 c of a
// tile for the scores and dims j + 32 t for P V, as in the simt body, but
// K and V stay in their input type in shared memory, each row padded by 16
// bytes so a quarter-warp's 16-byte reads of eight rows hit distinct banks.

template <typename T, int DL>
struct SplitTile {
  static constexpr int DP = 32 * DL;                    // padded head dim
  static constexpr int E = 16 / sizeof(T);              // elements per 16 bytes
  static constexpr int BKS = sizeof(T) * DP > 512 ? 32 : 64;  // keys per tile
  static constexpr int KPL = BKS / 32;                  // keys per lane
  static constexpr int KS = DP + E;                     // K/V row stride
  static constexpr int RW = kSplitRows / kSplitWarps;   // row slots per warp
  static constexpr int TILE = BKS * KS;                 // elements of K or V
  static constexpr size_t SMEM =
      sizeof(float) * (kSplitRows * DP + kSplitRows * BKS) + sizeof(T) * 4 * TILE;
};

// Scratch layout, per (b, g, split s, row r) with idx = ((b * Hkv + g) *
// splits + s) * rows + r: m at [2 idx], l at [2 idx + 1], acc at
// [acc0 + idx * D, + D) with acc0 = 2 * B * Hkv * splits * rows.
__device__ __forceinline__ size_t part_idx(const FlashArgs& a, int rows, int b,
                                           int g, int s, int r) {
  return ((size_t)(b * a.Hkv + g) * a.splits + s) * rows + r;
}

template <typename T, int DL>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(FlashArgs a) {
  using TL = SplitTile<T, DL>;
  constexpr int DP = TL::DP, E = TL::E, BKS = TL::BKS, KPL = TL::KPL;
  constexpr int KS = TL::KS, RW = TL::RW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);          // [16][DP]
  float* Ps = Qs + kSplitRows * DP;                     // [16][BKS]
  T* KV = reinterpret_cast<T*>(Ps + kSplitRows * BKS);  // stage s: K, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const RowMap rm = row_map(a, b);
  const int rep = rm.rep, rows = rm.rows;
  const int D = a.D;

  const T* q = static_cast<const T*>(a.q);
  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;

  // This CTA's keys: [kb, ke), cut at the largest row limit.
  const int kb = s * a.chunk;
  const int ke = min(kb + a.chunk, rm.lim(rows - 1));
  const int ntiles = ke > kb ? (ke - kb + BKS - 1) / BKS : 0;

  // Tile t of the chunk into stage t & 1; keys at or past ke and the pad
  // past D read as zeros.
  auto issue = [&](int t) {
    T* Kt = KV + (t & 1) * 2 * TL::TILE;
    T* Vt = Kt + TL::TILE;
    const int k0 = kb + t * BKS;
    for (int idx = tid; idx < BKS * (DP / E); idx += kSplitThreads) {
      int j = idx / (DP / E), c = (idx % (DP / E)) * E;
      bool ok = k0 + j < ke && c < D;
      cp16(smem_u32(Kt + j * KS + c),
           ok ? kbase + (int64_t)(k0 + j) * a.k_st + c : kbase, ok);
      cp16(smem_u32(Vt + j * KS + c),
           ok ? vbase + (int64_t)(k0 + j) * a.v_st + c : vbase, ok);
    }
  };
  if (ntiles > 0) issue(0);
  cp_commit();

  // Q rows, f32, zero-padded to DP.
  for (int idx = tid; idx < kSplitRows * (DP / 8); idx += kSplitThreads) {
    int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows && c < D) {
      int i = r / rep, h = g * rep + r % rep;
      load8(q + b * a.q_sb + i * a.q_st + h * a.q_sh + c, x);
    }
    put8(Qs + r * DP + c, x);
  }

  const int active = max(0, min(RW, (rows - warp + kSplitWarps - 1) / kSplitWarps));
  float* Pw = Ps + warp * RW * BKS;                     // this warp's p rows
  float m[RW], l[RW], acc[RW][DL];
  bool live[RW];                                        // row sees keys here
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = NEG;
    l[rr] = 0.f;
    live[rr] = rm.lim(rr * kSplitWarps + warp) > kb;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) issue(t + 1);
    cp_commit();
    cp_wait<1>();                                       // tile t has landed
    __syncthreads();
    const T* Kt = KV + (t & 1) * 2 * TL::TILE;
    const T* Vt = Kt + TL::TILE;
    const int k0 = kb + t * BKS;

    float sc[RW][KPL];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int c = 0; c < KPL; ++c) sc[rr][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += E) {
      float kf[KPL][E];
#pragma unroll
      for (int c = 0; c < KPL; ++c) chunk_f32(Kt + (lane + 32 * c) * KS + d, kf[c]);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        if (rr >= active) break;
        const float* qr = Qs + (rr * kSplitWarps + warp) * DP + d;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          float4 qq = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
          for (int c = 0; c < KPL; ++c) sc[rr][c] = dot4(qq, kf[c] + e, sc[rr][c]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      if (rr >= active) break;
      const int lim = rm.lim(rr * kSplitWarps + warp);
      float p[KPL];
      if (live[rr]) {                                   // warp-uniform
        float x[KPL], mx = NEG;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          x[c] = k0 + lane + 32 * c < lim ? sc[rr][c] * a.scale : NEG;
          mx = fmaxf(mx, x[c]);
        }
        const float m_new = fmaxf(m[rr], warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          p[c] = expf(x[c] - m_new);
          sum += p[c];
        }
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(sum);
        m[rr] = m_new;
#pragma unroll
        for (int t2 = 0; t2 < DL; ++t2) acc[rr][t2] *= alpha;
      } else {
#pragma unroll
        for (int c = 0; c < KPL; ++c) p[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < KPL; ++c) Pw[rr * BKS + lane + 32 * c] = p[c];
    }
    __syncwarp();

    // acc += P V over the tile's keys, four at a time.
#pragma unroll 2
    for (int j = 0; j < BKS; j += 4) {
      float vv[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t2 = 0; t2 < DL; ++t2) vv[jj][t2] = to_f32(Vt[(j + jj) * KS + lane + 32 * t2]);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        if (rr >= active) break;
        float4 pp = *reinterpret_cast<const float4*>(Pw + rr * BKS + j);
#pragma unroll
        for (int t2 = 0; t2 < DL; ++t2) {
          float x = acc[rr][t2];
          x = fmaf(pp.x, vv[0][t2], x);
          x = fmaf(pp.y, vv[1][t2], x);
          x = fmaf(pp.z, vv[2][t2], x);
          acc[rr][t2] = fmaf(pp.w, vv[3][t2], x);
        }
      }
    }
    __syncthreads();                                    // stage free for t + 2
  }

  // The partial (m, l, acc) of each row; a row with no key here keeps
  // m = -1e30, l = 0, acc = 0.
  float* ml = a.scratch;
  float* pacc = a.scratch + 2 * (size_t)a.B * a.Hkv * a.splits * rows;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    if (rr >= active) break;
    const size_t idx = part_idx(a, rows, b, g, s, rr * kSplitWarps + warp);
    if (lane == 0) {
      ml[2 * idx] = m[rr];
      ml[2 * idx + 1] = l[rr];
    }
#pragma unroll
    for (int t2 = 0; t2 < DL; ++t2) {
      int d = lane + 32 * t2;
      if (d < D) pacc[idx * D + d] = acc[rr][t2];
    }
  }
}

// The block's maximum or sum of x (fixed tree: the same bits every run).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                                      // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Grid (rows, Hkv, B), 8 warps: merges the splits of one row. Thread s
// reads split s's (m, l); the weights exp(m_s - M) go to shared memory.
// The threads form G = 256 / D groups of D; group g sums the output of the
// splits [g S / G, (g + 1) S / G) in order, and the groups' sums are added
// in order, so the result does not depend on the order the CTAs ran in.
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(FlashArgs a) {
  extern __shared__ float w[];                          // [splits] weights
  __shared__ float red[kCombineThreads / 32];
  __shared__ float part[kCombineThreads];               // [G][D] group sums
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rep = a.Hq / a.Hkv, rows = a.Tq * rep, S = a.splits, D = a.D;
  const float* ml = a.scratch;
  const float* pacc = a.scratch + 2 * (size_t)a.B * a.Hkv * S * rows;
  const size_t i0 = part_idx(a, rows, b, g, 0, r);      // split s at i0 + s * rows

  float mx = NEG;
  for (int s = tid; s < S; s += kCombineThreads)
    mx = fmaxf(mx, ml[2 * (i0 + (size_t)s * rows)]);
  const float M = block_reduce<true>(mx, red);
  float lsum = 0.f;
  for (int s = tid; s < S; s += kCombineThreads) {
    const float2 m_l = *reinterpret_cast<const float2*>(ml + 2 * (i0 + (size_t)s * rows));
    w[s] = expf(m_l.x - M);
    lsum += w[s] * m_l.y;
  }
  const float inv = 1.f / fmaxf(block_reduce<false>(lsum, red), 1e-30f);

  const int G = kCombineThreads / D, grp = tid / D, d = tid % D;
  if (grp < G) {
    float x = 0.f;
    const float* src = pacc + i0 * D + d;
    for (int s = grp * S / G; s < (grp + 1) * S / G; ++s)
      x += w[s] * src[(size_t)s * rows * D];
    part[tid] = x;
  }
  __syncthreads();
  if (tid < D) {
    float x = part[tid];
    for (int k = 1; k < G; ++k) x += part[k * D + tid];
    const int i = r / rep, h = g * rep + r % rep;
    store1(static_cast<T*>(a.o) + b * a.o_sb + i * a.o_st + h * a.o_sh + tid, x * inv);
  }
}

// ---------------------------------------------------------------------------
// mma body: bf16 prefill on the tensor cores (wgmma).
// ---------------------------------------------------------------------------

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulators (N / 2 per thread:
// element 4 j + e is row lane / 4 + 8 (e / 2) of the warp's 16, column 8 j +
// 2 (lane % 4) + e % 2).
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }

  // D[64 x 64] += A[64 x 16] B[16 x 64]: A (bf16 pairs) in registers, B
  // MN-major (transposed) in shared memory.
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }

  // D[64 x 128] += A[64 x 16] B[16 x 128]: A (bf16 pairs) in registers, B
  // MN-major (transposed) in shared memory.
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<256> {
  // D[64 x 256] += A[64 x 16] B[16 x 256]: A (bf16 pairs) in registers, B
  // MN-major (transposed) in shared memory.
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};


__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulators before the wait.
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}
// Copies written by cp.async (generic proxy) become visible to wgmma's reads
// (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x (ex2.approx; the mma body's softmax runs in the log2 domain: scores
// are multiplied by scale * log2(e) once).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c (elements 8c .. 8c + 7) of row r in a
// [ROWS][DP] bf16 tile kept as DP / 64 column blocks of [ROWS][64], each
// row 128 bytes with the 128-byte swizzle (chunk c ^ (r % 8)): the layout
// of a K-major wgmma operand (Q, K) and, read with the transpose bit, of an
// MN-major one (V). Tiles start 1024-byte aligned.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-column blocks of an MN-major operand; unused for
// K-major), stride byte offset (between groups of 8 rows).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Warpgroups per CTA and keys per K/V tile by padded head dim. At 64 one
// warpgroup lets two CTAs share an SM and drift apart, so one's softmax can
// overlap the other's products (two warpgroups sharing each K/V tile meet
// at every tile's barrier and were 5% slower at qwen2-0.5b's prefill), and
// tiles of 64 keys beat 128 there; above 64 one warpgroup's CTA would fill
// an SM's shared memory alone (PERF.md).
template <int DP>
struct MmaTile {
  static constexpr int WG = DP == 64 ? 1 : 2;
  static constexpr int BKM = DP == 128 ? 128 : 64;      // keys per tile
  static constexpr int M = 64 * WG;                     // rows per CTA
  static constexpr int THREADS = 128 * WG;
  static constexpr int Q_BYTES = M * DP * 2;
  static constexpr int KV_BYTES = BKM * DP * 2;         // one tile of K or V
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * 2 * KV_BYTES;  // 2 stages
};

// Grid: one CTA per (row tile, b, g), the last row tile of every (b, g)
// first. Each of the WG warpgroups owns 64 rows; thread (warp w, lane)
// holds rows 16 w + lane / 4 and that + 8 of them.
template <int DP>
__global__ void __launch_bounds__(MmaTile<DP>::THREADS, 3 - MmaTile<DP>::WG)
mma_kernel(FlashArgs a) {
  using TL = MmaTile<DP>;
  constexpr int BKM = TL::BKM, M = TL::M, THREADS = TL::THREADS;
  constexpr int C = DP / 8;                             // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t KVs = Qs + TL::Q_BYTES;                // stage s: K, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int rep = a.Hq / a.Hkv, rows = a.Tq * rep;
  const int nrt = (rows + M - 1) / M, bgs = a.B * a.Hkv;
  const int rt = nrt - 1 - (int)(blockIdx.x / bgs);
  const int g = (int)(blockIdx.x % bgs) % a.Hkv, b = (int)(blockIdx.x % bgs) / a.Hkv;
  const RowMap rm = row_map(a, b);
  const int r0 = rt * M;
  const int hi = rm.lim(min(r0 + M, rows) - 1);
  const int ntiles = (hi + BKM - 1) / BKM;
  const int D = a.D;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kbase = static_cast<const bf16*>(a.k) + b * a.k_sb + g * a.k_sh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + b * a.v_sb + g * a.v_sh;

  // Q rows (zeros past the rows and past D), then K/V tiles into stage t & 1.
  for (int idx = tid; idx < M * C; idx += THREADS) {
    int r = idx / C, c = idx % C, fr = r0 + r;
    bool ok = fr < rows && c * 8 < D;
    const bf16* src = q;
    if (ok) src = q + b * a.q_sb + (int64_t)(fr / rep) * a.q_st
                  + (g * rep + fr % rep) * a.q_sh + c * 8;
    cp16(Qs + sw128<M>(r, c), src, ok);
  }
  auto issue = [&](int t) {
    const uint32_t Kt = KVs + (t & 1) * 2 * TL::KV_BYTES, Vt = Kt + TL::KV_BYTES;
    for (int idx = tid; idx < BKM * C; idx += THREADS) {
      int j = idx / C, c = idx % C, key = t * BKM + j;
      bool ok = key < hi && c * 8 < D;
      cp16(Kt + sw128<BKM>(j, c), ok ? kbase + (int64_t)key * a.k_st + c * 8 : kbase, ok);
      cp16(Vt + sw128<BKM>(j, c), ok ? vbase + (int64_t)key * a.v_st + c * 8 : vbase, ok);
    }
  };
  issue(0);
  cp_commit();

  const int ra = wg * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int lim_a = rm.lim(r0 + ra), lim_b = rm.lim(r0 + rb);
  const int col0 = 2 * (lane & 3);
  float O[DP / 2], S[BKM / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) O[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKM / 2; ++i) S[i] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;     // l: this thread's part
  const float sl2 = a.scale * 1.4426950408889634f;      // scale * log2(e)

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<0>();                                       // tile t has landed
    fence_proxy_async();
    __syncthreads();                                    // ... for every thread
    if (t + 1 < ntiles) issue(t + 1);                   // overlaps this tile
    cp_commit();
    const uint32_t Kt = KVs + (t & 1) * 2 * TL::KV_BYTES, Vt = Kt + TL::KV_BYTES;

    // S = Q K^T: DP / 16 steps of k16; a step inside a 128-byte row moves
    // the start address by 32 bytes.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dq = gmma_desc(Qs + (kk >> 2) * (M * 128) + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t dk = gmma_desc(Kt + (kk >> 2) * (BKM * 128) + (kk & 3) * 32, 16, 1024);
      Wgmma<BKM>::ss(S, dq, dk, kk > 0);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int i = 0; i < BKM / 2; ++i) reg_fence(S[i]);

    // Scale (by scale * log2 e, in f32) and mask, then the online softmax
    // of rows a and b in the log2 domain. Tiles below both rows' limits
    // need no mask.
    const int k0 = t * BKM;
    float mx_a = m_a, mx_b = m_b;
    if (k0 + BKM <= min(lim_a, lim_b)) {
#pragma unroll
      for (int j = 0; j < BKM / 2; ++j) S[j] *= sl2;
    } else {
#pragma unroll
      for (int j = 0; j < BKM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + col0 + e;
          S[4 * j + e] = col < lim_a ? S[4 * j + e] * sl2 : NEG;
          S[4 * j + 2 + e] = col < lim_b ? S[4 * j + 2 + e] * sl2 : NEG;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BKM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, S[4 * j + e]);
        mx_b = fmaxf(mx_b, S[4 * j + 2 + e]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float al_a = ex2(m_a - mx_a), al_b = ex2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int j = 0; j < BKM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        S[4 * j + e] = ex2(S[4 * j + e] - mx_a);
        S[4 * j + 2 + e] = ex2(S[4 * j + 2 + e] - mx_b);
        s_a += S[4 * j + e];
        s_b += S[4 * j + 2 + e];
      }
    }
    l_a = l_a * al_a + s_a;
    l_b = l_b * al_b + s_b;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      O[4 * j] *= al_a;
      O[4 * j + 1] *= al_a;
      O[4 * j + 2] *= al_b;
      O[4 * j + 3] *= al_b;
    }

    // O += P V: P in bf16 as wgmma's A fragments (the accumulator layout of
    // S is the A layout of k16 step kk: S[8 kk .. 8 kk + 7]); V through the
    // transpose bit, 16 keys (2048 bytes) a step.
    uint32_t P[BKM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKM / 16; ++kk) {
      P[kk][0] = pack_bf16(S[8 * kk], S[8 * kk + 1]);
      P[kk][1] = pack_bf16(S[8 * kk + 2], S[8 * kk + 3]);
      P[kk][2] = pack_bf16(S[8 * kk + 4], S[8 * kk + 5]);
      P[kk][3] = pack_bf16(S[8 * kk + 6], S[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKM / 16; ++kk)
      Wgmma<DP>::rs(O, P[kk], gmma_desc(Vt + kk * 2048, BKM * 128, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) reg_fence(O[i]);
  }

  // The row sums are split over the four threads of a quad.
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  bf16* o = static_cast<bf16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = r0 + (half ? rb : ra);
    if (fr >= rows) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    bf16* orow = o + b * a.o_sb + (int64_t)(fr / rep) * a.o_st + (g * rep + fr % rep) * a.o_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + col0;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            O[4 * j + 2 * half] * inv, O[4 * j + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// A measurement, not a body: the mma body's exponential against expf.
// ---------------------------------------------------------------------------
//
// For scores s [rows][cols] (raw q . k in f32; -inf where masked, skipped)
// and each row's largest score mx, p = exp(scale * s - scale * mx) as the
// reference computes it (expf of f32 products) and as the mma body does
// (ex2 of products by scale * log2 e). out[0] and out[1] receive, as float
// bits, the largest |p_body - p_ref| and the largest |p_body - p_ref| / p_ref
// where p_ref is a normal float.
__global__ void ex2_error_kernel(const float* s, const float* mx, int64_t cols,
                                 int64_t n, float scale, unsigned* out) {
  const float sl2 = scale * 1.4426950408889634f;        // as in mma_kernel
  float worst = 0.f, worst_rel = 0.f;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float x = s[i], m = mx[i / cols];
    if (x == -INFINITY) continue;
    const float ref = expf(__fsub_rn(__fmul_rn(x, scale), __fmul_rn(m, scale)));
    const float got = ex2(__fsub_rn(__fmul_rn(x, sl2), __fmul_rn(m, sl2)));
    const float err = fabsf(got - ref);
    worst = fmaxf(worst, err);
    if (ref >= 1.17549435e-38f) worst_rel = fmaxf(worst_rel, err / ref);
  }
  worst = warp_max(worst);
  worst_rel = warp_max(worst_rel);
  if ((threadIdx.x & 31) == 0) {                        // >= 0: bits order
    atomicMax(out, __float_as_uint(worst));
    atomicMax(out + 1, __float_as_uint(worst_rel));
  }
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared memory limit once per device (so a
// launch captured into a CUDA graph after a first launch makes no other
// call), then launches it.
template <typename Kernel>
int launch_kernel(Kernel kernel, bool* opted_in, dim3 grid, int threads,
                  size_t smem, cudaStream_t stream, const FlashArgs& a) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DL>
int launch_simt(const FlashArgs& a, cudaStream_t s) {
  using TL = Tile<DL>;
  static bool opted_in[64] = {};
  const int rows = a.Tq * (a.Hq / a.Hkv);
  dim3 grid((rows + TL::R - 1) / TL::R, a.Hkv, a.B);
  return launch_kernel(simt_kernel<DL>, opted_in, grid, kThreads,
                       sizeof(float) * TL::SMEM_FLOATS, s, a);
}

template <typename T, int DL>
int launch_split(const FlashArgs& a, cudaStream_t s) {
  static bool opted_in[64] = {};
  dim3 grid(a.splits, a.Hkv, a.B);
  return launch_kernel(split_kernel<T, DL>, opted_in, grid, kSplitThreads,
                       SplitTile<T, DL>::SMEM, s, a);
}

template <int DP>
int launch_mma(const FlashArgs& a, cudaStream_t s) {
  using TL = MmaTile<DP>;
  static bool opted_in[64] = {};
  const int rows = a.Tq * (a.Hq / a.Hkv);
  const long long ctas = (long long)((rows + TL::M - 1) / TL::M) * a.B * a.Hkv;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch_kernel(mma_kernel<DP>, opted_in, dim3((unsigned)ctas), TL::THREADS,
                       TL::SMEM, s, a);
}

// Head-dim dispatch of the CUDA-core bodies: DL = ceil(D / 32).
int dispatch_simt(const FlashArgs& a, cudaStream_t s) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_simt<1>(a, s);
    case 2: return launch_simt<2>(a, s);
    case 3: return launch_simt<3>(a, s);
    case 4: return launch_simt<4>(a, s);
    case 5: return launch_simt<5>(a, s);
    case 6: return launch_simt<6>(a, s);
    case 7: return launch_simt<7>(a, s);
    case 8: return launch_simt<8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_split(const FlashArgs& a, cudaStream_t s) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_split<T, 1>(a, s);
    case 2: return launch_split<T, 2>(a, s);
    case 3: return launch_split<T, 3>(a, s);
    case 4: return launch_split<T, 4>(a, s);
    case 5: return launch_split<T, 5>(a, s);
    case 6: return launch_split<T, 6>(a, s);
    case 7: return launch_split<T, 7>(a, s);
    case 8: return launch_split<T, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_mma(const FlashArgs& a, cudaStream_t s) {
  if (a.D <= 64) return launch_mma<64>(a, s);
  if (a.D <= 128) return launch_mma<128>(a, s);
  return launch_mma<256>(a, s);
}

bool valid(const FlashArgs* a) {
  return a->D >= 8 && a->D <= 256 && a->D % 8 == 0 && a->Hkv > 0 &&
         a->Hq % a->Hkv == 0 && a->B > 0 && a->Tq > 0 && a->Tkv > 0 &&
         a->B <= 65535 && a->Hkv <= 65535 && (a->dtype == 0 || a->dtype == 1);
}

bool valid_split(const FlashArgs* a) {
  return a->scratch != nullptr && a->splits >= 1 && a->splits <= 4096 &&
         a->chunk >= 64 && a->chunk % 64 == 0 &&
         a->Tq * (a->Hq / a->Hkv) <= kSplitRows;
}

}  // namespace

// Runs the body that a->body names: 0 simt (f32 only), 1 mma (bf16 only), 2 split
// (partials into a->scratch; flash_attention_combine finishes it). Returns
// 0 or the CUDA error of the launch. The wrapper
// (repro_torch/kernels/flash_attention.py) checks shapes, types, strides,
// alignment and the plan; these checks only keep a bad call from reaching
// the device.
extern "C" int flash_attention_fwd(const FlashArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->body) {
    case 0:
      if (a->dtype != 0) return (int)cudaErrorInvalidValue;
      return dispatch_simt(*a, s);
    case 1:
      if (a->dtype != 1) return (int)cudaErrorInvalidValue;
      return dispatch_mma(*a, s);
    case 2:
      if (!valid_split(a)) return (int)cudaErrorInvalidValue;
      return a->dtype == 0 ? dispatch_split<float>(*a, s)
                           : dispatch_split<__nv_bfloat16>(*a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The split body's second kernel: merges the partials in a->scratch into o.
extern "C" int flash_attention_combine(const FlashArgs* a, void* stream) {
  if (!valid(a) || a->body != 2 || !valid_split(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = a->Tq * (a->Hq / a->Hkv);
  dim3 grid(rows, a->Hkv, a->B);
  const size_t smem = sizeof(float) * a->splits;
  if (a->dtype == 0) combine_kernel<float><<<grid, kCombineThreads, smem, s>>>(*a);
  else combine_kernel<__nv_bfloat16><<<grid, kCombineThreads, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

// ex2_error_kernel over n scores (out: two zeroed unsigned ints).
extern "C" int flash_attention_ex2_error(const float* s, const float* mx,
                                         int64_t cols, int64_t n, float scale,
                                         unsigned* out, void* stream) {
  if (cols <= 0 || n <= 0 || n % cols) return (int)cudaErrorInvalidValue;
  ex2_error_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, mx, cols, n, scale, out);
  return (int)cudaGetLastError();
}
