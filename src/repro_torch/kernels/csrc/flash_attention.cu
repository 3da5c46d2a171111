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
// multiple of 8 up to 256: tiles are padded with zeros to DP, the next
// multiple of 32, in shared memory (the TPU's padding of D to 128 lanes is
// not carried over).
//
// Design. One CTA of 4 warps per (b, kv head g, tile of R rows), where the
// rows are the flattened (q position, q head of the group) pairs, position
// major: the rep q heads that share kv head g sit in one CTA, so each K/V
// tile is read from device memory once per kv head and not rep times. A
// loop over key tiles of BK = 64 takes the place of the Pallas grid's
// sequential fourth axis: each tile is converted to f32 into shared memory,
// then every warp updates its RW rows. A CTA's rows are dealt out to the
// warps in turn, so the rep rows of a decode step keep all four warps busy.
// Running max m, normaliser l and the accumulator (DP / 32 values per lane
// and row) stay in registers for the whole loop. Scores: lane j owns keys j
// and j + 32 of the tile and takes the dot products with float4 reads (the
// q row is a broadcast, the K rows are padded by 4 floats so a
// quarter-warp's 16-byte reads hit 32 distinct banks). Softmax: warp
// shuffles for the row max and sum; p goes to the warp's own rows of shared
// memory. P V: lane owns dims lane + 32 t, reads p four keys at a time as a
// broadcast float4 and V rows conflict-free.
// The exponential is expf (the build never uses fast math).
//
// Bound. Prefill is bound by operations: 4 * D flops per visible (row, key)
// pair, ~60 GFLOP per layer of qwen2-0.5b at batch 8 x 2048 tokens, ~61 us
// at the H100's 989 TFLOP/s in bf16 -- a rate only the tensor cores reach.
// This kernel runs the two products on the CUDA cores in f32 (67 TFLOP/s at
// most), with about five FMAs per shared-memory read: simple and right, a
// tensor-core (wgmma, TMA) version is later work. Decode (Tq = 1) is bound
// by bytes: K and V of the visible cache, read once per kv head thanks to
// the row grouping above; but one CTA per (b, kv head) reads its tiles one
// after another with no split over the keys, so it is bound by the latency
// of that chain, not by the card's memory rate.

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
  int64_t q_sb, q_st, q_sh;     // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int32_t B, Tq, Tkv, Hq, Hkv, D;
  int32_t kv_len_all;           // kv_len of every row when kv_len is null
  int32_t causal;
  int32_t dtype;                // 0 = float32, 1 = bfloat16
  float scale;
};

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BK = 64;          // keys per tile
constexpr float NEG = -1e30f;   // the reference's mask value

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

// Rows per warp: the accumulator holds RW * DL floats per lane.
template <int DL>
struct Tile {
  static constexpr int DP = 32 * DL;                    // padded head dim
  static constexpr int KS = DP + 4;                     // K row stride
  static constexpr int RW = DL <= 2 ? 16 : (DL <= 4 ? 8 : 4);
  static constexpr int R = kWarps * RW;                 // rows per CTA
  static constexpr int SMEM_FLOATS = R * DP + BK * KS + BK * DP + R * BK;
};

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
flash_kernel(FlashArgs a) {
  using TL = Tile<DL>;
  constexpr int DP = TL::DP, KS = TL::KS, RW = TL::RW, R = TL::R;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);          // [R][DP]
  float* Ks = Qs + R * DP;                              // [BK][KS]
  float* Vs = Ks + BK * KS;                             // [BK][DP]
  float* Ps = Vs + BK * DP;                             // [R][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, g = blockIdx.y;
  const int rep = a.Hq / a.Hkv;
  const int rows = a.Tq * rep;                          // flattened rows of (b, g)
  const int r0 = blockIdx.x * R;
  const int D = a.D;

  int kvl = a.kv_len != nullptr ? a.kv_len[b] : a.kv_len_all;
  kvl = min(max(kvl, 0), a.Tkv);
  const int off = kvl - a.Tq;                           // ends-aligned offset

  auto row_lim = [&](int fr) -> int {
    if (fr >= rows) return 0;
    int lim = a.causal ? min(kvl, fr / rep + off + 1) : kvl;
    return max(lim, 0);
  };

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  // Q rows of this CTA, f32, zero-padded to DP (inactive rows all zero).
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
  const int hi = row_lim(last);
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
    lim[rr] = row_lim(r0 + rr * kWarps + warp);
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }

  const T* kb = k + b * a.k_sb + g * a.k_sh;
  const T* vb = v + b * a.v_sb + g * a.v_sh;

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
    T* orow = o + b * a.o_sb + i * a.o_st + h * a.o_sh;
    float inv = 1.f / fmaxf(l[row], 1e-30f);
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      int d = lane + 32 * t;
      if (d < D) store1(orow + d, acc[row][t] * inv);
    }
  }
}

template <typename T, int DL>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using TL = Tile<DL>;
  const size_t smem = sizeof(float) * TL::SMEM_FLOATS;
  // Above 48 KB only after this opt-in, once per device (so a launch being
  // captured into a CUDA graph after a first launch makes no other call).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_kernel<T, DL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int rows = a.Tq * (a.Hq / a.Hkv);
  dim3 grid((rows + TL::R - 1) / TL::R, a.Hkv, a.B);
  flash_kernel<T, DL><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashArgs& a, cudaStream_t s) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<T, 1>(a, s);
    case 2: return launch<T, 2>(a, s);
    case 3: return launch<T, 3>(a, s);
    case 4: return launch<T, 4>(a, s);
    case 5: return launch<T, 5>(a, s);
    case 6: return launch<T, 6>(a, s);
    case 7: return launch<T, 7>(a, s);
    case 8: return launch<T, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns 0 or the CUDA error of the launch. The wrapper
// (repro_torch/kernels/flash_attention.py) checks shapes, types, strides and
// alignment; these checks only keep a bad call from reaching the device.
extern "C" int flash_attention_fwd(const FlashArgs* a, void* stream) {
  if (a->D < 8 || a->D > 256 || a->D % 8 != 0 || a->Hkv <= 0 ||
      a->Hq % a->Hkv != 0 || a->B <= 0 || a->Tq <= 0 || a->Tkv <= 0)
    return (int)cudaErrorInvalidValue;
  if (a->B > 65535 || a->Hkv > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return dispatch<float>(*a, s);
  if (a->dtype == 1) return dispatch<__nv_bfloat16>(*a, s);
  return (int)cudaErrorInvalidValue;
}
