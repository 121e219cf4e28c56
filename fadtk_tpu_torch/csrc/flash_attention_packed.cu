// Flash attention for the speech encoders, hand-written for Hopper (sm_90a),
// in the two layouts the JAX package's two Pallas kernels take.
//
// Replaces, in fadtk_tpu/ops/flash_attention.py:
//
// - K1/K1b: flash_attention_packed (the Pallas body _kernel_packed), q, k, v
//   and out in the packed (B, T, H*D) projection layout, gate (B, T, H);
//   entry point fadtk_flash_attention_packed;
// - K2: flash_attention, per-(b, h) grid (the pallas_call at :490, bodies
//   _kernel / _kernel_bias over _body) and grouped grid (the pallas_call at
//   :422, body _kernel_grouped), q, k, v and out head-major (B, H, T, D),
//   gate (B, H, T); entry point fadtk_flash_attention_headmajor.
//
// Both compute
//
//   out[b, h, t, :] = softmax_s(q[b, h, t] . k[b, h, s] / sqrt(D)
//                               [+ gate[b, h, t] * pb[h, t, s]]) v[b, h, s]
//
// over keys s < n_valid[b] (a prefix key mask, n_valid clamped to [1, T]).
// The bracketed term is WavLM's factorized gated relative-position bias: pb
// (H, T, T) and gate, both float32, added after the 1/sqrt(D) scale and
// before the mask. The dense (B, H, T, T) bias is never built. pb and gate
// arrive unpadded (the Pallas wrappers pad them to their block multiple), so
// every pb read at a row or column >= T and every gate read at a row >= T is
// guarded. D = 64. Logits, the running max m, the running sum l and the
// accumulator are float32; the output is written in the input dtype. Masked
// logits are the finite -0.7*FLT_MAX of the Pallas kernels, so no NaN can
// arise.
//
// Layout. Every tensor is read through explicit element strides of its
// (batch, head, row) dimensions, with a unit last dimension (the Strides
// struct): the packed layout is (T*H*D, D, H*D), a contiguous head-major one
// (H*T*D, T*D, D), and the tensor-parallel path's head-split views of a
// packed projection, x.view(B, T, H, D).transpose(1, 2), are the packed
// strides again, so they are read in place with no .contiguous() copy. The
// gate is (T*H, 1, H) packed and (H*T, T, 1) head-major. Rows are loaded 16
// bytes a thread, so every stride but the last, and each base pointer, must
// be a multiple of 16 bytes (the wrappers check). pb is contiguous (H, T, T).
//
// Padded-row contract (same as the Pallas kernels): key tiles that start at
// or beyond n_valid[b] are skipped; query tiles that start at or beyond
// n_valid[b] write exact zeros; query rows in [n_valid, T) inside a live tile
// attend over the valid prefix. Every row < T is written with a finite value:
// the output comes from torch.empty, and a NaN left in a padded row would
// reach the next layer's V at a masked key, where 0 * NaN poisons valid rows.
//
// What bounds it. At the w2v2/WavLM 10 s bucket (B=16, T=499, H=12, D=64,
// bf16) with every key valid, one call does ~12 GFLOP of logits and p.v
// products against ~49 MB of q/k/v/out traffic (K1's count; the head-major
// form moves the same bytes), ~250 FLOP per byte, under the ~295 at which
// the tensor cores rather than device memory would bind: the roofline is the
// bytes, ~15 us at 3.35 TB/s, and this simple kernel is far from it, bound by
// its arithmetic and on-chip data movement. The design keeps everything after
// the one tile load on chip:
//
// - one CTA of 4 warps per (64-row query tile, head, batch element), or, in
//   the grouped form, per (query tile, group of G heads, batch element),
//   looping over its G heads and reusing the same shared memory for each;
// - the Q tile is loaded once per head; K and V tiles of 64 keys are staged
//   in shared memory, and the loop stops at ceil(n_valid / 64) tiles;
// - bf16: both products run on tensor cores through nvcuda::wmma (16x16x16,
//   bf16 in, f32 accumulate); each warp owns 16 query rows, so the online
//   softmax needs only warp-level synchronisation;
// - f32: both products run as FMA on CUDA cores (tensor-core TF32 would keep
//   ~3 digits and break the f32 parity contract);
// - the softmax state (m, l) and the output accumulator stay in registers.
//
// The bias form adds, per 64x64 tile, a read of the pb tile (16 KB of f32,
// batch-independent: 12 MB at H=12, T=499, which the 50 MB L2 keeps for the
// B query CTAs of a head) and one gate value per query row. In bf16 each warp
// adds it to its own 16 rows of the logits in shared memory with coalesced
// 128-byte row reads, so the kernel keeps its 45,056 bytes of static shared
// memory; in f32 the pb tile is staged in the P buffer, whose row r is read
// and then overwritten by the same two threads.
//
// The grouped form's G (fadtk_flash_attention_pick_group) comes from this
// card, not from the Pallas _pick_group's VMEM budget: shared memory is
// reused across the G heads, so G does not change it; the card's shared
// memory and registers fix how many CTAs an SM holds, and G is the largest
// divisor of H that still leaves one full wave of CTAs on every SM. The
// Pallas grouping amortised per-grid-step overhead, which a CUDA grid does
// not have, so the form is expected to gain nothing here; it is kept
// complete, checked and timed, and no production path calls it.
//
// The TPU kernels' VMEM block choices (_pick_block, _fit_packed_blocks,
// _pick_group) were deliberately not carried over: they fit 16 MB of VMEM
// and a 128x128 MXU. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 4 warps
constexpr float NEG = -0.7f * FLT_MAX;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64), exact

// Element strides of the (batch, head, row) dimensions; the last is unit.
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ int clamp_valid(const int* n_valid, int b, int T) {
  return min(max(n_valid[b], 1), T);
}

// ------------------------------------------------------------------------- //
// bf16: tensor cores via wmma
// ------------------------------------------------------------------------- //

constexpr int LDH = D + 8;  // bf16 tile row stride (multiple of 8, 16 B rows)
constexpr int LDS = D + 4;  // f32 scratch row stride (multiple of 4)

__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int T, long long st) {
  // 64 rows x 64 columns = 512 chunks of 8 bf16 (16 B); rows >= T read as 0.
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int row = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < T)
      val = *reinterpret_cast<const uint4*>(src + (row0 + row) * st + c);
    *reinterpret_cast<uint4*>(dst + row * LDH + c) = val;
  }
}

__device__ __forceinline__ void zero_tile_bf16(__nv_bfloat16* dst, int q0, int T,
                                               long long st) {
  for (int i = threadIdx.x; i < BQ * 8; i += THREADS) {
    const int row = i >> 3, c = (i & 7) * 8;
    if (q0 + row < T)
      *reinterpret_cast<uint4*>(dst + (q0 + row) * st + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One (query tile, head) of the bf16 kernel. qh/kh/vh/oh point at row 0 of
// this (batch, head); gh at this (batch, head)'s gate row 0 (stride gst) and
// pb_h at this head's (T, T) plane, both unused without BIAS.
template <bool BIAS>
__device__ __forceinline__ void attend_bf16(
    __nv_bfloat16* QP, __nv_bfloat16* Ks, __nv_bfloat16* Vs, float* S,
    const __nv_bfloat16* qh, long long qst, const __nv_bfloat16* kh, long long kst,
    const __nv_bfloat16* vh, long long vst, __nv_bfloat16* oh, long long ost,
    const float* pb_h, const float* gh, long long gst, int q0, int nv, int T) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile_bf16(QP, qh, q0, T, qst);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], QP + warp * 16 * LDH + kk * 16, LDH);

  // Lane (lr, half) owns row warp*16 + lr and the interleaved columns
  // 2*j + half, j < 32 (both of the logits tile and of the output).
  const int lr = lane >> 1, half = lane & 1;
  float* srow = S + (warp * 16 + lr) * LDS;
  __nv_bfloat16* prow = QP + (warp * 16 + lr) * LDH;
  float m_i = NEG, l_i = 0.f;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  // Bias form: lane i < 16 holds the gate of the warp's query row i.
  float g_lane = 0.f;
  if (BIAS) {
    const int gr = q0 + warp * 16 + (lane & 15);
    if (gr < T) g_lane = gh[gr * gst];
  }

  const int n_tiles = (nv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile_bf16(Ks, kh, k0, T, kst);
    load_tile_bf16(Vs, vh, k0, T, vst);
    __syncthreads();

    // S[16 rows, 64 keys] = Q K^T for this warp's rows.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(S + warp * 16 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    if (BIAS) {
      // S = S / sqrt(D) + gate * pb over the warp's 16 x 64 logits: each
      // step reads 32 consecutive keys of one pb row. Rows >= T and keys
      // >= n_valid (masked below) are not read.
#pragma unroll 4
      for (int it = 0; it < 32; ++it) {
        const int row = it >> 1, col = ((it & 1) << 5) + lane;
        const int qr = q0 + warp * 16 + row, kc = k0 + col;
        const float g = __shfl_sync(0xffffffffu, g_lane, row);
        float* sp = S + (warp * 16 + row) * LDS + col;
        const float bias = (qr < T && kc < nv) ? g * pb_h[(size_t)qr * T + kc] : 0.f;
        *sp = *sp * SCALE + bias;
      }
      __syncwarp();
    }

    // Online softmax over this tile, two lanes per row.
    float s[32];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      s[j] = (k0 + c < nv) ? (BIAS ? srow[c] : srow[c] * SCALE) : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      prow[2 * j + half] = __float2bfloat16(p);
      o[j] *= alpha;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
    __syncwarp();

    // S[16 rows, 64 dims] = P V for this warp's rows.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, QP + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(S + warp * 16 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] += srow[2 * j + half];
    __syncwarp();
  }

  const float den = fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int j = 0; j < 32; ++j) srow[2 * j + half] = o[j] / den;
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * 8; i += THREADS) {
    const int row = i >> 3, c = i & 7;
    if (q0 + row >= T) continue;
    const float* src = S + row * LDS + c * 8;
    __align__(16) __nv_bfloat16 pk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) pk[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(oh + (q0 + row) * ost + c * 8) =
        *reinterpret_cast<const uint4*>(pk);
  }
}

// Grid (query tiles, H / G, B); each CTA serves G consecutive heads of one
// batch element in turn (G = 1 outside the grouped form).
template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, Strides sq,
                 const __nv_bfloat16* __restrict__ k, Strides sk,
                 const __nv_bfloat16* __restrict__ v, Strides sv,
                 const int* __restrict__ n_valid,
                 const float* __restrict__ pb, const float* __restrict__ gate, Strides sg,
                 __nv_bfloat16* __restrict__ out, Strides so, int T, int G) {
  // QP holds the Q tile, then each warp's probabilities P over its own 16
  // rows (Q lives in registers by then). S holds each warp's logits, then its
  // p.v product, then the normalised output tile.
  __shared__ __align__(128) __nv_bfloat16 QP[BQ * LDH];
  __shared__ __align__(128) __nv_bfloat16 Ks[BK * LDH];
  __shared__ __align__(128) __nv_bfloat16 Vs[BK * LDH];
  __shared__ __align__(128) float S[BQ * LDS];

  const int b = blockIdx.z, h0 = blockIdx.y * G, q0 = blockIdx.x * BQ;
  const int nv = clamp_valid(n_valid, b, T);

  for (int hh = 0; hh < G; ++hh) {
    const int h = h0 + hh;
    __nv_bfloat16* oh = out + b * so.b + h * so.h;
    if (q0 >= nv) {  // fully padded query tile: exact zeros, no compute
      zero_tile_bf16(oh, q0, T, so.t);
      continue;
    }
    if (hh) __syncthreads();  // the previous head's output is written out of S
    attend_bf16<BIAS>(QP, Ks, Vs, S, q + b * sq.b + h * sq.h, sq.t, k + b * sk.b + h * sk.h,
                      sk.t, v + b * sv.b + h * sv.h, sv.t, oh, so.t,
                      BIAS ? pb + (size_t)h * T * T : nullptr,
                      BIAS ? gate + b * sg.b + h * sg.h : nullptr, sg.t, q0, nv, T);
  }
}

// ------------------------------------------------------------------------- //
// f32: FMA on CUDA cores
// ------------------------------------------------------------------------- //

constexpr int LDF = D + 1;  // odd stride: column walks hit distinct banks
constexpr size_t F32_SMEM = 4 * 64 * LDF * sizeof(float);

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int T, long long st) {
  // 64 rows x 64 columns = 1024 float4; rows >= T read as 0.
  for (int i = threadIdx.x; i < 64 * 16; i += THREADS) {
    const int row = i >> 4, c = (i & 15) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < T)
      val = *reinterpret_cast<const float4*>(src + (row0 + row) * st + c);
    float* d = dst + row * LDF + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// One (query tile, head) of the f32 kernel; arguments as attend_bf16's.
template <bool BIAS>
__device__ __forceinline__ void attend_f32(
    float* Qs, float* Ks, float* Vs, float* Ps,
    const float* qh, long long qst, const float* kh, long long kst,
    const float* vh, long long vst, float* oh, long long ost,
    const float* pb_h, const float* gh, long long gst, int q0, int nv, int T) {
  load_tile_f32(Qs, qh, q0, T, qst);
  // Thread (r, half) owns query row r and the interleaved columns 2*j + half.
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float m_i = NEG, l_i = 0.f;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  const float g_r = (BIAS && q0 + r < T) ? gh[(q0 + r) * gst] : 0.f;

  const int n_tiles = (nv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32(Ks, kh, k0, T, kst);
    load_tile_f32(Vs, vh, k0, T, vst);
    if (BIAS) {  // the pb tile, staged in Ps; rows >= T, keys >= n_valid read as 0
      for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
        const int row = i >> 6, c = i & 63;
        Ps[row * LDF + c] =
            (q0 + row < T && k0 + c < nv) ? pb_h[(size_t)(q0 + row) * T + k0 + c] : 0.f;
      }
    }
    __syncthreads();

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LDF + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = fmaf(qv, Ks[(2 * j + half) * LDF + d], s[j]);
    }
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      float x = s[j] * SCALE;
      if (BIAS) x += g_r * Ps[r * LDF + c];  // this thread rewrites Ps[r][c] below
      s[j] = (k0 + c < nv) ? x : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      Ps[r * LDF + 2 * j + half] = p;
      o[j] *= alpha;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
    __syncwarp();  // row r of P is written by this thread and its pair
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * LDF + c];
#pragma unroll
      for (int j = 0; j < 32; ++j) o[j] = fmaf(p, Vs[c * LDF + 2 * j + half], o[j]);
    }
  }

  const float den = fmaxf(l_i, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) Ps[r * LDF + 2 * j + half] = o[j] / den;
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int row = i >> 6, c = i & 63;
    if (q0 + row < T) oh[(q0 + row) * ost + c] = Ps[row * LDF + c];
  }
}

template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, Strides sq, const float* __restrict__ k,
                Strides sk, const float* __restrict__ v, Strides sv,
                const int* __restrict__ n_valid, const float* __restrict__ pb,
                const float* __restrict__ gate, Strides sg, float* __restrict__ out,
                Strides so, int T, int G) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + 64 * LDF;
  float* Vs = Ks + 64 * LDF;
  float* Ps = Vs + 64 * LDF;

  const int b = blockIdx.z, h0 = blockIdx.y * G, q0 = blockIdx.x * BQ;
  const int nv = clamp_valid(n_valid, b, T);

  for (int hh = 0; hh < G; ++hh) {
    const int h = h0 + hh;
    float* oh = out + b * so.b + h * so.h;
    if (q0 >= nv) {  // fully padded query tile: exact zeros, no compute
      for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
        const int row = i >> 6, c = i & 63;
        if (q0 + row < T) oh[(q0 + row) * so.t + c] = 0.f;
      }
      continue;
    }
    if (hh) __syncthreads();  // the previous head's output is written out of Ps
    attend_f32<BIAS>(Qs, Ks, Vs, Ps, q + b * sq.b + h * sq.h, sq.t, k + b * sk.b + h * sk.h,
                     sk.t, v + b * sv.b + h * sv.h, sv.t, oh, so.t,
                     BIAS ? pb + (size_t)h * T * T : nullptr,
                     BIAS ? gate + b * sg.b + h * sg.h : nullptr, sg.t, q0, nv, T);
  }
}

template <bool BIAS>
cudaError_t launch(const void* q, Strides sq, const void* k, Strides sk, const void* v,
                   Strides sv, const int* n_valid, const float* pb, const float* gate,
                   Strides sg, void* out, Strides so, int B, int T, int H, int G, int dtype,
                   cudaStream_t s) {
  const dim3 grid((T + BQ - 1) / BQ, H / G, B);
  if (dtype == 1) {
    attn_bf16_kernel<BIAS><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), sq, static_cast<const __nv_bfloat16*>(k), sk,
        static_cast<const __nv_bfloat16*>(v), sv, n_valid, pb, gate, sg,
        static_cast<__nv_bfloat16*>(out), so, T, G);
  } else if (dtype == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_f32_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (e != cudaSuccess) return e;
    attn_f32_kernel<BIAS><<<grid, THREADS, F32_SMEM, s>>>(
        static_cast<const float*>(q), sq, static_cast<const float*>(k), sk,
        static_cast<const float*>(v), sv, n_valid, pb, gate, sg, static_cast<float*>(out), so,
        T, G);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, Strides sq, const void* k, Strides sk, const void* v,
                     Strides sv, const int* n_valid, const float* pb, const float* gate,
                     Strides sg, void* out, Strides so, int B, int T, int H, int G, int dtype,
                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G || (pb == nullptr) != (gate == nullptr) ||
      (pb != nullptr && G != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pb ? launch<true>(q, sq, k, sk, v, sv, n_valid, pb, gate, sg, out, so, B, T, H, G,
                           dtype, s)
            : launch<false>(q, sq, k, sk, v, sv, n_valid, pb, gate, sg, out, so, B, T, H, G,
                            dtype, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// pb (H, T, T) and gate are float32 and both null for the no-bias form;
// dtype 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.

// K1/K1b: q, k, v, out packed (B, T, H*D), gate (B, T, H), all contiguous.
extern "C" int fadtk_flash_attention_packed(const void* q, const void* k, const void* v,
                                            const int* n_valid, const float* pb,
                                            const float* gate, void* out, int B, int T,
                                            int H, int dtype, void* stream) {
  const long long hd = (long long)H * D;
  const Strides packed{(long long)T * hd, D, hd};
  const Strides gate_bth{(long long)T * H, 1, H};
  return (int)dispatch(q, packed, k, packed, v, packed, n_valid, pb, gate, gate_bth, out,
                       packed, B, T, H, 1, dtype, stream);
}

// K2: q, k, v, out (B, H, T, D) and gate (B, H, T) through element strides:
// ``strides`` holds 15 host int64s, the (batch, head, row) strides of q, k,
// v, out and gate in that order (the gate's are ignored without bias). G > 1
// is the grouped form: G heads per CTA, no bias, H a multiple of G.
extern "C" int fadtk_flash_attention_headmajor(const void* q, const void* k, const void* v,
                                               const int* n_valid, const float* pb,
                                               const float* gate, void* out,
                                               const long long* strides, int B, int T,
                                               int H, int G, int dtype, void* stream) {
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  return (int)dispatch(q, s[0], k, s[1], v, s[2], n_valid, pb, gate, s[4], out, s[3], B, T,
                       H, G, dtype, stream);
}

// The grouped form's G on the current card: the largest divisor of H for
// which (query tiles x H/G x B) CTAs still fill one wave at the occupancy the
// no-bias kernel reaches (its shared memory and registers fix CTAs per SM);
// 1 when no G > 1 does. Returns -cudaError on failure.
extern "C" int fadtk_flash_attention_pick_group(int B, int T, int H, int dtype) {
  if (B <= 0 || T <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dtype == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_bf16_kernel<false>,
                                                      THREADS, 0);
  } else if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(attn_f32_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_f32_kernel<false>,
                                                        THREADS, F32_SMEM);
  }
  if (e != cudaSuccess) return -(int)e;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (long long)((T + BQ - 1) / BQ) * B;
  for (int g = H; g > 1; --g)
    if (H % g == 0 && tiles * (H / g) >= wave) return g;
  return 1;
}
