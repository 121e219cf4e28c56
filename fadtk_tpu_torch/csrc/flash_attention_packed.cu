// Packed-heads flash attention for the speech encoders, hand-written for
// Hopper (sm_90a).
//
// Replaces fadtk_tpu/ops/flash_attention.py::flash_attention_packed (the
// Pallas body _kernel_packed), in both of its forms:
//
//   out[b, t, h*D:(h+1)*D] = softmax_s(q_h[t] . k_h[s] / sqrt(D)
//                                      [+ gate[b, t, h] * pb[h, t, s]]) v_h[s]
//
// over keys s < n_valid[b] (a prefix key mask, n_valid clamped to [1, T]).
// The bracketed term is WavLM's factorized gated relative-position bias
// (has_bias=True in the Pallas kernel, its lines 559-562): pb (H, T, T) and
// gate (B, T, H), both float32, added after the 1/sqrt(D) scale and before
// the mask. The dense (B, H, T, T) bias is never built. pb and gate arrive
// unpadded (the Pallas wrapper pads them to its block multiple), so every pb
// read at a row or column >= T and every gate read at a row >= T is guarded.
// q, k, v and out are (B, T, H*D) row-major, the layout the projection GEMMs
// write: head h is read in place at column h*D, with no head transposes.
// D = 64. Logits, the running max m, the running sum l and the accumulator
// are float32; the output is written in the input dtype. Masked logits are
// the finite -0.7*FLT_MAX of the Pallas kernel, so no NaN can arise.
//
// Padded-row contract (same as the Pallas kernel): key tiles that start at
// or beyond n_valid[b] are skipped; query tiles that start at or beyond
// n_valid[b] write exact zeros; query rows in [n_valid, T) inside a live tile
// attend over the valid prefix. Every row < T is written with a finite value:
// the output comes from torch.empty, and a NaN left in a padded row would
// reach the next layer's V at a masked key, where 0 * NaN poisons valid rows.
//
// What bounds it. At the w2v2 10 s bucket (B=16, T=499, H=12, D=64, bf16)
// one call does ~12 GFLOP of logits and p.v products against ~49 MB of
// q/k/v/out traffic, ~250 FLOP per byte: a simple kernel is bound by its
// arithmetic and on-chip data movement, not by device memory. The design
// keeps everything after the one tile load on chip:
//
// - one CTA of 4 warps per (64-row query tile, head, batch element);
// - the Q tile is loaded once; K and V tiles of 64 keys are staged in shared
//   memory, and the loop stops at ceil(n_valid / 64) tiles;
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
// The TPU kernel's VMEM block choices (_pick_block, _fit_packed_blocks) were
// deliberately not carried over: they fit 16 MB of VMEM and a 128x128 MXU.
// wgmma, TMA and warp specialisation are later work.

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
                                               int row0, int T, int HD) {
  // 64 rows x 64 columns = 512 chunks of 8 bf16 (16 B); rows >= T read as 0.
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int row = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < T)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * HD + c);
    *reinterpret_cast<uint4*>(dst + row * LDH + c) = val;
  }
}

template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ n_valid,
                 const float* __restrict__ pb, const float* __restrict__ gate,
                 __nv_bfloat16* __restrict__ out, int T, int H) {
  using namespace nvcuda;
  // QP holds the Q tile, then each warp's probabilities P over its own 16
  // rows (Q lives in registers by then). S holds each warp's logits, then its
  // p.v product, then the normalised output tile.
  __shared__ __align__(128) __nv_bfloat16 QP[BQ * LDH];
  __shared__ __align__(128) __nv_bfloat16 Ks[BK * LDH];
  __shared__ __align__(128) __nv_bfloat16 Vs[BK * LDH];
  __shared__ __align__(128) float S[BQ * LDS];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const int nv = clamp_valid(n_valid, b, T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (q0 >= nv) {  // fully padded query tile: exact zeros, no compute
    for (int i = threadIdx.x; i < BQ * 8; i += THREADS) {
      const int row = i >> 3, c = (i & 7) * 8;
      if (q0 + row < T)
        *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + row) * HD + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  load_tile_bf16(QP, q + base, q0, T, HD);
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
  const float* pb_h = BIAS ? pb + (size_t)h * T * T : nullptr;
  float g_lane = 0.f;
  if (BIAS) {
    const int gr = q0 + warp * 16 + (lane & 15);
    if (gr < T) g_lane = gate[((size_t)b * T + gr) * H + h];
  }

  const int n_tiles = (nv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile_bf16(Ks, k + base, k0, T, HD);
    load_tile_bf16(Vs, v + base, k0, T, HD);
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
    const int row = i >> 3, c = (i & 7) * 8;
    if (q0 + row >= T) continue;
    const float* src = S + row * LDS + c;
    __align__(16) __nv_bfloat16 pk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) pk[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + row) * HD + c) =
        *reinterpret_cast<const uint4*>(pk);
  }
}

// ------------------------------------------------------------------------- //
// f32: FMA on CUDA cores
// ------------------------------------------------------------------------- //

constexpr int LDF = D + 1;  // odd stride: column walks hit distinct banks
constexpr size_t F32_SMEM = 4 * 64 * LDF * sizeof(float);

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int T, int HD) {
  // 64 rows x 64 columns = 1024 float4; rows >= T read as 0.
  for (int i = threadIdx.x; i < 64 * 16; i += THREADS) {
    const int row = i >> 4, c = (i & 15) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < T)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + row) * HD + c);
    float* d = dst + row * LDF + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ n_valid,
                const float* __restrict__ pb, const float* __restrict__ gate,
                float* __restrict__ out, int T, int H) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + 64 * LDF;
  float* Vs = Ks + 64 * LDF;
  float* Ps = Vs + 64 * LDF;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const int nv = clamp_valid(n_valid, b, T);

  if (q0 >= nv) {  // fully padded query tile: exact zeros, no compute
    for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
      const int row = i >> 6, c = i & 63;
      if (q0 + row < T) out[base + (size_t)(q0 + row) * HD + c] = 0.f;
    }
    return;
  }

  load_tile_f32(Qs, q + base, q0, T, HD);
  // Thread (r, half) owns query row r and the interleaved columns 2*j + half.
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float m_i = NEG, l_i = 0.f;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  const float* pb_h = BIAS ? pb + (size_t)h * T * T : nullptr;
  const float g_r = (BIAS && q0 + r < T) ? gate[((size_t)b * T + q0 + r) * H + h] : 0.f;

  const int n_tiles = (nv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32(Ks, k + base, k0, T, HD);
    load_tile_f32(Vs, v + base, k0, T, HD);
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
    if (q0 + row < T) out[base + (size_t)(q0 + row) * HD + c] = Ps[row * LDF + c];
  }
}

template <bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const int* n_valid,
                   const float* pb, const float* gate, void* out, int B, int T, int H,
                   int dtype, cudaStream_t s) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  if (dtype == 1) {
    attn_bf16_kernel<BIAS><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), n_valid, pb, gate,
        static_cast<__nv_bfloat16*>(out), T, H);
  } else if (dtype == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_f32_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (e != cudaSuccess) return e;
    attn_f32_kernel<BIAS><<<grid, THREADS, F32_SMEM, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), n_valid, pb, gate, static_cast<float*>(out), T, H);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// pb (H, T, T) and gate (B, T, H) are float32 and both null for the no-bias
// form; dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int fadtk_flash_attention_packed(const void* q, const void* k, const void* v,
                                            const int* n_valid, const float* pb,
                                            const float* gate, void* out, int B, int T,
                                            int H, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (pb == nullptr) != (gate == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pb ? launch<true>(q, k, v, n_valid, pb, gate, out, B, T, H, dtype, s)
                  : launch<false>(q, k, v, n_valid, pb, gate, out, B, T, H, dtype, s));
}
