// Packed-heads flash attention for the speech encoders, hand-written for
// Hopper (sm_90a).
//
// Replaces fadtk_tpu/ops/flash_attention.py::flash_attention_packed (the
// Pallas body _kernel_packed), no-bias form:
//
//   out[b, t, h*D:(h+1)*D] = softmax_s(q_h[t] . k_h[s] / sqrt(D)) v_h[s]
//
// over keys s < n_valid[b] (a prefix key mask, n_valid clamped to [1, T]).
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

__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ n_valid,
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

    // Online softmax over this tile, two lanes per row.
    float s[32];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      s[j] = (k0 + c < nv) ? srow[c] * SCALE : NEG;
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

__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ n_valid,
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

  const int n_tiles = (nv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32(Ks, k + base, k0, T, HD);
    load_tile_f32(Vs, v + base, k0, T, HD);
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
      s[j] = (k0 + 2 * j + half < nv) ? s[j] * SCALE : NEG;
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

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int fadtk_flash_attention_packed(const void* q, const void* k, const void* v,
                                            const int* n_valid, void* out, int B, int T,
                                            int H, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attn_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), n_valid, static_cast<__nv_bfloat16*>(out), T, H);
  } else if (dtype == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (e != cudaSuccess) return (int)e;
    attn_f32_kernel<<<grid, THREADS, F32_SMEM, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), n_valid, static_cast<float*>(out), T, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
