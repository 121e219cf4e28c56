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
// bytes, ~15 us at 3.35 TB/s. What holds the kernel above it is on-chip:
// tensor-core issue, the softmax's exponentials, and the latency of each
// tile's loads. The bf16 design keeps everything after the loads in
// registers and overlaps the loads with the products:
//
// - one CTA of 4 warps per (64-row query tile, head, batch element), or, in
//   the grouped form, per (query tile, group of G heads, batch element),
//   looping over its G heads and reusing the same shared memory for each;
// - Q is copied once per head, and K and V tiles of 64 keys go through a
//   ring of two shared-memory stages filled by cp.async (16 bytes a thread,
//   zero-filled past T), so tile j + 1 lands while tile j is multiplied; the
//   loop stops at ceil(n_valid / 64) tiles;
// - bf16: both products are mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//   operands from shared memory by ldmatrix (V through its transpose); each
//   warp owns 16 query rows, so the online softmax needs only shuffles
//   within a quad of lanes; the logits S, the probabilities P (the A operand
//   of the p.v product is the S accumulator, exponentiated and packed to
//   bf16 pairs) and the output accumulator never leave registers, and the
//   output is written from them;
// - f32: both products run as FMA on CUDA cores, with K, V and P staged in
//   shared memory (no launch on the main path);
// - the softmax state (m, l) and the output accumulator stay in registers.
//
// The bias form adds, per 64x64 tile, a read of the pb tile (16 KB of f32,
// batch-independent: 12 MB at H=12, T=499, which the 50 MB L2 keeps for the
// B query CTAs of a head) and one gate value per query row. In bf16 each
// lane adds gate[row] * pb[h, row, key] to its own accumulator positions,
// read straight from L2 (pb rows of odd length are not 8-byte aligned, so
// the reads are 4-byte); in f32 the pb tile is staged in the P buffer, whose
// row r is read and then overwritten by the same two threads.
//
// wgmma (one warpgroup per 64-row tile, K and V as swizzled shared-memory
// descriptors) and TMA are not used: mma.sync keeps the same
// register-resident structure with operand layouts that the bf16 SEANet
// kernel already exercises.
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
// and a 128x128 MXU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// bf16: mma.sync on the tensor cores, S, P and O in registers
// ------------------------------------------------------------------------- //

constexpr int LDH = D + 8;          // smem tile row stride, elements (144 B: ldmatrix conflict-free)
constexpr int TILE = 64 * LDH;      // one 64-row tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared of `bytes` (0 or 16) bytes, the
// rest zero-filled (src must be a valid address even when bytes is 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate. Not volatile: the
// scheduler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 64 rows x 64 columns of a (batch, head) into a padded smem tile by
// cp.async, 16 bytes a thread; rows >= T are zero-filled.
__device__ __forceinline__ void fetch_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int T, long long st) {
#pragma unroll
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int row = i >> 3, c = (i & 7) * 8;
    const bool live = row0 + row < T;
    cp_async16(dst + row * LDH + c, live ? src + (row0 + row) * st + c : src, live ? 16 : 0);
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
// pb_h at this head's (T, T) plane, both unused without BIAS. Qs holds the Q
// tile, KV the ring of two (K, V) stages.
//
// Warp w owns query rows 16w .. 16w + 15 of the tile. In the m16n8k16
// accumulator layout lane (g = lane / 4, c = lane % 4) holds rows g and g + 8
// at columns 8j + 2c and 8j + 2c + 1 of each n8 tile j: the logits S (keys)
// and the output O (dims) both live there, and the A fragments of P for the
// p.v product are the S accumulators of two neighbouring n8 tiles, packed to
// bf16 pairs, so S, P and O never leave registers.
template <bool BIAS>
__device__ __forceinline__ void attend_bf16(
    __nv_bfloat16* Qs, __nv_bfloat16* KV,
    const __nv_bfloat16* qh, long long qst, const __nv_bfloat16* kh, long long kst,
    const __nv_bfloat16* vh, long long vst, __nv_bfloat16* oh, long long ost,
    const float* pb_h, const float* gh, long long gst, int q0, int nv, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n_tiles = (nv + BK - 1) / BK;

  // Q and the first K/V stage: one cp.async group.
  fetch_tile(Qs, qh, q0, T, qst);
  fetch_tile(KV, kh, 0, T, kst);
  fetch_tile(KV + TILE, vh, 0, T, vst);
  cp_async_commit();

  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;  // this lane's two query rows
  float gate0 = 0.f, gate1 = 0.f;
  if (BIAS) {
    if (r0 < T) gate0 = gh[r0 * gst];
    if (r1 < T) gate1 = gh[r1 * gst];
  }
  const float* pb0 = BIAS ? pb_h + (size_t)min(r0, T - 1) * T : nullptr;
  const float* pb1 = BIAS ? pb_h + (size_t)min(r1, T - 1) * T : nullptr;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // Tile kt + 1 into the other stage while tile kt is multiplied (that
    // stage's last readers passed the barrier at the end of the last tile).
    if (kt + 1 < n_tiles) {
      __nv_bfloat16* nxt = KV + ((kt + 1) & 1) * 2 * TILE;
      fetch_tile(nxt, kh, k0 + BK, T, kst);
      fetch_tile(nxt + TILE, vh, k0 + BK, T, vst);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) landed
    __syncthreads();
    const __nv_bfloat16* Ks = KV + (kt & 1) * 2 * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;

    // The bias form's pb values for this lane's logits, loaded before the
    // product so that their latency (L2) overlaps it.
    float pbv[BK / 8][4];
    if (BIAS) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * c + (e & 1);
          pbv[j][e] = key < nv ? __ldg((e < 2 ? pb0 : pb1) + key) : 0.f;
        }
    }

    // S = Q K^T: n8 tile j is keys 8j .. 8j + 7; one ldmatrix.x4 of K rows
    // gives the B fragments of two k16 steps. The Q fragments of those two
    // steps are read from shared memory again for every tile (8 registers,
    // not 16: the no-bias form then fits 128 without a spill).
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      unsigned qa0[4], qa1[4];
      const __nv_bfloat16* qrow = Qs + (16 * warp + (lane & 15)) * LDH + 8 * (lane >> 4);
      ldmatrix_x4(qa0, qrow + 16 * kk);
      ldmatrix_x4(qa1, qrow + 16 * kk + 16);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        unsigned kb[4];
        ldmatrix_x4(kb, Ks + (8 * j + (lane & 7)) * LDH + 16 * kk + 8 * (lane >> 3));
        mma_bf16(s[j], qa0, kb[0], kb[1]);
        mma_bf16(s[j], qa1, kb[2], kb[3]);
      }
    }

    // Scale, bias and key mask, in registers.
    const bool ragged = k0 + BK > nv;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        float x = s[j][e] * SCALE;
        if (BIAS) x += (e < 2 ? gate0 : gate1) * pbv[j][e];
        s[j][e] = ragged && key >= nv ? NEG : x;
      }
    }

    // Online softmax over this tile: a row's 64 logits lie in the four
    // lanes of a quad.
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * LOG2E), alpha1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
    unsigned pa[BK / 16][4];  // P as the A fragments of the p.v product
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f((s[j][0] - mn0) * LOG2E), p1 = exp2f((s[j][1] - mn0) * LOG2E);
      const float p2 = exp2f((s[j][2] - mn1) * LOG2E), p3 = exp2f((s[j][3] - mn1) * LOG2E);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V: V rows are keys, read transposed; one ldmatrix.x4.trans
    // gives the B fragments of two n8 tiles (dims) of one k16 step (keys).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH + 8 * j +
                                  8 * (lane >> 4));
        mma_bf16(o[j], pa[kk], vb[0], vb[1]);
        mma_bf16(o[j + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // The quad's row sums, then the output straight from registers.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < T)
      *reinterpret_cast<unsigned*>(oh + r0 * ost + 8 * j + 2 * c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<unsigned*>(oh + r1 * ost + 8 * j + 2 * c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// Grid (query tiles, H / G, B); each CTA serves G consecutive heads of one
// batch element in turn (G = 1 outside the grouped form).
template <bool BIAS>
__global__ void __launch_bounds__(THREADS, BIAS ? 2 : 4)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, Strides sq,
                 const __nv_bfloat16* __restrict__ k, Strides sk,
                 const __nv_bfloat16* __restrict__ v, Strides sv,
                 const int* __restrict__ n_valid,
                 const float* __restrict__ pb, const float* __restrict__ gate, Strides sg,
                 __nv_bfloat16* __restrict__ out, Strides so, int T, int G) {
  // The Q tile and two (K, V) stages: 46,080 bytes.
  __shared__ __align__(128) __nv_bfloat16 Qs[TILE];
  __shared__ __align__(128) __nv_bfloat16 KV[4 * TILE];

  const int b = blockIdx.z, h0 = blockIdx.y * G, q0 = blockIdx.x * BQ;
  const int nv = clamp_valid(n_valid, b, T);

  for (int hh = 0; hh < G; ++hh) {
    const int h = h0 + hh;
    __nv_bfloat16* oh = out + b * so.b + h * so.h;
    if (q0 >= nv) {  // fully padded query tile: exact zeros, no compute
      zero_tile_bf16(oh, q0, T, so.t);
      continue;
    }
    if (hh) __syncthreads();  // the previous head's readers of Qs are done
    attend_bf16<BIAS>(Qs, KV, q + b * sq.b + h * sq.h, sq.t, k + b * sk.b + h * sk.h,
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
