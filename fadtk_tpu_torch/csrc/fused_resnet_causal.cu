// Fused SEANet residual block of EnCodec's 24 kHz encoder, hand-written for
// Hopper (sm_90a).
//
// Replaces fadtk_tpu/ops/fused_resnet.py::fused_resnet_causal (the Pallas body
// _kernel). For x (B, C, T) and Ch = C / 2:
//
//   e   = elu(x), reflected on the left by two columns: [e2, e1, e0, e1, ...]
//   h   = elu(round(round(w1 (*) e) + b1))          w1 (Ch, C, 3), causal k=3
//   out = round(round(round(wsc x) + bsc) + round(round(w2 h) + b2))
//
// with every product accumulated in float32 and round() the cast to the input
// dtype (the identity in float32; in bf16 each product is rounded before its
// bias is added, as the Pallas kernel does). Two forms, two entry points,
// both on the tensor cores: float32 as 3xTF32 products, bf16 as bf16
// products. The wrapper prepares each weight set's layout once and caches it:
// the weights packed in the fragment order of the form's mma.sync (float32:
// split into TF32 hi and lo parts); biases float32.
//
// What bounds it. Each time column costs 6 C^2 FLOP (3 C^2 for the k=3 conv,
// C^2 for the k=1 conv, 2 C^2 for the shortcut) against 2 C item bytes of x
// and out: 3 C / item FLOP per byte, 24-192 in float32 at the four call
// sites of one 24 kHz forward (C = 32..256). On the CUDA cores (67 TFLOP/s
// against 3.35 TB/s, 20 FLOP per byte) that is bound by arithmetic at every
// site. The float32 form therefore runs on the tensor cores as 3xTF32: three
// TF32 products of error-compensated operands (below) keep about 22 of
// float32's 24 significand bits, where one TF32 product would keep 11, and
// cost 3 x 2 C^2 FLOP a column at 495 TFLOP/s: the bound is the bytes at C <=
// 64 and the three products at C >= 128. In bf16 (48-384 FLOP per byte) the
// card's bound is the bytes, on the tensor cores (989 TFLOP/s). Both forms
// are persistent and overlap the next tile's copy with this tile's products;
// what remains above the bound is the ELU of x (expm1), the on-chip split of
// the A operands and the tensor cores' issue rate. The Pallas kernel's VMEM
// tile (_tile_len, ~1.5 MB per buffer) was not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "tf32.cuh"

namespace {

// elu for the float32 form: expm1 as its Taylor polynomial of degree 5 on
// (-1/16, 0] (truncation < 1.4e-9 relative) and as __expf - 1 below, where
// |expm1| > 0.06 and __expf's error (2 ulp of e^v, plus the rounding of
// v log2 e) stays under 3e-7 of the result: a few float32 ulps, far inside the
// block's bound, at a fraction of expm1f's cost.
__device__ __forceinline__ float elu(float v) {
  if (v > 0.f) return v;
  if (v <= -0.0625f) return __expf(v) - 1.f;
  const float p = fmaf(fmaf(fmaf(1.f / 120, v, 1.f / 24), v, 1.f / 6), v, 0.5f);
  return fmaf(p * v, v, v);
}

// 16-byte asynchronous copy global -> shared of `bytes` (0..16) bytes, the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// CTAs the card holds at once for `kernel`, found once per device (a
// host-bound forward makes four launches): `device` and `ctas` are the
// caller's cache.
template <typename K>
cudaError_t resident_ctas(K kernel, int threads, size_t smem, int& device, int& ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == device) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  ctas = sms * std::max(per_sm, 1);
  device = dev;
  return cudaSuccess;
}

// --------------------------------------------------------------------------
// The float32 form: 3xTF32 on the tensor cores.
//
// Each product is mma.sync.m16n8k8 with TF32 operands and float32
// accumulation, taken three times: a_lo.b_hi + a_hi.b_lo, then a_hi.b_hi,
// into one accumulator, where v_hi = tf32(v) (cvt.rna: 10 explicit mantissa
// bits, rounded to nearest) and v_lo = tf32(v - v_hi). The dropped a_lo.b_lo
// term and the rounding of the two lo parts leave each product within ~2^-21
// of its float32 value, where one TF32 product would keep 2^-11. Time is the
// M dimension, as in the bf16 form:
//
//   hT (TT x Ch) = eT (TT x 3C) . w1T     (three taps: three row shifts)
//   outT (TT x C) = xT (TT x C) . wscT + hT (TT x Ch) . w2T
//
// A operands are read from shared memory where they lie channel-major (row
// c, times contiguous, row stride = 8 or 24 mod 32 words, so the fragment's
// 32 scalar loads hit 32 banks): x as copied, elu(x) and h as computed. A tap
// is a shift of the row offset, so the k=3 conv needs no im2col. elu(x),
// which the k=3 conv reads 3 Ch / 16 times, is split into hi and lo once, as
// it is staged; x and h, read C / 32 times, are split where they are read. B
// operands are the weights, split and packed once per weight set by the
// wrapper into the m16n8k8 fragment order, (N/8, K/8, 32 lanes, {hi, hi, lo,
// lo}): one 16-byte load per lane, n8 tile and k8 step, through L1 and L2
// (every CTA reads the same ones; the load feeds 3 x MI products). The next
// k8 step's operands are loaded while this one multiplies.
//
// Persistent CTAs (as many as fit on the card) walk the (batch, TT-column)
// tiles, and the next tile's x is copied with cp.async (16 bytes, zero-filled
// past T) into a second buffer while this tile is multiplied. Per tile:
//
// 1. es = elu(x) for the tile and its 2-column reflected left halo, from the
//    copy of x (which holds the 4 columns before the tile), 16 bytes a
//    thread, stored as its hi and lo parts;
// 2. h = elu(conv1 + b1) into shared memory, channel-major;
// 3. out = (wsc x + w2 h) + bsc + b2 into a channel-major tile over es (in
//    float32 the kernel's rounding points are the identity);
// 4. the tile is written out, 16 bytes at a time.
//
// The card's latency is hidden by CTAs in flight, so tiles are short: TT =
// 64, 32, 16 columns at C = 32, 64, 128 (41-55 KB of shared memory and 4
// warps; four CTAs per SM at C <= 64, three at C = 128, whose registers
// need more than 128), a warp item 16 rows by 16 (h) or 32 (out; 16 at C =
// 32, which keeps it within 128 registers) columns; at C = 256, TT = 32 (184
// KB, 8 warps, one CTA per SM) and items of 32 rows.
// --------------------------------------------------------------------------

// tf32_rna, split and mma_tf32: tf32.cuh.

template <int C>
struct F32Shape {
  static constexpr int CH = C / 2;
  static constexpr int TT = C == 32 ? 64 : C == 128 ? 16 : 32;  // time columns per tile
  static constexpr int WARPS = C == 256 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MI = C == 256 ? 2 : 1;  // m16 tiles per item
  static constexpr int NT1 = 2;   // n8 tiles per h item
  static constexpr int NTO = C == 32 ? 2 : 4;  // n8 tiles per output item
  static constexpr int MIN_CTAS = C == 256 ? 1 : C == 128 ? 3 : 4;  // per SM
  static constexpr int LD = TT + 8;  // row stride of every tile: 8 or 24 mod 32 words
  // raw[2][C][LD]: x[c][t_base - 4 + col]; es[2][C][LD]: elu(x) at the same
  // columns as TF32 hi and lo parts, later (hi) the output tile;
  // hs[CH][LD]: h[n][t_base + t].
  static constexpr int ELEMS = (4 * C + CH) * LD;
  static constexpr size_t SMEM = sizeof(float) * (size_t)ELEMS;
  static_assert(LD % 32 == 8 || LD % 32 == 24, "fragment loads need 32 distinct banks");
};

// acc[mi][ni] += A(row0 + 16 mi + (0..15), k) . W(k, n8 tile nt0 + ni) over
// the k8 steps kt < nk, in 3xTF32. A is channel-major in shared memory:
// element (t, k) at A[k * LD + t]; W is packed (N/8, KT, 32, 4) and the steps
// start at its k8 tile kt0. With SPLIT, A holds TF32 hi parts and its lo
// parts lie LO floats further on; without, each A value is split here. The
// next step's A values and B fragments are loaded while this step
// multiplies.
template <int MI, int NT, int LD, bool SPLIT = false, int LO = 0>
__device__ __forceinline__ void warp_mma_3xtf32(float (&acc)[MI][NT][4], const float* A, int row0,
                                                const float4* __restrict__ P, int KT, int kt0,
                                                int nk, int nt0, int lane) {
  // Fragment a: (row g, k c), (g + 8, c), (g, c + 4), (g + 8, c + 4).
  const float* base = A + (lane & 3) * LD + row0 + (lane >> 2);
  const float4* pw = P + ((size_t)nt0 * KT + kt0) * 32 + lane;
  float va[MI][4], vl[MI][4];
  float4 vb[NT];  // {hi, hi, lo, lo}
  auto load = [&](int kt) {
    const float* ak = base + 8 * kt * LD;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int off[4] = {16 * mi, 16 * mi + 8, 4 * LD + 16 * mi, 4 * LD + 16 * mi + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        va[mi][e] = ak[off[e]];
        if (SPLIT) vl[mi][e] = ak[LO + off[e]];
      }
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) vb[ni] = __ldg(pw + ((size_t)ni * KT + kt) * 32);
  };
  load(0);
#pragma unroll 2
  for (int kt = 0; kt < nk; ++kt) {
    unsigned ahi[MI][4], alo[MI][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (SPLIT) {
          ahi[mi][e] = __float_as_uint(va[mi][e]);
          alo[mi][e] = __float_as_uint(vl[mi][e]);
        } else {
          ahi[mi][e] = tf32_rna(va[mi][e]);
          alo[mi][e] = tf32_rna(va[mi][e] - __uint_as_float(ahi[mi][e]));
        }
      }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      bh[ni][0] = __float_as_uint(vb[ni].x);
      bh[ni][1] = __float_as_uint(vb[ni].y);
      bl[ni][0] = __float_as_uint(vb[ni].z);
      bl[ni][1] = __float_as_uint(vb[ni].w);
    }
    if (kt + 1 < nk) load(kt + 1);
    // Each accumulator takes the small terms first, then the big one; the
    // three passes over all (mi, ni) keep MI * NT independent products
    // between two that depend on each other.
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[mi][ni], alo[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[mi][ni], ahi[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[mi][ni], ahi[mi], bh[ni][0], bh[ni][1]);
  }
}

template <int MI, int NT>
__device__ __forceinline__ void zero(float (&acc)[MI][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

template <int C>
__global__ void __launch_bounds__(F32Shape<C>::THREADS, F32Shape<C>::MIN_CTAS)
    fused_resnet_f32_kernel(const float* __restrict__ x, const float4* __restrict__ p1,
                            const float* __restrict__ b1, const float4* __restrict__ p2,
                            const float* __restrict__ b2, const float4* __restrict__ psc,
                            const float* __restrict__ bsc, float* __restrict__ out, int len,
                            int ntiles) {
  using S = F32Shape<C>;
  constexpr int CH = S::CH, TT = S::TT, LD = S::LD, MI = S::MI, NTH = S::THREADS;
  extern __shared__ __align__(16) float fsm[];
  float* raw = fsm;             // [2][C][LD]
  float* es = raw + 2 * C * LD;  // [2][C][LD]: hi, lo; then the output tile
  float* hs = es + 2 * C * LD;   // [CH][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int ntb = (len + TT - 1) / TT;  // tiles per batch row
  const bool vec = len % 4 == 0;        // 16-byte rows: cp.async; else plain loads

  // Tile `tile`'s x (and the 4 columns before it) into raw buffer `buf`.
  auto fetch = [&](int tile, int buf) {
    const int b = tile / ntb, t_base = (tile % ntb) * TT;
    const float* xb = x + (size_t)b * C * len;
    float* r = raw + buf * C * LD;
    constexpr int PIECES = (TT + 4) / 4;
    for (int i = tid; i < C * PIECES; i += NTH) {
      const int c = i / PIECES, k = i % PIECES;
      const int t = t_base - 4 + 4 * k;
      if (vec) {
        const int bytes = t < 0 ? 0 : 4 * max(0, min(4, len - t));
        cp_async16(r + c * LD + 4 * k, bytes ? xb + (size_t)c * len + t : xb, bytes);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tj = t + j;
          r[c * LD + 4 * k + j] = tj >= 0 && tj < len ? xb[(size_t)c * len + tj] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  int buf = 0;
  if (blockIdx.x < ntiles) fetch(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / ntb, t_base = (tile % ntb) * TT;
    cp_async_wait_all();
    __syncthreads();  // raw[buf] landed; the last tile's output is written

    // 1. es = elu(x) split into TF32 hi and lo parts (the k=3 conv reads
    //    each value 3 * CH / 16 times), 16 bytes a thread, column for
    //    column; reflected at t = 0 (len >= 3): times -2, -1 (columns 2, 3)
    //    take x[2], x[1] (columns 6, 5). Columns 0 and 1 are never read.
    const float* r = raw + buf * C * LD;
    {
      constexpr int Q = (TT + 4) / 4, N = C * Q;  // float4 per row, in all
#pragma unroll 2
      for (int i = tid; i < N; i += NTH) {
        const int c = i / Q, k = i - c * Q;
        const float4 v = *reinterpret_cast<const float4*>(r + c * LD + 4 * k);
        float4 e = make_float4(elu(v.x), elu(v.y), elu(v.z), elu(v.w));
        if (k == 0 && t_base == 0) {
          e.z = elu(r[c * LD + 6]);
          e.w = elu(r[c * LD + 5]);
        }
        float4 hi, lo;
        split(e.x, hi.x, lo.x);
        split(e.y, hi.y, lo.y);
        split(e.z, hi.z, lo.z);
        split(e.w, hi.w, lo.w);
        *reinterpret_cast<float4*>(es + c * LD + 4 * k) = hi;
        *reinterpret_cast<float4*>(es + C * LD + c * LD + 4 * k) = lo;
      }
    }
    if (tile + (int)gridDim.x < ntiles) fetch(tile + gridDim.x, buf ^ 1);
    __syncthreads();

    // 2. h items: (32 rows, NT1 n8 tiles of h).
    {
      constexpr int NT = S::NT1, NCH = CH / (8 * NT), ITEMS = (TT / (16 * MI)) * NCH;
      for (int it = warp; it < ITEMS; it += S::WARPS) {
        const int row0 = 16 * MI * (it / NCH), nt0 = (it % NCH) * NT;
        float acc[MI][NT][4];
        zero(acc);
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
          warp_mma_3xtf32<MI, NT, LD, true, C * LD>(acc, es + 2 + tap, row0, p1, 3 * C / 8,
                                                    tap * (C / 8), C / 8, nt0, lane);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int n = 8 * (nt0 + ni) + 2 * q;
          const float c0 = __ldg(b1 + n), c1 = __ldg(b1 + n + 1);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const int t = row0 + 16 * mi + g;
            hs[n * LD + t] = elu(acc[mi][ni][0] + c0);
            hs[(n + 1) * LD + t] = elu(acc[mi][ni][1] + c1);
            hs[n * LD + t + 8] = elu(acc[mi][ni][2] + c0);
            hs[(n + 1) * LD + t + 8] = elu(acc[mi][ni][3] + c1);
          }
        }
      }
    }
    __syncthreads();

    // 3. Output items: (32 rows, NTO n8 tiles of out), into es's space.
    float* os = es;
    {
      constexpr int NT = S::NTO, NCH = C / (8 * NT), ITEMS = (TT / (16 * MI)) * NCH;
      for (int it = warp; it < ITEMS; it += S::WARPS) {
        const int row0 = 16 * MI * (it / NCH), nt0 = (it % NCH) * NT;
        float acc[MI][NT][4];
        zero(acc);
        warp_mma_3xtf32<MI, NT, LD>(acc, r + 4, row0, psc, C / 8, 0, C / 8, nt0, lane);
        warp_mma_3xtf32<MI, NT, LD>(acc, hs, row0, p2, CH / 8, 0, CH / 8, nt0, lane);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int n = 8 * (nt0 + ni) + 2 * q;
          const float s0 = __ldg(bsc + n), s1 = __ldg(bsc + n + 1);
          const float z0 = __ldg(b2 + n), z1 = __ldg(b2 + n + 1);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const int t = row0 + 16 * mi + g;
            os[n * LD + t] = acc[mi][ni][0] + s0 + z0;
            os[(n + 1) * LD + t] = acc[mi][ni][1] + s1 + z1;
            os[n * LD + t + 8] = acc[mi][ni][2] + s0 + z0;
            os[(n + 1) * LD + t + 8] = acc[mi][ni][3] + s1 + z1;
          }
        }
      }
    }
    __syncthreads();

    // 4. The tile out, 4 columns of a channel at a time.
    float* ob = out + (size_t)b * C * len;
    for (int i = tid; i < C * (TT / 4); i += NTH) {
      const int c = i / (TT / 4), k = i % (TT / 4);
      const int t = t_base + 4 * k;
      if (t >= len) continue;
      const float* src = os + c * LD + 4 * k;
      if (vec && t + 4 <= len) {
        *reinterpret_cast<float4*>(ob + (size_t)c * len + t) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int j = 0; j < 4 && t + j < len; ++j) ob[(size_t)c * len + t + j] = src[j];
      }
    }
  }
  cp_async_wait_all();
}

template <int C>
cudaError_t launch_f32(const void* x, const void* p1, const float* b1, const void* p2,
                       const float* b2, const void* psc, const float* bsc, void* out, int B,
                       int len, cudaStream_t stream) {
  using S = F32Shape<C>;
  const auto kernel = fused_resnet_f32_kernel<C>;
  static int cached_device = -1, cached_ctas = 0;
  cudaError_t err = resident_ctas(kernel, S::THREADS, S::SMEM, cached_device, cached_ctas);
  if (err != cudaSuccess) return err;
  const long long ntiles = (long long)B * ((len + S::TT - 1) / S::TT);
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(ntiles, cached_ctas);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float4*>(p1), b1,
      static_cast<const float4*>(p2), b2, static_cast<const float4*>(psc), bsc,
      static_cast<float*>(out), len, (int)ntiles);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// The bf16 form on the tensor cores.
//
// The Pallas body multiplies bf16 by bf16 with f32 accumulation, which is
// what mma.sync.m16n8k16 (bf16 -> f32) computes. Time is the M dimension, so
// every width fills the instruction (Ch = 16 at C = 32 is two n8 tiles):
//
//   hT (TT x Ch)  = eT (TT x 3C) . w1T      (three taps: three row shifts)
//   scT (TT x C)  = xT (TT x C)  . wscT
//   zT (TT x C)   = hT (TT x Ch) . w2T
//
// A operands come from shared memory with ldmatrix: eT and hT time-major
// (channels contiguous, rows padded by 8 elements so the eight 16-byte rows
// of each 8x8 matrix fall in distinct bank groups; a tap is a shift of the
// row pointer, so the k = 3 conv needs no im2col), and x as it lies in
// memory, channel-major, through ldmatrix.trans. B operands are the weights
// in fragment order: the wrapper packs each weight once per weight set into
// (N/8, K/16, 32 lanes, 4) bf16, one 8-byte load per lane and fragment,
// through L1 and L2 (every CTA reads the same ones).
//
// At C = 32 and 64 the bound is the bytes of x and out, so the design keeps
// HBM busy: persistent CTAs (as many as fit on the card) walk the (batch,
// TT-column) tiles, and the next tile's x is copied with cp.async (16 bytes,
// zero-filled past T) into a second buffer while this tile is multiplied.
// Per tile:
//
// 1. eT = round(elu(x)) is built from the copy of x (with the 8 columns
//    before the tile) by transposing pairs of channels, with its 2-row
//    reflected halo on top;
// 2. h = round(elu(round(round(hT) + b1))) goes to shared memory by
//    stmatrix;
// 3. per output item, sc = round(round(scT) + bsc) stays in registers as
//    bf16 pairs, then z = round(round(zT) + b2), and round(sc + z) goes to a
//    (C x TT) tile over eT by stmatrix.trans; each "round(a + b)" of two
//    bf16 values is one add.rn.bf16x2;
// 4. the tile is written out, 16 bytes at a time.
//
// These are the Pallas rounding points: each is where an operand is bf16.
// TT = 256, 128, 64, 64 at C = 32, 64, 128, 256 (64-82 KB of shared memory
// and 4 warps: three CTAs per SM at C <= 64, two at C = 128; at C = 256,
// 162 KB and 8 warps, one). Each warp owns whole items of 64 rows by 16 or
// 32 columns.
// --------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

template <bool TRANS>
__device__ __forceinline__ void stmatrix_x4(__nv_bfloat16* p, unsigned r0, unsigned r1, unsigned r2,
                                            unsigned r3) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3));
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// elu for the bf16 form, whose result is rounded to bf16: expm1 as a
// degree-6 polynomial near 0 (truncation < 2e-8 relative at -0.25) and as
// exp - 1 below -0.25 (|expm1| >= 0.22 there, so __expf's few-ulp error is
// < 1e-6 relative), both far inside a bf16 ulp (3.9e-3) and cheaper than
// expm1f's range reduction.
__device__ __forceinline__ float elu_bf(float v) {
  if (v > 0.f) return v;
  const float p =
      v * (1.f + v * (0.5f + v * (1.f / 6 + v * (1.f / 24 + v * (1.f / 120 + v * (1.f / 720))))));
  return v > -0.25f ? p : __expf(v) - 1.f;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// round(round(a) + bias) for a pair of accumulators: one cvt.rn.bf16x2 and
// one add.rn.bf16x2 (the sum of two bf16 values rounded once, as a bf16 add
// rounds it).
__device__ __forceinline__ __nv_bfloat162 add_bias(float a0, float a1, __nv_bfloat162 bias) {
  return __hadd2(__float22bfloat162_rn(make_float2(a0, a1)), bias);
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int C>
struct TcShape {
  static constexpr int CH = C / 2;
  static constexpr int TT = C == 32 ? 256 : C == 64 ? 128 : 64;  // time columns per tile
  static constexpr int MB = TT / 64;                               // 64-row blocks per tile
  static constexpr int WARPS = C == 256 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NT1 = 2;                 // n8 tiles per h item
  static constexpr int NTO = C <= 64 ? 2 : 4;   // n8 tiles per output item
  static constexpr int MIN_CTAS = C <= 64 ? 3 : C == 128 ? 2 : 1;  // per SM
  static constexpr int LDR = TT + 8;            // raw x row: 8 columns before the tile, TT
  static constexpr int LDX = C + 8;             // eT row stride (elements)
  static constexpr int LDH = CH + 8;            // hT row stride
  static constexpr int LDO = TT + 8;            // output tile row stride
  static constexpr int E_ELEMS = (TT + 2) * LDX;
  static constexpr int O_ELEMS = C * LDO;
  static constexpr int R0 = E_ELEMS > O_ELEMS ? E_ELEMS : O_ELEMS;  // eT, later the out tile
  static constexpr int ELEMS = 2 * C * LDR + R0 + TT * LDH;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (size_t)ELEMS;
};

// acc[mi][ni] += A[row0 + 16 mi .., 16 kt ..] . P[n-tile nt0 + ni, k-tile kt0 + kt]
// for kt < nk; P has KT k16 tiles per n8 tile. A is time-major (row t, channels contiguous, stride lda),
// or with TRANS channel-major as x lies in memory (row c, times contiguous:
// element (t, k) at A[k * lda + t]), read with ldmatrix.trans.
template <int NT, bool TRANS = false>
__device__ __forceinline__ void warp_mma(float (&acc)[4][NT][4], const __nv_bfloat16* A, int lda,
                                         int row0, const uint2* __restrict__ P, int KT, int kt0, int nk,
                                         int nt0, int lane) {
  const __nv_bfloat16* arow =
      TRANS ? A + ((lane & 7) + 8 * (lane >> 4)) * lda + row0 + 8 * ((lane >> 3) & 1)
            : A + (row0 + (lane & 15)) * lda + 8 * (lane >> 4);
#pragma unroll 2
  for (int kt = 0; kt < nk; ++kt) {
    unsigned a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (TRANS)
        ldmatrix_x4_trans(a[mi], arow + 16 * kt * lda + 16 * mi);
      else
        ldmatrix_x4(a[mi], arow + 16 * mi * lda + 16 * kt);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const uint2 b = __ldg(P + ((size_t)(nt0 + ni) * KT + kt0 + kt) * 32 + lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(TcShape<C>::THREADS, TcShape<C>::MIN_CTAS)
    fused_resnet_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint2* __restrict__ p1,
                           const float* __restrict__ b1, const uint2* __restrict__ p2,
                           const float* __restrict__ b2, const uint2* __restrict__ psc,
                           const float* __restrict__ bsc, __nv_bfloat16* __restrict__ out,
                           int len, int ntiles) {
  using S = TcShape<C>;
  constexpr int CH = S::CH, TT = S::TT, LDR = S::LDR, LDX = S::LDX, LDH = S::LDH,
                LDO = S::LDO, NTH = S::THREADS;
  extern __shared__ __align__(16) __nv_bfloat16 tsm[];
  __nv_bfloat16* raw = tsm;               // [2][C][LDR]: x[c][t_base - 8 + col]
  __nv_bfloat16* es = raw + 2 * C * LDR;  // (TT + 2) x LDX: row p = elu(x) at t_base - 2 + p
  __nv_bfloat16* os = es;                 // C x LDO, over es once h is done
  __nv_bfloat16* hs = es + S::R0;         // TT x LDH

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane % 4;
  const int ntb = (len + TT - 1) / TT;    // tiles per batch row
  const bool vec = len % 8 == 0;          // 16-byte rows: cp.async; else plain loads

  const uint2 *w1 = p1, *w2 = p2, *wsc = psc;

  // Tile `tile`'s x (and the 8 columns before it) into raw buffer `buf`.
  auto fetch = [&](int tile, int buf) {
    const int b = tile / ntb, t_base = (tile % ntb) * TT;
    const __nv_bfloat16* xb = x + (size_t)b * C * len;
    __nv_bfloat16* r = raw + buf * C * LDR;
    constexpr int PIECES = LDR / 8;
    for (int i = tid; i < C * PIECES; i += NTH) {
      const int c = i / PIECES, k = i % PIECES;
      const int t = t_base - 8 + 8 * k;
      if (vec) {
        const int bytes = t < 0 ? 0 : 2 * max(0, min(8, len - t));
        cp_async16(r + c * LDR + 8 * k, bytes ? xb + (size_t)c * len + t : xb, bytes);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int tj = t + j;
          r[c * LDR + 8 * k + j] = tj >= 0 && tj < len ? xb[(size_t)c * len + tj]
                                                       : __float2bfloat16(0.f);
        }
      }
    }
    cp_async_commit();
  };

  int buf = 0;
  if (blockIdx.x < ntiles) fetch(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / ntb, t_base = (tile % ntb) * TT;
    cp_async_wait_all();
    __syncthreads();  // raw[buf] and the weights landed; the last tile's out is written

    // 1. eT from raw[buf]: 8 columns of a channel pair per item, neighbouring
    //    threads on neighbouring pairs (the pair stores of a warp then fill
    //    one or two rows of eT, not one bank).
    const __nv_bfloat16* r = raw + buf * C * LDR;
    {
      for (int i = tid; i < (C / 2) * (TT / 8); i += NTH) {
        const int c = 2 * (i % (C / 2)), k = i / (C / 2);
        const uint4 r0 = *reinterpret_cast<const uint4*>(r + c * LDR + 8 + 8 * k);
        const uint4 r1 = *reinterpret_cast<const uint4*>(r + (c + 1) * LDR + 8 + 8 * k);
        const __nv_bfloat16* h0 = reinterpret_cast<const __nv_bfloat16*>(&r0);
        const __nv_bfloat16* h1 = reinterpret_cast<const __nv_bfloat16*>(&r1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<unsigned*>(es + (8 * k + j + 2) * LDX + c) =
              pack_bf16(elu_bf(__bfloat162float(h0[j])), elu_bf(__bfloat162float(h1[j])));
        }
      }
      // The halo: columns t_base - 2 and t_base - 1, reflected at t = 0 (len >= 3).
      for (int i = tid; i < 2 * C; i += NTH) {
        const int c = i / 2, p = i % 2;
        const int col = t_base > 0 ? 6 + p : 8 + 2 - p;  // x[t_base - 2 + p], or x[2 - p]
        es[p * LDX + c] = __float2bfloat16(elu_bf(__bfloat162float(r[c * LDR + col])));
      }
    }
    if (tile + (int)gridDim.x < ntiles) fetch(tile + gridDim.x, buf ^ 1);
    __syncthreads();

    // 2. h items: (64-row block, NT1 n8 tiles of h).
    {
      constexpr int NT = S::NT1, NCH = CH / (8 * NT), ITEMS = S::MB * NCH;
      constexpr int KT = 3 * C / 16;
      for (int it = warp; it < ITEMS; it += S::WARPS) {
        const int row0 = 64 * (it / NCH), nt0 = (it % NCH) * NT;
        float acc[4][NT][4];
        zero(acc);
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
          warp_mma<NT>(acc, es, LDX, row0 + tap, w1, KT, tap * (C / 16), C / 16, nt0, lane);
        // h rows 16 mi + (0..15), columns 8 nt0 + (0..15): one stmatrix.x4
        // per mi; lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of
        // column block l >> 4.
        static_assert(NT == 2, "one x4 store covers two n8 tiles");
        __nv_bfloat162 bias[2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int o = 8 * (nt0 + ni) + 2 * q;
          bias[ni] = __floats2bfloat162_rn(__ldg(b1 + o), __ldg(b1 + o + 1));  // exact: bf16 values
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          unsigned reg[4];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 v = __bfloat1622float2(
                  add_bias(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1], bias[ni]));
              reg[2 * ni + hh] = pack_bf16(elu_bf(v.x), elu_bf(v.y));
            }
          stmatrix_x4<false>(hs + (row0 + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH +
                                 8 * nt0 + 8 * (lane >> 4),
                             reg[0], reg[1], reg[2], reg[3]);
        }
      }
    }
    __syncthreads();

    // 3. Output items: (64-row block, NTO n8 tiles of out).
    {
      constexpr int NTO = S::NTO, NCH = C / (8 * NTO), ITEMS = S::MB * NCH;
      for (int it = warp; it < ITEMS; it += S::WARPS) {
        const int row0 = 64 * (it / NCH), nt0 = (it % NCH) * NTO;
        float acc[4][NTO][4];
        __nv_bfloat162 sc[4][NTO][2];  // round(round(x . wsc) + bsc), row pairs g and g + 8
        zero(acc);
        warp_mma<NTO, true>(acc, r + 8, LDR, row0, wsc, C / 16, 0, C / 16, nt0, lane);
#pragma unroll
        for (int ni = 0; ni < NTO; ++ni) {
          const int c = 8 * (nt0 + ni) + 2 * q;
          const __nv_bfloat162 bias = __floats2bfloat162_rn(__ldg(bsc + c), __ldg(bsc + c + 1));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              sc[mi][ni][hh] = add_bias(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1], bias);
        }
        zero(acc);
        warp_mma<NTO>(acc, hs, LDH, row0, w2, CH / 16, 0, CH / 16, nt0, lane);
        // round(sc + z) into the (C x TT) tile, transposed by stmatrix.trans:
        // per (mi, pair of n8 tiles) one x4 store; lane l addresses channel
        // row (l & 7) of block l >> 4, at time 16 mi + 8 ((l >> 3) & 1).
        __nv_bfloat162 bz[NTO];
#pragma unroll
        for (int ni = 0; ni < NTO; ++ni) {
          const int c = 8 * (nt0 + ni) + 2 * q;
          bz[ni] = __floats2bfloat162_rn(__ldg(b2 + c), __ldg(b2 + c + 1));
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int np = 0; np < NTO / 2; ++np) {
            unsigned reg[4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int ni = 2 * np + u;
                const __nv_bfloat162 z =
                    add_bias(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1], bz[ni]);
                reg[2 * u + hh] = as_u32(__hadd2(sc[mi][ni][hh], z));
              }
            stmatrix_x4<true>(os + (8 * (nt0 + 2 * np) + (lane & 7) + 8 * (lane >> 4)) * LDO +
                                  row0 + 16 * mi + 8 * ((lane >> 3) & 1),
                              reg[0], reg[1], reg[2], reg[3]);
          }
      }
    }
    __syncthreads();

    // 4. The tile out, 8 columns of a channel at a time.
    __nv_bfloat16* ob = out + (size_t)b * C * len;
    for (int i = tid; i < C * (TT / 8); i += NTH) {
      const int c = i / (TT / 8), k = i % (TT / 8);
      const int t = t_base + 8 * k;
      if (t >= len) continue;
      const __nv_bfloat16* src = os + c * LDO + 8 * k;
      if (vec && t + 8 <= len) {
        *reinterpret_cast<uint4*>(ob + (size_t)c * len + t) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8 && t + j < len; ++j) ob[(size_t)c * len + t + j] = src[j];
      }
    }
  }
  cp_async_wait_all();
}

template <int C>
cudaError_t launch_tc(const void* x, const void* p1, const float* b1, const void* p2,
                      const float* b2, const void* psc, const float* bsc, void* out, int B,
                      int len, cudaStream_t stream) {
  using S = TcShape<C>;
  const auto kernel = fused_resnet_tc_kernel<C>;
  static int cached_device = -1, cached_ctas = 0;
  cudaError_t err = resident_ctas(kernel, S::THREADS, S::SMEM, cached_device, cached_ctas);
  if (err != cudaSuccess) return err;
  const long long ntiles = (long long)B * ((len + S::TT - 1) / S::TT);
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(ntiles, cached_ctas);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(p1), b1,
      static_cast<const uint2*>(p2), b2, static_cast<const uint2*>(psc), bsc,
      static_cast<__nv_bfloat16*>(out), len, (int)ntiles);
  return cudaGetLastError();
}

}  // namespace

// The float32 form (3xTF32). x, out: (B, C, T) row-major float32; p1, p2,
// psc: w1 (taps, channels as K), w2 and wsc split into TF32 hi and lo parts
// and packed in fragment order as (N/8, K/8, 32, {hi, hi, lo, lo}) float32
// (ops/fused_resnet.py::pack_tf32_fragments); biases float32. C in {32, 64,
// 128, 256}, T >= 3. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch.
extern "C" int fadtk_fused_resnet_causal(const void* x, const void* p1, const float* b1,
                                         const void* p2, const float* b2, const void* psc,
                                         const float* bsc, void* out, int B, int C, int T,
                                         void* stream) {
  if (B <= 0 || T < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)launch_f32<32>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 64: return (int)launch_f32<64>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 128: return (int)launch_f32<128>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 256: return (int)launch_f32<256>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 form on the tensor cores. x, out: (B, C, T) row-major bf16;
// p1, p2, psc: w1 (taps, channels as K), w2 and wsc packed in fragment order
// as (N/8, K/16, 32, 4) bf16 (ops/fused_resnet.py::pack_fragments); biases
// float32. C in {32, 64, 128, 256}, T >= 3. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int fadtk_fused_resnet_causal_bf16(const void* x, const void* p1, const float* b1,
                                              const void* p2, const float* b2, const void* psc,
                                              const float* bsc, void* out, int B, int C, int T,
                                              void* stream) {
  if (B <= 0 || T < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)launch_tc<32>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 64: return (int)launch_tc<64>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 128: return (int)launch_tc<128>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    case 256: return (int)launch_tc<256>(x, p1, b1, p2, b2, psc, bsc, out, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
