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
// bias is added, as the Pallas kernel does). The wrapper hands the weights in
// float32 and pre-transposed so that output channels are contiguous:
// w1t (C, 3, Ch), w2t (Ch, C), wsct (C, C); biases float32.
//
// What bounds it. Each time column costs 6 C^2 FLOP (3 C^2 for the k=3 conv,
// C^2 for the k=1 conv, 2 C^2 for the shortcut) against 2 C item bytes of x
// and out: 3 C / item FLOP per byte, 24-192 in float32 at the four call
// sites of one 24 kHz forward (C = 32..256). On the CUDA cores (67 TFLOP/s
// against 3.35 TB/s, 20 FLOP per byte) that is bound by arithmetic. In bf16
// (48-384 FLOP per byte) the card's bound is the bytes, but only on tensor
// cores (989 TFLOP/s); this first form does float32 FMA on the CUDA cores in
// both dtypes, so it stays bound by its arithmetic: TF32 tensor cores would
// keep ~3 digits and break the float32 parity contract, and bf16 tensor
// cores (wmma/wgmma) are later work.
//
// Design: one block of 256 threads per (time tile, batch element); a tile is
// TT = 8192 / C columns, so every width gives the same thread tiles and
// 80-86 KB of dynamic shared memory (two blocks per SM):
//
// 1. x and elu(x) for the tile plus the 2-column left halo are staged in
//    shared memory as float32 (the halo is read from the previous tile's
//    columns in global memory, reflected at t = 0; columns at or past T are
//    zeros and feed only columns that are not stored: the ragged edge);
// 2. h = the k=3 conv as a (Ch x 3C) . (3C x TT) product, each thread a 4x4
//    register tile; the three taps are three shifts of one 6-column read;
//    elu(h + b1) goes to shared memory;
// 3. the k=1 conv and the shortcut as two (C x K) . (K x TT) products into two
//    8x4 register tiles, summed with their biases and written once.
//
// Weights are read through L1/L2 with 16-byte loads (all blocks read the same
// ones: 12 KB at C = 32, 768 KB at C = 256). The Pallas kernel's VMEM tile
// (_tile_len, ~1.5 MB per buffer) was not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 8192;  // C * TT for every width

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ __forceinline__ static float load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

template <int C>
constexpr size_t smem_bytes() {
  // x (C x TT) + elu(x) (C x (TT + 4)) + h (C/2 x TT), float32
  return sizeof(float) * (size_t)(C * (COLS / C) + C * (COLS / C + 4) + (C / 2) * (COLS / C));
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, 2)
    fused_resnet_kernel(const T* __restrict__ x, const float* __restrict__ w1t,
                        const float* __restrict__ b1, const float* __restrict__ w2t,
                        const float* __restrict__ b2, const float* __restrict__ wsct,
                        const float* __restrict__ bsc, T* __restrict__ out, int len) {
  constexpr int CH = C / 2;
  constexpr int TT = COLS / C;  // time columns per block
  constexpr int EW = TT + 4;    // elu row: 2 halo + TT columns, padded to 16 bytes
  constexpr int NT = TT / 4;    // threads along time in both products
  static_assert(NT * (CH / 4) == THREADS && NT * (C / 8) == THREADS, "thread tiling");

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;         // C x TT: x[:, t_base + t]
  float* es = xs + C * TT;  // C x EW: column p holds elu(x)[:, t_base - 2 + p]
  float* hs = es + C * EW;  // CH x TT: elu(conv1 + b1)

  const int t_base = blockIdx.x * TT;
  const T* xb = x + (size_t)blockIdx.y * C * len;
  T* ob = out + (size_t)blockIdx.y * C * len;

  // 1. Stage x and elu(x), with the reflected left edge at t = 0 (len >= 3).
  for (int i = threadIdx.x; i < C * (TT + 2); i += THREADS) {
    const int c = i / (TT + 2), p = i - c * (TT + 2);
    const int t = t_base - 2 + p;
    const int src = t < 0 ? -t : t;
    const float v = src < len ? Io<T>::load(xb + (size_t)c * len + src) : 0.f;
    es[c * EW + p] = Io<T>::round(elu(v));
    if (p >= 2) xs[c * TT + p - 2] = v;
  }
  __syncthreads();

  const int tx = threadIdx.x % NT, ty = threadIdx.x / NT;
  const int t0 = 4 * tx;

  // 2. h[h0 .. h0+3][t0 .. t0+3]: taps k = 0, 1, 2 read e columns t + k.
  {
    const int h0 = 4 * ty;
    float acc[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 ea = *reinterpret_cast<const float4*>(es + c * EW + t0);
      const float2 eb = *reinterpret_cast<const float2*>(es + c * EW + t0 + 4);
      const float e[6] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(w1t + (c * 3 + k) * CH + h0));
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], e[j + k], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bias = __ldg(b1 + h0 + i);
      float4 hv;
      hv.x = Io<T>::round(elu(Io<T>::round(Io<T>::round(acc[i][0]) + bias)));
      hv.y = Io<T>::round(elu(Io<T>::round(Io<T>::round(acc[i][1]) + bias)));
      hv.z = Io<T>::round(elu(Io<T>::round(Io<T>::round(acc[i][2]) + bias)));
      hv.w = Io<T>::round(elu(Io<T>::round(Io<T>::round(acc[i][3]) + bias)));
      *reinterpret_cast<float4*>(hs + (h0 + i) * TT + t0) = hv;
    }
  }
  __syncthreads();

  // 3. out[c0 .. c0+7][t0 .. t0+3] = shortcut + k=1 conv of h.
  {
    const int c0 = 8 * ty;
    float z[8][4] = {}, sc[8][4] = {};
#pragma unroll 4
    for (int k = 0; k < CH; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(hs + k * TT + t0);
      const float4 wa = __ldg(reinterpret_cast<const float4*>(w2t + k * C + c0));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(w2t + k * C + c0 + 4));
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(wv[i], vv[j], z[i][j]);
    }
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(xs + k * TT + t0);
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wsct + k * C + c0));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wsct + k * C + c0 + 4));
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(wv[i], vv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      const float bz = __ldg(b2 + c), bs = __ldg(bsc + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t_base + t0 + j;
        if (t < len) {
          const float zz = Io<T>::round(Io<T>::round(z[i][j]) + bz);
          const float ss = Io<T>::round(Io<T>::round(sc[i][j]) + bs);
          Io<T>::store(ob + (size_t)c * len + t, ss + zz);
        }
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const float* w1t, const float* b1, const float* w2t,
                   const float* b2, const float* wsct, const float* bsc, void* out, int B,
                   int len, cudaStream_t stream) {
  constexpr int TT = COLS / C;
  constexpr size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(fused_resnet_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((len + TT - 1) / TT, B);
  fused_resnet_kernel<T, C><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w1t, b1, w2t, b2, wsct, bsc, static_cast<T*>(out), len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* w1t, const float* b1, const float* w2t,
                     const float* b2, const float* wsct, const float* bsc, void* out, int B,
                     int C, int len, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, len, s);
    case 64: return launch<T, 64>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, len, s);
    case 128: return launch<T, 128>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, len, s);
    case 256: return launch<T, 256>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, len, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) row-major in the dtype (0 float32, 1 bfloat16); weights
// and biases float32 as described at the top. C in {32, 64, 128, 256}, T >= 3.
// Launches on `stream`, does not synchronise; returns the cudaError_t of the
// launch.
extern "C" int fadtk_fused_resnet_causal(const void* x, const float* w1t, const float* b1,
                                         const float* w2t, const float* b2, const float* wsct,
                                         const float* bsc, void* out, int B, int C, int T,
                                         int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, C, T, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, w1t, b1, w2t, b2, wsct, bsc, out, B, C, T, s);
  return (int)cudaErrorInvalidValue;
}
