// Fused log-mel spectrogram (K3), hand-written for Hopper (sm_90a).
//
// Replaces fadtk_tpu/dsp/pallas_mel.py::fused_log_mel (the Pallas body
// _kernel). For frames x (N, W) of one clip, window-folded DFT bases
// dre, dim (W, F) and a mel matrix mel (F, M):
//
//   re = x dre,  im = x dim,  p = re^2 + im^2,  out = log_mode(p mel)
//
// with log_mode one of ln_offset (log(v + offset)), log10_clamp
// (log10(max(v, 1e-10)), Whisper) and db_clamp (10 log10(max(v, 1e-10)),
// CLAP), a template parameter. Everything is float32, with FMA on the CUDA
// cores: TF32 tensor cores would keep ~3 digits and break the frontend's
// float32 parity contract.
//
// Frames are read in place from a strided view: element (b, n, w) is
// frames[b * bs + n * fs + w]. For Whisper that is the reflect-padded
// signal itself (fs = hop = 160, bs = 480400), so the (N, W) frame tensor,
// 2.5x the signal, is never materialised; the Pallas contract, a contiguous
// (N, W) tensor, is fs = W. W, F and M are taken as they are (W = 400,
// F = 201, M = 80 for Whisper), not padded to lane multiples: ragged edges
// are masked with zeros on load.
//
// What bounds it. At Whisper's B = 16 (N = 48000 frames) the work is
// 2 N W 2F + 2 N F M = 16.98 GFLOP against ~46.8 MB of signal, bases and
// output: 363 FLOP per byte, far above the card's 20 for float32 on the CUDA
// cores (67 TFLOP/s against 3.35 TB/s), so the bound is the arithmetic,
// 0.253 ms. The (N, F) power spectrum (38.6 MB at Whisper's shape) is the
// traffic the Pallas kernel existed to save; here it never leaves the SM.
//
// Design (a simple form; wgmma-free, CUDA cores only): one block of 256
// threads per (64-frame tile, clip). A loop over frequency chunks of 64:
//
// 1. the DFT products for the tile and chunk, a (64 x W) . (W x 2*64)
//    product: 32-sample slices of the frames and of both bases are staged in
//    shared memory, and each thread keeps 4 frames x 4 frequencies of re
//    and of im in registers. The slices are double-buffered: cp.async copies
//    slice s+1 (zero-filling past N, W and F) while slice s is multiplied,
//    so the L2 latency of the staging overlaps the FMAs;
// 2. the power, re^2 + im^2, goes to shared memory (64 x 64), beside the
//    chunk's 64 mel rows;
// 3. the mel product accumulates into a (64 x M) register tile, 4 frames x
//    ceil(M/16) mel columns per thread, across all chunks.
//
// After the last chunk each thread applies the log and writes its values
// once. Bases (707 KB at Whisper's shape) are read by every block through
// L2; frames are re-read once per frequency chunk, from L2.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int TN = 64;      // frames per block
constexpr int FC = 64;      // frequencies per chunk
constexpr int KC = 32;      // window samples per staged slice
constexpr int PS = FC + 4;  // power row stride in floats (rows stay 16-byte aligned)
constexpr int SLICE = TN * KC + 2 * KC * FC;  // one staged slice: frames, dre, dim

template <int MODE>
__device__ __forceinline__ float log_epilogue(float v, float offset) {
  if (MODE == 0) return logf(v + offset);
  if (MODE == 1) return log10f(fmaxf(v, 1e-10f));
  return 10.f * log10f(fmaxf(v, 1e-10f));
}

// 4-byte asynchronous copy global -> shared; copies zeros when !ok (src is
// then only a valid address, not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <int MPT>
constexpr size_t smem_bytes() {
  // two staged slices, power tile, mel rows
  return sizeof(float) * (size_t)(2 * SLICE + TN * PS + FC * 16 * MPT);
}

template <int MODE, int MPT>
__global__ void __launch_bounds__(THREADS)
    fused_log_mel_kernel(const float* __restrict__ frames, long long bs, long long fs, int N,
                         int W, const float* __restrict__ dre, const float* __restrict__ dim,
                         int F, const float* __restrict__ mel, int M, float* __restrict__ out,
                         float offset) {
  constexpr int MP = 16 * MPT;  // mel columns held per block (>= M)
  extern __shared__ __align__(16) float smem[];
  // slice buffer b at smem + b * SLICE: TN x KC frames[n0 + r][k0 + k], then
  // KC x FC dre[k0 + k][f0 + f], then KC x FC dim[k0 + k][f0 + f]
  float* ps = smem + 2 * SLICE;  // TN x PS: power of the chunk
  float* ms = ps + TN * PS;      // FC x MP: mel[f0 + f][m]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TN;
  const float* fb = frames + (long long)blockIdx.y * bs;
  const int nk = (W + KC - 1) / KC;                 // slices per chunk
  const int total = nk * ((F + FC - 1) / FC);       // slices in all

  // Stage slice s (chunk s / nk, samples (s % nk) * KC ..) into buffer buf.
  auto stage = [&](int s, int buf) {
    const int f0 = (s / nk) * FC, k0 = (s % nk) * KC;
    float* as = smem + buf * SLICE;
    float* bre = as + TN * KC;
    float* bim = bre + KC * FC;
    for (int i = tid; i < TN * KC; i += THREADS) {
      const int r = i / KC, k = i % KC;
      const int n = n0 + r, smp = k0 + k;
      const bool ok = n < N && smp < W;
      cp_async4(as + i, ok ? fb + (long long)n * fs + smp : fb, ok);
    }
    for (int i = tid; i < KC * FC; i += THREADS) {
      const int k = i / FC, f = i % FC;
      const int smp = k0 + k, fr = f0 + f;
      const bool ok = smp < W && fr < F;
      const size_t off = ok ? (size_t)smp * F + fr : 0;
      cp_async4(bre + i, dre + off, ok);
      cp_async4(bim + i, dim + off, ok);
    }
    cp_async_commit();
  };

  float acc[4][MPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < MPT; ++j) acc[r][j] = 0.f;
  float re[4][4], im[4][4];

  stage(0, 0);
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) {
      stage(s + 1, (s + 1) & 1);  // its buffer was last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (s & 1) * SLICE;
    const float* bre = as + TN * KC;
    const float* bim = bre + KC * FC;
    const int kslice = s % nk;

    // 1. re, im for frames 4ty..4ty+3 and frequencies f0 + 4tx..4tx+3.
    if (kslice == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) re[r][c] = im[r][c] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(as + (4 * ty + r) * KC + kk);
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 br = *reinterpret_cast<const float4*>(bre + (kk + k) * FC + 4 * tx);
        const float4 bi = *reinterpret_cast<const float4*>(bim + (kk + k) * FC + 4 * tx);
        const float brv[4] = {br.x, br.y, br.z, br.w};
        const float biv[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            re[r][c] = fmaf(a[r][k], brv[c], re[r][c]);
            im[r][c] = fmaf(a[r][k], biv[c], im[r][c]);
          }
      }
    }

    if (kslice == nk - 1) {
      // 2. The power to shared memory (columns past F are zeros: their bases
      //    were), and the chunk's mel rows (zeros past F and past M).
      const int f0 = (s / nk) * FC;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4 p;
        p.x = fmaf(re[r][0], re[r][0], im[r][0] * im[r][0]);
        p.y = fmaf(re[r][1], re[r][1], im[r][1] * im[r][1]);
        p.z = fmaf(re[r][2], re[r][2], im[r][2] * im[r][2]);
        p.w = fmaf(re[r][3], re[r][3], im[r][3] * im[r][3]);
        *reinterpret_cast<float4*>(ps + (4 * ty + r) * PS + 4 * tx) = p;
      }
      for (int i = tid; i < FC * MP; i += THREADS) {
        const int f = i / MP, m = i % MP;
        const int fr = f0 + f;
        ms[i] = (fr < F && m < M) ? __ldg(mel + (size_t)fr * M + m) : 0.f;
      }
      __syncthreads();

      // 3. acc[r][j] += sum_f p[4ty + r][f] * mel[f0 + f][tx + 16 j].
#pragma unroll 4
      for (int f = 0; f < FC; ++f) {
        float p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = ps[(4 * ty + r) * PS + f];
#pragma unroll
        for (int j = 0; j < MPT; ++j) {
          const float mv = ms[f * MP + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], mv, acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)blockIdx.y * N * M;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + 4 * ty + r;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int m = tx + 16 * j;
      if (m < M) ob[(size_t)n * M + m] = log_epilogue<MODE>(acc[r][j], offset);
    }
  }
}

template <int MODE, int MPT>
cudaError_t launch(const float* frames, long long bs, long long fs, int B, int N, int W,
                   const float* dre, const float* dim, int F, const float* mel, int M, float* out,
                   float offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<MPT>();
  cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<MODE, MPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, B);
  fused_log_mel_kernel<MODE, MPT><<<grid, THREADS, smem, stream>>>(
      frames, bs, fs, N, W, dre, dim, F, mel, M, out, offset);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const float* frames, long long bs, long long fs, int B, int N, int W,
                     const float* dre, const float* dim, int F, const float* mel, int M,
                     float* out, float offset, cudaStream_t s) {
  // mel columns per thread: 4 (M <= 64: VGGish, CLAP), 5 (M <= 80: Whisper), 8
  if (M <= 64) return launch<MODE, 4>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
  if (M <= 80) return launch<MODE, 5>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
  return launch<MODE, 8>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
}

}  // namespace

// frames: float32, element (b, n, w) at frames[b * bs + n * fs + w];
// dre, dim (W, F), mel (F, M) contiguous float32; out (B, N, M) contiguous
// float32. mode: 0 ln_offset, 1 log10_clamp, 2 db_clamp. 1 <= M <= 128,
// 1 <= B <= 65535. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch.
extern "C" int fadtk_fused_log_mel(const float* frames, long long bs, long long fs, int B, int N,
                                   int W, const float* dre, const float* dim, int F,
                                   const float* mel, int M, float* out, int mode, float offset,
                                   void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || W <= 0 || F <= 0 || M <= 0 || M > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)dispatch<0>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
    case 1: return (int)dispatch<1>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
    case 2: return (int)dispatch<2>(frames, bs, fs, B, N, W, dre, dim, F, mel, M, out, offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
