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
// CLAP), a template parameter. Everything is float32 on the CUDA cores: TF32
// tensor cores would keep ~3 digits and break the frontend's float32 parity
// contract.
//
// Frames are read in place from a strided view: element (b, n, w) is
// frames[b * bs + n * fs + w]. For Whisper that is the reflect-padded
// signal itself (fs = hop = 160, bs = 480400), so the (N, W) frame tensor,
// 2.5x the signal, is never materialised; the Pallas contract, a contiguous
// (N, W) tensor, is fs = W.
//
// Three bodies; the wrapper (ops/fused_log_mel.py) picks one per base
// tensor, in a layout it builds once and caches:
//
// * The FFT body (fused_log_mel_fft_kernel), where the bases are a windowed
//   real DFT of n_fft = 512 or 1024 points (CLAP: W = n_fft = 1024; VGGish:
//   a 400-sample window in a 512-point DFT). The layout is the window,
//   zero-padded to n_fft, the twiddles exp(-2 pi i j / n_fft) (float64 cast
//   to float32 once) and the union [klo, khi) of the mel bands.
//
//   What bounds it. A real FFT of n_fft points is a P = n_fft/2 point
//   complex FFT plus a split pass: ~28 kFLOP a frame at n_fft = 1024, 37x
//   less than the folded DFT product's 1.05 MFLOP. At CLAP-LAION's B = 32
//   (32 032 frames, hop 480) that is ~0.9 GFLOP (~14 us on the CUDA cores)
//   against 61.6 MB of padded signal and 8.2 MB of output (~21 us at
//   3.35 TB/s): bound by bytes. The chain it replaces (torch.stft -> |.|^2 ->
//   mel -> log) writes and reads a 131 MB complex spectrum; here no spectrum
//   and no (N, F) power leaves the SM.
//
//   Design: one block of 8 warps per (32-frame tile, clip), two blocks per
//   SM; each warp takes the tile's frames w, w + 8, ... in turn, one frame
//   at a time:
//   1. the warp reads the frame through the strided view as z[q] = x[2q] +
//      i x[2q+1] times the window, 8-byte loads where the C entry finds the
//      view 8-byte aligned (CLAP's frame strides are 1920 and 1280 bytes),
//      scalar loads otherwise; consecutive lanes read consecutive points,
//      and the frames of a block are consecutive frames of one clip, so
//      their overlapping samples come from L2;
//   2. a Stockham FFT of P points (radix 8, 8, 8 for P = 512; 8, 8, 4 for
//      256): each lane does P / (32 R) radix-R butterflies in registers per
//      stage, with the warp's P points in shared memory between stages
//      (re and im apart, one pad word per 32 so the strided writes of the
//      first stages do not collide); natural order in and out, so no
//      bit-reversal pass. The first stage butterflies the loaded points
//      straight from registers. Stage twiddles come from small per-stage
//      tables the block builds from the layout's table, never __sincosf;
//   3. the split pass X[k] = (Z[k] + conj Z[P-k])/2 + W^k (Z[k] - conj
//      Z[P-k])/2i and the power |X[k]|^2, over the band union only, into a
//      (bins x 32 frames) shared tile (odd row stride: conflict-free
//      writes across bins and reads across frames);
//   4. after a barrier, thread (frame, mel column) sums the column's band
//      rows, the mel value a warp-uniform load from the layout's packed
//      bands (each column's nonzero rows contiguous, ~2.5 KB for CLAP, so
//      they stay in L1 beside two blocks' shared memory, where the dense
//      (F, M) matrix's rows did not), takes the log and puts it in a (M x
//      32) tile that is stored once, coalesced.
//
// * The FMA bodies (fused_log_mel_kernel<MODE, FOLD>), for any other bases,
//   in a (2, Kp, Fp) layout: the re and im rows 0..K-1 with rows padded to
//   Kp = 16 k and columns to Fp = 128 c with zeros, so every copy of a slice
//   is 16 bytes, and the band [lo_m, hi_m) of nonzero rows of every mel
//   column.
//
//   The even/odd fold. Where the bases are those of a periodic window with
//   W = n_fft (Whisper W = 400), dre[W - n] = dre[n] and dim[W - n] =
//   -dim[n], so with h = W / 2
//
//     re = x[0] dre[0] + x[h] dre[h] + sum_{n=1}^{h-1} (x[n] + x[W-n]) dre[n]
//     im = x[0] dim[0] + x[h] dim[h] + sum_{n=1}^{h-1} (x[n] - x[W-n]) dim[n]
//
//   a product of depth K = h + 1 instead of W: half the DFT arithmetic.
//   Other bases run the unfolded template (K = W, one operand for both
//   products).
//
//   What bounds it. At Whisper's B = 16 (N = 48000 frames) the folded DFT is
//   2 N F W = 7.72 GFLOP and the banded mel product 2 N nnz(mel) = 0.04
//   GFLOP, against ~31 MB of signal, bases and output: bound by the
//   arithmetic of this formulation at the f32 rate (0.116 ms); a 400-point
//   FFT would be bound by bytes. The (N, F) power spectrum never leaves the
//   SM.
//
//   Design: one block of 256 threads per (128-frame tile, clip), one block
//   per SM (up to 255 registers a thread). A loop over frequency chunks of
//   128 columns, computing only the 32-column groups below F (224 of
//   Whisper's 201 columns, not 256); inside a chunk, a loop over slices of
//   16 folded samples, double-buffered, one barrier per slice:
//
//   1. each thread loads 8 frames' samples x[j], x[W - j] of the next slice
//      into registers and the next slice's 16 x 128 rows of both bases go
//      to shared memory by cp.async, while this slice is multiplied; then
//      the thread folds its samples into a = lo + hi, b = lo - hi
//      (frame-major);
//   2. each thread keeps 8 frames x 8 frequencies of re and of im in
//      registers (128 accumulators); per sample it reads its 8 a and 8 b
//      (four 16-byte loads, broadcast over the 16 threads of a frame group)
//      and four float2 of each base row: 12 shared loads for 128 FMAs;
//   3. after the chunk's last slice the power goes to shared memory (over
//      the slice buffers) and the chunk's part of the mel product is added
//      to a (M x 128) shared tile, each mel column over its band rows only;
//   4. after the last chunk, the log of the tile is written once.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int TN = 128;     // frames per block: 16 frame groups of 8
constexpr int FC = 128;     // frequency columns per chunk: 4 groups of 32
constexpr int KC = 16;      // folded samples per slice
constexpr int TNP = TN + 4;  // a / b / power row stride (rows stay 16-byte aligned)
constexpr int OS = TN + 1;   // mel tile row stride (conflict-free both ways)
// Shared memory, in floats: the folded a and b (2 buffers x KC x TNP each)
// and the base rows (2 buffers x re, im x KC x FC) of a slice, with the power
// of a chunk (FC x TNP) over them once the chunk's products are done; then
// the mel bands (2 x M ints) and the (M x OS) mel tile.
constexpr int AB = 2 * KC * TNP;   // folded a and b of one slice
constexpr int BASE = 2 * KC * FC;  // re and im base rows of one slice
constexpr int SLICE_AREA = 2 * AB + 2 * BASE;
constexpr int REGION = SLICE_AREA > FC * TNP ? SLICE_AREA : FC * TNP;

template <int MODE>
__device__ __forceinline__ float log_epilogue(float v, float offset) {
  if (MODE == 0) return logf(v + offset);
  if (MODE == 1) return log10f(fmaxf(v, 1e-10f));
  return 10.f * log10f(fmaxf(v, 1e-10f));
}

// 16-byte asynchronous copy global -> shared, through L2 only.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One slice's products: re/im[r][c] += a[r] * B[c] for the thread's 8 frames
// and its JN groups of 2 columns (JN = 4 in a full chunk, fewer in a last
// chunk that ends within its first 32 JN columns).
template <bool FOLD, int JN>
__device__ __forceinline__ void slice_products(const float* as, const float* bs, const float* bre,
                                               const float* bim, int tx, int ty,
                                               float (&re)[8][8], float (&im)[8][8]) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * TNP + 8 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * TNP + 8 * ty + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[8];
    if (FOLD) {
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * TNP + 8 * ty);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * TNP + 8 * ty + 4);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) bv[r] = av[r];
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float2 wr = *reinterpret_cast<const float2*>(bre + k * FC + 2 * tx + 32 * j);
      const float2 wi = *reinterpret_cast<const float2*>(bim + k * FC + 2 * tx + 32 * j);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        re[r][2 * j] = fmaf(av[r], wr.x, re[r][2 * j]);
        re[r][2 * j + 1] = fmaf(av[r], wr.y, re[r][2 * j + 1]);
        im[r][2 * j] = fmaf(bv[r], wi.x, im[r][2 * j]);
        im[r][2 * j + 1] = fmaf(bv[r], wi.y, im[r][2 * j + 1]);
      }
    }
  }
}

template <int MODE, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
    fused_log_mel_kernel(const float* __restrict__ frames, long long bs_, long long fs, int N,
                         int W, const float* __restrict__ bases, int Kp, int Fp, int F,
                         const float* __restrict__ mel, const int* __restrict__ band, int M,
                         float* __restrict__ out, float offset) {
  extern __shared__ __align__(16) float smem[];
  float* ab = smem;                    // [buf][a, b][KC][TNP]: a = lo (+ hi), b = lo - hi
  float* bsm = ab + 2 * AB;            // [buf][re, im][KC][FC]
  float* ps = smem;                    // [FC][TNP] power of a chunk (over the above)
  int* bnd = reinterpret_cast<int*>(smem + REGION);  // [lo, hi][M]
  float* ms = smem + REGION + 2 * M;   // [M][OS] mel tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TN;
  const int h = W / 2;
  const int nslices = Kp / KC;
  const int nchunks = (F + FC - 1) / FC;
  const bool live = n0 + 16 * (tid / 32) < N;  // this warp has a frame below N
  const float* bre_g = bases;
  const float* bim_g = bases + (size_t)Kp * Fp;

  for (int i = tid; i < M * OS; i += THREADS) ms[i] = 0.f;
  for (int i = tid; i < 2 * M; i += THREADS) bnd[i] = __ldg(band + i);

  // The fold: this thread reads sample j = s * KC + jj of frames r0 + 16 q
  // (q < 8), and x[W - j] where the bases fold, into registers a slice
  // ahead; then stores a = lo + hi and b = lo - hi. Rows 0 and h take x[j]
  // alone; rows past h have zero bases. Zeros past N and past the frame.
  const int jj = tid % KC, r0 = tid / KC;
  const float* xr = frames + (long long)blockIdx.y * bs_ + (long long)(n0 + r0) * fs;
  float xl[8], xh[8];
  auto load = [&](int s) {
    const int j = s * KC + jj;
    const bool ok_lo = j < W, ok_hi = FOLD && j >= 1 && j < h;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = n0 + r0 + 16 * q < N;
      const float* xf = xr + (long long)(16 * q) * fs;
      xl[q] = in && ok_lo ? __ldg(xf + j) : 0.f;
      xh[q] = in && ok_hi ? __ldg(xf + (W - j)) : 0.f;
    }
  };
  auto fold_store = [&](int buf) {
    float* a = ab + buf * AB;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[jj * TNP + r0 + 16 * q] = xl[q] + xh[q];
      if (FOLD) a[KC * TNP + jj * TNP + r0 + 16 * q] = xl[q] - xh[q];
    }
  };
  // Slice s of chunk c of both bases into buffer buf, 16 bytes a copy.
  auto stage_bases = [&](int s, int c, int buf) {
    float* b = bsm + buf * BASE;
    const int j0 = s * KC, f0 = c * FC;
    for (int i = tid; i < 2 * KC * FC / 4; i += THREADS) {
      const int mat = i / (KC * FC / 4), rem = i % (KC * FC / 4);
      const int k = rem / (FC / 4), c4 = rem % (FC / 4);
      const float* src = (mat ? bim_g : bre_g) + (size_t)(j0 + k) * Fp + f0 + 4 * c4;
      cp_async16(b + mat * KC * FC + k * FC + 4 * c4, src);
    }
    cp_async_commit();
  };

  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * FC;
    const int jn = min(4, (F - f0 + 31) / 32);  // 32-column groups below F
    float re[8][8], im[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) re[r][q] = im[r][q] = 0.f;

    load(0);
    fold_store(0);
    stage_bases(0, c, 0);
    for (int s = 0; s < nslices; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slice s visible; every thread is done with slice s - 1
      const bool next = s + 1 < nslices;
      if (next) {
        stage_bases(s + 1, c, (s + 1) & 1);
        load(s + 1);
      }
      if (live) {
        const float* a = ab + (s & 1) * AB;
        const float* b = bsm + (s & 1) * BASE;
        switch (jn) {
          case 4: slice_products<FOLD, 4>(a, a + KC * TNP, b, b + KC * FC, tx, ty, re, im); break;
          case 3: slice_products<FOLD, 3>(a, a + KC * TNP, b, b + KC * FC, tx, ty, re, im); break;
          case 2: slice_products<FOLD, 2>(a, a + KC * TNP, b, b + KC * FC, tx, ty, re, im); break;
          default: slice_products<FOLD, 1>(a, a + KC * TNP, b, b + KC * FC, tx, ty, re, im);
        }
      }
      if (next) fold_store((s + 1) & 1);
    }
    __syncthreads();  // the slice buffers become the power tile

    // The chunk's power, frame-major: ps[f - f0][frame].
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= jn) break;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int fl = 2 * tx + 32 * j + q;
        float p[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = re[r][2 * j + q], y = im[r][2 * j + q];
          p[r] = fmaf(x, x, y * y);
        }
        *reinterpret_cast<float4*>(ps + fl * TNP + 8 * ty) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(ps + fl * TNP + 8 * ty + 4) =
            make_float4(p[4], p[5], p[6], p[7]);
      }
    }
    __syncthreads();
    {
      // ms[m][n] += the chunk's band rows of mel column m.
      const int n = tid % TN;
      const int f1 = min(f0 + FC, F);
      for (int m = tid / TN; m < M; m += THREADS / TN) {
        const int lo = max(bnd[m], f0), hi = min(bnd[M + m], f1);
        if (lo >= hi) continue;
        float acc = ms[m * OS + n];
#pragma unroll 4
        for (int f = lo; f < hi; ++f)
          acc = fmaf(ps[(f - f0) * TNP + n], __ldg(mel + (size_t)f * M + m), acc);
        ms[m * OS + n] = acc;
      }
    }
    __syncthreads();  // the power tile becomes the slice buffers again
  }

  float* ob = out + (size_t)blockIdx.y * N * M;
  for (int i = tid; i < TN * M; i += THREADS) {
    const int r = i / M, m = i % M, n = n0 + r;
    if (n < N) ob[(size_t)n * M + m] = log_epilogue<MODE>(ms[m * OS + r], offset);
  }
}

size_t smem_bytes(int M) { return sizeof(float) * (size_t)(REGION + 2 * M + M * OS); }

template <int MODE, bool FOLD>
cudaError_t launch(const float* frames, long long bs, long long fs, int B, int N, int W,
                   const float* bases, int Kp, int Fp, int F, const float* mel, const int* band,
                   int M, float* out, float offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<MODE, FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, B);
  fused_log_mel_kernel<MODE, FOLD><<<grid, THREADS, smem, stream>>>(
      frames, bs, fs, N, W, bases, Kp, Fp, F, mel, band, M, out, offset);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int fold, const float* frames, long long bs, long long fs, int B, int N,
                     int W, const float* bases, int Kp, int Fp, int F, const float* mel,
                     const int* band, int M, float* out, float offset, cudaStream_t s) {
  if (fold)
    return launch<MODE, true>(frames, bs, fs, B, N, W, bases, Kp, Fp, F, mel, band, M, out,
                              offset, s);
  return launch<MODE, false>(frames, bs, fs, B, N, W, bases, Kp, Fp, F, mel, band, M, out, offset,
                             s);
}

// ---- The FFT body -------------------------------------------------------

constexpr int FT = 32;             // frames per block
constexpr int FTP = FT + 1;        // power and mel tile row stride
constexpr int FFT_THREADS = 256;
constexpr int FFT_WARPS = FFT_THREADS / 32;
constexpr int TWS = 512;           // stage-table floats (re or im) of a block

__host__ __device__ constexpr int spad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int brev(int k, int r) {
  int out = 0;
  for (int hi = r / 2, lo = 1; hi >= 1; hi /= 2, lo *= 2)
    if (k & lo) out |= hi;
  return out;
}

// a times exp(-2 pi i t / 8), t in 0..3.
__device__ __forceinline__ float2 rot8(float2 a, int t) {
  constexpr float C = 0.70710678118654752f;
  switch (t) {
    case 1: return make_float2(C * (a.x + a.y), C * (a.y - a.x));
    case 2: return make_float2(a.y, -a.x);
    case 3: return make_float2(C * (a.y - a.x), -C * (a.x + a.y));
    default: return a;
  }
}

// One radix-2 decimation-in-frequency level of an R-point DFT: pairs HALF
// apart, the difference times W_{2 HALF}^i; then the next level.
template <int R, int HALF>
__device__ __forceinline__ void dif_level(float2 (&v)[R]) {
#pragma unroll
  for (int base = 0; base < R; base += 2 * HALF)
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float2 a = v[base + i], b = v[base + i + HALF];
      v[base + i] = make_float2(a.x + b.x, a.y + b.y);
      v[base + i + HALF] = rot8(make_float2(a.x - b.x, a.y - b.y), i * 4 / HALF);
    }
  if constexpr (HALF > 1) dif_level<R, HALF / 2>(v);
}

// t[k] = v[bit reversal of k], k = K..R-1 (compile-time indices).
template <int R, int K = 0>
__device__ __forceinline__ void bit_reverse(const float2 (&v)[R], float2 (&t)[R]) {
  if constexpr (K < R) {
    t[K] = v[brev(K, R)];
    bit_reverse<R, K + 1>(v, t);
  }
}

// The R-point DFT (R = 2, 4, 8) of v in registers, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  dif_level<R, R / 2>(v);
  float2 t[R];
  bit_reverse<R>(v, t);
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = t[k];
}

// The butterflies of one radix-R Stockham stage (NS points already
// combined), on values v[b][r] = z[j + r P / R] of butterfly j = lane + 32 b:
// point r times W_{NS R}^{r (j % NS)} (the stage table twr / twi at
// [(r - 1) NS + j % NS]), the R-point DFT, output r to
// z[(j / NS) NS R + j % NS + r NS].
template <int P, int R, int NS>
__device__ __forceinline__ void butterflies(float2 (&v)[P / (32 * R)][R], float* zr, float* zi,
                                            const float* twr, const float* twi, int lane) {
#pragma unroll
  for (int b = 0; b < P / (32 * R); ++b) {
    const int j = lane + 32 * b, jm = j % NS;
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float wr = twr[(r - 1) * NS + jm], wi = twi[(r - 1) * NS + jm];
        const float2 a = v[b][r];
        v[b][r] = make_float2(fmaf(a.x, wr, -a.y * wi), fmaf(a.x, wi, a.y * wr));
      }
    }
    dft<R>(v[b]);
    const int d = (j / NS) * NS * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = spad(d + r * NS);
      zr[s] = v[b][r].x;
      zi[s] = v[b][r].y;
    }
  }
  __syncwarp();
}

// A whole Stockham stage on the warp's points in shared memory: read, then
// (after every lane has read) the butterflies in place.
template <int P, int R, int NS>
__device__ __forceinline__ void stage(float* zr, float* zi, const float* twr, const float* twi,
                                      int lane) {
  float2 v[P / (32 * R)][R];
#pragma unroll
  for (int b = 0; b < P / (32 * R); ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = spad(lane + 32 * b + r * (P / R));
      v[b][r] = make_float2(zr[s], zi[s]);
    }
  __syncwarp();
  butterflies<P, R, NS>(v, zr, zi, twr, twi, lane);
}

// The stage table of a radix-R stage after NS points: [(r - 1) NS + jm] =
// W_{NS R}^{r jm} = tw[r jm (2 P / (NS R))], r = 1..R-1, jm < NS.
template <int P, int R, int NS>
__device__ __forceinline__ void stage_table(float* twr, float* twi, const float2* tw, int tid) {
  for (int i = tid; i < (R - 1) * NS; i += FFT_THREADS) {
    const float2 w = __ldg(tw + (i / NS + 1) * (i % NS) * (2 * P / (NS * R)));
    twr[i] = w.x;
    twi[i] = w.y;
  }
}

// The radices after the first radix-8 stage: 8 then 8 (P = 512) or 4 (256).
template <int P>
constexpr int R3 = P == 512 ? 8 : 4;

template <int MODE, int P, bool VEC>
__global__ void __launch_bounds__(FFT_THREADS, 2)
    fused_log_mel_fft_kernel(const float* __restrict__ frames, long long bs_, long long fs,
                             int N, int W, const float* __restrict__ window,
                             const float2* __restrict__ tw, int klo, int nk,
                             const float* __restrict__ melp, const int* __restrict__ band,
                             const int* __restrict__ packed_at, int M, float* __restrict__ out,
                             float offset) {
  static_assert(P == 256 || P == 512, "the FFT body takes n_fft = 512 or 1024");
  static_assert(7 * 8 + (R3<P> - 1) * 64 <= TWS, "stage tables");
  constexpr int ZS = spad(P);  // a warp's re (or im) points, padded
  extern __shared__ __align__(16) float smem[];
  float* twr = smem;                            // [TWS] stage tables, re
  float* twi = twr + TWS;                       // [TWS] im
  float* zs = twi + TWS;                        // [warp][re, im][ZS]
  float* pw = zs + FFT_WARPS * 2 * ZS;          // [nk][FTP] power of the band union
  float* ms = pw + nk * FTP;                    // [M][FTP] log-mel tile
  int* bnd = reinterpret_cast<int*>(ms + M * FTP);  // [lo, hi, packed_at][M]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  stage_table<P, 8, 8>(twr, twi, tw, tid);
  stage_table<P, R3<P>, 64>(twr + 56, twi + 56, tw, tid);
  for (int i = tid; i < 3 * M; i += FFT_THREADS)
    bnd[i] = i < 2 * M ? __ldg(band + i) : __ldg(packed_at + i - 2 * M);
  __syncthreads();

  float* zr = zs + warp * 2 * ZS;
  float* zi = zr + ZS;
  const int n0 = blockIdx.x * FT;
  const float* clip = frames + (long long)blockIdx.y * bs_;
  const float2* win2 = reinterpret_cast<const float2*>(window);
  for (int fl = warp; fl < FT && n0 + fl < N; fl += FFT_WARPS) {
    const float* x = clip + (long long)(n0 + fl) * fs;
    constexpr int NB = P / (32 * 8);
    float2 v[NB][8];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int q = lane + 32 * b + r * (P / 8), s = 2 * q;
        const float2 w = __ldg(win2 + q);
        float2 xv;
        if (VEC) {
          xv = s < W ? __ldg(reinterpret_cast<const float2*>(x + s)) : make_float2(0.f, 0.f);
        } else {
          xv.x = s < W ? __ldg(x + s) : 0.f;
          xv.y = s + 1 < W ? __ldg(x + s + 1) : 0.f;
        }
        v[b][r] = make_float2(xv.x * w.x, xv.y * w.y);
      }
    __syncwarp();  // the previous frame's split pass is done with z
    butterflies<P, 8, 1>(v, zr, zi, twr, twi, lane);
    stage<P, 8, 8>(zr, zi, twr, twi, lane);
    stage<P, R3<P>, 64>(zr, zi, twr + 56, twi + 56, lane);

    // The split pass and the power over the band union.
    for (int t = lane; t < nk; t += 32) {
      const int k = klo + t;
      const int ia = spad(k & (P - 1)), ib = spad((P - k) & (P - 1));
      const float ar = zr[ia], ai = zi[ia], br = zr[ib], bi = zi[ib];
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float o_r = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
      const float2 w = __ldg(tw + k);
      const float xr = er + (w.x * o_r - w.y * oi);
      const float xi = ei + (w.x * oi + w.y * o_r);
      pw[t * FTP + fl] = fmaf(xr, xr, xi * xi);
    }
  }
  __syncthreads();

  // Thread (frame, mel column): the column's band rows (its packed values
  // are contiguous: a warp-uniform load that stays in L1), then the log.
  {
    const int fl = tid % FT;
    for (int m = tid / FT; m < M; m += FFT_THREADS / FT) {
      const int lo = bnd[m], hi = bnd[M + m];
      const float* mp = melp + bnd[2 * M + m] - lo;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(pw[(k - klo) * FTP + fl], __ldg(mp + k), acc);
      ms[m * FTP + fl] = log_epilogue<MODE>(acc, offset);
    }
  }
  __syncthreads();

  float* ob = out + ((size_t)blockIdx.y * N + n0) * M;
  for (int i = tid; i < FT * M; i += FFT_THREADS) {
    const int r = i / M, m = i % M;
    if (n0 + r < N) ob[(size_t)r * M + m] = ms[m * FTP + r];
  }
}

size_t fft_smem_bytes(int P, int nk, int M) {
  return sizeof(float) * (size_t)(2 * TWS + FFT_WARPS * 2 * spad(P) + (nk + M) * FTP) +
         sizeof(int) * (size_t)(3 * M);
}

struct FftArgs {
  const float* frames;
  long long bs, fs;
  int B, N, W;
  const float* window;
  const float2* tw;
  int klo, nk;
  const float* melp;
  const int* band;
  const int* packed_at;
  int M;
  float* out;
  float offset;
  cudaStream_t stream;
};

template <int MODE, int P, bool VEC>
cudaError_t launch_fft(const FftArgs& a) {
  const size_t smem = fft_smem_bytes(P, a.nk, a.M);
  cudaError_t err = cudaFuncSetAttribute(fused_log_mel_fft_kernel<MODE, P, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + FT - 1) / FT, a.B);
  fused_log_mel_fft_kernel<MODE, P, VEC><<<grid, FFT_THREADS, smem, a.stream>>>(
      a.frames, a.bs, a.fs, a.N, a.W, a.window, a.tw, a.klo, a.nk, a.melp, a.band, a.packed_at,
      a.M, a.out, a.offset);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_fft(int n_fft, bool vec, const FftArgs& a) {
  if (n_fft == 1024) return vec ? launch_fft<MODE, 512, true>(a) : launch_fft<MODE, 512, false>(a);
  return vec ? launch_fft<MODE, 256, true>(a) : launch_fft<MODE, 256, false>(a);
}

}  // namespace

// frames: float32, element (b, n, w) at frames[b * bs + n * fs + w];
// bases (2, Kp, Fp) float32: the re and im rows 0..K-1 of the bases (K =
// W/2 + 1 when fold, W otherwise), zero-padded, Kp % 16 == 0, Fp % 128 == 0,
// Fp >= F; mel (F, M) contiguous float32; band (2, M) int32: the first and
// one past the last nonzero row of each mel column; out (B, N, M)
// contiguous float32. mode: 0 ln_offset, 1 log10_clamp, 2 db_clamp.
// 1 <= M <= 128, 1 <= B <= 65535, W even when fold. Launches on `stream`,
// does not synchronise; returns the cudaError_t of the launch.
extern "C" int fadtk_fused_log_mel(const float* frames, long long bs, long long fs, int B, int N,
                                   int W, int fold, const float* bases, int Kp, int Fp, int F,
                                   const float* mel, const int* band, int M, float* out, int mode,
                                   float offset, void* stream) {
  const int K = fold ? W / 2 + 1 : W;
  if (B <= 0 || B > 65535 || N <= 0 || W <= 0 || F <= 0 || M <= 0 || M > 128 ||
      (fold && W % 2) || Kp % KC || Kp < K || Fp % FC || Fp < F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)dispatch<0>(fold, frames, bs, fs, B, N, W, bases, Kp, Fp, F, mel, band, M, out, offset, s);
    case 1: return (int)dispatch<1>(fold, frames, bs, fs, B, N, W, bases, Kp, Fp, F, mel, band, M, out, offset, s);
    case 2: return (int)dispatch<2>(fold, frames, bs, fs, B, N, W, bases, Kp, Fp, F, mel, band, M, out, offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// frames: float32, element (b, n, w) at frames[b * bs + n * fs + w]; window
// (n_fft,) float32, zero past W; twiddle (n_fft, 2) float32, exp(-2 pi i j /
// n_fft); [klo, khi) the union of the mel bands (every band of `band` lies in
// it); band (2, M) int32: the first and one past the last nonzero row of each
// mel column; melp float32: mel column m's rows band[0][m]..band[1][m] - 1,
// from melp[packed_at[m]]; out (B, N, M) contiguous float32. n_fft 512 or 1024, 1 <= W <= n_fft, 1 <=
// M <= 128, 1 <= B <= 65535. Loads are 8 bytes where the frames' address and
// strides allow it (even bs, fs and W, 8-byte aligned base), one float
// otherwise. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch.
extern "C" int fadtk_fused_log_mel_fft(const float* frames, long long bs, long long fs, int B,
                                       int N, int W, int n_fft, const float* window,
                                       const float* twiddle, int klo, int khi, const float* melp,
                                       const int* band, const int* packed_at, int M, float* out,
                                       int mode, float offset, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || W <= 0 || W > n_fft || (n_fft != 512 && n_fft != 1024) ||
      M <= 0 || M > 128 || klo < 0 || khi < klo || khi > n_fft / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<size_t>(frames) % 8 == 0 && bs % 2 == 0 && fs % 2 == 0 &&
                   W % 2 == 0;
  const FftArgs a{frames, bs, fs, B, N, W, window, reinterpret_cast<const float2*>(twiddle),
                  klo, khi - klo, melp, band, packed_at, M, out, offset,
                  static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return (int)dispatch_fft<0>(n_fft, vec, a);
    case 1: return (int)dispatch_fft<1>(n_fft, vec, a);
    case 2: return (int)dispatch_fft<2>(n_fft, vec, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
