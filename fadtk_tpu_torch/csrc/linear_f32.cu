// K6: the float32 projection y = x . W^T (+ bias) as 3xTF32 on Hopper's
// wgmma, hand-written for sm_90a.
//
// Replaces no TPU kernel: in the JAX package XLA does the dots of every
// nn.Linear-style projection. In the port they went to cuBLAS's float32
// sgemm, which runs on the CUDA cores (~48 TFLOP/s of their 67 at the
// speech encoders' and Whisper's shapes) because a float32 product has no
// tensor-core form. This kernel puts it on the tensor cores with float32
// accuracy: each operand is split into two TF32 values, v = hi + lo, and
//
//   x . W^T = x_lo . W_hi^T + x_hi . W_lo^T + x_hi . W_hi^T   (+ bias)
//
// on wgmma m64n128k8 tf32 with float32 accumulation; the dropped
// x_lo . W_lo^T is ~2^-22 of the product (tf32.cuh).
//
// Operands. x (M, K) and W (N, K) are both row-major, so both are K-major
// as wgmma's tf32 form requires (it has no transposed operand). wgmma reads
// a tf32 operand's float32 bits and ignores the low 13: W itself is fed as
// W_hi, which the hardware truncates, and W_lo = tf32_rna(W - trunc(W)) is
// made once per weight by the wrapper (ops/linear_f32.py, cached with the
// weight) and read beside it. x is split in registers: hi = tf32_rna(x),
// lo = tf32_rna(x - hi), both exact TF32 values. y (M, N) is written once,
// the bias added in the epilogue, in float32.
//
// What bounds it: operations. 3 x 2MNK at the 495 TFLOP/s of dense TF32;
// at Whisper-large's fc1 (M = 24000, K = 1280, N = 5120) 1.91 ms, against
// bytes of x, W, W_lo and y of 0.67 GB, 0.20 ms at 3.35 TB/s.
//
// Design. Persistent CTAs, one per SM, walk the 128 x 128 output tiles in
// groups of 16 row tiles (so that the tiles in flight share their x rows
// and W columns in L2). One thread of a
// producer warpgroup (which gives its registers to the consumers with
// setmaxnreg) keeps a ring of 4 stages in shared memory full with TMA: per
// stage the x tile (128 x 32), the W_hi tile and the W_lo tile (128 x 32
// each), 128-byte swizzled, 48 KB. Two consumer warpgroups take 64 rows
// each: per stage a thread loads its A fragments (4 k8 slices) from the
// swizzled x tile, splits them, and issues 12 wgmmas with the W tiles as
// shared-memory operands into a partial product; it waits for them, frees
// the stage and adds the partial to its float32 accumulators, while the
// other warpgroup's wgmmas keep the tensor cores busy.
//
// Accuracy. The tensor cores' float32 accumulation truncates each sum it
// forms, so a chain of wgmmas into one accumulator over all of K drifts by
// up to an ulp a step: a first version that chained them read 14-28x
// cuBLAS's float32 error against a float64 product, growing with K. A
// stage's partial starts from zero and takes its small terms first; the
// partials add in registers, rounded to nearest. That reads 0.2-0.4x
// cuBLAS's error at the speech encoders' and Whisper's shapes.
//
// The epilogue adds the bias and stores straight from the accumulators.
// Ragged M, N and K come in as zeros from TMA's out-of-bounds fill; the
// store is masked.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kBM = 128;      // rows of x a tile (two warpgroups of 64)
constexpr int kBN = 128;      // rows of W a tile
constexpr int kBK = 32;       // k a stage: one 128-byte swizzle row of float32
constexpr int kStages = 4;
constexpr int kGroupM = 16;   // row tiles walked together
constexpr int kConsumers = 2; // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer's warpgroup
constexpr int kTileBytes = kBM * kBK * 4;        // 16 KB, also a W tile's
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 2-d TMA load of the box at (c0 along k, c1 along rows) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzled
// (8-row groups 1024 bytes apart), starting at shared address addr.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmmas.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a . b (+ d where accumulate) on m64n128k8, tf32 in, float32
// accumulate; a from registers (this thread's 4 values of the warpgroup's
// 64 x 8 fragment), b a shared-memory descriptor.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Output tile `tile` as (row tile, column tile): groups of kGroupM row
// tiles, row tile fastest within a group.
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& mb, int& nb) {
  const int per_group = kGroupM * tiles_n;
  const int group = tile / per_group;
  const int first = group * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int in = tile - group * per_group;
  mb = first + in % rows;
  nb = in / rows;
}

__global__ void __launch_bounds__(kThreads, 1)
    linear_f32_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap twlo, const float* __restrict__ bias,
                      float* __restrict__ y, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + kStages * kStageBytes;  // kStages mbarriers, then the empties
  const uint32_t empty = full + kStages * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n, ksteps = (K + kBK - 1) / kBK;

  if (warp >= kConsumers * 4) {  // the producer: one thread of its warpgroup issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumers * 4 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mb, nb;
        tile_coords(tile, tiles_m, tiles_n, mb, nb);
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage, dst = ring + stage * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(dst, &tx, bar, ks * kBK, mb * kBM);
          tma_load(dst + kTileBytes, &tw, bar, ks * kBK, nb * kBN);
          tma_load(dst + 2 * kTileBytes, &twlo, bar, ks * kBK, nb * kBN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows wg * 64 + [0, 64) of the tile; this thread's
  // fragment rows are r and r + 8, its columns t and t + 4 of each k8 slice.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r = wg * 64 + (warp % 4) * 16 + g;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mb, nb;
    tile_coords(tile, tiles_m, tiles_n, mb, nb);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      const float* a_tile = reinterpret_cast<const float*>(smem + stage * kStageBytes);
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // Element (row, k) of a swizzled tile: 16-byte chunk k / 4 of the
        // row's 128 bytes is stored at chunk (k / 4) ^ (row % 8); row % 8 is
        // g for both of this thread's rows.
        const int c0 = (((2 * kk) ^ g) << 2) + t, c1 = (((2 * kk + 1) ^ g) << 2) + t;
        const float v[4] = {a_tile[r * kBK + c0], a_tile[(r + 8) * kBK + c0], a_tile[r * kBK + c1],
                            a_tile[(r + 8) * kBK + c1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(v[i], a_hi[kk][i], a_lo[kk][i]);
      }
      const uint32_t b_hi = ring + stage * kStageBytes + kTileBytes, b_lo = b_hi + kTileBytes;
      // The stage's partial product, from zero: the two small terms first,
      // then the large one (see Accuracy in the header).
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // a k8 slice is 32 bytes into each 128-byte row
        wgmma_tf32(part, a_lo[kk], desc_sw128(b_hi + 32 * kk), kk > 0);
        wgmma_tf32(part, a_hi[kk], desc_sw128(b_lo + 32 * kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_hi[kk], desc_sw128(b_hi + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: acc[4j + {0, 1}] is (row r, columns 8j + 2t + {0, 1}),
    // acc[4j + {2, 3}] the same columns of row r + 8.
    const int row0 = mb * kBM + r;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = nb * kBN + 8 * j + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < N) b0 = bias[col];
        if (col + 1 < N) b1 = bias[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M || col >= N) continue;
        const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        float* out = y + static_cast<size_t>(row) * N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (col + 1 < N) out[1] = v1;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry points, so
// that the library links against nothing but the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a row-major float32 (rows, cols) matrix, boxes of kBK
// columns by box_rows rows, 128-byte swizzled, zeros out of bounds.
CUresult tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// y (M, N) = x (M, K) . w (N, K)^T (+ bias (N,)), w_lo the TF32 remainder
// of w (see the header). All float32, contiguous, 16-byte aligned, K a
// multiple of 4 (TMA's row stride). Returns a cudaError_t, or 1000 + a
// CUresult when a TMA map cannot be made (2000 when there is no
// cuTensorMapEncodeTiled).
extern "C" int fadtk_linear_f32(const void* x, const void* w, const void* w_lo, const void* bias,
                                void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return 2000;
  CUtensorMap tx, tw, twlo;
  CUresult res = tensor_map(&tx, x, M, K, kBM);
  if (res == CUDA_SUCCESS) res = tensor_map(&tw, w, N, K, kBN);
  if (res == CUDA_SUCCESS) res = tensor_map(&twlo, w_lo, N, K, kBN);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linear_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * static_cast<long long>((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  linear_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, twlo, static_cast<const float*>(bias), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
