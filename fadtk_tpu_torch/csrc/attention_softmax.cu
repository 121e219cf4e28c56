// The float32 attention's bias and softmax in one pass over the logits,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. In the JAX package XLA fuses the bias add and the
// softmax of fadtk_tpu/models/speech/encoder.py::_attention_core by itself;
// the port's _attention_core is eager, and as a chain of torch ops it made
// eight passes over a float32 (B, H, T, T) term in every WavLM layer (the
// dense gated bias written, the key mask added to it, logits + bias, the
// softmax) and four with the key mask alone (w2v2, HuBERT, MERT).
//
// For each query row (b, h, i), in place over the logits:
//
//   x_j = logit[b, h, i, j] + (key_bias[b, j] + gate[b, i, h] * pb[h, i, j])  (gated)
//   x_j = logit[b, h, i, j] + key_bias[b, j]                                  (key mask only)
//   logit[b, h, i, j] = exp(x_j - max_j x) / sum_j exp(x_j - max_j x)
//
// Every product and sum of x is rounded to float32 in the order the torch
// composition rounds it (__fmul_rn / __fadd_rn, so that nvcc contracts
// nothing into an FMA): x equals the eager path's logits + bias bit for bit.
// The softmax is torch's but for its last step: the row max, expf at full
// precision (not __expf), a float32 sum, and a product with the correctly
// rounded reciprocal of the sum where torch divides (at most an ulp apart;
// dividing cost 20% at the 60 s WavLM-large shape). The order of the sum
// differs too: the probabilities agree within a few ulp.
//
// Layouts, all contiguous float32: logits (B, H, T, T); key_bias (B, T), the
// additive key mask (0 or a large negative); gate (B, T, H), WavLM's
// per-query, per-head gate; pb (H, T, T), the relative-position table. A
// tensor-parallel shard passes its own heads in gate and pb.
//
// What bounds it: bytes. A row reads its T logits once and writes T
// probabilities over them; the key mask (B x T) stays in L2, and the grid
// orders rows (h, i, b) with b fastest, so the B rows that share a table row
// pb[h, i, :] run side by side and read it from HBM once. At the 60 s
// WavLM-large bucket (B=16, H=16, T=2999) that is 9.2 GB read, 9.2 GB
// written and the 0.58 GB table: 19 GB, 5.7 ms at 3.35 TB/s; with the key
// mask alone (w2v2-base, H=12) 13.8 GB, 4.1 ms. Logits are read and written
// with the streaming hints (ld/st .cs), so they do not push the table out of
// L2.
//
// Design. One CTA per row. A row of T floats is read and written as float4
// groups from its first 16-byte boundary on (a row starts anywhere: T is
// odd at every bucket), spread over NT threads, V groups a thread, thread t
// holding groups t, t + NT, ...; the few columns before the boundary and
// after the last whole group go one to a thread. The row stays in registers
// from the load to the store: a thread issues all its loads before the first
// use, and the two block reductions (max, sum) go through 32 floats of
// shared memory. Vector loads and stores matter here: with a load, a store
// and their address arithmetic per column the kernel issued nearly as many
// instructions as the math, and reached 47% of the byte bound at the 60 s
// WavLM-large shape; with float4 it reaches ~82%. V is a template parameter
// in {1, 2, 4, 8}, chosen from T at the launch (max_threads): rows up to
// kMaxT = 32768 columns, and no longer. The speech models cut a clip at six
// minutes, T = 18000 frames at 50 Hz.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A CTA's threads at most, for V float4 groups a thread (measured best at
// B = 16 on the H100: 128 threads up to T = 1024, then V = 4).
constexpr int max_threads(int v) { return v == 8 ? 1024 : v == 4 ? 256 : 128; }
constexpr int kMaxT = 32 * 1024;  // V = 8 at 1024 threads

struct Row {
  float* logits;        // the row's T logits, overwritten with probabilities
  const float* key;     // key_bias[b, :]
  const float* table;   // pb[h, i, :] (gated) or nullptr
  float gate;           // gate[b, i, h] (gated)
};

template <bool GATED>
__device__ __forceinline__ Row row_of(float* logits, const float* key_bias, const float* gate,
                                      const float* pb, int B, int H, int T) {
  const long long r = blockIdx.x;  // (h, i, b), b fastest
  const int b = (int)(r % B);
  const long long hi = r / B;  // h * T + i
  const int h = (int)(hi / T), i = (int)(hi % T);
  Row row;
  row.logits = logits + ((long long)(b * H + h) * T + i) * T;
  row.key = key_bias + (long long)b * T;
  row.table = GATED ? pb + hi * T : nullptr;
  row.gate = GATED ? gate[((long long)b * T + i) * H + h] : 0.f;
  return row;
}

// logit + bias at column j, rounded as the torch composition rounds:
// bias = key_bias + gate * pb (the product first), then logit + bias.
template <bool GATED>
__device__ __forceinline__ float biased(const Row& row, int j) {
  const float logit = __ldcs(row.logits + j);
  if (!GATED) return __fadd_rn(logit, row.key[j]);
  return __fadd_rn(logit, __fadd_rn(row.key[j], __fmul_rn(row.gate, row.table[j])));
}

// The same at columns c .. c + 3, with c on a 16-byte boundary of the
// logits row. The table row shares that alignment when table16 says so
// (always where H * T * T is a multiple of 4); the key row is read a column
// at a time.
template <bool GATED>
__device__ __forceinline__ float4 biased4(const Row& row, int c, bool table16) {
  const float4 l = __ldcs(reinterpret_cast<const float4*>(row.logits + c));
  const float* kb = row.key + c;
  if (!GATED)
    return make_float4(__fadd_rn(l.x, kb[0]), __fadd_rn(l.y, kb[1]), __fadd_rn(l.z, kb[2]),
                       __fadd_rn(l.w, kb[3]));
  const float* tb = row.table + c;
  const float4 p = table16 ? *reinterpret_cast<const float4*>(tb)
                           : make_float4(tb[0], tb[1], tb[2], tb[3]);
  const float g = row.gate;
  return make_float4(__fadd_rn(l.x, __fadd_rn(kb[0], __fmul_rn(g, p.x))),
                     __fadd_rn(l.y, __fadd_rn(kb[1], __fmul_rn(g, p.y))),
                     __fadd_rn(l.z, __fadd_rn(kb[2], __fmul_rn(g, p.z))),
                     __fadd_rn(l.w, __fadd_rn(kb[3], __fmul_rn(g, p.w))));
}

__device__ __forceinline__ float max4(float4 v) { return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)); }

// The max (MAX) or the sum of v over the CTA, on every thread. red holds 32
// floats of shared memory; it is free again when this returns.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : (MAX ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  return v;
}

// A row in registers. The columns split into a head of at most 3 before
// the logits row's first 16-byte boundary, whole groups of 4 read and
// written as float4 (V a thread: thread t holds groups t, t + NT, ...), and
// a tail of at most 3; thread t < head + tail holds one head or tail column
// besides.
template <int V, bool GATED>
__global__ void __launch_bounds__(max_threads(V))
softmax_rows(float* __restrict__ logits, const float* __restrict__ key_bias,
             const float* __restrict__ gate, const float* __restrict__ pb, int B, int H, int T) {
  __shared__ float red[32];
  const Row row = row_of<GATED>(logits, key_bias, gate, pb, B, H, T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(row.logits);
  const int head = min((int)((0u - (unsigned)(at >> 2)) & 3u), T);
  const int groups = (T - head) >> 2, body_end = head + 4 * groups;
  const int extras = head + T - body_end;
  const bool table16 = GATED && ((reinterpret_cast<uintptr_t>(row.table) ^ at) & 15) == 0;
  const int nt = blockDim.x, t = threadIdx.x;
  const int je = t < head ? t : body_end + t - head;  // this thread's extra column
  float xe = t < extras ? biased<GATED>(row, je) : -INFINITY;
  float m = xe;
  float4 x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = t + k * nt;
    x[k] = g < groups ? biased4<GATED>(row, head + 4 * g, table16)
                      : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    m = fmaxf(m, max4(x[k]));
  }
  m = block_reduce<true>(m, red);
  float s = 0.f;
  if (t < extras) {
    xe = expf(xe - m);
    s = xe;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (t + k * nt < groups) {
      x[k] = make_float4(expf(x[k].x - m), expf(x[k].y - m), expf(x[k].z - m), expf(x[k].w - m));
      s += x[k].x;
      s += x[k].y;
      s += x[k].z;
      s += x[k].w;
    }
  }
  const float inv = __frcp_rn(block_reduce<false>(s, red));
  if (t < extras) __stcs(row.logits + je, xe * inv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = t + k * nt;
    if (g < groups)
      __stcs(reinterpret_cast<float4*>(row.logits + head + 4 * g),
             make_float4(x[k].x * inv, x[k].y * inv, x[k].z * inv, x[k].w * inv));
  }
}

template <int V, bool GATED>
cudaError_t launch_regs(float* logits, const float* key_bias, const float* gate, const float* pb,
                        int B, int H, int T, unsigned rows, cudaStream_t s) {
  const int nt = 32 * ((T + 128 * V - 1) / (128 * V));  // ceil(T / 4) groups, V a thread
  softmax_rows<V, GATED><<<rows, nt, 0, s>>>(logits, key_bias, gate, pb, B, H, T);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch(float* logits, const float* key_bias, const float* gate, const float* pb,
                   int B, int H, int T, cudaStream_t s) {
  const long long rows = (long long)B * H * T;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned n = (unsigned)rows;
  if (T <= 4 * max_threads(1)) return launch_regs<1, GATED>(logits, key_bias, gate, pb, B, H, T, n, s);
  if (T <= 8 * max_threads(2)) return launch_regs<2, GATED>(logits, key_bias, gate, pb, B, H, T, n, s);
  if (T <= 16 * max_threads(4)) return launch_regs<4, GATED>(logits, key_bias, gate, pb, B, H, T, n, s);
  if (T <= kMaxT) return launch_regs<8, GATED>(logits, key_bias, gate, pb, B, H, T, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// logits (B, H, T, T), overwritten with softmax(logits + bias) over the last
// dim; key_bias (B, T); gate (B, T, H) and pb (H, T, T) both, or both null
// for the key mask alone. All float32, contiguous. T <= 32768. Launches on
// `stream`, does not synchronise; returns the cudaError_t of the launch.
extern "C" int fadtk_attention_softmax(void* logits, const void* key_bias, const void* gate,
                                       const void* pb, int B, int H, int T, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (gate == nullptr) != (pb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(logits);
  const float* kb = static_cast<const float*>(key_bias);
  const float* g = static_cast<const float*>(gate);
  const float* p = static_cast<const float*>(pb);
  return (int)(gate ? launch<true>(l, kb, g, p, B, H, T, s) : launch<false>(l, kb, g, p, B, H, T, s));
}
