// Ragged single-token decode attention over the slot-pool KV cache, for
// Hopper (sm_90a), in fp32: over an fp32 cache, and over an int8 cache
// of codes with per-block fp32 scales that it dequantizes in registers.
//
// Replaces the TPU kernels `_decode_kernel` and `_dequant_kernel`
// (paddle_tpu/ops/kern/decode_attention.py:108 and :123, launched by
// `decode_attend` at :169 and `dequant_attend` at :194 through
// `_common_wiring` at :150).
//
//   q      [S, H, Dh] fp32      one query row per (slot, head)
//   k,v    [S, T, H, Dh] fp32   the layer's slice of the slot-pool cache
//   or kq,vq [S, T, H, Dh] int8 codes and ks,vs [S, T, H, Dh/qblock]
//          fp32 scales: element d of a row is code[d] * scale[d/qblock]
//   pos    [S] int32            slot s attends to t <= pos[s]
//   out    [S, H, Dh] fp32
//
// Semantics (those of the TPU kernels): f32 scores times `scale`, online
// softmax in f32, weighted sum of v in f32. pos[s] < 0 gives an all-zero
// row; pos[s] >= T attends to all T rows (free slots carry stale
// positions). An int8 element is dequantized by one rounded fp32
// multiply, code * scale (__fmul_rn, never fused into the dot), which is
// what the plain version computes before its dot.
//
// Bound: memory. Each call must read the attended cache rows once,
// sum_s min(pos[s]+1, T) * H * Dh elements of k and as many of v (4
// bytes each in fp32; 1 byte plus 4/qblock bytes of scale in int8), and
// does 4 flops per element read (6 with the int8 multiplies), far below
// the card's ~20 flops per byte in fp32. The design therefore reads
// every attended row exactly once and never touches rows above pos[s]:
// no score tensor and no dequantized fp32 copy of the cache goes to
// device memory, and the softmax state lives in registers.
//
// Design: one block per (slot, head); the TPU kernel's sequential t grid
// axis becomes a loop inside the block. Each of the block's warps
// strides over t (warp w takes t = w, w + kWarps, ...) and keeps its
// own online-softmax state (m, l, acc); lanes stride over Dh, so any
// Dh <= 256 works. The warps' states are merged through shared memory
// in a fixed order, so the result is deterministic and needs no
// atomics. The two caches differ only in how a lane reads element d of
// row (s, t, h), which is the kernel's `Cache` template argument.
// Splitting t across blocks for short pools, vector loads and TMA are
// left for later.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxDh = 256;

// row = (s * T + t) * H + h indexes one cached head row of Dh elements
struct F32Cache {
  const float* k;
  const float* v;
  int Dh;
  __device__ float key(size_t row, int d) const { return k[row * Dh + d]; }
  __device__ float val(size_t row, int d) const { return v[row * Dh + d]; }
};

struct Int8Cache {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  int Dh;
  int nb;      // scales per row
  int qblock;  // Dh / nb elements share one scale
  __device__ float key(size_t row, int d) const {
    return __fmul_rn((float)kq[row * Dh + d], ks[row * nb + d / qblock]);
  }
  __device__ float val(size_t row, int d) const {
    return __fmul_rn((float)vq[row * Dh + d], vs[row * nb + d / qblock]);
  }
};

template <int NCH, class Cache>  // NCH = ceil(Dh / 32): elements a lane
__global__ void __launch_bounds__(kWarps * 32)
attend_kernel(const float* __restrict__ q, Cache cache,
              const int* __restrict__ pos, float* __restrict__ out,
              int T, int H, int Dh, float scale) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxDh];

  const int sh = blockIdx.x;  // s * H + h
  const int s = sh / H;
  const int h = sh - s * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = pos[s];
  const int n = p < 0 ? 0 : (p >= T ? T : p + 1);  // rows 0 .. n-1
  float* o = out + (size_t)sh * Dh;
  if (n == 0) {
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) o[d] = 0.f;
    return;
  }

  const float* qrow = q + (size_t)sh * Dh;
  float qr[NCH];
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < Dh ? qrow[d] : 0.f;
    acc[c] = 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  const size_t row0 = (size_t)s * T * H + h;  // row of t = 0
  for (int t = warp; t < n; t += kWarps) {
    const size_t row = row0 + (size_t)t * H;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) part = fmaf(qr[c], cache.key(row, d), part);
    }
    // xor butterfly: every lane ends with the same, bitwise equal sum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float sc = part * scale;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);  // 0 on the warp's first row
    const float pw = expf(sc - m_new);
    l = l * alpha + pw;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      acc[c] = acc[c] * alpha + (d < Dh ? pw * cache.val(row, d) : 0.f);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = lane + 32 * c;
    if (d < Dh) sm_acc[warp][d] = acc[c];
  }
  __syncthreads();

  // merge in warp order; warp 0 always holds row 0, so M is finite and
  // L >= 1 (the row holding the maximum contributes exp(0))
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float f[kWarps];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - M);
    L = fmaf(f[w], sm_l[w], L);
  }
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(f[w], sm_acc[w][d], a);
    o[d] = a / L;
  }
}

template <class Cache>
int launch(const float* q, const Cache& cache, const int* pos, float* out,
           int S, int T, int H, int Dh, float scale, void* stream) {
  if (S < 1 || T < 1 || H < 1 || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)S * (unsigned)H), block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((Dh + 31) / 32) {
#define PTT_CASE(N)                                                  \
  case N:                                                            \
    attend_kernel<N, Cache><<<grid, block, 0, st>>>(q, cache, pos,   \
                                                    out, T, H, Dh,   \
                                                    scale);          \
    break;
    PTT_CASE(1) PTT_CASE(2) PTT_CASE(3) PTT_CASE(4)
    PTT_CASE(5) PTT_CASE(6) PTT_CASE(7)
#undef PTT_CASE
    default:
      attend_kernel<8, Cache><<<grid, block, 0, st>>>(q, cache, pos, out,
                                                      T, H, Dh, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int ptt_decode_attend_f32(const float* q, const float* k,
                                     const float* v, const int* pos,
                                     float* out, int S, int T, int H,
                                     int Dh, float scale, void* stream) {
  return launch(q, F32Cache{k, v, Dh}, pos, out, S, T, H, Dh, scale,
                stream);
}

extern "C" int ptt_dequant_attend_int8(const float* q, const int8_t* kq,
                                       const float* ks, const int8_t* vq,
                                       const float* vs, const int* pos,
                                       float* out, int S, int T, int H,
                                       int Dh, int nb, float scale,
                                       void* stream) {
  if (nb < 1 || Dh % nb != 0) return (int)cudaErrorInvalidValue;
  return launch(q, Int8Cache{kq, ks, vq, vs, Dh, nb, Dh / nb}, pos, out,
                S, T, H, Dh, scale, stream);
}
