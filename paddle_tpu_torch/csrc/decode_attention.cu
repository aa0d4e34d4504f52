// Ragged single-token decode attention over the slot-pool KV cache, for
// Hopper (sm_90a), in fp32.
//
// Replaces the TPU kernel `_decode_kernel`
// (paddle_tpu/ops/kern/decode_attention.py:108, launched by
// `decode_attend` at :169 through `_common_wiring` at :150).
//
//   q   [S, H, Dh] fp32      one query row per (slot, head)
//   k,v [S, T, H, Dh] fp32   the layer's slice of the slot-pool cache
//   pos [S] int32            slot s attends to t <= pos[s]
//   out [S, H, Dh] fp32
//
// Semantics (those of the TPU kernel): f32 scores times `scale`, online
// softmax in f32, weighted sum of v in f32. pos[s] < 0 gives an all-zero
// row; pos[s] >= T attends to all T rows (free slots carry stale
// positions).
//
// Bound: memory. Each call must read the attended cache rows once,
// sum_s min(pos[s]+1, T) * H * Dh * 4 bytes of k and as many of v, and
// does 4 flops per element read, far below the card's ~20 flops per
// byte in fp32. The design therefore reads every attended row exactly
// once and never touches rows above pos[s]: no score tensor goes to
// device memory, and the softmax state lives in registers.
//
// Design: one block per (slot, head); the TPU kernel's sequential t grid
// axis becomes a loop inside the block. Each of the block's warps
// strides over t (warp w takes t = w, w + kWarps, ...) and keeps its
// own online-softmax state (m, l, acc); lanes stride over Dh, so any
// Dh <= 256 works. The warps' states are merged through shared memory
// in a fixed order, so the result is deterministic and needs no
// atomics. Splitting t across blocks for short pools, vector loads and
// TMA are left for later.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxDh = 256;

template <int NCH>  // NCH = ceil(Dh / 32): head elements per lane
__global__ void __launch_bounds__(kWarps * 32)
decode_attend_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ pos,
                     float* __restrict__ out,
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
  const size_t row = (size_t)H * Dh;  // stride between consecutive t
  const float* kb = k + ((size_t)s * T * H + h) * Dh;
  const float* vb = v + ((size_t)s * T * H + h) * Dh;
  for (int t = warp; t < n; t += kWarps) {
    const float* kr = kb + (size_t)t * row;
    const float* vr = vb + (size_t)t * row;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) part = fmaf(qr[c], kr[d], part);
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
      acc[c] = acc[c] * alpha + (d < Dh ? pw * vr[d] : 0.f);
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

template <int NCH>
void launch(const float* q, const float* k, const float* v, const int* pos,
            float* out, int S, int T, int H, int Dh, float scale,
            cudaStream_t stream) {
  decode_attend_kernel<NCH><<<dim3((unsigned)S * (unsigned)H),
                              dim3(kWarps * 32), 0, stream>>>(
      q, k, v, pos, out, T, H, Dh, scale);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int ptt_decode_attend_f32(const float* q, const float* k,
                                     const float* v, const int* pos,
                                     float* out, int S, int T, int H,
                                     int Dh, float scale, void* stream) {
  if (S < 1 || T < 1 || H < 1 || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((Dh + 31) / 32) {
    case 1: launch<1>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 2: launch<2>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 3: launch<3>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 4: launch<4>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 5: launch<5>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 6: launch<6>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    case 7: launch<7>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
    default: launch<8>(q, k, v, pos, out, S, T, H, Dh, scale, st); break;
  }
  return (int)cudaGetLastError();
}
