// Blockwise absmax int8 quantize, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_quant_kernel`
// (paddle_tpu/ops/kern/quant.py:79, launched by `quantize_int8_pallas`
// at :89).
//
//   x      [nb * bs] fp32   flat input, nb blocks of bs elements
//   codes  [nb, bs] int8    clip(round_half_even(x / safe), -127, 127)
//   scales [nb, 1] fp32     absmax / 127, the raw scale: 0 for an
//                           all-zero block, whose divisor `safe` is 1
//
// The arithmetic is the reference's, step for step, so codes and scales
// are bit-identical to the plain version: absmax is an exact max of
// exact absolute values; the scale and each code's quotient are IEEE
// round-to-nearest divisions (__fdiv_rn, so no build flag can turn them
// into a reciprocal multiply, which moves codes at rounding boundaries);
// rintf rounds half to even as jnp.round and torch.round do (roundf
// would round half away from zero). A NaN in a block propagates as in
// the reference's max: the absmax, and so the block's scale, is NaN
// (fmaxf would drop it). The codes of such a block come from casting a
// NaN quotient to int8, which is implementation-defined in the
// reference too; here they are -127.
//
// Bound: memory, and launch at the decode path's sizes. A call reads
// 4 bytes and writes 1 byte per element plus 4 bytes per block, with a
// handful of operations per element. The design reads each element once
// into registers (absmax, scale and codes in one pass) and writes each
// output once.
//
// Design: one warp per block (the TPU kernel's row of a row tile), 8
// warps per thread block. Lanes stride over the block, holding NCH =
// ceil(bs / 32) elements each in registers (NCH rounded up to a power of
// two, up to 32: bs <= kMaxBlock = 1024), and the absmax is reduced with
// an xor butterfly, so every lane holds the same scale.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxBlock = 1024;

// max that keeps a NaN from either side, as jnp.max and torch.amax do
__device__ __forceinline__ float max_nan(float m, float a) {
  return (a > m || a != a) ? a : m;
}

template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                float* __restrict__ scales, int nb, int bs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= nb) return;
  const float* xb = x + (size_t)b * bs;
  float v[NCH];
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = lane + 32 * c;
    v[c] = d < bs ? xb[d] : 0.f;
    m = max_nan(m, fabsf(v[c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = __fdiv_rn(m, 127.0f);
  const float safe = s == 0.f ? 1.f : s;
  int8_t* cb = codes + (size_t)b * bs;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = lane + 32 * c;
    if (d < bs) {
      const float r = rintf(__fdiv_rn(v[c], safe));
      cb[d] = (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
    }
  }
  if (lane == 0) scales[b] = s;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int ptt_quantize_int8(const float* x, int8_t* codes,
                                 float* scales, int nb, int bs,
                                 void* stream) {
  if (nb < 1 || bs < 1 || bs > kMaxBlock) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nb + kWarps - 1) / kWarps)),
      block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int nch = (bs + 31) / 32;
  if (nch <= 1)
    quantize_kernel<1><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  else if (nch <= 2)
    quantize_kernel<2><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  else if (nch <= 4)
    quantize_kernel<4><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  else if (nch <= 8)
    quantize_kernel<8><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  else if (nch <= 16)
    quantize_kernel<16><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  else
    quantize_kernel<32><<<grid, block, 0, st>>>(x, codes, scales, nb, bs);
  return (int)cudaGetLastError();
}
