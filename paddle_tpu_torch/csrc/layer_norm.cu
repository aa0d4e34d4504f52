// LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel`
// (paddle_tpu/ops/pallas/layer_norm.py:67, launched by `_fwd` at :151
// through `pallas_call` at :157).
//
//   x      [R, C] fp32 or bf16, row-major (any leading dims, flattened)
//   scale  [C] fp32, bias [C] fp32
//   y      [R, C] in x's dtype: (x - mean) * rsqrt(var + eps) * scale + bias
//   mean   [R] fp32, var [R] fp32 (biased: mean of (x - mean)^2)
//
// Semantics (those of the TPU kernel and of the op's composition): the
// row is read once, converted to f32, its mean taken, then its variance
// as the mean of squared deviations (two passes over registers, not
// E[x^2] - mean^2), and y computed in f32 in the order
// ((x - mean) * rstd) * scale + bias, then rounded to x's dtype (round
// to nearest even for bf16).
//
// Bound: memory. A call reads x once and writes y once, plus 2 x 4
// bytes of stats per row and the 2 x 4 C bytes of scale and bias; it
// does about 8 flops per element, far below the card's ~20 flops per
// byte in fp32. The design reads every element of x exactly once from
// device memory into registers and keeps the row there for both
// reductions and the output.
//
// Design: WPR warps own a row (one warp for C <= 1024, eight warps for
// C <= 8192, the stated limit kMaxC); each lane holds NPT elements of
// the row in registers at d = lane + 32 * WPR * c, so neighbouring lanes
// load neighbouring elements. A row's sums are reduced by an xor
// butterfly inside each warp and, for WPR > 1, through shared memory in
// a fixed order: results are deterministic and need no atomics. A
// thread block of 8 warps holds 8 / WPR rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxC = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red, int wr,
                                         int lane, int rloc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (WPR == 1) return v;
  // the row's WPR warp sums, added in warp order by every lane
  if (lane == 0) red[rloc * WPR + wr] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WPR; ++w) s += red[rloc * WPR + w];
  __syncthreads();
  return s;
}

template <typename T, int WPR, int NPT>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ var_out, int rows, int C,
                      float eps) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rloc = warp / WPR;          // row within the block
  const int wr = warp % WPR;            // warp within the row
  const int row = blockIdx.x * kRowsPerBlock + rloc;
  // rows past the end still join the block's barriers (WPR > 1)
  const bool live = row < rows;
  const T* xr = x + (size_t)(live ? row : 0) * C;
  const int t = wr * 32 + lane;         // thread within the row
  float v[NPT];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NPT; ++c) {
    const int d = t + 32 * WPR * c;
    v[c] = (live && d < C) ? to_f32(xr[d]) : 0.f;
    s += v[c];
  }
  const float mean = row_sum<WPR>(s, red, wr, lane, rloc) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < NPT; ++c) {
    const int d = t + 32 * WPR * c;
    v[c] = v[c] - mean;
    if (d < C) q += v[c] * v[c];
  }
  const float var = row_sum<WPR>(q, red, wr, lane, rloc) / (float)C;
  if (!live) return;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + (size_t)row * C;
#pragma unroll
  for (int c = 0; c < NPT; ++c) {
    const int d = t + 32 * WPR * c;
    if (d < C) store(yr + d, v[c] * rstd * scale[d] + bias[d]);
  }
  if (t == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <typename T, int WPR, int NPT>
void launch(const void* x, const float* scale, const float* bias, void* y,
            float* mean, float* var, int rows, int C, float eps,
            cudaStream_t st) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  layer_norm_fwd_kernel<T, WPR, NPT><<<grid, kWarps * 32, 0, st>>>(
      (const T*)x, scale, bias, (T*)y, mean, var, rows, C, eps);
}

template <typename T>
void dispatch(const void* x, const float* scale, const float* bias, void* y,
              float* mean, float* var, int rows, int C, float eps,
              cudaStream_t st) {
  if (C <= 32)
    launch<T, 1, 1>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 64)
    launch<T, 1, 2>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 128)
    launch<T, 1, 4>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 256)
    launch<T, 1, 8>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 512)
    launch<T, 1, 16>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 1024)
    launch<T, 1, 32>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 2048)
    launch<T, 8, 8>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else if (C <= 4096)
    launch<T, 8, 16>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else
    launch<T, 8, 32>(x, scale, bias, y, mean, var, rows, C, eps, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and y are bf16 when is_bf16
// is nonzero, else fp32. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int ptt_layer_norm_fwd(const void* x, const float* scale,
                                  const float* bias, void* y, float* mean,
                                  float* var, int rows, int C, float eps,
                                  int is_bf16, void* stream) {
  if (rows < 1 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    dispatch<__nv_bfloat16>(x, scale, bias, y, mean, var, rows, C, eps, st);
  else
    dispatch<float>(x, scale, bias, y, mean, var, rows, C, eps, st);
  return (int)cudaGetLastError();
}
