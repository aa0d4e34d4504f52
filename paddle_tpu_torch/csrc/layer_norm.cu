// LayerNorm over the last axis, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel`
// (paddle_tpu/ops/pallas/layer_norm.py:67, launched by `_fwd` at :151
// through `pallas_call` at :157) and `_bwd_kernel` (:78, launched by
// `_bwd_vjp` at :176 through `pallas_call` at :182). The forward is
// described first; the backward follows it below.
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

// ---------------------------------------------------------------- backward
//
//   dy, x  [R, C] fp32; scale [C] fp32
//   dx     [R, C] fp32: rstd * (dx^ - mean(dx^) - x^ * mean(dx^ * x^))
//   dscale [C] = sum over rows of dy * x^, dbias [C] = sum of dy (f32)
//
// with the row's mean and rstd recomputed from x as the forward
// computes them (mean, then the mean of squared deviations), x^ =
// (x - mean) * rstd and dx^ = dy * scale: the TPU kernel's arithmetic.
//
// Bound: memory. A call reads dy and x once and writes dx once (3 x 4
// bytes an element, plus scale, dscale and dbias); about 20 flops an
// element. The design reads every element once into registers, keeps
// the row there for its four reductions and dx, and keeps the dscale /
// dbias column sums of the rows it handles in registers too.
//
// Stage 1 (layer_norm_bwd_kernel): the forward's row mapping (WPR warps
// a row, NPT elements a lane), in a grid of G blocks, each looping over
// rows (row r of the block's slot in turn r, r + G * rows-a-block, ...):
// G = min(ceil(rows / rows-a-block), max_blocks), chosen in launch_bwd
// beside the WPR dispatch; the caller's scratch holds max_blocks rows
// of partial sums. On the TPU,
// dscale and dbias accumulate across the sequential grid; here every
// block adds its rows' column sums, warp by warp in a fixed order through
// shared memory, and writes them as row blockIdx.x of `part` [2, G, C].
// Stage 2 (layer_norm_bwd_reduce): one block per 32 columns; warp w adds
// rows w, w + 8, ... of `part` in order, then warp 0 adds the 8 warp
// sums in order. No atomics: the result is deterministic.

// out[d] = the sum over the block's 8 warps, in warp order, of each
// warp's v[c] at column d = lane + 32 c (one warp a row, WPR == 1)
template <int NPT>
__device__ __forceinline__ void block_column_sum(const float (&v)[NPT],
                                                 float* cols, float* out,
                                                 int C, int warp,
                                                 int lane) {
#pragma unroll
  for (int c = 0; c < NPT; ++c) {
    const int d = lane + 32 * c;
    if (d < C) cols[warp * C + d] = v[c];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < C; d += kWarps * 32) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += cols[w * C + d];
    out[d] = sum;
  }
  __syncthreads();
}

template <int WPR, int NPT>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_bwd_kernel(const float* __restrict__ dy,
                      const float* __restrict__ x,
                      const float* __restrict__ scale,
                      float* __restrict__ dx, float* __restrict__ part,
                      int rows, int C, float eps) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  extern __shared__ float cols[];        // [kWarps][C] when WPR == 1
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rloc = warp / WPR;
  const int wr = warp % WPR;
  const int t = wr * 32 + lane;
  float ps[NPT], pb[NPT];
#pragma unroll
  for (int c = 0; c < NPT; ++c) ps[c] = pb[c] = 0.f;

  // every warp of a block runs the same iterations: the barriers of
  // row_sum (WPR > 1) stay matched
  for (int row0 = blockIdx.x * kRowsPerBlock; row0 < rows;
       row0 += gridDim.x * kRowsPerBlock) {
    const int row = row0 + rloc;
    const bool live = row < rows;
    const size_t base = (size_t)(live ? row : 0) * C;
    float xv[NPT], g[NPT];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int d = t + 32 * WPR * c;
      const bool in = live && d < C;
      xv[c] = in ? x[base + d] : 0.f;
      g[c] = in ? dy[base + d] : 0.f;
      s += xv[c];
    }
    const float mean = row_sum<WPR>(s, red, wr, lane, rloc) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int d = t + 32 * WPR * c;
      xv[c] = d < C ? xv[c] - mean : 0.f;
      q += xv[c] * xv[c];
    }
    const float var = row_sum<WPR>(q, red, wr, lane, rloc) / (float)C;
    const float rstd = rsqrtf(var + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int d = t + 32 * WPR * c;
      xv[c] *= rstd;                       // x^
      ps[c] += g[c] * xv[c];
      pb[c] += g[c];
      g[c] *= d < C ? scale[d] : 0.f;      // dx^
      s1 += g[c];
      s2 += g[c] * xv[c];
    }
    const float m1 = row_sum<WPR>(s1, red, wr, lane, rloc) / (float)C;
    const float m2 = row_sum<WPR>(s2, red, wr, lane, rloc) / (float)C;
    if (live) {
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const int d = t + 32 * WPR * c;
        if (d < C) dx[base + d] = rstd * (g[c] - m1 - xv[c] * m2);
      }
    }
  }

  float* ps_out = part + (size_t)blockIdx.x * C;
  float* pb_out = ps_out + (size_t)gridDim.x * C;
  if (WPR > 1) {              // one row a block: each thread owns columns
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int d = t + 32 * WPR * c;
      if (d < C) {
        ps_out[d] = ps[c];
        pb_out[d] = pb[c];
      }
    }
    return;
  }
  // eight rows a block: add the warps' column sums in warp order
  block_column_sum<NPT>(ps, cols, ps_out, C, warp, lane);
  block_column_sum<NPT>(pb, cols, pb_out, C, warp, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
layer_norm_bwd_reduce(const float* __restrict__ part,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      int G, int C) {
  __shared__ float rs[kWarps][32], rb[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * 32 + lane;
  float s = 0.f, b = 0.f;
  if (d < C) {
    for (int g = warp; g < G; g += kWarps) {
      s += part[(size_t)g * C + d];
      b += part[((size_t)G + g) * C + d];
    }
  }
  rs[warp][lane] = s;
  rb[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && d < C) {
    float ts = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += rs[w][lane];
      tb += rb[w][lane];
    }
    dscale[d] = ts;
    dbias[d] = tb;
  }
}

template <int WPR, int NPT>
int launch_bwd(const float* dy, const float* x, const float* scale,
               float* dx, float* part, float* dscale, float* dbias,
               int rows, int C, float eps, int max_blocks,
               cudaStream_t st) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  const int need = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int G = need < max_blocks ? need : max_blocks;
  const size_t smem = WPR == 1 ? sizeof(float) * kWarps * (size_t)C : 0;
  layer_norm_bwd_kernel<WPR, NPT><<<G, kWarps * 32, smem, st>>>(
      dy, x, scale, dx, part, rows, C, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  layer_norm_bwd_reduce<<<(C + 31) / 32, kWarps * 32, 0, st>>>(
      part, dscale, dbias, G, C);
  return (int)cudaGetLastError();
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

// Plain C entry point of the backward, loaded with ctypes: dy, x, dx
// fp32 [rows, C]; part [2, max_blocks, C] f32 scratch for stage 1's
// partial sums (stage 1 runs at most max_blocks blocks); dscale, dbias
// [C] f32. Launches both
// stages on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int ptt_layer_norm_bwd(const float* dy, const float* x,
                                  const float* scale, float* dx,
                                  float* part, float* dscale, float* dbias,
                                  int rows, int C, float eps,
                                  int max_blocks, void* stream) {
  if (rows < 1 || C < 1 || C > kMaxC || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 32)
    return launch_bwd<1, 1>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                            eps, max_blocks, st);
  if (C <= 64)
    return launch_bwd<1, 2>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                            eps, max_blocks, st);
  if (C <= 128)
    return launch_bwd<1, 4>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                            eps, max_blocks, st);
  if (C <= 256)
    return launch_bwd<1, 8>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                            eps, max_blocks, st);
  if (C <= 512)
    return launch_bwd<1, 16>(dy, x, scale, dx, part, dscale, dbias, rows,
                             C, eps, max_blocks, st);
  if (C <= 1024)
    return launch_bwd<1, 32>(dy, x, scale, dx, part, dscale, dbias, rows,
                             C, eps, max_blocks, st);
  if (C <= 2048)
    return launch_bwd<8, 8>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                            eps, max_blocks, st);
  if (C <= 4096)
    return launch_bwd<8, 16>(dy, x, scale, dx, part, dscale, dbias, rows,
                             C, eps, max_blocks, st);
  return launch_bwd<8, 32>(dy, x, scale, dx, part, dscale, dbias, rows, C,
                           eps, max_blocks, st);
}
