// Fused embedding lookup + pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pool_kernel`
// (paddle_tpu/ops/pallas/embedding.py:78, launched by `_fwd` at :100
// through `pallas_call` at :123).
//
//   table [C, D] fp32, row-major
//   inv   [R, F] int32 or int64; a negative entry is padding
//   w     [R, F] fp32, or null (every weight 1)
//   out   [R, D] fp32:
//         out[r] = sum over f with inv[r, f] >= 0 of w[r, f] * table[i]
//         with i = min(inv[r, f], C - 1); with `mean`, divided by
//         max(number of such f, 1)
//
// Arithmetic, which the plain version (ops/kern/embedding.py
// `lookup_pool_plain`) repeats bit for bit: each position's contribution
// is the row, or __fmul_rn(w, row) with weights, or 0 for padding; the
// sum starts from the contribution of f = 0 and adds the others in order
// f = 1 .. F-1 with __fadd_rn (no contraction into an fma), so it repeats
// bit for bit and a one-field gather (the sharded engine's F = 1 call) is
// an exact copy of its rows; the mean is an IEEE division (__fdiv_rn, so
// no build flag turns it into a reciprocal multiply). A padding position
// reads nothing, so a NaN in the table reaches only the rows that look
// it up. (The TPU kernel's one-hot product multiplies every table row,
// a NaN one too, by the weighted counts, and spreads a NaN anywhere in
// the table to every output row.)
//
// Bound: memory. A call reads the F looked-up rows of each output row
// (D x 4 bytes each), the indices and weights once, and writes R x D x 4
// bytes; it does one multiply and one add per element read. The TPU
// kernel holds the whole table in VMEM and gathers with a one-hot
// [R, C] x [C, D] matrix product, and refuses tables over 1.5 M
// elements. Hopper has no such buffer and needs none: this is a direct
// gather from HBM, whatever the table's size (row offsets are 64-bit:
// an id times D passes 2^31 for a 1e8-row table).
//
// Design: one thread per (output row, group of VEC columns). VEC is 4
// where D is a multiple of 4 and the table and output are 16-byte
// aligned (a D = 8 or 16 row is 2 or 4 threads' 16-byte loads), else 1,
// so the engine's first-order table (D = 1) still fills whole warps with
// one row a thread. Neighbouring threads own neighbouring columns of a
// row, then the next rows, so a warp's stores are contiguous. Each
// thread loops over the F fields itself (reading the row's indices,
// which its neighbours read too, from L1), so there is no reduction
// across threads and no atomic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_row(const float* __restrict__ p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = __ldg(p + k);
  }
  return r;
}

template <typename IdxT, int VEC, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
lookup_pool_kernel(const float* __restrict__ table,
                   const IdxT* __restrict__ inv, const float* __restrict__ w,
                   float* __restrict__ out, long long R, int F, long long C,
                   int D, int mean) {
  const int groups = D / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= R * groups) return;
  const long long r = t / groups;
  const int c = (int)(t - r * groups) * VEC;
  const IdxT* ir = inv + r * F;
  float acc[VEC] = {};
  int count = 0;
  for (int f = 0; f < F; ++f) {
    const long long id = (long long)ir[f];
    float v[VEC];
    if (id >= 0) {
      const long long row = id < C ? id : C - 1;
      const Vec<VEC> x = load_row<VEC>(table + row * D + c);
      if constexpr (HAS_W) {
        const float wf = __ldg(w + r * F + f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(wf, x.v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = x.v[k];
      }
      ++count;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = f == 0 ? v[k] : __fadd_rn(acc[k], v[k]);
  }
  if (mean) {
    const float d = (float)(count > 1 ? count : 1);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], d);
  }
  float* o = out + r * D + c;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = acc[k];
  }
}

template <typename IdxT, int VEC>
void launch_w(const float* table, const void* inv, const float* w,
              float* out, long long R, int F, long long C, int D, int mean,
              cudaStream_t st) {
  const long long n = R * (D / VEC);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  const IdxT* ip = static_cast<const IdxT*>(inv);
  if (w)
    lookup_pool_kernel<IdxT, VEC, true><<<grid, block, 0, st>>>(
        table, ip, w, out, R, F, C, D, mean);
  else
    lookup_pool_kernel<IdxT, VEC, false><<<grid, block, 0, st>>>(
        table, ip, w, out, R, F, C, D, mean);
}

template <typename IdxT>
void launch_idx(const float* table, const void* inv, const float* w,
                float* out, long long R, int F, long long C, int D,
                int mean, int vec4, cudaStream_t st) {
  if (vec4)
    launch_w<IdxT, 4>(table, inv, w, out, R, F, C, D, mean, st);
  else
    launch_w<IdxT, 1>(table, inv, w, out, R, F, C, D, mean, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `inv_is_64` picks int64 over
// int32 indices; `w` may be null; `vec4` (the wrapper checks D % 4 == 0
// and 16-byte alignment) picks 16-byte loads. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int ptt_lookup_pool(const float* table, const void* inv,
                               int inv_is_64, const float* w, float* out,
                               long long R, int F, long long C, int D,
                               int mean, int vec4, void* stream) {
  if (R < 1 || F < 1 || C < 1 || D < 1 || (vec4 && D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long groups = vec4 ? D / 4 : D;
  if ((R * groups + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (inv_is_64)
    launch_idx<int64_t>(table, inv, w, out, R, F, C, D, mean, vec4, st);
  else
    launch_idx<int32_t>(table, inv, w, out, R, F, C, D, mean, vec4, st);
  return (int)cudaGetLastError();
}
