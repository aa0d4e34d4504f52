// Flash-attention forward (online softmax) in fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel`
// (paddle_tpu/ops/pallas/flash_attention.py:234, launched by `_fwd_call`
// at :284 through `pallas_call` at :297; wrapped there by
// `flash_attention` :638, `flash_attention_with_lse` :572 and
// `try_flash` :675).
//
//   q     [B, H, T, D]  fp32, read through element strides (b, h, t), so
//   k, v  [B, H, S, D], [B, H, S, DV]   both the "bthd" and the "bhtd"
//                       layout work without a transpose; the last dim
//                       is contiguous
//   bias  [Bb, S] fp32 or none: an additive per-key bias shared by every
//         head and query row (Bb = B, or 1 with a zero batch stride)
//   out   [B, H, T, DV] fp32 through its own strides
//   lse   [B, H, T] fp32: m + log(l), the per-row logsumexp
//
// Semantics (those of the TPU kernel): s = (q . k) * scale + bias[key];
// with `causal`, key > t + offset is masked to -1e30 (offset = S - T +
// causal_offset, a bottom-right diagonal), and key tiles wholly above
// the last row's diagonal are skipped; online softmax in f32 from
// m = -1e30, l = 0; out = acc / max(l, 1e-20), lse = m + log(max(l,
// 1e-20)). A row whose every key is masked is implementation-defined,
// as in the TPU kernel. Keys past S (the ragged tail tile) get weight 0.
//
// Bound: at the Transformer-base shapes (T = S = 128, D = 64), fp32
// operations: 4 T S D flops per (batch, head) against reading q, k, v
// and writing out once (about 31 flops per byte, above the card's ~20
// in fp32). The design never writes the [T, S] scores to device memory
// and reads each q, k and v element once per q tile from device memory.
//
// Design: one thread block of 8 warps per (batch x head, 64-row q tile);
// the TPU kernel's sequential key grid axis becomes a loop over 32-key
// tiles staged in shared memory. Each warp owns 8 query rows and keeps
// their m, l and output accumulators in registers; lane j scores key j
// of the tile against the warp's 8 rows at once (one 16-byte shared
// load of k feeds 32 fmas), then each row's max and sum are reduced by
// an xor butterfly and p is broadcast lane to lane for the p.v product,
// where each lane owns DV/32 output columns. fp32 fmas throughout (no
// TF32), and no atomics: results are deterministic. Tensor cores
// (wgmma), TMA and warp specialization are left for later.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                   // query rows per warp
constexpr int kBQ = kWarps * kRows;        // query rows per block
constexpr int kBK = 32;                    // keys per tile, one per lane
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;          // _NEG_INF of the TPU kernel

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st, bias_sb;
  int H, T, S, D, DV, causal, offset;
  float scale;
};

__host__ __device__ constexpr int round4(int d) { return (d + 3) & ~3; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NV: output columns per lane (DV <= 32 * NV)
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DV = p.DV;
  const int QS = round4(D);                // q row stride in shared memory
  const int KS = QS + 4;                   // k row stride: 16-byte rows
  constexpr int VS = 32 * NV;              // v row stride, zero-padded
  float* Qs = smem;                        // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;               // [kBK][KS]
  float* Vs = Ks + kBK * KS;               // [kBK][VS]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* bb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  for (int i = threadIdx.x; i < kBQ * QS; i += kWarps * 32) {
    const int r = i / QS, d = i - r * QS, t = q0 + r;
    Qs[i] = (t < p.T && d < D) ? qb[t * p.q_st + d] : 0.f;
  }
  // causal: key tiles past the last live row's diagonal never run
  int k_end = p.S;
  if (p.causal) {
    const int last = min(q0 + kBQ, p.T) - 1;
    k_end = min(p.S, last + p.offset + 1);
  }

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // the last tile is consumed
    for (int i = threadIdx.x; i < kBK * KS; i += kWarps * 32) {
      const int j = i / KS, d = i - j * KS, s = k0 + j;
      Ks[i] = (s < p.S && d < D) ? kb[s * p.k_st + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * VS; i += kWarps * 32) {
      const int j = i / VS, d = i - j * VS, s = k0 + j;
      Vs[i] = (s < p.S && d < DV) ? vb[s * p.v_st + d] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool live = key < p.S;
    const float bk = (live && bb) ? bb[key] : 0.f;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KS;
    const float* qrows = Qs + warp * kRows * QS;
    for (int d = 0; d < QS; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(qrows + r * QS + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = q0 + warp * kRows + r;
      float sr = s[r] * p.scale + bk;
      if (p.causal && key > t + p.offset) sr = kNegInf;
      if (!live) sr = -INFINITY;           // lane 0 is always live
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float pj = live ? expf(sr - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pj);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[r][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        const float* vrow = Vs + j * VS + lane;
#pragma unroll
        for (int c = 0; c < NV; ++c)
          acc[r][c] = fmaf(pb, vrow[32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= p.T) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    float* orow = p.out + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int dv = lane + 32 * c;
      if (dv < DV) orow[dv] = acc[r][c] / lc;
    }
    if (lane == 0) p.lse[(long long)bh * p.T + t] = m[r] + logf(lc);
  }
}

template <int NV>
int launch(const Params& p, int BH, cudaStream_t st) {
  const int QS = round4(p.D);
  const size_t smem =
      sizeof(float) * (size_t)(kBQ * QS + kBK * (QS + 4) + kBK * 32 * NV);
  // above 48 KB a block's shared memory must be asked for (D > ~90)
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)BH, (unsigned)((p.T + kBQ - 1) / kBQ));
  flash_fwd_kernel<NV><<<grid, kWarps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds 13 element
// strides: q (b, h, t), k (b, h, s), v (b, h, s), out (b, h, t) and the
// bias's batch stride; bias may be null. Launches on `stream` without
// synchronising and returns a cudaError_t (0 on success).
extern "C" int ptt_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, const float* bias,
                                       float* out, float* lse,
                                       const long long* strides, int B,
                                       int H, int T, int S, int D, int DV,
                                       int causal, int offset, float scale,
                                       void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 1 || D > kMaxD || DV < 1 ||
      DV > kMaxD || (long long)B * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.out = out; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.bias_sb = strides[12];
  p.H = H; p.T = T; p.S = S; p.D = D; p.DV = DV;
  p.causal = causal; p.offset = offset; p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (DV <= 32) return launch<1>(p, B * H, st);
  if (DV <= 64) return launch<2>(p, B * H, st);
  return launch<4>(p, B * H, st);
}
