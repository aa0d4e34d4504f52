// Flash attention in fp32 for Hopper (sm_90a): the forward (online
// softmax) and the two backward kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (:234, launched by `_fwd_call` at :284 through
// `pallas_call` at :297), `_dq_kernel` (:331) and `_dkv_kernel` (:366),
// both launched by `_bwd_call` (:418, `pallas_call` at :437 and :471);
// wrapped there by `flash_attention` :638, `flash_attention_with_lse`
// :572 and `try_flash` :675. The forward is described first; the
// backward kernels follow it below.
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

// ---------------------------------------------------------------- backward
//
// Both backward kernels recompute the probabilities from the forward's
// lse, as the TPU kernels do: s = (q . k) * scale + bias[key], masked to
// -1e30 past the causal diagonal, p = exp(s - lse[row]); with dp = dO . v
// and delta[row] = rowsum(dO * O) less the lse cotangent (computed by the
// wrapper), ds = p * (dp - delta). Then
//
//   dq = (sum over keys of ds * k) * scale          (flash_dq_kernel)
//   dv = sum over rows of p * dO,
//   dk = (sum over rows of ds * q) * scale,
//   db[bh, key] = sum over rows of ds               (flash_dkv_kernel)
//
// with the inputs read through the forward's strides (either layout),
// dO through its own, lse and delta [B*H, T] f32, and dq, dk, dv written
// through theirs. Keys past S and rows past T weigh 0.
//
// Bound: fp32 operations, as the forward's: dq does 3 products of
// T x S x D per (batch, head) (scores, dp, ds . k), about 6 T S D flops,
// and dk/dv 4 (scores, dp, p^T dO, ds^T q), about 8 T S D flops, against
// reading q, k, v, dO and writing one or two outputs of the same size.
// Neither kernel writes the [T, S] scores to device memory.
//
// flash_dq_kernel: the forward's layout with the roles of the forward's
// p.v product taken by ds.k. One block of 8 warps per (batch x head,
// 64-row q tile); the TPU's sequential key grid axis becomes a loop
// over 32-key tiles of k and v staged in shared memory. Each warp owns
// 8 rows and keeps their dq accumulators in registers (each lane D/32
// columns); lane j computes key j's score and dp for the warp's 8 rows
// from 16-byte shared loads (k and v rows padded by 4 floats, so the 32
// lanes' loads fall in distinct banks), then ds is broadcast lane to
// lane for the ds.k product.
//
// flash_dkv_kernel: the transpose. One block of 8 warps per (batch x
// head, 64-key tile); a loop over 32-row tiles of q and dO (with their
// lse and delta) in shared memory, starting at the first tile whose
// rows see a key of the block under the causal mask (tiles above the
// diagonal are skipped). Each warp owns 8 keys and keeps their dk and
// dv accumulators and bias-gradient sums in registers; lane i computes
// row i's score and dp for the warp's 8 keys, then p and ds are
// broadcast lane to lane for the p^T dO and ds^T q products. The bias
// gradient of a key is a warp sum (xor butterfly) per row tile, added
// tile after tile in order: no atomics, so every result is
// deterministic. Tensor cores are left for later, as in the forward.

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  float* db;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;              // dO
  long long g_sb, g_sh, g_st;              // dq, or dk
  long long w_sb, w_sh, w_st;              // dv
  long long bias_sb;
  int H, T, S, D, DV, causal, offset;
  float scale;
};

constexpr int kKeysPerWarp = 8;
constexpr int kBKV = kWarps * kKeysPerWarp;   // keys per dk/dv block
constexpr int kBQ2 = 32;                      // q rows per tile, one a lane

// ND: dq columns per lane (D <= 32 * ND)
template <int ND>
__global__ void __launch_bounds__(kWarps * 32)
flash_dq_kernel(const BwdParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DV = p.DV;
  const int QS = round4(D), OS = round4(DV);
  const int KS = QS + 4, VS = OS + 4;       // lane-strided 16-byte rows
  float* Qs = smem;                        // [kBQ][QS]
  float* Os = Qs + kBQ * QS;               // [kBQ][OS]  dO
  float* Ks = Os + kBQ * OS;               // [kBK][KS]
  float* Vs = Ks + kBK * KS;               // [kBK][VS]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* bb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  for (int i = threadIdx.x; i < kBQ * QS; i += kWarps * 32) {
    const int r = i / QS, d = i - r * QS, t = q0 + r;
    Qs[i] = (t < p.T && d < D) ? qb[t * p.q_st + d] : 0.f;
  }
  for (int i = threadIdx.x; i < kBQ * OS; i += kWarps * 32) {
    const int r = i / OS, d = i - r * OS, t = q0 + r;
    Os[i] = (t < p.T && d < DV) ? ob[t * p.o_st + d] : 0.f;
  }
  float lse[kRows], dl[kRows], acc[kRows][ND];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    const long long at = (long long)bh * p.T + t;
    lse[r] = t < p.T ? p.lse[at] : 0.f;
    dl[r] = t < p.T ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  }
  int k_end = p.S;
  if (p.causal) {
    const int last = min(q0 + kBQ, p.T) - 1;
    k_end = min(p.S, last + p.offset + 1);
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
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* krow = Ks + lane * KS;
    const float* vrow = Vs + lane * VS;
    const float* qrows = Qs + warp * kRows * QS;
    const float* orows = Os + warp * kRows * OS;
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
    for (int d = 0; d < OS; d += 4) {
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 oo =
            *reinterpret_cast<const float4*>(orows + r * OS + d);
        dp[r] = fmaf(oo.x, vv.x, dp[r]);
        dp[r] = fmaf(oo.y, vv.y, dp[r]);
        dp[r] = fmaf(oo.z, vv.z, dp[r]);
        dp[r] = fmaf(oo.w, vv.w, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = q0 + warp * kRows + r;
      float sr = s[r] * p.scale + bk;
      if (p.causal && key > t + p.offset) sr = kNegInf;
      const float pj = live ? expf(sr - lse[r]) : 0.f;
      const float ds = pj * (dp[r] - dl[r]);
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float dsb = __shfl_sync(0xffffffffu, ds, j);
        const float* kj = Ks + j * KS + lane;
#pragma unroll
        for (int c = 0; c < ND; ++c)
          if (lane + 32 * c < D) acc[r][c] = fmaf(dsb, kj[32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= p.T) continue;
    float* grow = p.dq + b * p.g_sb + h * p.g_sh + t * p.g_st;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) grow[d] = acc[r][c] * p.scale;
    }
  }
}

// NC: dk and dv columns per lane (D, DV <= 32 * NC)
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_dkv_kernel(const BwdParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DV = p.DV;
  const int KS = round4(D), VS = round4(DV);   // broadcast reads
  const int QS = KS + 4, OS = VS + 4;          // lane-strided 16-byte rows
  float* Ks = smem;                        // [kBKV][KS]
  float* Vs = Ks + kBKV * KS;              // [kBKV][VS]
  float* Qs = Vs + kBKV * VS;              // [kBQ2][QS]
  float* Os = Qs + kBQ2 * QS;              // [kBQ2][OS]  dO
  float* Ls = Os + kBQ2 * OS;              // [kBQ2] lse
  float* Dl = Ls + kBQ2;                   // [kBQ2] delta

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int k0 = blockIdx.y * kBKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* bb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  for (int i = threadIdx.x; i < kBKV * KS; i += kWarps * 32) {
    const int j = i / KS, d = i - j * KS, s = k0 + j;
    Ks[i] = (s < p.S && d < D) ? kb[s * p.k_st + d] : 0.f;
  }
  for (int i = threadIdx.x; i < kBKV * VS; i += kWarps * 32) {
    const int j = i / VS, d = i - j * VS, s = k0 + j;
    Vs[i] = (s < p.S && d < DV) ? vb[s * p.v_st + d] : 0.f;
  }
  float bk[kKeysPerWarp], db[kKeysPerWarp];
  float dk[kKeysPerWarp][NC], dv[kKeysPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r) {
    const int key = k0 + warp * kKeysPerWarp + r;
    bk[r] = (key < p.S && bb) ? bb[key] : 0.f;
    db[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  // causal: row t sees key s iff s <= t + offset, so the rows before
  // k0 - offset see none of this block's keys
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - p.offset) / kBQ2 * kBQ2;

  for (int q0 = q_begin; q0 < p.T; q0 += kBQ2) {
    __syncthreads();                       // the last tile is consumed
    for (int i = threadIdx.x; i < kBQ2 * QS; i += kWarps * 32) {
      const int r = i / QS, d = i - r * QS, t = q0 + r;
      Qs[i] = (t < p.T && d < D) ? qb[t * p.q_st + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kBQ2 * OS; i += kWarps * 32) {
      const int r = i / OS, d = i - r * OS, t = q0 + r;
      Os[i] = (t < p.T && d < DV) ? ob[t * p.o_st + d] : 0.f;
    }
    if (threadIdx.x < kBQ2) {
      const int t = q0 + threadIdx.x;
      const long long at = (long long)bh * p.T + t;
      Ls[threadIdx.x] = t < p.T ? p.lse[at] : 0.f;
      Dl[threadIdx.x] = t < p.T ? p.delta[at] : 0.f;
    }
    __syncthreads();

    const int t = q0 + lane;
    const bool row_live = t < p.T;
    float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
    for (int r = 0; r < kKeysPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qrow = Qs + lane * QS;
    const float* orow = Os + lane * OS;
    const float* keys = Ks + warp * kKeysPerWarp * KS;
    const float* vals = Vs + warp * kKeysPerWarp * VS;
    for (int d = 0; d < KS; d += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int r = 0; r < kKeysPerWarp; ++r) {
        const float4 kk =
            *reinterpret_cast<const float4*>(keys + r * KS + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    for (int d = 0; d < VS; d += 4) {
      const float4 oo = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
      for (int r = 0; r < kKeysPerWarp; ++r) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vals + r * VS + d);
        dp[r] = fmaf(oo.x, vv.x, dp[r]);
        dp[r] = fmaf(oo.y, vv.y, dp[r]);
        dp[r] = fmaf(oo.z, vv.z, dp[r]);
        dp[r] = fmaf(oo.w, vv.w, dp[r]);
      }
    }
    const float lse = Ls[lane], dl = Dl[lane];
#pragma unroll
    for (int r = 0; r < kKeysPerWarp; ++r) {
      const int key = k0 + warp * kKeysPerWarp + r;
      float sr = s[r] * p.scale + bk[r];
      if (p.causal && key > t + p.offset) sr = kNegInf;
      const float pi = row_live ? expf(sr - lse) : 0.f;
      const float ds = pi * (dp[r] - dl);
      db[r] += warp_sum(ds);
#pragma unroll 4
      for (int i = 0; i < kBQ2; ++i) {
        const float pb = __shfl_sync(0xffffffffu, pi, i);
        const float dsb = __shfl_sync(0xffffffffu, ds, i);
        const float* oi = Os + i * OS + lane;
        const float* qi = Qs + i * QS + lane;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (lane + 32 * c < DV) dv[r][c] = fmaf(pb, oi[32 * c], dv[r][c]);
          if (lane + 32 * c < D) dk[r][c] = fmaf(dsb, qi[32 * c], dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r) {
    const int key = k0 + warp * kKeysPerWarp + r;
    if (key >= p.S) continue;
    float* krow = p.dk + b * p.g_sb + h * p.g_sh + key * p.g_st;
    float* vrow = p.dv + b * p.w_sb + h * p.w_sh + key * p.w_st;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) krow[d] = dk[r][c] * p.scale;
      if (d < DV) vrow[d] = dv[r][c];
    }
    if (p.db && lane == 0) p.db[(long long)bh * p.S + key] = db[r];
  }
}

// Launch `kernel` on `grid` with `smem` bytes of dynamic shared memory,
// asking for more than the default 48 KB where it needs it.
template <typename Kernel>
int launch_with_smem(Kernel kernel, dim3 grid, size_t smem,
                     const BwdParams& p, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kWarps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_dq(const BwdParams& p, int BH, cudaStream_t st) {
  const int QS = round4(p.D), OS = round4(p.DV);
  const size_t smem = sizeof(float) * (size_t)(kBQ * (QS + OS) +
                                               kBK * (QS + 4 + OS + 4));
  const dim3 grid((unsigned)BH, (unsigned)((p.T + kBQ - 1) / kBQ));
  if (p.D <= 32) return launch_with_smem(flash_dq_kernel<1>, grid, smem, p, st);
  if (p.D <= 64) return launch_with_smem(flash_dq_kernel<2>, grid, smem, p, st);
  return launch_with_smem(flash_dq_kernel<4>, grid, smem, p, st);
}

int launch_dkv(const BwdParams& p, int BH, cudaStream_t st) {
  const int KS = round4(p.D), VS = round4(p.DV);
  const size_t smem = sizeof(float) * (size_t)(kBKV * (KS + VS) +
                                               kBQ2 * (KS + 4 + VS + 4) +
                                               2 * kBQ2);
  const dim3 grid((unsigned)BH, (unsigned)((p.S + kBKV - 1) / kBKV));
  const int wide = max(p.D, p.DV);
  if (wide <= 32) return launch_with_smem(flash_dkv_kernel<1>, grid, smem, p, st);
  if (wide <= 64) return launch_with_smem(flash_dkv_kernel<2>, grid, smem, p, st);
  return launch_with_smem(flash_dkv_kernel<4>, grid, smem, p, st);
}

bool bad_dims(int B, int H, int T, int S, int D, int DV) {
  return B < 1 || H < 1 || T < 1 || S < 1 || D < 1 || D > kMaxD || DV < 1 ||
         DV > kMaxD || (long long)B * H >= (1LL << 31);
}

BwdParams bwd_params(const float* q, const float* k, const float* v,
                     const float* bias, const float* dout, const float* lse,
                     const float* delta, const long long* st, int H, int T,
                     int S, int D, int DV, int causal, int offset,
                     float scale) {
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.dout = dout; p.lse = lse;
  p.delta = delta;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_st = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_st = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_st = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_st = st[11];
  p.g_sb = st[12]; p.g_sh = st[13]; p.g_st = st[14];
  p.H = H; p.T = T; p.S = S; p.D = D; p.DV = DV;
  p.causal = causal; p.offset = offset; p.scale = scale;
  return p;
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
  if (bad_dims(B, H, T, S, D, DV)) return (int)cudaErrorInvalidValue;
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

// Plain C entry points of the backward kernels, loaded with ctypes.
// `strides` holds the element strides (b, h, t) of q, k, v, dO and then
// dq (16 in all, the bias's batch stride last) for the dq kernel, or of
// q, k, v, dO, dk and dv (19, the bias's batch stride last) for the
// dk/dv kernel. bias and db may be null; db [B*H, S] is written only
// when given. Each launches on `stream` without synchronising and
// returns a cudaError_t (0 on success).
extern "C" int ptt_flash_attention_dq(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const float* dout, const float* lse,
                                      const float* delta, float* dq,
                                      const long long* strides, int B,
                                      int H, int T, int S, int D, int DV,
                                      int causal, int offset, float scale,
                                      void* stream) {
  if (bad_dims(B, H, T, S, D, DV)) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, bias, dout, lse, delta, strides, H, T,
                           S, D, DV, causal, offset, scale);
  p.dq = dq;
  p.bias_sb = strides[15];
  return launch_dq(p, B * H, (cudaStream_t)stream);
}

extern "C" int ptt_flash_attention_dkv(const float* q, const float* k,
                                       const float* v, const float* bias,
                                       const float* dout, const float* lse,
                                       const float* delta, float* dk,
                                       float* dv, float* db,
                                       const long long* strides, int B,
                                       int H, int T, int S, int D, int DV,
                                       int causal, int offset, float scale,
                                       void* stream) {
  if (bad_dims(B, H, T, S, D, DV)) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, bias, dout, lse, delta, strides, H, T,
                           S, D, DV, causal, offset, scale);
  p.dk = dk; p.dv = dv; p.db = db;
  p.w_sb = strides[15]; p.w_sh = strides[16]; p.w_st = strides[17];
  p.bias_sb = strides[18];
  return launch_dkv(p, B * H, (cudaStream_t)stream);
}
