// Kernel A: flash attention for the CFM estimator, softmax(scale*QK^T + bias)V.
//
// Replaces the JAX package's Pallas kernels in cosy_tpu/ops/flash_attention.py:
// the one-tile kernel (_make_one_tile_kernel, :76, called by
// _one_tile_attention :113 for S <= 1152), its q-blocked variant (the same
// kernel up to S = 8192) and the streaming online-softmax kernel
// (_make_kernel, :30, S > 8192).  Those three existed because a TPU core has
// to fit whole score tiles in VMEM; here one kernel serves every S.
//
// Semantics (identical to the Pallas kernels):
//   s = (q . k) * scale in f32; s += bias[b, t, s] (shared across heads);
//   keys at s >= k_valid[b] are REPLACED by -1e10 after the bias;
//   o = sum_s softmax(s) v, denominator clamped at max(l, 1e-30);
//   the probabilities are rounded to the input type before the PV product
//   (p.astype(v.dtype) in the Pallas kernel), accumulation is f32.
// The running max starts at -1e10, not -inf, so a fully masked row gives the
// finite uniform average the reference gives (with -inf it would be NaN).
// Ragged T and S edges are masked here: rows t >= T are not written and keys
// s >= S are excluded outright (p = 0), so the caller pads nothing.
//
// What bounds it on an H100: at the estimator's shapes (d = 64, T = S = 200
// to 2 600, B*H = 16) the work is 4*B*H*T*S*d flops against (3+1)*B*H*T*d
// elements of q/k/v/out plus the B*T*S bias, i.e. operations, not bytes.
// This first version computes on the CUDA cores in f32 (peak 67 TFLOP/s),
// not on the tensor cores: one block per (b, h, 64-row q tile), K/V streamed
// through shared memory in 32-key tiles with an online softmax, 4x4 register
// tiles for QK^T and 8x4 for PV.  Nothing is written to device memory but
// the output; the score tile never leaves shared memory.  wgmma/TMA tiles
// are later work.
//
// Kernel C: banded (windowed) self-attention, the kBanded instantiation of the
// same kernel.  Replaces the Pallas kernel of banded_attention
// (cosy_tpu/ops/flash_attention.py:313, kernel _make_banded_kernel :275): a
// query attends keys with |t - s| <= window and s < k_valid[b]; no bias;
// S == T.  The TPU kernel loads three Bq-wide key tiles (previous, own, next)
// per query block, because a block spec names whole tiles, and masks the rest
// by position.  Here a block walks only the keys of
// [q0 - window, q0 + 63 + window] & [0, min(T, k_valid[b])) in 32-key tiles,
// so no clamped duplicate tile exists and no fully masked tile is loaded; a
// key inside the walked range but outside a row's band has its score
// REPLACED by -1e10, as in the Pallas kernel.  The walk shortens the work to
// 4*B*H*T*(2*window+1)*d flops, still bound by operations on the CUDA cores.
// A row with no admissible key (t >= k_valid[b] + window, discarded by the
// caller) gives the finite average over the keys its block walked, or 0 when
// the block walked none; the Pallas kernel averages over its three padded
// tiles there.
#include "common.cuh"

namespace cosy {
namespace {

constexpr int kBQ = 64;    // q rows per block
constexpr int kBKV = 32;   // keys per shared-memory tile
constexpr int kThreads = 128;

struct Strides {  // element strides of the (b, h, t) axes; d is contiguous
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

template <typename T, int D, bool kBanded>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ bias,
                       const int* __restrict__ k_valid, T* __restrict__ out,
                       int H, int Tq, int S, Strides st, float scale, int window) {
  static_assert(D == 64, "thread mapping assumes a head dim of 64");
  __shared__ float Qs[kBQ][D + 1];
  __shared__ float Ks[kBKV][D + 1];
  __shared__ __align__(16) float Vs[kBKV][D];
  __shared__ float Ps[kBQ][kBKV + 1];
  __shared__ float alpha_s[kBQ];
  __shared__ float l_s[kBQ];

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int kv = k_valid != nullptr ? k_valid[b] : S;
  // keys this block walks: all of [0, S), or the band's reach of this q tile
  // cut at the valid keys (global positions; no overflow for window <= S)
  const int s_begin = kBanded ? max(0, q0 - window) : 0;
  const int s_end = kBanded ? min(min(S, kv), q0 + kBQ + window) : S;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const T* bp = bias != nullptr ? bias + (long long)b * Tq * S : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    Qs[r][c] = t < Tq ? to_f(qp[t * st.qt + c]) : 0.f;
  }

  // scores: each thread owns a 4x4 tile of the 64x32 score block
  const int sr0 = (tid / 8) * 4, sc0 = (tid % 8) * 4;
  // softmax statistics: two threads per q row, 16 keys each
  const int row = tid >> 1, half = tid & 1;
  // PV: each thread owns an 8x4 tile of the 64x64 output block
  const int pr0 = (tid / 16) * 8, pc0 = (tid % 16) * 4;

  float m_run = kNegBias, l_run = 0.f;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += kBKV) {
    __syncthreads();  // Q is loaded / the previous tile's PV is done
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int r = i / D, c = i % D, s = s0 + r;
      float kk = 0.f, vv = 0.f;
      if (s < s_end) {
        kk = to_f(kp[s * st.kt + c]);
        vv = to_f(vp[s * st.vt + c]);
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[sr0 + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[sc0 + j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + sr0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + sc0 + j;
        float val;
        if (s >= s_end) {
          val = -INFINITY;  // not a key: excluded, never averaged in
        } else {
          val = sc[i][j] * scale;
          if (bp != nullptr && t < Tq) val += to_f(bp[(long long)t * S + s]);
          if (s >= kv) val = kNegBias;
          if (kBanded && abs(t - s) > window) val = kNegBias;
        }
        Ps[sr0 + i][sc0 + j] = val;
      }
    }
    __syncthreads();

    // online softmax over this tile; m_run starts finite, so exp never sees
    // (-inf) - (-inf)
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, Ps[row][half * 16 + j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(Ps[row][half * 16 + j] - m_new);
      sum += p;
      Ps[row][half * 16 + j] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (half == 0) alpha_s[row] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = alpha_s[pr0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[kk][pc0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = Ps[pr0 + i][kk];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

  if (half == 0) l_s[row] = l_run;
  __syncthreads();
  T* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + pr0 + i;
    if (t >= Tq) continue;
    const float l = fmaxf(l_s[pr0 + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) op[t * st.ot + pc0 + j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, bool kBanded>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const int* k_valid, void* out, int B, int H, int Tq, int S,
                   const Strides& st, float scale, int window, cudaStream_t stream) {
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, 64, kBanded><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), k_valid, static_cast<T*>(out), H, Tq, S, st, scale,
      window);
  return cudaGetLastError();
}

template <bool kBanded>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* bias,
             const int* k_valid, void* out, int B, int H, int T, int S, int d,
             const long long* strides, float scale, int window, void* stream) {
  if (d != 64 || B <= 0 || H <= 0 || T <= 0 || S <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = launch<float, kBanded>(q, k, v, bias, k_valid, out, B, H, T, S, st, scale,
                                 window, s);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16, kBanded>(q, k, v, bias, k_valid, out, B, H, T, S, st,
                                         scale, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace cosy

// q/k/v/out: (B, H, T|S, d) views given by element strides (12 values:
// q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t), d contiguous.
// bias: contiguous (B, T, S) of the input type, or null.  k_valid: (B,)
// int32 on the device, or null (= S).  Returns a cudaError_t code.
extern "C" int cosy_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const int* k_valid, void* out, int B, int H,
                                    int T, int S, int d, const long long* strides,
                                    float scale, void* stream) {
  return cosy::dispatch<false>(dtype, q, k, v, bias, k_valid, out, B, H, T, S, d,
                               strides, scale, 0, stream);
}

// Kernel C.  q/k/v/out as above with S == T; no bias; a key is admitted when
// |t - s| <= window and s < k_valid[b] (k_valid null = T).  ``window`` is
// clamped to T (every key in reach), which keeps the position arithmetic in
// int range.  Returns a cudaError_t code.
extern "C" int cosy_banded_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* k_valid, void* out,
                                     int B, int H, int T, int d,
                                     const long long* strides, float scale,
                                     int window, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  return cosy::dispatch<true>(dtype, q, k, v, nullptr, k_valid, out, B, H, T, T, d,
                              strides, scale, window < T ? window : T, stream);
}
