// Kernel B: the estimator's diffusers transformer block, as a chain of hand
// kernels: a row LayerNorm and a tiled GEMM with a fused epilogue.  Kernel A
// (flash_attention.cu) is the attention step between them.
//
// Replaces the JAX package's Pallas kernel cosy_tpu/ops/fused_block.py
// (_make_kernel :34, called by fused_transformer_block :95), which ran the
// whole block for one batch row with every intermediate in VMEM:
//   h  = LN1(x)                         (eps 1e-5, f32 stats, cast to the compute type)
//   q,k,v = h Wq^T, h Wk^T, h Wv^T       (f32 accumulation, cast)
//   a  = per-head softmax(scale q k^T + bias) v     -> kernel A
//   x1 = x + a Wo^T + bo                 (kept in f32)
//   f  = gelu_tanh(LN3(x1) W1^T + b1)    (cast)
//   y  = x1 + f W2^T + b2                (cast to x's type)
// A Hopper SM has 227 KB of shared memory, not the 16 MB of VMEM a (T, 256)
// block row and its (T, 1024) intermediates need, so the block is split:
// LN1 -> QKV GEMM -> A -> out-proj GEMM -> LN3 -> FF1 GEMM -> FF2 GEMM, seven
// launches, rounding to the compute type at the same points as the Pallas
// kernel.  Only the five intermediates of one block pass through device
// memory (q/k/v, attention out, x1, LN outputs, the FF hidden).
//
// What bounds it on an H100: at the main path's shapes (B*T = 400 to 5 200
// rows, C = 256, inner 512, FF 1024) the four GEMMs carry ~2*rows*(4*C*I
// + 2*C*F) flops over ~1.5 MB of weights and a few MB of activations:
// operations, not bytes.  This first version uses the CUDA cores in f32
// (64x64 output tiles, 16-deep K slices in shared memory, 4x4 register
// tiles per thread); the epilogue (bias, GELU, residual, output rounding)
// is fused so no extra pass touches device memory.  At the estimator's T/2
// level (M ~ 300 rows, N = 256) that grid is 20 blocks for 132 SMs, and the
// GEMM is most of the block's device time; 32x32 tiles of 64 threads were
// tried and were slower (two warps per SM cannot hide the latency).
// Split-K and tensor-core (wgmma) tiles are later work.
#include "common.cuh"

namespace cosy {
namespace {

// ---------------------------------------------------------------------------
// LayerNorm over rows: one warp per row, two passes over the row in f32
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;

template <typename TI, typename TW, typename TO>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const TI* __restrict__ x, const TW* __restrict__ w,
                  const TW* __restrict__ b, TO* __restrict__ y, int rows, int C,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const TI* xr = x + (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v = fmaf(d, d, v);
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
  TO* yr = y + (long long)row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<TO>((to_f(xr[c]) - mean) * inv * to_f(w[c]) + to_f(b[c]));
}

// ---------------------------------------------------------------------------
// GEMM  Y = act(A W^T + bias) + residual
//   A (M, K) row-major; W (N, K) row-major, given as up to three row
//   segments of `seg` rows each (Wq, Wk, Wv side by side without a concat);
//   bias (N) of A's type; residual (M, N) of type TR; Y (M, N) of type TO.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

enum Act : int { kNone = 0, kGeluTanh = 1 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// One block computes a 64x64 tile of Y with 256 threads, each a 4x4
// register tile; K advances 16 at a time through shared memory.
template <typename T, typename TR, typename TO>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W0,
            const T* __restrict__ W1, const T* __restrict__ W2, int seg,
            const T* __restrict__ bias, const TR* __restrict__ res,
            TO* __restrict__ Y, int M, int N, int K, int act) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // As[k][m]
  __shared__ __align__(16) float Ws[kBK][kBN + 4];  // Ws[k][n]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = tid % 16, ty = tid / 16;  // rows ty*4.., cols tx*4..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK, c = i % kBK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f(A[(long long)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kGemmThreads) {
      const int r = i / kBK, c = i % kBK, gn = n0 + r, gk = k0 + c;
      float val = 0.f;
      if (gn < N && gk < K) {
        const int sgi = gn / seg;
        const T* wseg = sgi == 0 ? W0 : (sgi == 1 ? W1 : W2);
        val = to_f(wseg[(long long)(gn - sgi * seg) * K + gk]);
      }
      Ws[c][r] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float val = acc[i][j];
      if (bias != nullptr) val += to_f(bias[gn]);
      val = activate(val, act);
      const long long o = (long long)gm * N + gn;
      if (res != nullptr) val = to_f(res[o]) + val;
      Y[o] = from_f<TO>(val);
    }
  }
}

template <typename T, typename TR, typename TO>
cudaError_t launch_gemm(const void* a, const void* w0, const void* w1,
                        const void* w2, int seg, const void* bias,
                        const void* res, void* y, int M, int N, int K, int act,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, TR, TO><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w0), static_cast<const T*>(w1),
      static_cast<const T*>(w2), seg, static_cast<const T*>(bias),
      static_cast<const TR*>(res), static_cast<TO*>(y), M, N, K, act);
  return cudaGetLastError();
}

// residual and output are each of type float or T
template <typename T>
cudaError_t dispatch_gemm(int res_dtype, int out_dtype, const void* a,
                          const void* w0, const void* w1, const void* w2, int seg,
                          const void* bias, const void* res, void* y, int M,
                          int N, int K, int act, cudaStream_t s) {
  const bool res_f32 = res_dtype == kF32;
  const bool out_f32 = out_dtype == kF32;
  if (res_f32 && out_f32)
    return launch_gemm<T, float, float>(a, w0, w1, w2, seg, bias, res, y, M, N, K, act, s);
  if (res_f32)
    return launch_gemm<T, float, T>(a, w0, w1, w2, seg, bias, res, y, M, N, K, act, s);
  if (out_f32)
    return launch_gemm<T, T, float>(a, w0, w1, w2, seg, bias, res, y, M, N, K, act, s);
  return launch_gemm<T, T, T>(a, w0, w1, w2, seg, bias, res, y, M, N, K, act, s);
}

template <typename TW, typename TI, typename TO>
cudaError_t launch_ln(const void* x, const void* w, const void* b, void* y,
                      int rows, int C, float eps, cudaStream_t s) {
  const int grid = (rows + kLnWarps - 1) / kLnWarps;
  layer_norm_kernel<TI, TW, TO><<<grid, kLnWarps * 32, 0, s>>>(
      static_cast<const TI*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<TO*>(y), rows, C, eps);
  return cudaGetLastError();
}

// input and output are each of type float or TW (the weights' type)
template <typename TW>
cudaError_t dispatch_ln(int in_dtype, int out_dtype, const void* x, const void* w,
                        const void* b, void* y, int rows, int C, float eps,
                        cudaStream_t s) {
  const bool in_f32 = in_dtype == kF32;
  const bool out_f32 = out_dtype == kF32;
  if (in_f32 && out_f32) return launch_ln<TW, float, float>(x, w, b, y, rows, C, eps, s);
  if (in_f32) return launch_ln<TW, float, TW>(x, w, b, y, rows, C, eps, s);
  if (out_f32) return launch_ln<TW, TW, float>(x, w, b, y, rows, C, eps, s);
  return launch_ln<TW, TW, TW>(x, w, b, y, rows, C, eps, s);
}

bool valid_dtype(int d) { return d == kF32 || d == kBF16; }

}  // namespace
}  // namespace cosy

// y (rows, C) = LayerNorm(x) * w + b.  x is f32 or of w's type, y likewise.
extern "C" int cosy_layer_norm(int w_dtype, int in_dtype, int out_dtype,
                               const void* x, const void* w, const void* b,
                               void* y, int rows, int C, float eps, void* stream) {
  using namespace cosy;
  if (!valid_dtype(w_dtype) || !valid_dtype(in_dtype) || !valid_dtype(out_dtype) ||
      rows <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w_dtype == kF32
          ? dispatch_ln<float>(in_dtype, out_dtype, x, w, b, y, rows, C, eps, s)
          : dispatch_ln<__nv_bfloat16>(in_dtype, out_dtype, x, w, b, y, rows, C, eps, s);
  return static_cast<int>(err);
}

// y (M, N) = act(a (M, K) . W^T + bias) + residual, W given as up to three
// row segments of `seg` rows (w1/w2 null when N == seg).  res_dtype < 0
// means no residual.  act: 0 none, 1 tanh GELU.
extern "C" int cosy_gemm(int dtype, int res_dtype, int out_dtype, const void* a,
                         const void* w0, const void* w1, const void* w2, int seg,
                         const void* bias, const void* res, void* y, int M, int N,
                         int K, int act, void* stream) {
  using namespace cosy;
  if (!valid_dtype(dtype) || !valid_dtype(out_dtype) ||
      (res != nullptr && !valid_dtype(res_dtype)) || M <= 0 || N <= 0 || K <= 0 ||
      seg <= 0 || N > 3 * seg || act < kNone || act > kGeluTanh)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32
          ? dispatch_gemm<float>(res_dtype, out_dtype, a, w0, w1, w2, seg, bias, res, y,
                                 M, N, K, act, s)
          : dispatch_gemm<__nv_bfloat16>(res_dtype, out_dtype, a, w0, w1, w2, seg, bias,
                                         res, y, M, N, K, act, s);
  return static_cast<int>(err);
}
