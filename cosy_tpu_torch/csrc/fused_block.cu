// Kernel B: the estimator's diffusers transformer block, as a chain of hand
// kernels: a row LayerNorm and a tensor-core GEMM with a fused epilogue.  Kernel A
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
// What bounds it on an H100: at the main path's shapes (B*T = 312 to 5 200
// rows, C = 256, inner 512, FF 1024) the four GEMMs carry ~2*rows*(4*C*I
// + 2*C*F) flops over ~1.5 MB of weights and a few MB of activations:
// operations, not bytes.  At the estimator's T/2 level (M = 312 rows, where
// 56 of the 64 blocks run) the limit is neither: a grid of whole 64x64 tiles
// has 20 blocks for 132 SMs, and each block waits for its loads.
//
// What gemm_kernel does about it:
//  - Tensor cores.  bf16 operands go through mma.sync.m16n8k16 (ldmatrix
//    fragments, f32 accumulators).  f32 operands go through
//    error-compensated 3xTF32 on mma.sync.m16n8k8 (mma.cuh): it was taken
//    because it holds the f32 tolerance against the exact plain version
//    (atol = rtol = 1e-4 at K = 1024, 1e-4 * max|y| over the 64-block
//    estimator) on the card, where single-pass TF32 does not.  The tensor
//    cores add into their accumulator by truncation, so each K slice is
//    summed into a zeroed fragment and added to the running sum on the CUDA
//    cores (mma.cuh, kPromote); bf16 needs none of that.
//  - Loads that overlap the math.  K advances in slices of 128 bytes a row
//    (32 f32 or 64 bf16 values) through a ring of three shared-memory stages
//    filled by 16-byte cp.async copies, one __syncthreads() a slice; rows are
//    padded to 144 bytes, which keeps ldmatrix and the scalar fragment loads
//    free of bank conflicts.  Ragged M, N and K edges are zero-filled.
//  - A grid that fills the card.  The wrapper picks the tile (64x64 on four
//    warps, or 128x128 on eight; the large f32 tile is 128x64, since its
//    accumulators are held twice) and a split over K from (M, N, K), so that
//    every SM has a block and 8 to 12 warps wherever the work allows.
//    The blocks of one output tile form a thread block cluster along
//    gridDim.z; each writes its partial tile to its own shared memory, and
//    after a cluster barrier every block sums a band of rows over all ranks
//    in rank order through distributed shared memory and runs the epilogue
//    on it.  No second pass, no scratch in device memory and no float
//    atomics: the result does not change from run to run.
//  - The epilogue (bias, tanh GELU, residual, output rounding) is fused, so
//    no extra pass touches device memory.
#include <cooperative_groups.h>

#include "mma.cuh"

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
//   bias (N) of A's type; residual and Y (M, N), each f32 or of A's type.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kSliceBytes = 128;  // K advances 128 bytes of a row at a time
constexpr int kRowBytes = 144;    // a slice row in shared memory, padded
constexpr int kStages = 3;

enum Act : int { kNone = 0, kGeluTanh = 1 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// residual and output are f32 or T, told at run time (one instantiation
// serves all four combinations; the branch is uniform).  Values move in
// pairs of neighbouring columns: N is even and every row 8-byte aligned.
template <typename T>
__device__ __forceinline__ float2 load_rt(const void* p, long long i, bool f32) {
  return f32 ? load_pair(static_cast<const float*>(p) + i)
             : load_pair(static_cast<const T*>(p) + i);
}
template <typename T>
__device__ __forceinline__ void store_rt(void* p, long long i, float2 v, bool f32) {
  if (f32) store_pair(static_cast<float*>(p) + i, v);
  else store_pair(static_cast<T*>(p) + i, v);
}

struct GemmArgs {
  const void *a, *w0, *w1, *w2, *bias, *res;
  void* y;
  int seg, res_f32, out_f32, M, N, K, act, k_per_split;
};

// One block computes a BM x BN tile of Y over the K range of its rank in the
// cluster (blockIdx.z); WARPS_M x WARPS_N warps each own a (BM / WARPS_M) x
// (BN / WARPS_N) part of it as m16n8 accumulator fragments.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_kernel(const GemmArgs p) {
  using MM = Mma<T>;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int BK = kSliceBytes / sizeof(T);   // 32 f32 or 64 bf16 values
  constexpr int LD = kRowBytes / sizeof(T);     // padded row, in elements
  constexpr int EPC = 16 / sizeof(T);           // elements a 16-byte chunk
  constexpr int CPR = kSliceBytes / 16;         // chunks a row
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MT = WM / 16, NT = WN / 8;
  constexpr int RLD = BN + 4;                   // partial-tile row, in floats
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must hold whole fragments");
  static_assert(BM * RLD * 4 <= kStages * (BM + BN) * kRowBytes, "partial tile fits the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);           // [kStages][BM][LD]
  T* Ws = As + kStages * BM * LD;               // [kStages][BN][LD]

  const T* A = static_cast<const T*>(p.a);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int split = gridDim.z, rank = blockIdx.z;
  const int k_begin = rank * p.k_per_split;
  const int k_end = min(K, k_begin + p.k_per_split);
  const int n_slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_slice = [&](int slice) {
    const int stage = slice % kStages, k0 = k_begin + slice * BK;
    T* as = As + stage * BM * LD;
    T* ws = Ws + stage * BN * LD;
    for (int c = tid; c < BM * CPR; c += kThreads) {
      const int r = c / CPR, ch = c % CPR, gm = m0 + r, gk = k0 + ch * EPC;
      const bool ok = gm < M && gk < k_end;
      cp_async_16(as + r * LD + ch * EPC, ok ? A + (long long)gm * K + gk : A, ok);
    }
    for (int c = tid; c < BN * CPR; c += kThreads) {
      const int r = c / CPR, ch = c % CPR, gn = n0 + r, gk = k0 + ch * EPC;
      const bool ok = gn < N && gk < k_end;
      const int sgi = ok ? gn / p.seg : 0;
      const T* wseg = static_cast<const T*>(sgi == 0 ? p.w0 : (sgi == 1 ? p.w1 : p.w2));
      cp_async_16(ws + r * LD + ch * EPC,
                  ok ? wseg + (long long)(gn - sgi * p.seg) * K + gk : wseg, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the ring: slices 0 .. kStages-2 in flight before the first product; one
  // commit a step (an empty one past the end) keeps the group count uniform
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) load_slice(s);
    cp_async_commit();
  }
  for (int it = 0; it < n_slices; ++it) {
    cp_async_wait<kStages - 2>();  // slice `it` has landed
    __syncthreads();               // ... for every thread, and slice it-1 is consumed
    if (it + kStages - 1 < n_slices) load_slice(it + kStages - 1);
    cp_async_commit();
    const T* as = As + (it % kStages) * BM * LD + wm0 * LD;
    const T* ws = Ws + (it % kStages) * BN * LD + wn0 * LD;
    // the slice's product: into acc directly, or (kPromote) into a zeroed
    // fragment that is added to acc below, rounding to nearest
    float part[MM::kPromote ? MT : 1][NT][4];
    if constexpr (MM::kPromote) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += MM::kK) {
      typename MM::A a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) MM::load_a(a[i], as + i * 16 * LD + kk, LD, lane);
      typename MM::B b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) MM::load_b(b[j], ws + j * 8 * LD + kk, LD, lane);
      if constexpr (MM::kPromote) mma_grid<MM, MT, NT>(part, a, b);
      else mma_grid<MM, MT, NT>(acc, a, b);
    }
    if constexpr (MM::kPromote) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }

  const T* bias = static_cast<const T*>(p.bias);
  // the epilogue of columns gn (even) and gn + 1 of row gm
  auto finish = [&](int gm, int gn, float2 val) {
    if (gm >= M || gn >= N) return;
    if (bias != nullptr) {
      const float2 bb = load_pair(bias + gn);
      val.x += bb.x;
      val.y += bb.y;
    }
    val.x = activate(val.x, p.act);
    val.y = activate(val.y, p.act);
    const long long o = (long long)gm * N + gn;
    if (p.res != nullptr) {
      const float2 rr = load_rt<T>(p.res, o, p.res_f32);
      val.x = rr.x + val.x;
      val.y = rr.y + val.y;
    }
    store_rt<T>(p.y, o, val, p.out_f32);
  };

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          finish(m0 + wm0 + i * 16 + g + h * 8, n0 + wn0 + j * 8 + 2 * t,
                 make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]));
    return;
  }

  // split over K: partial tiles meet in shared memory across the cluster
  cg::cluster_group cluster = cg::this_cluster();
  float* red = reinterpret_cast<float*>(smem);  // [BM][RLD], over the ring
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (wm0 + i * 16 + g + h * 8) * RLD + wn0 + j * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cluster.sync();
  // rank r finishes rows r, r + split, ...: the sum runs over the ranks in
  // order, so it is the same sum on every run
  for (int idx = tid; idx < (BM / split) * (BN / 4); idx += kThreads) {
    const int r = rank + (idx / (BN / 4)) * split, c = (idx % (BN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < split; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, i) + r * RLD + c);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    finish(m0 + r, n0 + c, make_float2(sum.x, sum.y));
    finish(m0 + r, n0 + c + 2, make_float2(sum.z, sum.w));
  }
  cluster.sync();  // no block leaves while its partial tile is being read
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch_gemm(const GemmArgs& args, int split, cudaStream_t stream) {
  auto kernel = gemm_kernel<T, BM, BN, WARPS_M, WARPS_N>;
  constexpr int kSmem = kStages * (BM + BN) * kRowBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((args.N + BN - 1) / BN, (args.M + BM - 1) / BM, split);
  cfg.blockDim = dim3(WARPS_M * WARPS_N * 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the tiles the wrapper's plan may name: 64x64 on four warps, and on eight
// warps 128x128 in bf16 or 128x64 in f32, whose second (kPromote) fragment
// set doubles the accumulator registers
template <typename T>
cudaError_t dispatch_gemm(const GemmArgs& args, int block_m, int block_n, int split,
                          cudaStream_t s) {
  constexpr bool kF = sizeof(T) == 4;
  if (block_m == 64 && block_n == 64) return launch_gemm<T, 64, 64, 2, 2>(args, split, s);
  if (block_m == 128 && block_n == (kF ? 64 : 128))
    return launch_gemm<T, 128, kF ? 64 : 128, kF ? 4 : 2, kF ? 2 : 4>(args, split, s);
  return cudaErrorInvalidValue;
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
// means no residual.  act: 0 none, 1 tanh GELU.  (block_m, block_n) is the
// output tile, 64x64 or 128x128 (bf16) / 128x64 (f32);
// split_k in {1, 2, 4, 8} blocks
// share a tile's K range in slices of k_per_split = a multiple of 64.  All
// pointers 16-byte aligned, K a multiple of 8, seg a multiple of 4.
extern "C" int cosy_gemm(int dtype, int res_dtype, int out_dtype, const void* a,
                         const void* w0, const void* w1, const void* w2, int seg,
                         const void* bias, const void* res, void* y, int M, int N,
                         int K, int act, int block_m, int block_n, int split_k,
                         void* stream) {
  using namespace cosy;
  if (!valid_dtype(dtype) || !valid_dtype(out_dtype) ||
      (res != nullptr && !valid_dtype(res_dtype)) || M <= 0 || N <= 0 || K <= 0 ||
      seg <= 0 || N > 3 * seg || act < kNone || act > kGeluTanh || K % 8 != 0 ||
      seg % 4 != 0 || (split_k != 1 && split_k != 2 && split_k != 4 && split_k != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (K + 63) / 64;
  GemmArgs args{a, w0, w1, w2, bias, res, y, seg, res_dtype == kF32, out_dtype == kF32,
                M, N, K, act, (slices + split_k - 1) / split_k * 64};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == kF32
                              ? dispatch_gemm<float>(args, block_m, block_n, split_k, s)
                              : dispatch_gemm<__nv_bfloat16>(args, block_m, block_n, split_k, s);
  return static_cast<int>(err);
}
