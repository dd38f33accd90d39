// Kernel B: the estimator's diffusers transformer block, as a chain of three
// hand kernels: B1 (LayerNorm folded into the QKV product, this file's
// gemm_kernel<kLn>), kernel A (flash_attention.cu) and B2 (the block tail,
// block_tail.cu).  This file also keeps the row LayerNorm kernel and the
// plain GEMM, which the block's path no longer launches.
//
// Replaces the JAX package's Pallas kernel cosy_tpu/ops/fused_block.py
// (_make_kernel :34, called by fused_transformer_block :95), which ran the
// whole block for one batch row with every intermediate in VMEM:
//   h  = LN1(x)                         (eps 1e-5, f32 stats, cast to the compute type)
//   q,k,v = h Wq^T, h Wk^T, h Wv^T       (f32 accumulation, cast)       -> B1
//   a  = per-head softmax(scale q k^T + bias) v     -> kernel A
//   x1 = x + a Wo^T + bo                 (kept in f32)                   -> B2
//   f  = gelu_tanh(LN3(x1) W1^T + b1)    (cast)                          -> B2
//   y  = x1 + f W2^T + b2                (cast to x's type)              -> B2
// A Hopper SM has 227 KB of shared memory, not the 16 MB of VMEM a (T, 256)
// block row and its (T, 1024) intermediates need, so the block is cut where
// attention needs every row of a batch element: q/k/v and the attention
// output pass through device memory, nothing else does.  Rounding to the
// compute type happens at the Pallas kernel's points.
//
// What bounds it on an H100: at the main path's shapes (B*T = 312 to 5 200
// rows, C = 256, inner 512, FF 1024) the four products carry ~2*rows*(4*C*I
// + 2*C*F) flops over ~1.5 MB of weights and a few MB of activations:
// operations, not bytes.  At the estimator's T/2 level (M = 312 rows, where
// 56 of the 64 blocks run) the limit is neither: a grid of whole 64x64 tiles
// has 20 blocks for 132 SMs, and each block waits for its loads.
//
// What B1 adds to the GEMM: K = C = 256 is the whole row, so the blocks of
// a row tile compute its rows' statistics (f32, two passes, as
// layer_norm_kernel) while the first slices load, and every slice of x is
// normalised in shared memory as it lands; one launch and one (rows, C)
// round trip fewer.
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
//    filled by 16-byte cp.async copies, one __syncthreads() a slice
//    (stream_slices, mma.cuh); rows are padded to 144 bytes, which keeps
//    ldmatrix and the scalar fragment loads free of bank conflicts.  Ragged
//    M, N and K edges are zero-filled.
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

constexpr int kStages = 3;

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
  // the LayerNorm prologue (kLn): a is x, f32 (a_f32) or T; h = LN(x) w + b
  const void *ln_w, *ln_b;
  int a_f32;
  float eps;
};

constexpr int kLnMaxK = 256;  // a lane holds a whole row's statistics pass: K <= this

// shared memory of a gemm_kernel instantiation at depth K: the ring, and
// under kLn after it the rows' mean and 1/std and the affine w and b (f32);
// the split's partial tile (BM x (BN + 4) f32) lies over the start once the
// mainloop is done
template <typename T, int BM, int BN, bool kLn>
constexpr int gemm_smem_bytes(int K) {
  const int ring = kStages * (BM + BN) * kRowBytes;
  const int ln = kLn ? (2 * BM + 2 * K) * 4 : 0;
  const int red = BM * (BN + 4) * 4;
  return ring + ln > red ? ring + ln : red;
}

// One block computes a BM x BN tile of Y over the K range of its rank in the
// cluster (blockIdx.z); WARPS_M x WARPS_N warps each own a (BM / WARPS_M) x
// (BN / WARPS_N) part of it as m16n8 accumulator fragments (slice_product),
// K streaming through a three-stage ring (stream_slices, mma.cuh).
// kLn: A is h = LayerNorm(x) of the tile's BM rows; K is not split.  x
// streams through the ring as A does, and each landed slice is normalised
// in place, in f32 and rounded to T, before its product.  The row
// statistics come first: the blocks of one row tile form a cluster along N
// (gridDim.x); rank q computes mean and 1/std of rows [q BM/R, (q+1) BM/R)
// (a warp a row, two passes in the order of layer_norm_kernel) and, after a
// cluster barrier, every block reads the others' from their shared memory.
// Both alternatives measured slower on the card (ops/phase_trace.py,
// PERF.md): normalising the whole tile in each of the N / BN blocks of a row
// tile, and copying normalised rows between the ranks; the statistics are
// 512 bytes.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool kLn>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_kernel(const GemmArgs p) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MT = WM / 16, NT = WN / 8;
  constexpr int RLD = BN + 4;                   // partial-tile row, in floats

  extern __shared__ __align__(16) unsigned char smem[];
  const T* A = static_cast<const T*>(p.a);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int split = gridDim.z, rank = blockIdx.z;
  const int k_begin = rank * p.k_per_split;
  const int k_len = min(K, k_begin + p.k_per_split) - k_begin;
  unsigned char* ring = smem;
  // kLn: mean, 1/std of the BM rows; w and b of the K columns (f32)
  float* stats = reinterpret_cast<float*>(smem + kStages * (BM + BN) * kRowBytes);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto a_row = [&](int r) { return A + (long long)(m0 + r) * K + k_begin; };
  auto w_row = [&](int n) {
    const int gn = n0 + n, sgi = gn / p.seg;
    const T* wseg = static_cast<const T*>(sgi == 0 ? p.w0 : (sgi == 1 ? p.w1 : p.w2));
    return wseg + (long long)(gn - sgi * p.seg) * K + k_begin;
  };
  // kLn with f32 x under bf16 weights: x is read, normalised and rounded as
  // a slice is issued (not on the block's path, where x has T's type)
  const bool ln_convert = kLn && p.a_f32 && sizeof(T) != 4;
  // the rows' statistics: rank q of the cluster computes those of its share
  // of the tile's rows, then reads the others' (see above)
  auto ln_stats = [&]() {
    if constexpr (kLn) {
      cg::cluster_group cluster = cg::this_cluster();
      const int ranks = static_cast<int>(cluster.num_blocks());
      const int q = static_cast<int>(cluster.block_rank()), rp = BM / ranks, r0 = q * rp;
      const T* lw = static_cast<const T*>(p.ln_w);
      const T* lb = static_cast<const T*>(p.ln_b);
      for (int k = tid; k < K; k += kThreads) {
        stats[2 * BM + k] = to_f(lw[k]);
        stats[2 * BM + K + k] = to_f(lb[k]);
      }
      constexpr int kRows = 4, kC32 = kLnMaxK / 32;
      for (int rr = warp * kRows; rr < rp; rr += kThreads / 32 * kRows) {
        float v[kRows][kC32];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int gm = m0 + r0 + rr + i;
          const bool ok = rr + i < rp && gm < M;
#pragma unroll
          for (int j = 0; j < kC32; ++j) {
            const int c = lane + 32 * j;
            const long long o = (long long)gm * K + c;
            v[i][j] = ok && c < K ? (p.a_f32 ? static_cast<const float*>(p.a)[o] : to_f(A[o]))
                                  : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float s1 = 0.f;
#pragma unroll
          for (int j = 0; j < kC32; ++j) s1 += v[i][j];
          const float mean = warp_sum(s1) / K;
          float s2 = 0.f;
#pragma unroll
          for (int j = 0; j < kC32; ++j) {
            const float d = v[i][j] - mean;
            if (lane + 32 * j < K) s2 = fmaf(d, d, s2);
          }
          const float inv = rsqrtf(warp_sum(s2) / K + p.eps);
          if (lane == 0 && rr + i < rp) {
            stats[r0 + rr + i] = mean;
            stats[BM + r0 + rr + i] = inv;
          }
        }
      }
      cluster.sync();  // every rank's statistics are in place
      for (int r = tid; r < BM; r += kThreads) {
        if (r / rp == q) continue;
        stats[r] = *cluster.map_shared_rank(stats + r, r / rp);
        stats[BM + r] = *cluster.map_shared_rank(stats + BM + r, r / rp);
      }
      __syncthreads();
    }
  };
  // h of element (r, k): (x - mean) / std * w + b, as layer_norm_kernel
  auto ln = [&](float x, int r, int k) {
    return (x - stats[r]) * stats[BM + r] * stats[2 * BM + k] + stats[2 * BM + K + k];
  };
  // a stage: the slice of A's BM rows and W's BN rows
  constexpr int BK = kSliceBytes / sizeof(T), LD = kRowBytes / sizeof(T);
  constexpr int kStage = (BM + BN) * kRowBytes;
  const int n_slices = k_len > 0 ? (k_len + BK - 1) / BK : 0;
  auto issue = [&](int i) {
    T* st = reinterpret_cast<T*>(ring + (i % kStages) * kStage);
    if (!ln_convert) {
      load_slice_rows<T, BM, kThreads>(st, a_row, min(BM, M - m0), i * BK, k_len);
    } else {
      const float* x = static_cast<const float*>(p.a);
      for (int e = tid; e < BM * BK / 2; e += kThreads) {
        const int r = e / (BK / 2), c = (e % (BK / 2)) * 2, k = k_begin + i * BK + c;
        float2 v = make_float2(0.f, 0.f);
        if (m0 + r < M) {
          v = load_pair(x + (long long)(m0 + r) * K + k);
          v = make_float2(ln(v.x, r, k), ln(v.y, r, k + 1));
        }
        store_pair(st + r * LD + c, v);
      }
    }
    load_slice_rows<T, BN, kThreads>(st + BM * LD, w_row, min(BN, N - n0), i * BK, k_len);
  };
  if constexpr (kLn) COSY_PHASE(10);
  if (ln_convert) ln_stats();  // the slices are normalised as they are issued
  stream_start<kStages>(n_slices, issue);
  if (!ln_convert) ln_stats();  // while the first slices load
  if constexpr (kLn) COSY_PHASE(11);
  stream_slices<kStages>(0, n_slices, n_slices, issue, [&](int stage, int it) {
    T* st = reinterpret_cast<T*>(ring + stage * kStage);
    if (kLn && !ln_convert) {
      // the landed slice of x becomes h in place; the stream's next
      // __syncthreads() is a slice away, so one here
      for (int e = tid; e < BM * BK / 2; e += kThreads) {
        const int r = e / (BK / 2), c = (e % (BK / 2)) * 2, k = k_begin + it * BK + c;
        const float2 v = load_pair(st + r * LD + c);
        store_pair(st + r * LD + c, make_float2(ln(v.x, r, k), ln(v.y, r, k + 1)));
      }
      __syncthreads();
    }
    slice_product<T, BM, BN, WARPS_M, WARPS_N>(acc, st, LD, st + BM * LD);
  });
  if constexpr (kLn) COSY_PHASE(12);

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
    if constexpr (kLn) {
      COSY_PHASE(13);
      cg::this_cluster().sync();  // no block leaves while its statistics are read
    }
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

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool kLn>
cudaError_t launch_gemm(const GemmArgs& args, int split, cudaStream_t stream) {
  auto kernel = gemm_kernel<T, BM, BN, WARPS_M, WARPS_N, kLn>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_smem_bytes<T, BM, BN, kLn>(kLnMaxK));
  if (attr != cudaSuccess) return attr;
  // split: the cluster's size, along K (gridDim.z) or, under kLn, along N
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((args.N + BN - 1) / BN, (args.M + BM - 1) / BM, kLn ? 1 : split);
  cfg.blockDim = dim3(WARPS_M * WARPS_N * 32);
  cfg.dynamicSmemBytes = gemm_smem_bytes<T, BM, BN, kLn>(args.K);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kLn ? split : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = kLn ? 1 : split;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the tiles the wrapper's plan may name: 64x64 on four warps, and on eight
// warps 128x128 in bf16 or 128x64 in f32, whose second (kPromote) fragment
// set doubles the accumulator registers
template <typename T, bool kLn>
cudaError_t dispatch_gemm(const GemmArgs& args, int block_m, int block_n, int split,
                          cudaStream_t s) {
  constexpr bool kF = sizeof(T) == 4;
  if (block_m == 64 && block_n == 64) return launch_gemm<T, 64, 64, 2, 2, kLn>(args, split, s);
  if (block_m == 128 && block_n == (kF ? 64 : 128))
    return launch_gemm<T, 128, kF ? 64 : 128, kF ? 4 : 2, kF ? 2 : 4, kLn>(args, split, s);
  return cudaErrorInvalidValue;
}

bool valid_split(int split_k) {
  return split_k == 1 || split_k == 2 || split_k == 4 || split_k == 8;
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
      seg % 4 != 0 || !valid_split(split_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (K + 63) / 64;
  GemmArgs args{a, w0, w1, w2, bias, res, y, seg, res_dtype == kF32, out_dtype == kF32,
                M, N, K, act, (slices + split_k - 1) / split_k * 64,
                nullptr, nullptr, 0, 0.f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? dispatch_gemm<float, false>(args, block_m, block_n, split_k, s)
                    : dispatch_gemm<__nv_bfloat16, false>(args, block_m, block_n, split_k, s);
  return static_cast<int>(err);
}

#ifdef COSY_TRACE
// the phase times of the last COSY_TRACE launch (ops/phase_trace.py)
extern "C" int cosy_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cosy::trace_ns, sizeof(cosy::trace_ns)));
}
#endif

// Kernel B1: y (M, N) = LayerNorm(x) (M, K) . W^T, the LayerNorm (f32
// statistics, eps, affine ln_w / ln_b of the weights' type, rounded to it)
// computed into shared memory by the `cluster` blocks of a row tile
// together: the GEMM above with its A tile resident and K not split.  x is
// f32 or of the weights' type (in_dtype); y is f32 or of the weights' type.
// W as for cosy_gemm; K a multiple of 64 and at most 256; (block_m,
// block_n) as for cosy_gemm; cluster in {1, 2, 4, 8} divides the number of
// N tiles.
extern "C" int cosy_ln_gemm(int dtype, int in_dtype, int out_dtype, const void* x,
                            const void* ln_w, const void* ln_b, const void* w0,
                            const void* w1, const void* w2, int seg, void* y, int M,
                            int N, int K, float eps, int block_m, int block_n,
                            int cluster, void* stream) {
  using namespace cosy;
  if (!valid_dtype(dtype) || !valid_dtype(in_dtype) || !valid_dtype(out_dtype) ||
      (in_dtype != kF32 && in_dtype != dtype) || M <= 0 || N <= 0 || K <= 0 ||
      K > kLnMaxK || K % 64 != 0 || seg <= 0 || N > 3 * seg || seg % 4 != 0 ||
      !valid_split(cluster) || block_n <= 0 || ((N + block_n - 1) / block_n) % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs args{x, w0, w1, w2, nullptr, nullptr, y, seg, 0, out_dtype == kF32,
                M, N, K, kNone, K, ln_w, ln_b, in_dtype == kF32, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? dispatch_gemm<float, true>(args, block_m, block_n, cluster, s)
                    : dispatch_gemm<__nv_bfloat16, true>(args, block_m, block_n, cluster, s);
  return static_cast<int>(err);
}
