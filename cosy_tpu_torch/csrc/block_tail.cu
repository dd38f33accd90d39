// Kernel B2, the block tail: everything of the estimator's transformer block
// after attention, in one launch,
//   x1 = x + a Wo^T + bo                 (f32, never leaves the chip)
//   h2 = LN3(x1)                         (f32 statistics, rounded to T)
//   f  = gelu_tanh(h2 W1^T + b1)         (rounded to T, never leaves the chip)
//   y  = x1 + (f W2^T + b2)              (rounded to x's type T)
// with a (M, I) the attention output of kernel A and x (M, C) the block's
// input, both of type T.  Replaces lines :74-87 of the JAX package's Pallas
// kernel cosy_tpu/ops/fused_block.py (_make_kernel :34, call :129), which
// held the block's rows and its (T, 1024) FF hidden in VMEM.  Before this
// kernel the port ran the same math as four launches (out-projection GEMM,
// LayerNorm, FF1 GEMM, FF2 GEMM) with x1, h2 and the FF hidden passing
// through device memory.
//
// What bounds it on an H100: ~2 * M * (C*I + 2*C*F) flops (3xTF32 on the
// tensor cores in f32) over ~1.5 MB of weights read from L2 by every row
// tile; at the estimator's M = 312 rows neither the flops nor the bytes but
// the latency of a few dozen dependent K slices and the grid's fill.
//
// The design: the blocks of one tile of BM rows form a thread block cluster
// of R ranks (R = 4 or 8, along gridDim.x).  At M = 312 every K slice waits
// on L2 latency, so the chains are kept short and the loads run ahead:
//  0. The products' K slices form one stream through one cp.async ring of
//     three stages (two where the plan's tiles leave no room for a third;
//     stream_slices in mma.cuh): the next product's first weight slices
//     load while the block reduces across its cluster or normalises.
//  1. Rank r multiplies a[:, r I/R ...] by the same K range of Wo for all C
//     columns: a split over K, two f32 slices a rank at R = 8.  The partial
//     tiles meet through distributed shared memory: rank r sums columns
//     [r C/R, (r+1) C/R) over the ranks in rank order, adds bo and x, and
//     keeps those x1 columns (f32) in its own shared memory.
//  2. After a cluster barrier every rank reads whole x1 rows across the
//     cluster (distributed shared memory, four rows a warp in flight) and
//     computes LN3 of all BM rows into a resident h2 tile of type T.
//  3. Rank r takes FF hidden columns [r F/R, (r+1) F/R) in sub-tiles of FS:
//     FF1 (h2 resident, W1 rows streamed) + b1, GELU, rounded to T into a
//     resident f tile; then FF2 accumulates f W2[:, sub-tile]^T into the
//     rank's partial BM x C tile in registers.  The FF hidden never reaches
//     device memory.  Under Mma<float> every K slice is promoted on the CUDA
//     cores (kPromote), so the FF2 chain of F/R is cut into 128-byte links.
//  4. The partial tiles meet through distributed shared memory: rank r sums
//     columns [r C/R, (r+1) C/R) of every rank's tile in rank order, adds b2
//     and its own x1 columns, and writes y.  No atomics and no scratch: two
//     calls give the same bits.
// The plan (block_m, cluster, sub-tile) is the wrapper's _tail_plan, and
// its shared-memory budget is mirrored by ops/fused_block.py
// _tail_smem_bytes, which the CPU tests check against the 227 KB a block
// may have.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace cosy {
namespace {

namespace cg = cooperative_groups;

constexpr int kC = 256;          // the block's width: the only one instantiated
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct TailArgs {
  const void *a, *x, *wo, *bo, *n3w, *n3b, *w1, *b1, *w2, *b2;
  void* y;
  int M, I, F;
  float eps;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Rows 0 .. rows-1 of h (T, rows ld_h elements apart) = LayerNorm of the
// rows that load(r, c) reads (f32), times w plus b: a warp takes kRows rows
// at once (their loads in flight together), the statistics in f32 over two
// passes held in registers (C <= 32 * kMaxC32), summed in the order of
// layer_norm_kernel (lane-strided, then a butterfly).
template <int kMaxC32, int kRows, typename T, typename Load>
__device__ __forceinline__ void layer_norm_to_smem(T* h, int ld_h, int rows, int C, Load load,
                                                   const T* __restrict__ w,
                                                   const T* __restrict__ b, float eps) {
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  float wv[kMaxC32], bv[kMaxC32];  // this lane's columns of the affine map
#pragma unroll
  for (int j = 0; j < kMaxC32; ++j) {
    const int c = lane + 32 * j;
    wv[j] = c < C ? to_f(w[c]) : 0.f;
    bv[j] = c < C ? to_f(b[c]) : 0.f;
  }
  for (int r0 = (threadIdx.x / 32) * kRows; r0 < rows; r0 += warps * kRows) {
    float v[kRows][kMaxC32];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int j = 0; j < kMaxC32; ++j) {
        const int c = lane + 32 * j;
        v[q][j] = r0 + q < rows && c < C ? load(r0 + q, c) : 0.f;
      }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxC32; ++j) s += v[q][j];
      const float mean = warp_sum(s) / C;
      float d2 = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxC32; ++j) {
        const float d = v[q][j] - mean;
        if (lane + 32 * j < C) d2 = fmaf(d, d, d2);
      }
      const float inv = rsqrtf(warp_sum(d2) / C + eps);
      if (r0 + q >= rows) continue;
#pragma unroll
      for (int j = 0; j < kMaxC32; ++j) {
        const int c = lane + 32 * j;
        if (c < C)
          h[(r0 + q) * ld_h + c] = from_f<T>((v[q][j] - mean) * inv * wv[j] + bv[j]);
      }
    }
  }
}

// shared memory of one plan, in bytes; ops/fused_block.py _tail_smem_bytes
// computes the same
template <typename T, int BM, int R, int FS>
struct TailSmem {
  static constexpr int kES = sizeof(T);
  static constexpr int EPC = 16 / kES;
  static constexpr int CR = kC / R;        // x1 / y columns a rank owns
  static constexpr int LDH = kC + EPC;     // h2 row (T)
  static constexpr int RLD = kC + 4;       // partial-tile row (f32), over h2
  static constexpr int LDX = CR + 4;       // x1 row (f32)
  static constexpr int LDF = FS + EPC;     // f row (T)
  static constexpr int kRed = cmax(BM * LDH * kES, BM * RLD * 4);
  static constexpr int kX1 = BM * LDX * 4;
  static constexpr int kF = BM * LDF * kES;
  // a ring stage holds the largest slice of the stream: the out-projection's
  // A rows and its C rows of Wo (FF1's FS rows of W1, FF2's C rows of W2)
  static constexpr int kStage = (BM + kC) * kRowBytes;
  static constexpr int kBase = kRed + kX1 + kF;
  static constexpr int kStages = kBase + 3 * kStage <= kSmemLimit ? 3 : 2;
  static constexpr int kBytes = kBase + kStages * kStage;
};

template <typename T, int BM, int R, int FS>
__global__ void __launch_bounds__(kThreads, 1) block_tail_kernel(const TailArgs p) {
  using S = TailSmem<T, BM, R, FS>;
  constexpr int CR = S::CR, LDH = S::LDH, RLD = S::RLD, LDX = S::LDX, LDF = S::LDF;
  constexpr int kStages = S::kStages, kStage = S::kStage;
  constexpr int BK = kSliceBytes / sizeof(T), LD = kRowBytes / sizeof(T);
  // warps of the FF1 sub-tile: 16 rows a warp along M where BM allows; the
  // full-width tiles (BM x C: the out-projection's and FF2's) give each warp
  // 32 rows, which splits fewer f32 operands (kPromote) a product
  constexpr int WMA = BM / 16 < 4 ? BM / 16 : 4, WNA = kWarps / WMA;
  constexpr int WM2 = BM / 32, WN2 = kWarps / WM2;
  static_assert(S::kBytes <= kSmemLimit, "the plan's shared memory exceeds 227 KB");

  extern __shared__ __align__(16) unsigned char smem[];
  T* H2 = reinterpret_cast<T*>(smem);                    // [BM][LDH]
  float* red = reinterpret_cast<float*>(smem);           // [BM][RLD], over H2
  float* X1 = reinterpret_cast<float*>(smem + S::kRed);  // [BM][LDX]
  T* Fs = reinterpret_cast<T*>(smem + S::kRed + S::kX1);  // [BM][LDF]
  unsigned char* ring = smem + S::kBase;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = blockIdx.y * BM, rows = min(BM, p.M - m0);
  const int I = p.I, F = p.F, c0 = rank * CR;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, t = lane & 3;
  const T* A = static_cast<const T*>(p.a);
  const T* X = static_cast<const T*>(p.x);
  const T* Wo = static_cast<const T*>(p.wo);
  const T* W1 = static_cast<const T*>(p.w1);
  const T* W2 = static_cast<const T*>(p.w2);
  const T* bo = static_cast<const T*>(p.bo);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* b2 = static_cast<const T*>(p.b2);

  // The stream of K slices, in the order they are multiplied: the
  // out-projection's n0 slices (K range [r I/R, (r+1) I/R) of A and Wo),
  // then for each FS-column sub-tile of the rank's FF hidden columns FF1's
  // n1 slices (W1 rows over K = C) and FF2's n2 slices (W2 over K = FS)
  const int kr = I / R, k_o = rank * kr, f_begin = rank * (F / R);
  const int n0 = (kr + BK - 1) / BK;
  constexpr int n1 = (kC + BK - 1) / BK, n2 = (FS + BK - 1) / BK;
  const int n_sub = F / R / FS, total = n0 + n_sub * (n1 + n2);
  auto stage_ptr = [&](int stage) { return reinterpret_cast<T*>(ring + stage * kStage); };
  auto issue = [&](int i) {
    T* st = stage_ptr(i % kStages);
    if (i < n0) {
      load_slice_rows<T, BM, kThreads>(
          st, [&](int r) { return A + (long long)(m0 + r) * I + k_o; }, rows, i * BK, kr);
      load_slice_rows<T, kC, kThreads>(
          st + BM * LD, [&](int n) { return Wo + (long long)n * I + k_o; }, kC, i * BK, kr);
      return;
    }
    const int u = (i - n0) % (n1 + n2), j0 = f_begin + (i - n0) / (n1 + n2) * FS;
    if (u < n1)
      load_slice_rows<T, FS, kThreads>(
          st, [&](int n) { return W1 + (long long)(j0 + n) * kC; }, FS, u * BK, kC);
    else
      load_slice_rows<T, kC, kThreads>(
          st, [&](int n) { return W2 + (long long)n * F + j0; }, kC, (u - n1) * BK, FS);
  };
  COSY_PHASE(0);
  stream_start<kStages>(total, issue);

  constexpr int MT2 = BM / WM2 / 16, NT2 = kC / WN2 / 8;
  const int wm2 = (warp / WN2) * (BM / WM2), wn2 = (warp % WN2) * (kC / WN2);
  auto store_tile = [&](const float (&acc)[MT2][NT2][4]) {
#pragma unroll
    for (int i = 0; i < MT2; ++i)
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (wm2 + i * 16 + g + h * 8) * RLD + wn2 + j * 8 + 2 * t) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  };
  // partial tiles of every rank, summed in rank order: columns c .. c + 3 of row r
  auto rank_sum = [&](int r, int c) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float4 v = *cluster.map_shared_rank(reinterpret_cast<const float4*>(red + r * RLD + c), q);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    return s;
  };

  // 1. x1 = x + (a Wo^T + bo): rank r's partial product over its K range
  //    for every column, then the columns c0 .. c0 + CR summed over the
  //    ranks in rank order
  {
    float acc[MT2][NT2][4] = {};
    stream_slices<kStages>(0, n0, total, issue, [&](int stage, int) {
      const T* st = stage_ptr(stage);
      slice_product<T, BM, kC, WM2, WN2>(acc, st, LD, st + BM * LD);
    });
    COSY_PHASE(1);
    store_tile(acc);
  }
  cluster.sync();  // every rank's partial out-projection is in place
  COSY_PHASE(2);
  for (int idx = threadIdx.x; idx < BM * (CR / 4); idx += kThreads) {
    const int r = idx / (CR / 4), c = (idx % (CR / 4)) * 4;
    const float4 s = rank_sum(r, c0 + c);
    const float2 ba = load_pair(bo + c0 + c), bb = load_pair(bo + c0 + c + 2);
    float2 xa = make_float2(0.f, 0.f), xb = xa;
    if (r < rows) {
      xa = load_pair(X + (long long)(m0 + r) * kC + c0 + c);
      xb = load_pair(X + (long long)(m0 + r) * kC + c0 + c + 2);
    }
    *reinterpret_cast<float4*>(X1 + r * LDX + c) =
        make_float4(xa.x + (s.x + ba.x), xa.y + (s.y + ba.y), xb.x + (s.z + bb.x),
                    xb.y + (s.w + bb.y));
  }
  cluster.sync();  // every rank's x1 columns are in place, and no partial tile is read any more
  COSY_PHASE(3);

  // 2. h2 = LN3(x1) over whole rows, read across the cluster
  layer_norm_to_smem<kC / 32, 4>(
      H2, LDH, BM, kC,
      [&](int r, int c) { return *cluster.map_shared_rank(X1 + r * LDX + c % CR, c / CR); },
      static_cast<const T*>(p.n3w), static_cast<const T*>(p.n3b), p.eps);
  COSY_PHASE(4);

  // 3. the rank's FF hidden columns, FS at a time: FF1 + GELU into f, then
  //    f W2^T into the partial tile.  Each product's first slice opens with
  //    a __syncthreads(): FF1's makes h2 complete and ends the last FF2's
  //    reads of f, FF2's makes f complete.
  float acc2[MT2][NT2][4] = {};
  for (int sub = 0; sub < n_sub; ++sub) {
    const int first = n0 + sub * (n1 + n2), j0 = f_begin + sub * FS;
    {
      constexpr int WM = BM / WMA, WN = FS / WNA, MT = WM / 16, NT = WN / 8;
      float acc[MT][NT][4] = {};
      stream_slices<kStages>(first, n1, total, issue, [&](int stage, int it) {
        slice_product<T, BM, FS, WMA, WNA>(acc, H2 + it * BK, LDH, stage_ptr(stage));
      });
      if (sub == 0) COSY_PHASE(5);
      const int wm0 = (warp / WNA) * WM, wn0 = (warp % WNA) * WN;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm0 + i * 16 + g + h * 8, c = wn0 + j * 8 + 2 * t;
            const float2 bb = load_pair(b1 + j0 + c);
            store_pair(Fs + r * LDF + c,
                       make_float2(activate(acc[i][j][2 * h] + bb.x, kGeluTanh),
                                   activate(acc[i][j][2 * h + 1] + bb.y, kGeluTanh)));
          }
    }
    stream_slices<kStages>(first + n1, n2, total, issue, [&](int stage, int it) {
      slice_product<T, BM, kC, WM2, WN2>(acc2, Fs + it * BK, LDF, stage_ptr(stage));
    });
    if (sub == 0) COSY_PHASE(6);
  }

  // 4. the partial FF2 tiles meet across the cluster.  red lies over h2,
  //    which every warp finished reading before the last FF2 product began.
  store_tile(acc2);
  cluster.sync();
  COSY_PHASE(7);
  // rank r finishes columns c0 .. c0 + CR of every row: + b2, + x1
  T* Y = static_cast<T*>(p.y);
  for (int idx = threadIdx.x; idx < rows * (CR / 4); idx += kThreads) {
    const int r = idx / (CR / 4), c = (idx % (CR / 4)) * 4;
    const float4 s = rank_sum(r, c0 + c);
    const float2 ba = load_pair(b2 + c0 + c), bb = load_pair(b2 + c0 + c + 2);
    const float4 x1 = *reinterpret_cast<const float4*>(X1 + r * LDX + c);
    T* yr = Y + (long long)(m0 + r) * kC + c0 + c;
    store_pair(yr, make_float2(x1.x + (s.x + ba.x), x1.y + (s.y + ba.y)));
    store_pair(yr + 2, make_float2(x1.z + (s.z + bb.x), x1.w + (s.w + bb.y)));
  }
  cluster.sync();  // no block leaves while its x1 or partial tile is being read
  COSY_PHASE(8);
}

template <typename T, int BM, int R, int FS>
cudaError_t launch_tail(const TailArgs& args, cudaStream_t stream) {
  auto kernel = block_tail_kernel<T, BM, R, FS>;
  constexpr int kSmem = TailSmem<T, BM, R, FS>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, (args.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = R;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the plans ops/fused_block.py _TAIL_PLANS may name
template <typename T>
cudaError_t dispatch_tail(const TailArgs& a, int block_m, int cluster, int sub, cudaStream_t s) {
#define COSY_TAIL(BM, R, FS) \
  if (block_m == BM && cluster == R && sub == FS) return launch_tail<T, BM, R, FS>(a, s);
  COSY_TAIL(32, 4, 64)
  COSY_TAIL(32, 8, 64)
  COSY_TAIL(32, 8, 128)
  COSY_TAIL(64, 4, 64)
  COSY_TAIL(64, 4, 128)
  COSY_TAIL(64, 8, 64)
  COSY_TAIL(64, 8, 128)
#undef COSY_TAIL
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cosy

// y (M, 256) = the block tail of a (M, I) and x (M, 256), every tensor of
// type dtype (f32 or bf16), contiguous and 16-byte aligned; wo (256, I),
// bo (256), n3w / n3b (256), w1 (F, 256), b1 (F), w2 (256, F), b2 (256).
// I a multiple of 8 * cluster (a rank's K range of the out-projection is
// whole 16-byte chunks); F a multiple of cluster * sub.  (block_m, cluster,
// sub) is the plan.
#ifdef COSY_TRACE
// the phase times of the last COSY_TRACE launch (ops/phase_trace.py)
extern "C" int cosy_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cosy::trace_ns, sizeof(cosy::trace_ns)));
}
#endif

extern "C" int cosy_block_tail(int dtype, const void* a, const void* x, const void* wo,
                               const void* bo, const void* n3w, const void* n3b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* y, int M, int C, int I, int F,
                               float eps, int block_m, int cluster, int sub, void* stream) {
  using namespace cosy;
  if ((dtype != kF32 && dtype != kBF16) || M <= 0 || C != kC || I <= 0 || cluster <= 0 ||
      I % (8 * cluster) != 0 || sub <= 0 || F <= 0 || F % (cluster * sub) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs args{a, x, wo, bo, n3w, n3b, w1, b1, w2, b2, y, M, I, F, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? dispatch_tail<float>(args, block_m, cluster, sub, s)
                    : dispatch_tail<__nv_bfloat16>(args, block_m, cluster, sub, s);
  return static_cast<int>(err);
}
