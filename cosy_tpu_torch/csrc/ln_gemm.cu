// Kernel B1: y (M, N) = LayerNorm(x) (M, K) . W^T, the first third of the
// estimator's transformer block (LN1, then Wq, Wk, Wv read in place).
//
// Replaces the first third of the JAX package's Pallas kernel
// cosy_tpu/ops/fused_block.py (_make_kernel :34, lines :49-56; called by
// fused_transformer_block :129): h = LN1(x) with f32 statistics and eps,
// rounded to the compute type, then q, k, v = h Wq^T, h Wk^T, h Wv^T with
// f32 accumulation.  This kernel computes that function with the Pallas
// kernel's rounding points: h rounded to the weights' type, the product
// accumulated in f32, y rounded to its type once.
//
// What bounds it on an H100: at the main path's shapes (150 to 5116 rows,
// K = C = 256, N = 3 x 512) the product is 2 M N K flops over ~1.5 MB of
// weights (f32) and M K x values: 245 MFLOP over 3.8 MB at 312 rows, so
// operations at the f32 CUDA-core peak (3.7 us), 1.5 us as three TF32
// tensor-core passes, 1.1 us for the bytes.  At a few hundred rows the
// real limits are the fixed costs of one block: the time to its first
// product and the depth of its K loop.
//
// What the design does about it:
//  - No LayerNorm phase before the products and no cluster.  A block owns
//    64 rows and one N tile (64 or 128 columns): TMA brings its whole x
//    tile (K <= 256: at most 64 KB) slice by slice, while the first W
//    stages fill and the affine's loads land.  Each thread takes the
//    statistics of its own two rows from shared memory as each x slice
//    lands: in f32, its values of the slice summed about their own mean and
//    merged into a running (mean, M2) by Chan's rule, then merged with its
//    quad's in two shuffles (no sum cancels, whatever the row's |mean| /
//    std or wherever an outlier sits; never x^2 - K mean^2).  h is never
//    written anywhere: the product's A operand is built in registers, normalised
//    (two fused multiply-adds, x rstd - mean rstd first, within an f32
//    rounding or two of layer_norm_rows' order), rounded to the weights'
//    type or (f32) split, straight from the landed x tile.  A thread's
//    fragment words sit at fixed offsets of a slice row (one swizzle XOR a
//    thread), and slice i + 1 lands, is split and has its fragments built
//    while the products of slice i run.
//  - Hopper's mainloop (wgmma.cuh): one producer thread keeps the ring of W
//    slices (128 bytes of K a row, 128-byte swizzle) full by TMA, with
//    completion on mbarriers; one consumer warpgroup issues wgmma.mma_async
//    from registers (A) and the ring (B).  No thread computes a copy
//    address.  Two consumer warpgroups (128 rows, or the even and the odd
//    K slices of 64 rows) measured no faster (PERF.md).
//  - f32 as error-compensated 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi),
//    operands split once a block: A in registers, hi = cvt.rna.tf32(h),
//    lo = h - hi (the tensor cores read its top 19 bits, an error of
//    2^-21 h at most); each landed W slice is split once in shared memory by
//    truncation to the 19 bits the tensor cores read (hi written back in
//    place, so the tensor cores see exactly it; lo = w - hi beside it),
//    then fence.proxy.async before wgmma reads it.  The tensor cores add
//    into their accumulator by truncation, so each K slice (32 values) is
//    summed into a zeroed partial and added to the running sum on the CUDA
//    cores with rounding to nearest (mma.cuh, kPromote).  bf16 takes one
//    pass of m64nNk16 and accumulates in place.  The f32 products are what
//    bounds the mainloop: 12 m64n64k8 TF32 products a slice take ~0.42 us.
//  - The epilogue stages the 64 x BN tile in the free ring and stores it by
//    TMA (rows past M are not written); a tile that ends past its segment,
//    or a y whose rows are not 16-byte multiples, is stored by the threads.
//    TMA fills rows past the end of x or of a weight segment with zeros.  A
//    tile never crosses a weight segment: the grid walks the N tiles of
//    each segment in turn, one tensor map a segment.
#include "wgmma.cuh"

namespace cosy {
namespace {

constexpr int kLnMaxK = 256;       // the whole x tile stays resident
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr int kStages = 4;          // the W ring
constexpr int kSlice = 128;         // bytes of a row in a K slice (the swizzle width)
constexpr int kXBars = kLnMaxK * 4 / kSlice;  // x lands slice by slice: a barrier each

struct LnGemmArgs {
  CUtensorMap x_map, w_map[3];  // x (M, K); W's segments (seg, K)
  CUtensorMap y_map;            // y (M, N) in boxes of 64 rows (y_tma)
  const void *ln_w, *ln_b;      // the affine, of the weights' type
  void* y;                      // (M, N), f32 or the weights' type
  int M, N, K, seg, tiles_per_seg, out_f32, y_tma;
  float eps;
};

// shared memory of one instantiation at depth K: the ring of W stages (a
// hi and, under 3xTF32, a lo slice of BN rows each), the x tile (K / XS
// slices of 64 rows), the affine w and b (f32), the barriers; plus the
// slack that aligns the start to 1024 bytes.  The epilogue reuses the ring.
template <typename T, typename TX, int BN>
struct LnGemmSmem {
  static constexpr int BM = 64;
  static constexpr int kHalf = BN * kSlice;
  static constexpr int kStage = kHalf * (sizeof(T) == 4 ? 2 : 1);
  static constexpr int ring = kStages * kStage;
  static constexpr int bytes(int K) {
    return 1024 + ring + BM * K * static_cast<int>(sizeof(TX)) + 2 * K * 4 +
           (kXBars + 2 * kStages) * 8;
  }
  static_assert(bytes(kLnMaxK) <= kSmemLimit, "the tile does not fit in shared memory");
  static_assert(64 * BN * 4 <= ring, "the ring cannot hold the epilogue's y tile");
};

// One block: rows [m0, m0 + 64) against the BN rows [n0, n0 + BN) of
// segment sg.  Warps 0-3 are the consumer warpgroup, warp 4 the producer.
template <typename T, typename TX, int BN>
__global__ void __launch_bounds__(160, 1) ln_gemm_kernel(const __grid_constant__ LnGemmArgs p) {
  using L = LnGemmSmem<T, TX, BN>;
  constexpr bool kF = sizeof(T) == 4;
  constexpr int BM = 64, kConsumers = 128;
  constexpr int WS = kSlice / sizeof(T), XS = kSlice / sizeof(TX);  // K values a slice
  constexpr int KSTEP = kF ? 8 : 16, STEPS = WS / KSTEP;            // 4 products a slice
  constexpr int WROWS = BN * 8 / kConsumers;  // 16-byte W words a thread splits a slice

  COSY_PHASE(10);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int K = p.K;
  unsigned char* ring = smem;
  unsigned char* xs = ring + L::ring;
  float* aff = reinterpret_cast<float*>(xs + BM * K * sizeof(TX));  // w[K], then b[K]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(aff + 2 * K);
  TmaRing<kStages>* wring = reinterpret_cast<TmaRing<kStages>*>(xbar + kXBars);

  const int sg = blockIdx.x / p.tiles_per_seg, n0 = (blockIdx.x % p.tiles_per_seg) * BN;
  const int m0 = blockIdx.y * BM;
  const int n_slices = K / WS, x_slices = K / XS;
  // the affine's loads start now and land while x does (K <= 2 kConsumers)
  float lw[2] = {0.f, 0.f}, lb[2] = {0.f, 0.f};
  if (threadIdx.x < kConsumers) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = threadIdx.x + q * kConsumers;
      if (k < K) {
        lw[q] = to_f(static_cast<const T*>(p.ln_w)[k]);
        lb[q] = to_f(static_cast<const T*>(p.ln_b)[k]);
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < kXBars; ++j) mbar_init(&xbar[j], 1);
    wring->init(1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4) {  // the producer warp: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      const CUtensorMap* wm = &p.w_map[sg];
      tma_prefetch_map(wm);
      for (int j = 0; j < x_slices; ++j) {
        mbar_arrive_expect(&xbar[j], BM * kSlice);
        tma_load_2d(xs + j * BM * kSlice, &p.x_map, &xbar[j], j * XS, m0);
      }
      for (int i = 0; i < n_slices; ++i)
        tma_load_2d(ring + (i % kStages) * L::kStage, wm, wring->acquire(i, L::kHalf), i * WS,
                    n0);
    }
    return;
  }

  // the consumers
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid / 32) * 16 + g, r1 = r0 + 8;  // the thread's rows
  // The thread's word of 16-byte chunk c in x slice j: bytes 4t .. 4t + 3
  // of the chunk, which the swizzle puts at c ^ (r % 8) = c ^ g in both rows
  // (r1 = r0 + 8).  Read whole, it holds one f32 x value or two bf16 ones:
  // the quad covers the chunk, and a product's A fragment takes exactly the
  // words of the slice's eight chunks (c = 2 step + half: row pairs at
  // slots 2 half, 2 half + 1), for TX = T.
  const unsigned char* xr0 = xs + r0 * kSlice + 4 * t;
  const unsigned char* xr1 = xr0 + 8 * kSlice;
  auto word = [&](const unsigned char* row, int j, int c) {
    return row + j * BM * kSlice + ((c ^ g) << 4);
  };
  // x (r, k), k even, and its right neighbour (x f32 under bf16 weights)
  auto x_pair = [&](int r, int k) {
    const int byte = (k % XS) * static_cast<int>(sizeof(TX));
    return load_pair(reinterpret_cast<const TX*>(
        xs + (k / XS) * BM * kSlice + r * kSlice + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))));
  };

  // The statistics of rows r0 and r1, as each x slice lands: a thread's VPS
  // values of a row in the slice are summed about their own mean and merged
  // into its running (mean, M2) by Chan's rule, then the quad's four are
  // merged in two shuffles.  Every sum is of deviations from a local mean,
  // so nothing cancels, whatever the row's |mean| / std or where an outlier
  // sits (never x^2 - K mean^2, nor a shift by one of the row's values).
  constexpr int VPS = XS / 4;  // a thread's values of a row in one x slice
  float mean0, mean1, rstd0, rstd1;
  {
    float m[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    for (int j = 0; j < x_slices; ++j) {
      mbar_wait(&xbar[j], 0);
      float v[2][VPS];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if constexpr (sizeof(TX) == 4) {
          v[0][c] = *reinterpret_cast<const float*>(word(xr0, j, c));
          v[1][c] = *reinterpret_cast<const float*>(word(xr1, j, c));
        } else {
          const float2 v0 = load_pair(reinterpret_cast<const TX*>(word(xr0, j, c)));
          const float2 v1 = load_pair(reinterpret_cast<const TX*>(word(xr1, j, c)));
          v[0][2 * c] = v0.x;
          v[0][2 * c + 1] = v0.y;
          v[1][2 * c] = v1.x;
          v[1][2 * c + 1] = v1.y;
        }
      }
      // the slice's block of VPS values joins the j VPS before it
      const float share = 1.f / (j + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int e = 0; e < VPS; ++e) s += v[r][e];
        const float bm = s * (1.f / VPS);
#pragma unroll
        for (int e = 0; e < VPS; ++e) {
          const float d = v[r][e] - bm;
          q = fmaf(d, d, q);
        }
        const float d = bm - m[r];
        m[r] = fmaf(d, share, m[r]);
        m2[r] += fmaf(d * d, VPS * j * share, q);
      }
    }
    // the quad: both sides hold n values; the merge is symmetric in its two
    // sides, so all four lanes end with the same bits
    float n = static_cast<float>(K / 4);
#pragma unroll
    for (int lanes = 1; lanes <= 2; lanes *= 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float om = __shfl_xor_sync(0xffffffffu, m[r], lanes);
        const float om2 = __shfl_xor_sync(0xffffffffu, m2[r], lanes);
        const float d = om - m[r];
        m[r] = 0.5f * (m[r] + om);
        m2[r] = fmaf(d * d, 0.5f * n, m2[r] + om2);
      }
      n *= 2.f;
    }
    mean0 = m[0];
    mean1 = m[1];
    rstd0 = rsqrtf(m2[0] / K + p.eps);
    rstd1 = rsqrtf(m2[1] / K + p.eps);
  }
  COSY_PHASE(17);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = tid + q * kConsumers;
    if (k < K) {
      aff[k] = lw[q];
      aff[K + k] = lb[q];
    }
  }
  named_sync<1, kConsumers>();  // the affine is in place

  // h = (x - mean) rstd w + b in f32 as two fused multiply-adds, x rstd -
  // mean rstd first: within an f32 rounding or two of layer_norm_rows' order
  const float shift0 = -mean0 * rstd0, shift1 = -mean1 * rstd1;
  auto norm = [](float x, float rstd, float shift, float w, float b) {
    return fmaf(fmaf(x, rstd, shift), w, b);
  };
  // a TF32 pair: hi rounded to nearest (its low 13 bits zero: the tensor
  // cores read it exactly), lo = h - hi, of which they read the top 19 bits
  auto split = [](float h, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(h);
    lo = __float_as_uint(h - __uint_as_float(hi));
  };

  // slice i's A fragments: h normalised from the resident x tile, rounded
  // to T (bf16) or split into TF32 hi and lo (f32)
  using Frag = uint32_t[STEPS][4];
  auto build = [&](int i, Frag& a_hi, Frag& a_lo) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int s = c / 2, e = 2 * (c % 2);
      if constexpr (kF) {
        const int k = i * WS + 4 * c + t;
        const float w = aff[k], b = aff[K + k];
        split(norm(*reinterpret_cast<const float*>(word(xr0, i, c)), rstd0, shift0, w, b),
              a_hi[s][e], a_lo[s][e]);
        split(norm(*reinterpret_cast<const float*>(word(xr1, i, c)), rstd1, shift1, w, b),
              a_hi[s][e + 1], a_lo[s][e + 1]);
      } else {
        const int k = i * WS + 8 * c + 2 * t;
        const float2 w = *reinterpret_cast<const float2*>(aff + k);
        const float2 b = *reinterpret_cast<const float2*>(aff + K + k);
        float2 v0, v1;
        if constexpr (sizeof(TX) == sizeof(T)) {
          v0 = load_pair(reinterpret_cast<const TX*>(word(xr0, i, c)));
          v1 = load_pair(reinterpret_cast<const TX*>(word(xr1, i, c)));
        } else {
          v0 = x_pair(r0, k);
          v1 = x_pair(r1, k);
        }
        a_hi[s][e] = pack_bf16(norm(v0.x, rstd0, shift0, w.x, b.x),
                               norm(v0.y, rstd0, shift0, w.y, b.y));
        a_hi[s][e + 1] = pack_bf16(norm(v1.x, rstd1, shift1, w.x, b.x),
                                   norm(v1.y, rstd1, shift1, w.y, b.y));
      }
    }
  };
  // 3xTF32: split a landed W slice once for the block, hi in place (the 19
  // bits the tensor cores read), lo = w - hi beside it; then the fence that
  // lets wgmma read what the threads wrote
  auto split_w = [&](int i) {
    if constexpr (kF) {
      float4* h4 = reinterpret_cast<float4*>(ring + (i % kStages) * L::kStage);
      float4* l4 = h4 + L::kHalf / 16;
#pragma unroll
      for (int q = 0; q < WROWS; ++q) {
        const int e = tid + q * kConsumers;
        const float4 v = h4[e];
        const float4 h = make_float4(__uint_as_float(__float_as_uint(v.x) & 0xffffe000u),
                                     __uint_as_float(__float_as_uint(v.y) & 0xffffe000u),
                                     __uint_as_float(__float_as_uint(v.z) & 0xffffe000u),
                                     __uint_as_float(__float_as_uint(v.w) & 0xffffe000u));
        h4[e] = h;
        l4[e] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
      }
      fence_proxy_async();
    }
  };

  // the running sum and, under 3xTF32, one slice's sum (kPromote)
  float acc[BN / 2], part[kF ? BN / 2 : 1];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = part[kF ? e : 0] = 0.f;

  // Slice i: its products are issued on fragments `cur` and its split
  // stage; while they run, slice i + 1 lands, is split and has its
  // fragments built into `next`; then the products are waited for, the
  // partial sum promoted and the stage released.
  auto slice = [&](int i, Frag& cur_hi, Frag& cur_lo, Frag& next_hi, Frag& next_lo) {
    if constexpr (kF) named_sync<1, kConsumers>();  // every thread's split of stage i is done
    unsigned char* hi = ring + (i % kStages) * L::kStage;
    unsigned char* lo = hi + L::kHalf;
    // B of k step s: the BN rows, 32 bytes of K in
    auto desc = [&](unsigned char* base, int s) { return wgmma_desc(base + s * 32); };
    wgmma_fence();
    if constexpr (kF) {
      fence_operands(part);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        Wgmma<T, BN>::rs(part, cur_lo[s], desc(hi, s), s > 0);
        Wgmma<T, BN>::rs(part, cur_hi[s], desc(lo, s), 1);
        Wgmma<T, BN>::rs(part, cur_hi[s], desc(hi, s), 1);
      }
    } else {
      fence_operands(acc);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) Wgmma<T, BN>::rs(acc, cur_hi[s], desc(hi, s), 1);
    }
    wgmma_commit();
    if (i == 2) COSY_PHASE(14);
    if (i + 1 < n_slices) {
      wring->wait(i + 1);
      split_w(i + 1);
      build(i + 1, next_hi, next_lo);
    }
    if (i == 2) COSY_PHASE(15);
    wgmma_wait<0>();
    if (i == 2) COSY_PHASE(16);
    fence_operands(cur_hi);
    if constexpr (kF) {
      fence_operands(cur_lo);
      fence_operands(part);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
    } else {
      fence_operands(acc);
    }
    if (tid == 0) wring->release(i);
  };

  Frag f_hi[2], f_lo[2];  // f_lo: 3xTF32 only (bf16 leaves it unused)
  wring->wait(0);
  COSY_PHASE(11);
  split_w(0);
  build(0, f_hi[0], f_lo[0]);
  for (int i = 0; i < n_slices; i += 2) {
    slice(i, f_hi[0], f_lo[0], f_hi[1], f_lo[1]);
    if (i + 1 < n_slices) slice(i + 1, f_hi[1], f_lo[1], f_hi[0], f_lo[0]);
  }
  COSY_PHASE(12);

  // The epilogue: rows r0, r1 of the tile, columns 8j + 2t and the next.  A tile inside its segment goes out by TMA: the
  // consumers write it into the free ring as boxes of 64 rows and 128 bytes
  // of columns (swizzled, as TMA reads them) and one thread stores them.
  if (p.y_tma && n0 + BN <= p.seg) {
    named_sync<1, kConsumers>();  // every product is done: the ring is free
    const int es = p.out_f32 ? 4 : 2, bw = kSlice / es;
    unsigned char* stage = ring;
    auto put = [&](int rl, int col, float2 v) {
      const int byte = (col % bw) * es;
      unsigned char* at = stage + (col / bw) * 64 * kSlice + rl * kSlice +
                          ((((byte >> 4) ^ (rl & 7)) << 4) | (byte & 15));
      if (p.out_f32) *reinterpret_cast<float2*>(at) = v;
      else store_pair(reinterpret_cast<T*>(at), v);
    };
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      put(r0, col, make_float2(acc[4 * j], acc[4 * j + 1]));
      put(r1, col, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
    fence_proxy_async();
    named_sync<1, kConsumers>();
    if (tid == 0) {
      for (int bx = 0; bx < BN * es / kSlice; ++bx)
        tma_store_2d(&p.y_map, stage + bx * 64 * kSlice, sg * p.seg + n0 + bx * bw, m0);
      tma_store_wait();
    }
  } else {
    const long long row0 = m0 + r0, row1 = m0 + r1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.seg) continue;
      const long long gc = static_cast<long long>(sg) * p.seg + col;
      const float2 v0 = make_float2(acc[4 * j], acc[4 * j + 1]);
      const float2 v1 = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      if (p.out_f32) {
        float* y = static_cast<float*>(p.y);
        if (row0 < p.M) store_pair(y + row0 * p.N + gc, v0);
        if (row1 < p.M) store_pair(y + row1 * p.N + gc, v1);
      } else {
        T* y = static_cast<T*>(p.y);
        if (row0 < p.M) store_pair(y + row0 * p.N + gc, v0);
        if (row1 < p.M) store_pair(y + row1 * p.N + gc, v1);
      }
    }
  }
  COSY_PHASE(13);
}

template <typename T, typename TX, int BN>
cudaError_t launch(const LnGemmArgs& args, cudaStream_t stream) {
  using L = LnGemmSmem<T, TX, BN>;
  auto kernel = ln_gemm_kernel<T, TX, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(kLnMaxK));
  if (attr != cudaSuccess) return attr;
  const int segs = args.N / args.seg;
  const dim3 grid(segs * args.tiles_per_seg, (args.M + 63) / 64);
  kernel<<<grid, 160, L::bytes(args.K), stream>>>(args);
  return cudaGetLastError();
}

// the tiles the wrapper's plan may name (ops/fused_block.py _LN_GEMM_TILES):
// 64 rows and 64 or 128 columns
template <typename T, typename TX>
cudaError_t dispatch(const LnGemmArgs& args, int block_m, int block_n, cudaStream_t s) {
  if (block_m != 64) return cudaErrorInvalidValue;
  if (block_n == 64) return launch<T, TX, 64>(args, s);
  if (block_n == 128) return launch<T, TX, 128>(args, s);
  return cudaErrorInvalidValue;
}

bool valid_dtype(int d) { return d == kF32 || d == kBF16; }

}  // namespace
}  // namespace cosy

#ifdef COSY_TRACE
// the phase times of the last COSY_TRACE launch (ops/phase_trace.py)
extern "C" int cosy_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cosy::trace_ns, sizeof(cosy::trace_ns)));
}
#endif

// Kernel B1: y (M, N) = LayerNorm(x) (M, K) . W^T with f32 statistics, eps
// and the affine ln_w / ln_b of the weights' type, h rounded to that type.
// x is f32 or of the weights' type (in_dtype); y is f32 or of the weights'
// type.  W is one to three row segments of `seg` rows (w1 / w2 null when N
// is seg / 2 seg), N a multiple of seg.  K a multiple of 64 and at most
// 256; seg a multiple of 4; every pointer 16-byte aligned.  (block_m,
// block_n) is one of the tiles dispatch names.
extern "C" int cosy_ln_gemm(int dtype, int in_dtype, int out_dtype, const void* x,
                            const void* ln_w, const void* ln_b, const void* w0,
                            const void* w1, const void* w2, int seg, void* y, int M, int N,
                            int K, float eps, int block_m, int block_n, void* stream) {
  using namespace cosy;
  const int segs = seg > 0 ? N / seg : 0;
  const void* ws[3] = {w0, w1, w2};
  if (!valid_dtype(dtype) || !valid_dtype(in_dtype) || !valid_dtype(out_dtype) ||
      (in_dtype != kF32 && in_dtype != dtype) || M <= 0 || K <= 0 || K > kLnMaxK ||
      K % 64 != 0 || seg <= 0 || seg % 4 != 0 || N % seg != 0 || segs < 1 || segs > 3 ||
      block_n <= 0 || block_m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LnGemmArgs args{};
  cudaError_t err = make_tensor_map(&args.x_map, x, in_dtype == kF32, M, K, block_m);
  for (int i = 0; i < 3; ++i) {
    if (err != cudaSuccess) return static_cast<int>(err);
    if (i < segs && ws[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // an unused segment's map repeats the first; no block reads it
    err = make_tensor_map(&args.w_map[i], i < segs ? ws[i] : w0, dtype == kF32, seg, K,
                          block_n);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // y by TMA where its rows are 16-byte multiples (N * its size)
  const bool out_f32 = out_dtype == kF32;
  args.y_tma = (N * (out_f32 ? 4 : 2)) % 16 == 0 &&
               make_tensor_map(&args.y_map, y, out_f32, M, N, 64) == cudaSuccess;
  args.ln_w = ln_w;
  args.ln_b = ln_b;
  args.y = y;
  args.M = M;
  args.N = N;
  args.K = K;
  args.seg = seg;
  args.tiles_per_seg = (seg + block_n - 1) / block_n;
  args.out_f32 = out_dtype == kF32;
  args.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) err = dispatch<float, float>(args, block_m, block_n, s);
  else if (in_dtype == kF32) err = dispatch<__nv_bfloat16, float>(args, block_m, block_n, s);
  else err = dispatch<__nv_bfloat16, __nv_bfloat16>(args, block_m, block_n, s);
  return static_cast<int>(err);
}
