// Kernel B2, the block tail: everything of the estimator's transformer block
// after attention, in one launch,
//   x1 = x + a Wo^T + bo                 (f32, never leaves the chip)
//   h2 = LN3(x1)                         (f32 statistics, rounded to T)
//   f  = gelu(h2 W1^T + b1)              (tanh or erf GELU, rounded to T, never
//                                        leaves the chip)
//   y  = x1 + (f W2^T + b2)              (rounded to x's type T)
// with a (M, I) the attention output of kernel A and x (M, C) the block's
// input, both of type T.  Replaces lines :74-87 of the JAX package's Pallas
// kernel cosy_tpu/ops/fused_block.py (_make_kernel :34, call :129), which
// held the block's rows and its (T, 1024) FF hidden in VMEM.
//
// What bounds it on an H100: 2 M (C I + 2 C F) flops, 1.31 M MFLOP at C =
// 256, I = 512, F = 1024, over ~1.5 MB (f32) of weights that every row tile
// reads from L2.  At the estimator's 150-312 rows that is 0.2-0.4 GFLOP: a
// few microseconds of 3xTF32 at the tensor cores' peak, under 1.3 us of
// bytes.  What bounds this kernel is how many SMs share a 64-row tile's
// products (a wgmma takes 64 rows, so row tiles alone give 3-5 blocks), the
// rate one warpgroup reaches with narrow (n32, n64) products fed from
// registers (measured ~48 ns an m64n64k8 TF32 product, a third of the peak;
// PERF.md), and the cost of joining the blocks' parts.  At 5116 rows (80
// row tiles) it is the products.
//
// The design (one 64-row tile and rank r of R a block; warps 0-3 the one
// consumer warpgroup, warp 4 the producer, warp 5 the splitter):
//  - Hopper's mainloop (wgmma.cuh): the producer thread streams every tile
//    the block multiplies, in the order it is multiplied, by TMA into a
//    ring of stages (an item: a's 64 rows, or up to 64 W rows, of one
//    128-byte K slice; x's columns land once, up front), completion on
//    mbarriers; the consumers run wgmma.mma_async with A from registers and
//    B from the ring, one commit group a step, the next step's fragments
//    built and issued before the last step's products are waited for.  No A
//    operand passes through shared memory as a tile of its own: the
//    out-projection's A is a's landed slice, split or taken in registers;
//    FF1's is h2, normalised into registers straight from the x1 tile; FF2's
//    is f, built in registers from FF1's accumulators after b1 and the GELU
//    (as FlashAttention-3 keeps P).  In TF32 the accumulator holds columns
//    (2t, 2t+1) where a k8 fragment takes (t, t+4): the splitter permutes
//    each landed W2 item's K index within each group of 8 (0,2,4,6,1,3,5,7)
//    in the pass it already makes, so nothing moves between lanes.  In bf16
//    two n8 accumulator chunks are one k16 fragment as they stand.
//  - f32 is error-compensated 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi),
//    B1's rules: A split in registers (hi = cvt.rna, lo = the rest); each
//    landed W item split once by the splitter warp by truncation, hi written
//    back, lo beside it, then fence.proxy.async and a split barrier the
//    consumers wait on.  The tensor cores add by truncation, so no chain is
//    longer than 256 of K: the out-projection's is promoted every 256 into
//    the x1 tile, FF1's is 256 (C), FF2's 64 (half a sub-tile), whose sums
//    meet in an f32 FF2 sum in shared memory, quarter by quarter, rounding to
//    nearest; so no 64 x 256 accumulator stays in registers (the consumers
//    use 153-246 registers, no spill).
//  - The split, option (N): rank r owns a chunk of x1 and y columns and
//    F / R FF hidden columns.  It computes its chunk over the whole of K (a
//    landed by every rank: not multicast) and pushes it into every peer's
//    x1 tile (cp.async.bulk into the peer's shared memory, completion on the
//    peer's own mbarrier): every rank holds the whole 64 x 256 f32 x1 tile
//    and takes the same LN3 statistics in the same order (each thread its
//    two rows, Chan's rule a slice, as B1), so no statistics are exchanged.
//    FF1 and FF2 run sub-tile by sub-tile (128 hidden columns: FF1 as two
//    independent n64 chains on one set of h2 fragments).  The FF2 sum's
//    chunks then go to their owners (a reduce-scatter: as soon as the last
//    update of their columns is in, into the owner's x1 tile at this rank's
//    chunk, dead after the owner's last FF1, which the owner says by one
//    remote arrival on each sender's barrier); the owner sums the R parts in
//    rank order, adds b2 and x1 and stores y.  At R = 16 (a non-portable
//    cluster) the ranks pair up on 8 chunks: a pair splits the chunk's
//    out-projection over two halves of K and sums them in order, and each
//    of the pair stores the y of half the rows.  No atomics, no global
//    scratch: two calls give the same bits.  The cluster barrier is taken
//    twice: split around the out-projection after the barriers'
//    initialisation, and split around the final sum at the end.  R = 1
//    (large M) has no cluster launch attribute and no exchange.
//  - Shared memory: the ring (f32: 6 stages of 64 W rows hi + lo, 16 KB;
//    bf16: 12 of 8 KB), the f32 x1 tile (8 slices of 64 rows x 128 bytes,
//    128-byte swizzled: a chunk is whole slices, so each push is one
//    contiguous copy) and the f32 FF2 sum of its shape.  Regions are reused
//    where their data is dead: x's columns and the partner's out-projection
//    part land in the FF2 sum's place, the out-projection's promoted sum lies
//    in the rank's own x1 columns, and the received FF2 parts land in the x1
//    columns of the other chunks.  n3w, n3b, bo, b2 and b1 are read through
//    L1, prefetched at the start.
// The plan (block_m, cluster, sub-tile) is the wrapper's _tail_plan;
// ops/fused_block.py _tail_smem_bytes mirrors TailSmem.
#include "wgmma.cuh"

namespace cosy {
namespace {

constexpr int kC = 256;             // the block's width: the only one instantiated
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr int kSlice = 128;         // bytes of a row in a K slice (the swizzle width)
constexpr int kBM = 64;             // rows of a block: one wgmma tile
constexpr int kFS = 128;            // FF hidden columns of a sub-tile
constexpr int kFH = 64;             // a half of it: FF1's N a product, FF2's K a pass
constexpr int kWRows = 64;          // the most W rows an item brings (a product's N)
constexpr int kPromoteK = 256;      // the out-projection's chain is promoted this often
constexpr int kConsumers = 128;     // one consumer warpgroup; warp 4 produces, warp 5 splits
constexpr int kThreads = kConsumers + 64;

struct TailArgs {
  CUtensorMap a_map, wo_map, w1_map, w2_map, x_map;  // a (M, I); Wo (C, I); W1 (F, C); W2 (C, F); x
  const void *bo, *n3w, *n3b, *b1, *b2;
  void* y;
  int M, I, F;
  float eps;
  int act;  // kGeluTanh or kGeluErf
};

// shared memory of one instantiation: the ring of stages (an item's rows,
// and under 3xTF32 a W item's lo beside them at kHalf), the f32 x1 tile,
// the f32 FF2 sum in the x1 tile's shape (x's columns of the rank land there
// first), the barriers; plus the slack that aligns the start to 1024 bytes
template <typename T, int R>
struct TailSmem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStages = kF32 ? 6 : 12;
  static constexpr int kHalf = kWRows * kSlice;
  static constexpr int kStage = kHalf * (kF32 ? 2 : 1);
  static constexpr int ring = kStages * kStage;
  static constexpr int x1 = kBM * kC * 4;
  static constexpr int bars = (3 * kStages + 5) * 8;
  static constexpr int bytes = 1024 + ring + 2 * x1 + bars;
  static_assert(bytes <= kSmemLimit, "the plan's shared memory exceeds 227 KB");
};

// byte offset of x1 (row, col) in the x1 tile (and of the FF2 partials in
// its shape): 32 f32 columns a slice of 64 rows x 128 bytes, the 16-byte
// chunk c of row r at c ^ (r % 8)
__device__ __forceinline__ int x1_offset(int row, int col) {
  const int byte = (col % 32) * 4;
  return (col / 32) * (kBM * kSlice) + row * kSlice + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

// the tanh GELU as v sigmoid(2u), u = sqrt(2/pi) (v + 0.044715 v^3): one
// exponential (ex2) and one fast division, within a few f32 roundings of
// 0.5 v (1 + tanh(u)) and with no cancellation for negative v, where
// 1 + tanh(u) loses the relative accuracy of any tanh (so no tanh.approx);
// the erf GELU as it is
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.7978845608028654f * fmaf(0.044715f * v, v * v, v);
  return __fdividef(v, 1.f + __expf(fminf(-2.f * u, 80.f)));
}
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678f));
}

// a read-only vector's element k (f32 or bf16), and the pair k, k + 1
__device__ __forceinline__ float vec1(const float* v, int k) { return __ldg(v + k); }
__device__ __forceinline__ float vec1(const __nv_bfloat16* v, int k) {
  return __bfloat162float(__ldg(v + k));
}
__device__ __forceinline__ float2 vec2(const float* v, int k) {
  return __ldg(reinterpret_cast<const float2*>(v + k));
}
__device__ __forceinline__ float2 vec2(const __nv_bfloat16* v, int k) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(v + k)));
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1) block_tail_kernel(const __grid_constant__ TailArgs p) {
  using L = TailSmem<T, R>;
  constexpr bool kF = L::kF32;
  constexpr int S = L::kStages;
  constexpr int VS = kSlice / sizeof(T);                 // K values a slice: 32 f32, 64 bf16
  constexpr int STEPS = VS / (kF ? 8 : 16);              // 4 products a slice
  // R = 16: the ranks pair up, 8 chunks of x1 columns, each computed by a
  // pair over the two halves of K and its rows' y shared by the pair
  constexpr bool kPair = R == 16;
  constexpr int NCH = kPair ? 8 : R;                     // chunks of x1 columns
  constexpr int CR = kC / NCH;                           // x1 columns of a chunk
  constexpr int NO = CR < kWRows ? CR : kWRows;          // the out-projection's N a product
  // its passes over K: 128 columns a pass (two n64 chains) where a chunk
  // has them (R <= 2), else the chunk's NO columns (the even and the odd k
  // steps two chains)
  constexpr bool kTwoCols = CR >= 2 * kWRows;
  constexpr int HO = kTwoCols ? CR / (2 * kWRows) : CR / NO;
  constexpr int NQ = kC / kWRows;                        // FF2's products a k step (4)
  constexpr int kChunk = kBM * CR * 4;                   // bytes of a chunk's x1 columns
  constexpr int UH = kPair ? 1 : 2;                      // FF hidden halves of a sub-tile
  constexpr int n1 = kC / VS, n2 = kFH / VS;             // FF1 slices, FF2 slices a half
  constexpr int kPS = kPromoteK / VS;                    // out-projection slices a chain
  constexpr int XB = (CR + VS - 1) / VS;                 // x boxes of the chunk's columns
  constexpr int IT_O = kTwoCols ? 3 : 2, IT_1 = UH;     // items a step: a + Wo; W1's halves
  constexpr int kYRows = kPair ? kBM / 2 : kBM;          // y rows a rank stores

  COSY_PHASE(0);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* X1 = ring + L::ring;
  unsigned char* FSUM = X1 + L::x1;  // x's columns of the rank, then the FF2 partial sum
  uint64_t* bars = reinterpret_cast<uint64_t*>(FSUM + L::x1);
  TmaRing<S>* wring = reinterpret_cast<TmaRing<S>*>(bars);
  uint64_t* split = bars + 2 * S;  // 3xTF32: stage s's W is split (the splitter warp)
  uint64_t* xfull = split + S;     // the other ranks' x1 columns have landed
  uint64_t* pfull = xfull + 1;     // the other ranks' FF2 partials have landed
  uint64_t* ready = xfull + 2;     // the owners' x1 columns of this rank are dead
  uint64_t* xland = xfull + 3;     // x's columns of the rank have landed
  uint64_t* pairbar = xfull + 4;   // R = 16: the partner's out-projection part has landed

  const int rank = R > 1 ? static_cast<int>(blockIdx.x) : 0;
  const int chunk = kPair ? rank / 2 : rank, half = kPair ? rank % 2 : 0;
  const int m0 = blockIdx.y * kBM, c0 = chunk * CR, xc0 = c0 / VS * VS;
  const int n_sub = p.F / R / (UH * kFH), n_o = p.I / VS;
  // the out-projection's slices of this rank: all of K, or a pair's half
  const int n_oi = kPair ? n_o / 2 : n_o, o0 = half * n_oi;
  unsigned char* pair_in = FSUM + 4 * kBM * kSlice;  // R = 16: the partner's part lands here
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto stage = [&](int item) { return ring + (item % S) * L::kStage; };

  // Every item of the stream, one TMA box each, in the order it is
  // multiplied: f(item, map, box rows, c0, c1, rows to split, permute).  An
  // a item has no rows to split.
  enum { kPlain = 0, kPermuted = 1 };
  auto for_items = [&](auto&& f) {
    int item = 0;
    for (int h = 0; h < HO; ++h)
      for (int i = o0; i < o0 + n_oi; ++i, item += IT_O) {
        f(item, &p.a_map, kBM, i * VS, m0, 0, kPlain);
        for (int c = 1; c < IT_O; ++c)
          f(item + c, &p.wo_map, NO, i * VS, c0 + h * NO * (IT_O - 1) + (c - 1) * NO, NO, kPlain);
      }
    for (int s = 0; s < n_sub; ++s) {
      const int j0 = rank * (p.F / R) + s * UH * kFH;
      for (int i = 0; i < n1; ++i)
        for (int u = 0; u < UH; ++u, ++item)
          f(item, &p.w1_map, kFH, i * VS, j0 + u * kFH, kFH, kPlain);
      for (int u = 0; u < UH; ++u)
        for (int q = 0; q < NQ; ++q)
          for (int i = 0; i < n2; ++i, ++item)
            f(item, &p.w2_map, kWRows, j0 + u * kFH + i * VS, q * kWRows, kWRows, kPermuted);
    }
  };

  if (threadIdx.x == 0) {
    wring->init(1);
    for (int q = 0; q < S; ++q) mbar_init(&split[q], 1);
    mbar_init(xfull, 1);
    mbar_init(pfull, 1);
    mbar_init(ready, R > 1 ? R - 1 : 1);
    mbar_init(xland, 1);
    mbar_init(pairbar, 1);
    if constexpr (R > 1) {
      // R = 16: the 7 other chunks, 15 parts of 32 rows of this rank's chunk
      mbar_arrive_expect(xfull, (NCH - 1) * kChunk);
      mbar_arrive_expect(pfull, (R - 1) * (kChunk / (kPair ? 2 : 1)));
    }
    if constexpr (kPair) mbar_arrive_expect(pairbar, kChunk);
    mbar_init_fence();
  }
  __syncthreads();
  if constexpr (R > 1) cluster_arrive();  // the barriers are initialised; waited on before any push

  if (warp >= 4) {
    if (warp == 4 && lane == 0) {  // the producer: one thread issues every copy, in order
      tma_prefetch_map(&p.w1_map);
      tma_prefetch_map(&p.w2_map);
      // x's columns of the rank land in the FF2 sum's place, idle until FF2
      mbar_arrive_expect(xland, XB * kBM * kSlice);
      for (int b = 0; b < XB; ++b)
        tma_load_2d(FSUM + b * kBM * kSlice, &p.x_map, xland, xc0 + b * VS, m0);
      for_items([&](int item, const CUtensorMap* map, int rows, int x0, int y0, int, int) {
        tma_load_2d(stage(item), map, wring->acquire(item, rows * kSlice), x0, y0);
      });
    } else if (warp == 5 && kF) {
      // the splitter (3xTF32): each landed W item is split once, hi in place
      // (truncated to the 19 bits the tensor cores read), lo = w - hi at
      // kHalf, W2's K index permuted within each group of 8 to 0,2,4,6,1,3,5,7
      // (the order FF1's accumulator hands f to FF2); then fence.proxy.async
      // and one arrival on the stage's split barrier
      auto trunc4 = [](float4 v) {
        return make_float4(__uint_as_float(__float_as_uint(v.x) & 0xffffe000u),
                           __uint_as_float(__float_as_uint(v.y) & 0xffffe000u),
                           __uint_as_float(__float_as_uint(v.z) & 0xffffe000u),
                           __uint_as_float(__float_as_uint(v.w) & 0xffffe000u));
      };
      auto sub4 = [](float4 a, float4 b) {
        return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
      };
      for_items([&](int item, const CUtensorMap*, int, int, int, int rows, int perm) {
        wring->wait(item);
        if (rows > 0) {
          unsigned char* st = stage(item);
          if (perm == kPermuted) {
            for (int e = lane; e < rows * 4; e += 32) {
              const int n = e >> 2, grp = e & 3;
              float4* row = reinterpret_cast<float4*>(st + n * kSlice);
              float4* lrow = reinterpret_cast<float4*>(st + L::kHalf + n * kSlice);
              const int ca = (2 * grp) ^ (n & 7), cb = (2 * grp + 1) ^ (n & 7);
              const float4 a = row[ca], b = row[cb];
              const float4 u = make_float4(a.x, a.z, b.x, b.z), v = make_float4(a.y, a.w, b.y, b.w);
              const float4 uh = trunc4(u), vh = trunc4(v);
              row[ca] = uh;
              row[cb] = vh;
              lrow[ca] = sub4(u, uh);
              lrow[cb] = sub4(v, vh);
            }
          } else {
            float4* h4 = reinterpret_cast<float4*>(st);
            float4* l4 = reinterpret_cast<float4*>(st + L::kHalf);
            for (int e = lane; e < rows * 8; e += 32) {
              const float4 v = h4[e], h = trunc4(v);
              h4[e] = h;
              l4[e] = sub4(v, h);
            }
          }
          fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&split[item % S]);
      });
    }
    if constexpr (R > 1) {
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // the consumers
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // the thread's rows
  const T* n3w = static_cast<const T*>(p.n3w);
  const T* n3b = static_cast<const T*>(p.n3b);
  const T* bo = static_cast<const T*>(p.bo);
  const T* b1 = static_cast<const T*>(p.b1) + rank * (p.F / R);  // the rank's hidden columns
  const T* b2 = static_cast<const T*>(p.b2);
  {
    // the vectors this rank reads (n3w, n3b whole; bo, b2 of its chunk; b1
    // of its hidden columns) into L1 now, 128-byte lines, one a thread at a
    // time, so that their first reads do not wait on L2
    constexpr int kLine = 128 / sizeof(T);
    const int lines_c = kC / kLine, lines_o = (CR + kLine - 1) / kLine;
    const int lines_h = (p.F / R + kLine - 1) / kLine;
    for (int l = tid; l < 2 * lines_c + 2 * lines_o + lines_h; l += kConsumers) {
      const T* at = l < lines_c          ? n3w + l * kLine
                    : l < 2 * lines_c    ? n3b + (l - lines_c) * kLine
                    : l < 2 * lines_c + lines_o ? bo + c0 + (l - 2 * lines_c) * kLine
                    : l < 2 * lines_c + 2 * lines_o
                        ? b2 + c0 + (l - 2 * lines_c - lines_o) * kLine
                        : b1 + (l - 2 * lines_c - 2 * lines_o) * kLine;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(at));
    }
  }

  // item i has landed and, under 3xTF32, its W is split
  auto ready_item = [&](int i) {
    if constexpr (kF) mbar_wait(&split[i % S], (i / S) & 1);
    else wring->wait(i);
  };
  // a TF32 pair: hi rounded to nearest (its low 13 bits zero: the tensor
  // cores read it exactly), lo = v - hi, of which they read the top 19 bits
  auto split2 = [](float v, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
  };
  // B of k step s of a stage's hi or lo area: its rows, 32 bytes of K in
  auto desc = [](const unsigned char* base, int s) { return wgmma_desc(base + s * 32); };

  using Frag = uint32_t[STEPS][4];
  Frag f_hi[2], f_lo[2];  // f_lo: 3xTF32 only (bf16 leaves it unused)
  // The thread's word of 16-byte chunk c of a 64-row slice at `base`:
  // bytes 4t .. 4t + 3 of the chunk, which the swizzle puts at c ^ g in both
  // rows r0 and r1 = r0 + 8.  It holds one f32 value or two bf16 values,
  // and a product's A fragment takes exactly the words of the slice's eight
  // chunks (c = 2 step + half).
  auto word = [&](const unsigned char* base, int row, int c) {
    return base + row * kSlice + 4 * t + ((c ^ g) << 4);
  };

  // A mainloop of n product steps, one commit group a step: step k + 1's
  // items are waited for and its fragments built (prep) while step k's
  // products run, then issued before step k's are waited for; where post(k)
  // reads the accumulators (ends(k): a chain's end) step k is waited for
  // first.
  auto issue_group = [&](int k, Frag& hi, Frag& lo, auto&& issue, auto& acc) {
    fence_operands(acc);
    wgmma_fence();
    issue(k, hi, lo);
    wgmma_commit();
  };
  auto step = [&](int k, int n, Frag& cur_hi, Frag& cur_lo, Frag& next_hi, Frag& next_lo,
                  auto&& prep, auto&& issue, auto&& post, auto&& ends, auto& acc) {
    const bool more = k + 1 < n, hold = more && !ends(k);
    if (more) prep(k + 1, next_hi, next_lo);
    if (hold) {
      issue_group(k + 1, next_hi, next_lo, issue, acc);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operands(cur_hi);
    if constexpr (kF) fence_operands(cur_lo);
    fence_operands(acc);
    post(k);
    if (more && !hold) issue_group(k + 1, next_hi, next_lo, issue, acc);
  };
  auto run = [&](int n, auto&& prep, auto&& issue, auto&& post, auto&& ends, auto& acc) {
    prep(0, f_hi[0], f_lo[0]);
    issue_group(0, f_hi[0], f_lo[0], issue, acc);
    for (int k = 0; k < n; k += 2) {
      step(k, n, f_hi[0], f_lo[0], f_hi[1], f_lo[1], prep, issue, post, ends, acc);
      if (k + 1 < n) step(k + 1, n, f_hi[1], f_lo[1], f_hi[0], f_lo[0], prep, issue, post, ends, acc);
    }
  };
  // the products of one k slice into two accumulators, the even and the odd
  // k steps (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi), so that two
  // independent chains alternate on the tensor cores; `start`: the first
  // products of a chain, which set the accumulators
  auto two_chain_products = [&](auto& acc0, auto& acc1, const unsigned char* wh, Frag& hi, Frag& lo,
                            bool start) {
    constexpr int NN = sizeof(acc0) / sizeof(float) * 2;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      auto& acc = (s & 1) ? acc1 : acc0;
      const int keep = !(start && s < 2);
      if constexpr (kF) {
        Wgmma<T, NN>::rs(acc, lo[s], desc(wh, s), keep);
        Wgmma<T, NN>::rs(acc, hi[s], desc(wh + L::kHalf, s), 1);
        Wgmma<T, NN>::rs(acc, hi[s], desc(wh, s), 1);
      } else {
        Wgmma<T, NN>::rs(acc, hi[s], desc(wh, s), keep);
      }
    }
  };

  // ---- 1. the out-projection: x1 columns [c0, c0 + CR) over all of K, ----
  // a pass over K for every 128 columns (R <= 2) or for the chunk's NO; each
  // chain of kPromoteK ends in the rank's own x1 columns, summed there with
  // rounding to nearest
  float acc_o[2][NO / 2];
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) acc_o[0][e] = acc_o[1][e] = 0.f;
#pragma unroll
  for (int h = 0; h < HO; ++h) {
    const int first = h * n_oi;  // the pass's first slice in the item stream
    // slice i's a fragments from its landed item, split (f32) or as they are
    auto prep_o = [&](int i, Frag& hi, Frag& lo) {
      const int it = (first + i) * IT_O;
#pragma unroll
      for (int c = 0; c < IT_O; ++c) ready_item(it + c);
      const unsigned char* st = stage(it);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = c / 2, e = 2 * (c % 2);
        if constexpr (kF) {
          split2(*reinterpret_cast<const float*>(word(st, r0, c)), hi[s][e], lo[s][e]);
          split2(*reinterpret_cast<const float*>(word(st, r1, c)), hi[s][e + 1], lo[s][e + 1]);
        } else {
          hi[s][e] = *reinterpret_cast<const uint32_t*>(word(st, r0, c));
          hi[s][e + 1] = *reinterpret_cast<const uint32_t*>(word(st, r1, c));
        }
      }
      if (h == 0 && i == 0) COSY_PHASE(1);
    };
    auto issue_o = [&](int i, Frag& hi, Frag& lo) {
      const int it = (first + i) * IT_O;
      if constexpr (kTwoCols) {  // a chain for each 64 columns
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const unsigned char* wh = stage(it + 1 + c);
            const int keep = s > 0 || i % kPS != 0;
            if constexpr (kF) {
              Wgmma<T, NO>::rs(acc_o[c], lo[s], desc(wh, s), keep);
              Wgmma<T, NO>::rs(acc_o[c], hi[s], desc(wh + L::kHalf, s), 1);
              Wgmma<T, NO>::rs(acc_o[c], hi[s], desc(wh, s), 1);
            } else {
              Wgmma<T, NO>::rs(acc_o[c], hi[s], desc(wh, s), keep);
            }
          }
      } else {
        two_chain_products(acc_o[0], acc_o[1], stage(it + 1), hi, lo, i % kPS == 0);
      }
    };
    auto ends_o = [&](int i) { return (i + 1) % kPS == 0 || i + 1 == n_oi; };
    auto post_o = [&](int i) {
      if (ends_o(i)) {
        const bool chain0 = i < kPS;
#pragma unroll
        for (int c = 0; c < (kTwoCols ? 2 : 1); ++c)
#pragma unroll
          for (int j = 0; j < NO / 8; ++j) {
            const int col = c0 + (h * (IT_O - 1) + c) * NO + 8 * j + 2 * t;
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              float2* at = reinterpret_cast<float2*>(X1 + x1_offset(e ? r1 : r0, col));
              // two column chains, or the even and the odd k steps' sums
              const float2 v = kTwoCols
                  ? make_float2(acc_o[c][4 * j + e], acc_o[c][4 * j + e + 1])
                  : make_float2(acc_o[0][4 * j + e] + acc_o[1][4 * j + e],
                                acc_o[0][4 * j + e + 1] + acc_o[1][4 * j + e + 1]);
              *at = chain0 ? v : make_float2(at->x + v.x, at->y + v.y);
            }
          }
      }
      if (tid == 0)
        for (int c = 0; c < IT_O; ++c) wring->release((first + i) * IT_O + c);
    };
    run(n_oi, prep_o, issue_o, post_o, ends_o, acc_o);
  }
  COSY_PHASE(2);
  named_sync<1, kConsumers>();  // every thread's out-projection sums are in place
  // the thread's four columns of bo (and later b2) are the same in every
  // row it takes: loaded before the waits
  const int col4 = c0 + 4 * (tid % (CR / 4));
  const float2 bo_a = vec2(bo, col4), bo_b = vec2(bo, col4 + 2);
  const float2 b2_a = vec2(b2, col4), b2_b = vec2(b2, col4 + 2);
  if constexpr (R > 1) cluster_wait();  // every rank's barriers are initialised
  if constexpr (kPair) {
    // the pair's two halves of K meet: this rank's part goes to its partner
    fence_proxy_async();
    named_sync<1, kConsumers>();
    if (tid == 0) bulk_push(pair_in, X1 + chunk * kChunk, kChunk, pairbar, rank ^ 1);
    mbar_wait_cluster(pairbar, 0);
  }
  mbar_wait(xland, 0);  // and x's columns

  // x1 = x + (a Wo^T + bo) in the rank's columns of the x1 tile, four
  // columns a thread at a time (x from its landed boxes: VS values of 128
  // bytes a row, 128-byte swizzled)
  for (int idx = tid; idx < kBM * CR / 4; idx += kConsumers) {
    const int row = idx / (CR / 4), col = c0 + 4 * (idx % (CR / 4));
    const int xb = (col - xc0) % VS * static_cast<int>(sizeof(T));
    const unsigned char* xp = FSUM + (col - xc0) / VS * (kBM * kSlice) + row * kSlice +
                              ((((xb >> 4) ^ (row & 7)) << 4) | (xb & 15));
    const float2 xa = load_pair(reinterpret_cast<const T*>(xp));
    const float2 xc = load_pair(reinterpret_cast<const T*>(xp) + 2);
    float4* at = reinterpret_cast<float4*>(X1 + x1_offset(row, col));
    float4 s = *at;
    if constexpr (kPair) {  // the two halves of K, the first half's first
      const float4 o = *reinterpret_cast<const float4*>(pair_in + x1_offset(row, col - c0));
      s = half ? make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w)
               : make_float4(s.x + o.x, s.y + o.y, s.z + o.z, s.w + o.w);
    }
    *at = make_float4(xa.x + (s.x + bo_a.x), xa.y + (s.y + bo_a.y), xc.x + (s.z + bo_b.x),
                      xc.y + (s.w + bo_b.y));
  }
  if constexpr (R > 1) {
    // the chunk's columns go to every other chunk's ranks (R = 16: those of
    // this rank's half, the partner serving the other half)
    fence_proxy_async();
    named_sync<1, kConsumers>();
    if (tid < NCH && tid != chunk) {
      unsigned char* mine = X1 + chunk * kChunk;
      bulk_push(mine, mine, kChunk, xfull, kPair ? 2 * tid + half : tid);
    }
    mbar_wait_cluster(xfull, 0);
  } else {
    named_sync<1, kConsumers>();
  }
  COSY_PHASE(3);

  // ---- 2. LN3 statistics of rows r0 and r1 over the whole x1 tile ----
  // Each x1 slice's 8 values of a row are summed about their own mean and
  // merged into a running (mean, M2) by Chan's rule, then the quad's four
  // are merged in two shuffles: nothing cancels, whatever the row's |mean| /
  // std or where an outlier sits.  Every rank takes the same statistics in
  // the same order.
  float mean0, mean1, rstd0, rstd1;
  {
    float m[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    for (int j = 0; j < kC / 32; ++j) {
      const unsigned char* sl = X1 + j * kBM * kSlice;
      float v[2][8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[0][c] = *reinterpret_cast<const float*>(word(sl, r0, c));
        v[1][c] = *reinterpret_cast<const float*>(word(sl, r1, c));
      }
      const float share = 1.f / (j + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[r][e];
        const float bm = s * (1.f / 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[r][e] - bm;
          q = fmaf(d, d, q);
        }
        const float d = bm - m[r];
        m[r] = fmaf(d, share, m[r]);
        m2[r] += fmaf(d * d, 8 * j * share, q);
      }
    }
    float n = static_cast<float>(kC / 4);
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
    rstd0 = rsqrtf(m2[0] / kC + p.eps);
    rstd1 = rsqrtf(m2[1] / kC + p.eps);
  }
  // h2 = (x1 - mean) rstd w + b in f32 as two fused multiply-adds, x1 rstd -
  // mean rstd first (B1's order)
  const float shift0 = -mean0 * rstd0, shift1 = -mean1 * rstd1;
  auto norm = [](float v, float rstd, float shift, float w, float b) {
    return fmaf(fmaf(v, rstd, shift), w, b);
  };

  // ---- 3. FF1 + GELU -> f (registers) -> FF2, sub-tile by sub-tile ----
  // A sub-tile is 128 hidden columns: FF1 as two n64 products (two
  // independent chains on the same h2 fragments), then FF2 half by half.
  float acc1[UH][kFH / 2];
#pragma unroll
  for (int u = 0; u < UH; ++u)
#pragma unroll
    for (int e = 0; e < kFH / 2; ++e) acc1[u][e] = 0.f;
  const int items_o = HO * n_oi * IT_O;
  constexpr int items_sub = n1 * IT_1 + UH * NQ * n2;

  for (int sub = 0; sub < n_sub; ++sub) {
    const int base = items_o + sub * items_sub;
    // FF1 slice i's A fragments: h2 normalised from the x1 tile, split
    // (f32) or rounded to bf16
    auto prep_1 = [&](int i, Frag& hi, Frag& lo) {
#pragma unroll
      for (int u = 0; u < UH; ++u) ready_item(base + IT_1 * i + u);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = c / 2, e = 2 * (c % 2);
        if constexpr (kF) {
          const int k = i * VS + 4 * c + t;
          const float w = vec1(n3w, k), b = vec1(n3b, k);
          const unsigned char* sl = X1 + i * kBM * kSlice;
          split2(norm(*reinterpret_cast<const float*>(word(sl, r0, c)), rstd0, shift0, w, b),
                 hi[s][e], lo[s][e]);
          split2(norm(*reinterpret_cast<const float*>(word(sl, r1, c)), rstd1, shift1, w, b),
                 hi[s][e + 1], lo[s][e + 1]);
        } else {
          const int k = i * VS + 8 * c + 2 * t;
          const float2 w = vec2(n3w, k), b = vec2(n3b, k);
          const float2 v0 = *reinterpret_cast<const float2*>(X1 + x1_offset(r0, k));
          const float2 v1 = *reinterpret_cast<const float2*>(X1 + x1_offset(r1, k));
          hi[s][e] = pack_bf16(norm(v0.x, rstd0, shift0, w.x, b.x),
                               norm(v0.y, rstd0, shift0, w.y, b.y));
          hi[s][e + 1] = pack_bf16(norm(v1.x, rstd1, shift1, w.x, b.x),
                                   norm(v1.y, rstd1, shift1, w.y, b.y));
        }
      }
    };
    auto issue_1 = [&](int i, Frag& hi, Frag& lo) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int keep = s > 0 || i > 0;
#pragma unroll
        for (int u = 0; u < UH; ++u) {
          const unsigned char* wh = stage(base + IT_1 * i + u);
          if constexpr (kF) {
            Wgmma<T, kFH>::rs(acc1[u], lo[s], desc(wh, s), keep);
            Wgmma<T, kFH>::rs(acc1[u], hi[s], desc(wh + L::kHalf, s), 1);
            Wgmma<T, kFH>::rs(acc1[u], hi[s], desc(wh, s), 1);
          } else {
            Wgmma<T, kFH>::rs(acc1[u], hi[s], desc(wh, s), keep);
          }
        }
      }
    };
    run(
        n1, prep_1, issue_1,
        [&](int i) {
          if (tid == 0)
            for (int u = 0; u < UH; ++u) wring->release(base + IT_1 * i + u);
        },
        [](int) { return false; }, acc1);
    if (sub == 0) COSY_PHASE(4);
    if constexpr (R > 1) {
      if (sub + 1 == n_sub) {
        // the x1 columns of the other ranks are read for the last time:
        // each may now push its FF2 partial of this rank's columns there
        named_sync<1, kConsumers>();
        if (tid < R && tid != rank) mbar_arrive_remote(ready, tid);  // in parallel
      }
    }
    // f = gelu(h2 W1^T + b1) in FF1's accumulators
    auto activate_all = [&](auto&& act) {
#pragma unroll
      for (int u = 0; u < UH; ++u)
#pragma unroll
        for (int j = 0; j < kFH / 8; ++j) {
          const float2 b = vec2(b1, (sub * UH + u) * kFH + 8 * j + 2 * t);
          acc1[u][4 * j] = act(acc1[u][4 * j] + b.x);
          acc1[u][4 * j + 1] = act(acc1[u][4 * j + 1] + b.y);
          acc1[u][4 * j + 2] = act(acc1[u][4 * j + 2] + b.x);
          acc1[u][4 * j + 3] = act(acc1[u][4 * j + 3] + b.y);
        }
    };
    // one branch a sub-tile on the runtime GELU code (kGeluTanh or kGeluErf)
    if (p.act == kGeluErf) activate_all([](float v) { return gelu_erf(v); });
    else activate_all([](float v) { return gelu_tanh(v); });

    // FF2, half by half: f W2[:, 64 hidden columns]^T, 64 output columns (a
    // quarter, one n64 accumulator, one commit group) at a time, a chain of
    // 64; while quarter q's products run, quarter q - 1's sum joins the f32
    // FF2 sum in shared memory (rounding to nearest) and its items are
    // released, so no 64 x 256 accumulator stays in registers
#pragma unroll
    for (int u = 0; u < UH; ++u) {
      // the half's A fragments: f32 n8 chunk 4 i + s is step s of slice i,
      // (g, 2t) (g+8, 2t) (g, 2t+1) (g+8, 2t+1) in the permuted K order of
      // W2's items; in bf16 n8 chunks 2 s and 2 s + 1 are one k16 fragment
#pragma unroll
      for (int i = 0; i < n2; ++i)
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          if constexpr (kF) {
            const float* c = acc1[u] + 4 * (4 * i + s);
            split2(c[0], f_hi[i][s][0], f_lo[i][s][0]);
            split2(c[2], f_hi[i][s][1], f_lo[i][s][1]);
            split2(c[1], f_hi[i][s][2], f_lo[i][s][2]);
            split2(c[3], f_hi[i][s][3], f_lo[i][s][3]);
          } else {
            const float* c = acc1[u] + 8 * s;
            f_hi[i][s][0] = pack_bf16(c[0], c[1]);
            f_hi[i][s][1] = pack_bf16(c[2], c[3]);
            f_hi[i][s][2] = pack_bf16(c[4], c[5]);
            f_hi[i][s][3] = pack_bf16(c[6], c[7]);
          }
        }
      const int hb = base + n1 * IT_1 + u * NQ * n2;  // the half's first item
      float acc2[2][kWRows / 2];
      auto add_quarter = [&](int q, float (&acc)[kWRows / 2]) {
#pragma unroll
        for (int j = 0; j < kWRows / 8; ++j) {
          const int col = q * kWRows + 8 * j + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            float2* at = reinterpret_cast<float2*>(FSUM + x1_offset(e ? r1 : r0, col));
            const float2 v = make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
            *at = sub == 0 && u == 0 ? v : make_float2(at->x + v.x, at->y + v.y);
          }
        }
        if (tid == 0)
          for (int i = 0; i < n2; ++i) wring->release(hb + q * n2 + i);
        if constexpr (R > 1) {
          // after the last update of quarters q - 1 and q (q odd): the
          // chunks of their 128 columns go to their owners now (R = 16: each
          // half of their rows to its rank), while the next quarter's
          // products run
          if (sub + 1 == n_sub && u + 1 == UH && q % 2 == 1) {
            constexpr int kPart = kPair ? kChunk / 2 : kChunk, per = kPair ? 2 : 1;
            constexpr int ncomp = 2 * kWRows / CR;
            const int cbase = q / 2 * ncomp;
            fence_proxy_async();
            named_sync<1, kConsumers>();
            if (tid < ncomp * per) {
              const int c = cbase + tid / per, dst = kPair ? 2 * c + tid % per : c;
              if (dst != rank) {
                mbar_wait_cluster(ready, 0);  // the owner's x1 columns of this rank are dead
                bulk_push(X1 + chunk * kChunk + half * kPart, FSUM + c * kChunk + (tid % per) * kPart,
                          kPart, pfull, dst);
              }
            }
          }
        }
      };
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float (&acc)[kWRows / 2] = acc2[q & 1];
        const int it = hb + q * n2;
#pragma unroll
        for (int i = 0; i < n2; ++i) ready_item(it + i);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < n2; ++i) {
          const unsigned char* wh = stage(it + i);
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            const int keep = s > 0 || i > 0;
            if constexpr (kF) {
              Wgmma<T, kWRows>::rs(acc, f_lo[i][s], desc(wh, s), keep);
              Wgmma<T, kWRows>::rs(acc, f_hi[i][s], desc(wh + L::kHalf, s), 1);
              Wgmma<T, kWRows>::rs(acc, f_hi[i][s], desc(wh, s), 1);
            } else {
              Wgmma<T, kWRows>::rs(acc, f_hi[i][s], desc(wh, s), keep);
            }
          }
        }
        wgmma_commit();
        if (q > 0) {
          wgmma_wait<1>();
          fence_operands(acc2[(q - 1) & 1]);
          add_quarter(q - 1, acc2[(q - 1) & 1]);
        }
      }
      wgmma_wait<0>();
      fence_operands(f_hi);
      if constexpr (kF) fence_operands(f_lo);
      fence_operands(acc2[(NQ - 1) & 1]);
      add_quarter(NQ - 1, acc2[(NQ - 1) & 1]);
    }
  }
  COSY_PHASE(5);

  // ---- 4. the FF2 partials: a reduce-scatter over the cluster ----
  // The FF2 sum lies in the x1 tile's shape; its other chunks went out
  // quarter by quarter into their owners' x1 tiles at this rank's chunk
  // (and half), where this rank's chunk comes in from every other rank
  named_sync<1, kConsumers>();
  if constexpr (R > 1) {
    mbar_wait_cluster(pfull, 0);
    // every push into this block has landed: it arrives now and waits at
    // its end, so that no block leaves while a peer's push may still read
    // its memory
    cluster_arrive();
  }
  COSY_PHASE(6);

  // y = x1 + (the ranks' parts in rank order + b2) in the rank's columns
  {
    T* Y = static_cast<T*>(p.y);
#pragma unroll
    for (int idx = tid; idx < kYRows * CR / 4; idx += kConsumers) {
      const int row = half * kYRows + idx / (CR / 4), col = c0 + 4 * (idx % (CR / 4));
      if (m0 + row >= p.M) continue;
      // rank q's part: this rank's own in its FF2 sum, the others' in its
      // x1 tile at q's chunk (and half: rows from this rank's half's first);
      // every part is loaded before the sum in rank order
      float4 v[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int qc = kPair ? q / 2 : q, qh = kPair ? q % 2 : 0;
        const unsigned char* from =
            q == rank ? FSUM + x1_offset(row, col)
                      : X1 + qc * kChunk + qh * (kChunk / 2) * kPair +
                            x1_offset(row - half * kYRows * kPair, col - c0);
        v[q] = *reinterpret_cast<const float4*>(from);
      }
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < R; ++q)
        s = make_float4(s.x + v[q].x, s.y + v[q].y, s.z + v[q].z, s.w + v[q].w);
      const float4 x1 = *reinterpret_cast<const float4*>(X1 + x1_offset(row, col));
      T* yr = Y + static_cast<long long>(m0 + row) * kC + col;
      store_pair(yr, make_float2(x1.x + (s.x + b2_a.x), x1.y + (s.y + b2_a.y)));
      store_pair(yr + 2, make_float2(x1.z + (s.z + b2_b.x), x1.w + (s.w + b2_b.y)));
    }
  }
  if constexpr (R > 1) cluster_wait();
  COSY_PHASE(7);
}

template <typename T, int R>
cudaError_t launch_tail(const TailArgs& args, cudaStream_t stream) {
  using L = TailSmem<T, R>;
  auto kernel = block_tail_kernel<T, R>;
  static const cudaError_t attr = [&] {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e == cudaSuccess && R > 8)  // a cluster of 16: not portable, allowed on an H100
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, (args.M + kBM - 1) / kBM, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  if constexpr (R > 1) {  // R = 1: no cluster attribute
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = R;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the plans ops/fused_block.py _TAIL_PLANS may name: (64 rows, R ranks, a
// sub-tile of 128 hidden columns)
template <typename T>
cudaError_t dispatch_tail(const TailArgs& a, int block_m, int cluster, int sub, cudaStream_t s) {
#define COSY_TAIL(BM, R, FS)                                                          \
  static_assert(BM == kBM && FS == (R == 16 ? kFH : kFS), "a plan names the kernel's tiles"); \
  if (block_m == BM && cluster == R && sub == FS) return launch_tail<T, R>(a, s);
  COSY_TAIL(64, 1, 128)
  COSY_TAIL(64, 2, 128)
  COSY_TAIL(64, 4, 128)
  COSY_TAIL(64, 8, 128)
  COSY_TAIL(64, 16, 64)
#undef COSY_TAIL
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cosy

#ifdef COSY_TRACE
// the phase times of the last COSY_TRACE launch (ops/phase_trace.py)
extern "C" int cosy_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cosy::trace_ns, sizeof(cosy::trace_ns)));
}
#endif

// y (M, 256) = the block tail of a (M, I) and x (M, 256), every tensor of
// type dtype (f32 or bf16), contiguous and 16-byte aligned; wo (256, I),
// bo (256), n3w / n3b (256), w1 (F, 256), b1 (F), w2 (256, F), b2 (256).
// I a multiple of 128 (two halves of whole 128-byte K slices in either
// type); F a multiple of cluster * sub.  (block_m, cluster, sub) is the
// plan; act is the GELU, 1 tanh or 2 erf, a runtime argument every plan
// takes.
extern "C" int cosy_block_tail(int dtype, const void* a, const void* x, const void* wo,
                               const void* bo, const void* n3w, const void* n3b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* y, int M, int C, int I, int F,
                               float eps, int act, int block_m, int cluster, int sub,
                               void* stream) {
  using namespace cosy;
  if ((dtype != kF32 && dtype != kBF16) || (act != kGeluTanh && act != kGeluErf) || M <= 0 ||
      C != kC || I <= 0 || I % 128 != 0 || cluster <= 0 || cluster > 16 || sub <= 0 || F <= 0 ||
      F % (cluster * sub) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  const int chunk = kC / (cluster > 8 ? 8 : cluster);  // the kernel's CR, then NO
  const int wo_rows = chunk < kWRows ? chunk : kWRows;
  TailArgs args{};
  cudaError_t err = make_tensor_map(&args.a_map, a, f32, M, I, kBM);
  if (err == cudaSuccess) err = make_tensor_map(&args.wo_map, wo, f32, kC, I, wo_rows);
  if (err == cudaSuccess) err = make_tensor_map(&args.w1_map, w1, f32, F, kC, kFH);
  if (err == cudaSuccess) err = make_tensor_map(&args.w2_map, w2, f32, kC, F, kWRows);
  if (err == cudaSuccess) err = make_tensor_map(&args.x_map, x, f32, M, kC, kBM);
  if (err != cudaSuccess) return static_cast<int>(err);
  args.bo = bo;
  args.n3w = n3w;
  args.n3b = n3b;
  args.b1 = b1;
  args.b2 = b2;
  args.y = y;
  args.M = M;
  args.I = I;
  args.F = F;
  args.eps = eps;
  args.act = act;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = f32 ? dispatch_tail<float>(args, block_m, cluster, sub, s)
            : dispatch_tail<__nv_bfloat16>(args, block_m, cluster, sub, s);
  return static_cast<int>(err);
}
