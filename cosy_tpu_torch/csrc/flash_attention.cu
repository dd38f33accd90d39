// Kernel A: flash attention for the CFM estimator, softmax(scale*QK^T + bias)V,
// on Hopper's warpgroup products fed by the Tensor Memory Accelerator.
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
// What bounds it on an H100: the work is 4*B*H*T*S*d flops against
// (3+1)*B*H*T*d elements of q/k/v/out plus the B*T*S bias, i.e. operations
// (at (2,8,2580,64): 27.3 GFLOP, 0.41 ms at the f32 peak, 0.17 ms as three
// TF32 passes, 0.028 ms in bf16).  What bounds a kernel at these shapes is
// the rate of its products: d = 64 makes every product narrow (k = 64 for
// S, n = 64 for P V), f32 needs three TF32 passes of each, and a block
// that runs its products, its softmax and its loads in turn leaves the
// tensor cores idle most of the time.  At the short shapes (T = 156: 48
// blocks of 64 rows) and at T = 128 with S = 8320 it is the number of blocks
// in flight.
//
// The design (one block: kBQ = 64 query rows of one (b, h) over the key
// tiles of its rank in the cluster; the plan, the number of ranks, is the
// wrapper's _attention_plan):
//  - One producer warp: its lane 0 brings Q once, then the K and V tiles of
//    kBK = 64 keys of the block's key range, by TMA into a ring of
//    stages, completion on mbarriers.  No consumer thread computes a copy
//    address.  q, k, v come as strided views (the heads of B1's (B, T, 3,
//    H, d) output), so each is read through a tensor map of four
//    dimensions (d, t, h, b) with the view's byte strides: each dimension is
//    bounded on its own, so the rows of a box past T (or S) land as zeros
//    for the block's own (b, h) and never as the next head's rows.
//  - One consumer warpgroup of 64 query rows (128 threads; warp w owns rows
//    16w .. 16w + 15).  S = Q K^T is wgmma.mma_async with Q as the A
//    operand in registers (built once a block from the landed Q tile) and K
//    from the ring (K-major: the tile lands as (keys, d), d contiguous).  The scores stay in the
//    accumulator: scale, bias, masks, the row max and sum (two shuffles in
//    the quad) and the exponentials are applied there, and P, rounded to
//    the input type, is the A operand of O += P V from registers as it
//    stands (as FlashAttention-3 keeps it).  bf16: two adjacent n8 score
//    chunks are one k16 fragment; V lands as (keys, d), d contiguous, which
//    is MN-major for this product (the transpose bit, Wgmma<bf16, 64, 1>).
//  - bf16 issues tile i's P V and tile i + 1's S as one pair of commit
//    groups, then waits for P V alone: two independent product chains run
//    on the tensor cores.  f32 (a ring of two stages: see below) waits for
//    P V before the next S.  A block of two consumer groups taking turns at
//    the tensor cores (FlashAttention-3's ping-pong, 128 rows) measured no
//    faster in bf16 than three one-group blocks an SM, and f32's shared
//    memory holds one block of one group (PERF.md).
//  - The softmax is straight-line code: whether a tile needs its masks and
//    whether there is a bias are the tile's (every thread takes the same
//    branch), so the scores of a tile take one of six variants (masks or
//    none; no bias, a bias read in pairs, or value by value) in which every
//    mask is a select.  With the branches per score, each n8 chunk
//    was eight basic blocks and the softmax took 1.3-1.5 us a 64-key tile,
//    five times its products (PERF.md).
//  - f32 is error-compensated 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi),
//    B1's rules: Q is split once a block into registers kept for the whole
//    key loop (hi = cvt.rna, lo = the rest, of which the tensor cores read
//    the top 19 bits); P likewise a tile.  Three splitter warps split each
//    landed K and V tile once for the block: K's hi by truncation in place,
//    lo beside it; V into V^T hi and lo tiles (keys contiguous, 128-byte
//    swizzled: TF32 wgmma reads B only K-major), the keys of each group of
//    8 in the order 0,2,4,6,1,3,5,7, so that the score accumulator's
//    (2t, 2t+1) columns are the k8 fragment's (t, t+4) and nothing moves
//    between lanes.  Then fence.proxy.async and a split barrier the
//    consumers wait on.  The tensor cores add by truncation, so each tile's
//    P V sums into a zeroed accumulator that is added to O on the CUDA cores
//    with rounding to nearest (kPromote); S's chain is d = 64 long and needs
//    no promotion.  bf16 takes one pass and accumulates P V into O in place.
//  - The bias: where a bias row is a multiple of 16 bytes (S * sizeof(T)),
//    its (kBQ, kBK) tile comes by TMA into the stage (a map of (s, t, b)).
//    Otherwise (S = 1279, 2558 in f32; any S not a multiple of 8 in bf16)
//    the producer warp's 32 lanes copy each row's span of the tile from the
//    16-byte boundary at or before its first key, as 16-byte cp.async
//    chunks (a chunk past the tensor's end reads only what lies inside it)
//    into rows of kBK values and 16 bytes, and arrive on the stage's barrier
//    once they have landed; a consumer reads its rows at their offset from
//    the boundary.  Element by element, a warp's copy took longer than the
//    tile's products (PERF.md).  Either way the bias is loaded
//    ahead of the consumers by the ring's depth.  Blocks run the heads of a
//    query tile next to each other (h is the fastest grid index), so the 8
//    heads that read one bias tile are in flight together and the L2 can
//    serve the repeats (not measured: the profiler used here gives no L2
//    hit rate).
//  - Key splits over a cluster (gridDim.z, 1 to 8 ranks) for the shapes with
//    too few blocks: each rank walks whole key tiles; its unnormalised o,
//    running max m and sum l go to its shared memory over the ring, and
//    after a cluster barrier each rank combines a share of the rows over all
//    ranks in rank order through distributed shared memory (weights
//    exp(m_i - m), one division).  A split that holds only masked keys has
//    m_i = -1e10 and l_i = its key count, so a fully masked row still comes
//    out as the uniform average over all S keys; a split that walks no tile
//    has l_i = 0 and o_i = 0 and weighs nothing.  No atomics: the result is
//    the same on every run.
//  - No setmaxnreg: the f32 block (the consumer group, the producer and
//    three splitters: 256 threads, one block an SM) leaves 255 registers a
//    thread, bf16's (160 threads, three blocks an SM) 128; none spills.
//
// Shared memory (AttnSmem), 1024 bytes of alignment slack included; a
// stage's bias tile has kBQ rows of 64 values and 16 bytes (the lanes' copy;
// TMA's boxes take the first kBQ * 64 values), each stage rounded up to 1 KB:
//   f32: 2 stages of K hi | K lo | V | V^T hi | V^T lo (16 KB each) and the
//     bias (17 KB), Q 16 KB: 216 120 bytes, one block an SM.  Two stages is
//     all that fits, which is why f32 waits for P V before the next S;
//   bf16: 2 stages of K | V (8 KB each) | bias (9 KB), Q 8 KB: 60 472,
//     three blocks an SM (four stages, two blocks an SM, measured slower).
// Key tiles of 128 (bf16) measured slower at every shape, and (128, 128)
// left ptxas too few registers to pipeline its products.
// ops/flash_attention.py _attention_smem_bytes mirrors it.
//
// Kernel C: banded (windowed) self-attention, the kBanded instantiation of the
// same kernel.  Replaces the Pallas kernel of banded_attention
// (cosy_tpu/ops/flash_attention.py:313, kernel _make_banded_kernel :275): a
// query attends keys with |t - s| <= window and s < k_valid[b]; no bias;
// S == T.  The TPU kernel loads three Bq-wide key tiles (previous, own, next)
// per query block, because a block spec names whole tiles, and masks the rest
// by position.  Here the producer brings only the key tiles of
// [q0 - window, q0 + kBQ + window) & [0, min(T, k_valid[b])), so no clamped
// duplicate tile exists and no fully masked tile is loaded; a key inside the
// walked range but outside a row's band has its score REPLACED by -1e10, as
// in the Pallas kernel.  The walk shortens the work to 4*B*H*T*(2*window+1)*d
// flops, bound by operations.  A row with no admissible key (t >= k_valid[b]
// + window, discarded by the caller) gives the finite average over the keys
// its block walked, or 0 when the block walked none; the Pallas kernel
// averages over its three padded tiles there.
#include <cooperative_groups.h>

#include <type_traits>

#include "wgmma.cuh"

namespace cosy {
namespace {

namespace cg = cooperative_groups;

constexpr int kD = 64;              // head dim
constexpr int kBQ = 64;             // query rows a block (one consumer warpgroup)
constexpr int kBK = 64;             // keys a tile (f32's registers hold no more)
constexpr int kSlice = 128;         // bytes of a box row (the swizzle width)
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr int kSmSmem = 233472;     // an SM's shared memory

struct Strides {  // element strides of the (b, h, t) axes; d is contiguous
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

struct AttnArgs {
  CUtensorMap q_map, k_map, v_map;  // (d, t|s, h, b) of the strided views
  CUtensorMap bias_map;             // (s, t, b) of the bias, where bias_tma
  const void* bias;                 // (B, T, S) or null
  const int* k_valid;               // (B,) or null
  void* out;
  long long ob, oh, ot;
  int H, T, S, q_tiles, window, bias_tma;
  float scale;
};

// the layout of one type's shared memory (offsets from the 1024-aligned
// start): the ring of stages, Q, the barriers
template <typename T>
struct AttnSmem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kSideWarps = kF32 ? 4 : 1;      // the producer (+ 3 splitters)
  static constexpr int kThreads = 128 + kSideWarps * 32;
  // f32: all that fits; bf16: two, so that three blocks share an SM
  static constexpr int kStages = 2;
  static constexpr int kKV = kBK * kD * static_cast<int>(sizeof(T));  // a landed K or V tile
  // the bias tile: TMA's boxes of (kBQ rows, 128 bytes), or rows of kBRow
  // bytes (a row's span from a 16-byte boundary: kBChunks chunks of 16)
  static constexpr int kBRow = kBK * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kBChunks = kBRow / 16;
  static constexpr int kBias = kBQ * kBRow;
  static constexpr int kBiasBox = kBQ * kBK * static_cast<int>(sizeof(T));  // what TMA brings
  // a stage: K (f32: its hi in place) | K lo | V | V^T hi | V^T lo | bias
  static constexpr int kK = 0, kKlo = kKV, kV = kF32 ? 2 * kKV : kKV;
  static constexpr int kVhi = 3 * kKV, kVlo = 4 * kKV;
  static constexpr int kB = (kF32 ? 5 : 2) * kKV;
  static constexpr int kStage = (kB + kBias + 1023) / 1024 * 1024;
  static constexpr int kQOff = kStages * kStage;
  static constexpr int kQ = kBQ * kD * static_cast<int>(sizeof(T));
  static constexpr int kBarOff = kQOff + kQ;
  static constexpr int kBars = 3 * kStages + 1;  // full, empty, split; Q
  static constexpr int bytes = 1024 + kBarOff + kBars * 8;
  static constexpr int kMinBlocks = 3 * (bytes + 1024) <= kSmSmem ? 3 : 2 * (bytes + 1024) <= kSmSmem ? 2 : 1;
  static_assert(bytes <= kSmemLimit, "the plan does not fit in shared memory");
  static_assert(kBQ * (kD + 4 + 2) * 4 <= kQOff, "the combine's tiles fit over the ring");
};

template <typename T>
__device__ __forceinline__ float exp_of(float x);
template <>
__device__ __forceinline__ float exp_of<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ float exp_of<__nv_bfloat16>(float x) { return __expf(x); }

__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// a TF32 pair for an A operand: hi rounded to nearest, lo the rest
__device__ __forceinline__ void split_a(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// byte offset of value c (0 .. kBK) of row r in a (rows, kBK) tile stored as
// boxes of 128 bytes of columns, rows 128 bytes apart, 128-byte swizzled
template <typename T, int ROWS>
__device__ __forceinline__ int box_offset(int r, int c) {
  constexpr int KPB = kSlice / static_cast<int>(sizeof(T));
  const int byte = (c % KPB) * static_cast<int>(sizeof(T));
  return (c / KPB) * ROWS * kSlice + r * kSlice + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

template <typename T, bool kBanded>
__global__ void __launch_bounds__(AttnSmem<T>::kThreads, AttnSmem<T>::kMinBlocks)
flash_attention_kernel(const __grid_constant__ AttnArgs p) {
  using L = AttnSmem<T>;
  constexpr bool kF = L::kF32;
  constexpr int ES = sizeof(T);
  constexpr int KPB = kSlice / ES;      // values a box row holds
  constexpr int DB = kD * ES / kSlice;  // boxes across d: 2 f32, 1 bf16
  constexpr int ST = L::kStages;

  COSY_PHASE(0);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::kQOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + ST;
  uint64_t* split = empty + ST;
  uint64_t* qbar = split + ST;
  auto stage = [&](int i) { return smem + (i % ST) * L::kStage; };

  // h is the fastest index: the heads of a query tile run side by side
  const int h = blockIdx.x % p.H, q0 = (blockIdx.x / p.H) * kBQ, b = blockIdx.y;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int Tq = p.T, S = p.S, window = p.window;
  const int kv = p.k_valid != nullptr ? p.k_valid[b] : S;
  // keys this q tile walks: all of [0, S), or the band's reach of the tile
  // cut at the valid keys (global positions; no overflow for window <= S)
  const int s_begin = kBanded ? max(0, q0 - window) : 0;
  const int s_end = kBanded ? min(min(S, kv), q0 + kBQ + window) : S;
  // ... and the tiles of them that are this rank's
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kBK - 1) / kBK : 0;
  const int per_rank = (n_tiles + splits - 1) / splits;
  const int tile_begin = min(n_tiles, rank * per_rank);
  const int n = min(n_tiles, tile_begin + per_rank) - tile_begin;
  const bool has_bias = !kBanded && p.bias != nullptr;  // C takes no bias
  // a bias that TMA cannot bring is copied by the producer warp's lanes
  const bool lane_bias = has_bias && !p.bias_tma;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto tile_s0 = [&](int i) { return s_begin + (tile_begin + i) * kBK; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], lane_bias ? 33 : 1);
      mbar_init(&empty[s], 1);
      mbar_init(&split[s], 3);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  float o[kD / 2];  // the consumers' O: rows (g, g + 8), n8 chunk j at 4 j
  float m_run[2] = {kNegBias, kNegBias};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // a consumer's rows in the block

  if (warp >= 4) {
    if (warp == 4) {
      // the producer: lane 0 issues every copy, in order; the warp's lanes
      // write the bias tiles that TMA cannot bring
      if (lane == 0) {
        tma_prefetch_map(&p.k_map);
        tma_prefetch_map(&p.v_map);
        mbar_arrive_expect(qbar, L::kQ);
        for (int c = 0; c < DB; ++c)
          tma_load_4d(Qs + c * kBQ * kSlice, &p.q_map, qbar, c * KPB, q0, h, b);
      }
      const unsigned char* bbase = static_cast<const unsigned char*>(p.bias);
      const long long bias_bytes = static_cast<long long>(gridDim.y) * Tq * S * ES;
      // the byte offsets of this lane's bias rows (lane, lane + 32, ...);
      // a row past T copies nothing
      long long brow[kBQ / 32];
#pragma unroll
      for (int k = 0; k < kBQ / 32; ++k) {
        const int row = q0 + lane + 32 * k;
        brow[k] = row < Tq ? (static_cast<long long>(b) * Tq + row) * S * ES : bias_bytes + 16;
      }
      for (int i = 0; i < n; ++i) {
        unsigned char* st = stage(i);
        const int s0 = tile_s0(i);
        if (i >= ST) {
          if (lane == 0) mbar_wait(&empty[i % ST], ((i / ST) - 1) & 1);
          __syncwarp();
        }
        if (lane_bias) {
          // each bias row's span of the tile, from the 16-byte boundary at
          // or before its first key, as 16-byte chunks into a row of kBRow
          // bytes; a chunk past the tensor's end reads only what lies
          // inside it, a row past T reads nothing.  Each lane arrives on
          // the stage's barrier once its copies have landed (32 of its 33
          // arrivals)
          unsigned char* dst = st + L::kB;
#pragma unroll
          for (int k = 0; k < kBQ / 32; ++k) {
            const int r = lane + 32 * k;
            const long long at = (brow[k] + s0 * ES) & ~15LL;
            // the bytes of the tensor from this row's boundary on (none for
            // a row past T), so that no chunk reads past the tensor's end
            const int left = static_cast<int>(
                min(max(bias_bytes - at, 0LL), static_cast<long long>(L::kBRow)));
            for (int c = 0; c < L::kBChunks; ++c) {
              const int nb = min(max(left - 16 * c, 0), 16);
              cp_async_chunk(dst + r * L::kBRow + 16 * c, nb > 0 ? bbase + at + 16 * c : bbase, nb);
            }
          }
          cp_async_arrive(&full[i % ST]);
        }
        if (lane == 0) {
          const bool bt = has_bias && p.bias_tma;
          mbar_arrive_expect(&full[i % ST], 2 * L::kKV + (bt ? L::kBiasBox : 0));
          for (int c = 0; c < DB; ++c) {
            tma_load_4d(st + L::kK + c * kBK * kSlice, &p.k_map, &full[i % ST], c * KPB, s0, h, b);
            tma_load_4d(st + L::kV + c * kBK * kSlice, &p.v_map, &full[i % ST], c * KPB, s0, h, b);
          }
          if (bt)
            for (int c = 0; c < kBK / KPB; ++c)
              tma_load_3d(st + L::kB + c * kBQ * kSlice, &p.bias_map, &full[i % ST], s0 + c * KPB,
                          q0, b);
        }
      }
    } else if constexpr (kF) {
      // the splitters (3xTF32): each landed K and V tile is split once for
      // the block, K's hi in place (truncated to the 19 bits the tensor
      // cores read) and lo = k - hi beside it; V into V^T hi and lo, keys
      // contiguous, each group of 8 in the order 0,2,4,6,1,3,5,7
      const int sl = threadIdx.x - 160;  // 0 .. 95
      for (int i = 0; i < n; ++i) {
        unsigned char* st = stage(i);
        mbar_wait(&full[i % ST], (i / ST) & 1);
        float4* kh = reinterpret_cast<float4*>(st + L::kK);
        float4* kl = reinterpret_cast<float4*>(st + L::kKlo);
        for (int e = sl; e < L::kKV / 16; e += 96) {
          const float4 v = kh[e];
          const float4 hi = make_float4(trunc_tf32(v.x), trunc_tf32(v.y), trunc_tf32(v.z),
                                        trunc_tf32(v.w));
          kh[e] = hi;
          kl[e] = make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
        }
        // unit (j, d): keys 8j .. 8j + 7 of column d; a warp's lanes take 32
        // consecutive d of one j (one V row a load: no bank conflict)
        for (int u = sl; u < (kBK / 8) * kD; u += 96) {
          const int j = u / kD, d = u % kD;
          float x[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int key = 8 * j + k;
            x[k] = *reinterpret_cast<const float*>(
                st + L::kV + (d >> 5) * kBK * kSlice + key * kSlice +
                (((((d & 31) >> 2) ^ (key & 7))) << 4) + (d & 3) * 4);
          }
          const int c0 = 2 * (j & 3);
          const int row = (j >> 2) * kD * kSlice + d * kSlice;  // slice of 32 keys, row d
          const float4 ev = make_float4(x[0], x[2], x[4], x[6]);
          const float4 od = make_float4(x[1], x[3], x[5], x[7]);
          const float4 eh = make_float4(trunc_tf32(ev.x), trunc_tf32(ev.y), trunc_tf32(ev.z),
                                        trunc_tf32(ev.w));
          const float4 oh = make_float4(trunc_tf32(od.x), trunc_tf32(od.y), trunc_tf32(od.z),
                                        trunc_tf32(od.w));
          const int a0 = row + ((c0 ^ (d & 7)) << 4), a1 = row + (((c0 + 1) ^ (d & 7)) << 4);
          *reinterpret_cast<float4*>(st + L::kVhi + a0) = eh;
          *reinterpret_cast<float4*>(st + L::kVhi + a1) = oh;
          *reinterpret_cast<float4*>(st + L::kVlo + a0) =
              make_float4(ev.x - eh.x, ev.y - eh.y, ev.z - eh.z, ev.w - eh.w);
          *reinterpret_cast<float4*>(st + L::kVlo + a1) =
              make_float4(od.x - oh.x, od.y - oh.y, od.z - oh.z, od.w - oh.w);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&split[i % ST]);
      }
    }
    if (splits == 1) return;
  } else {
    // ---------------------------------------------------------------------
    // the consumers
    // ---------------------------------------------------------------------
    constexpr int QSTEPS = kF ? kD / 8 : kD / 16;  // k steps of S (d)
    constexpr int PSTEPS = kF ? kBK / 8 : kBK / 16;  // k steps of P V (keys)
    // f32 waits for a tile's P V before the next S: its ring is two
    // stages deep, and a deferred P V would hold a stage until the middle of
    // the next tile, leaving too little time to land and split the tile
    // after it (measured: PERF.md).  bf16 issues P V and the next S together
    constexpr bool kDefer = !kF;
#pragma unroll
    for (int e = 0; e < kD / 2; ++e) o[e] = 0.f;

    mbar_wait(qbar, 0);
    COSY_PHASE(1);
    // Q's A fragments, once a block: f32 step s is d 8s .. 8s + 7, (g, t)
    // (g+8, t) (g, t+4) (g+8, t+4), split into hi and lo; bf16 step s is
    // d 16s .. 16s + 15, pairs (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8)
    uint32_t qh[QSTEPS][4], ql[kF ? QSTEPS : 1][4];
    auto q_word = [&](int r, int box, int chunk) {
      return *reinterpret_cast<const uint32_t*>(Qs + box * kBQ * kSlice + r * kSlice +
                                                ((chunk ^ (r & 7)) << 4) + 4 * t);
    };
#pragma unroll
    for (int s = 0; s < QSTEPS; ++s) {
      if constexpr (kF) {
        const int box = s / 4, c = 2 * (s % 4);
        split_a(__uint_as_float(q_word(lr0, box, c)), qh[s][0], ql[s][0]);
        split_a(__uint_as_float(q_word(lr1, box, c)), qh[s][1], ql[s][1]);
        split_a(__uint_as_float(q_word(lr0, box, c + 1)), qh[s][2], ql[s][2]);
        split_a(__uint_as_float(q_word(lr1, box, c + 1)), qh[s][3], ql[s][3]);
      } else {
        qh[s][0] = q_word(lr0, 0, 2 * s);
        qh[s][1] = q_word(lr1, 0, 2 * s);
        qh[s][2] = q_word(lr0, 0, 2 * s + 1);
        qh[s][3] = q_word(lr1, 0, 2 * s + 1);
      }
    }

    float sacc[kBK / 2];                      // the scores of a tile
    uint32_t ph[PSTEPS][4], pl[kF ? PSTEPS : 1][4];  // P's fragments (pl: 3xTF32)
    // a tile's P V (3xTF32, kPromote): in f32's order (S, softmax, P V, a
    // tile at a time) the scores are dead once P is built, so P V takes
    // their registers
    float (&pv)[kBK / 2] = sacc;
    static_assert(kBK == kD, "P V's accumulator is the scores' shape");
    float alpha[2] = {1.f, 1.f};
    const float scale = p.scale;

    // the bias is read a pair at a time from TMA's boxes, and from the
    // lanes' rows where S is even (every row starts on a pair's boundary)
    const bool bias_pairs = p.bias_tma || (S & 1) == 0;
    // the low four bits of the byte offsets of this thread's bias rows
    const int brow16[2] = {
        static_cast<int>(((static_cast<long long>(b) * Tq + q0 + lr0) * S * ES) & 15),
        static_cast<int>(((static_cast<long long>(b) * Tq + q0 + lr1) * S * ES) & 15)};
    auto ready = [&](int i) { mbar_wait(kF ? &split[i % ST] : &full[i % ST], (i / ST) & 1); };
    auto issue_s = [&](int i) {
      const unsigned char* st = stage(i);
#pragma unroll
      for (int s = 0; s < QSTEPS; ++s) {
        if constexpr (kF) {
          const int off = (s / 4) * kBK * kSlice + (s % 4) * 32;
          Wgmma<T, kBK>::rs(sacc, ql[s], wgmma_desc(st + L::kK + off), s > 0);
          Wgmma<T, kBK>::rs(sacc, qh[s], wgmma_desc(st + L::kKlo + off), 1);
          Wgmma<T, kBK>::rs(sacc, qh[s], wgmma_desc(st + L::kK + off), 1);
        } else {
          Wgmma<T, kBK>::rs(sacc, qh[s], wgmma_desc(st + L::kK + s * 32), s > 0);
        }
      }
    };
    auto issue_pv = [&](int i) {
      const unsigned char* st = stage(i);
#pragma unroll
      for (int s = 0; s < PSTEPS; ++s) {
        if constexpr (kF) {
          const int off = (s / 4) * kD * kSlice + (s % 4) * 32;
          Wgmma<T, kD>::rs(pv, pl[s], wgmma_desc(st + L::kVhi + off), s > 0);
          Wgmma<T, kD>::rs(pv, ph[s], wgmma_desc(st + L::kVlo + off), 1);
          Wgmma<T, kD>::rs(pv, ph[s], wgmma_desc(st + L::kVhi + off), 1);
        } else {
          // V is MN-major: its 128-byte swizzled atom (8 keys of 64 d)
          // takes wgmma_desc's offsets, d being one atom wide
          Wgmma<T, kD, 1>::rs(o, ph[s], wgmma_desc(st + L::kV + s * 16 * kSlice), 1);
        }
      }
    };
    // after the wait that completed tile i's P V: f32 adds it to O, rounding
    // to nearest; the stage goes back to the producer
    auto finish_pv = [&](int i) {
      fence_operands(ph);
      if constexpr (kF) {
        fence_operands(pl);
        fence_operands(pv);
#pragma unroll
        for (int e = 0; e < kD / 2; ++e) o[e] = fmaf(o[e], alpha[(e >> 1) & 1], pv[e]);
      } else {
        fence_operands(o);
      }
      if (threadIdx.x == 0) mbar_arrive(&empty[i % ST]);
      if (i == 0) COSY_PHASE(4);
    };
    // tile i's scores: scale, bias and masks in place, the row maxima into
    // mx.  The branches are the tile's (every thread takes the same), so
    // each variant is straight-line code the compiler can interleave: kEdge
    // (a tile with keys past s_end or k_valid, or rows out of band: the
    // masks as selects), kBias (0 none, 1 read as aligned pairs, 2 value
    // by value).  Both bias layouts are read through one address: TMA's
    // swizzled boxes, or the lanes' rows of kBRow bytes with each row's
    // first key boff bytes past its 16-byte boundary (a pair is aligned
    // there when S is even).
    auto scores = [&](auto edge_c, auto bias_c, int i, float (&mx)[2]) {
      constexpr bool kEdge = decltype(edge_c)::value;
      constexpr int kBias = decltype(bias_c)::value;
      const unsigned char* bs = stage(i) + L::kB;
      const int s0 = tile_s0(i);
      const int row[2] = {q0 + lr0, q0 + lr1};
      const bool tma = p.bias_tma;
      const int boff[2] = {(brow16[0] + s0 * ES) & 15, (brow16[1] + s0 * ES) & 15};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int c = 8 * j + 2 * t;
        float bv[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kBias > 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int lr = r ? lr1 : lr0;
            const T* bp = reinterpret_cast<const T*>(
                bs + (tma ? box_offset<T, kBQ>(lr, c) : lr * L::kBRow + boff[r] + c * ES));
            if constexpr (kBias == 1) {
              const float2 v = load_pair(bp);
              bv[2 * r] = v.x;
              bv[2 * r + 1] = v.y;
            } else {
              bv[2 * r] = to_f(bp[0]);
              bv[2 * r + 1] = to_f(bp[1]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float val = fmaf(sacc[4 * j + e], scale, bv[e]);
          if constexpr (kEdge) {
            const int key = s0 + c + (e & 1);
            const bool in_band = !kBanded || abs(row[r] - key) <= window;
            val = key < kv && in_band ? val : kNegBias;
            val = key < s_end ? val : -INFINITY;  // not a key: excluded, never averaged in
          }
          sacc[4 * j + e] = val;
          mx[r] = fmaxf(mx[r], val);
        }
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    // tile i's scores -> P (rounded to T), the running max and sum; bf16
    // rescales O here (f32 when it adds the tile's P V)
    auto softmax = [&](int i) {
      const int s0 = tile_s0(i);
      // a tile with no key past the valid ones and no row out of band
      // needs no per-score test
      const bool edge = s0 + kBK > s_end || s0 + kBK > kv ||
                        (kBanded && (q0 + kBQ - 1 - s0 > window || s0 + kBK - 1 - q0 > window));
      float mx[2] = {-INFINITY, -INFINITY};
      using None = std::integral_constant<int, 0>;
      using Pairs = std::integral_constant<int, 1>;
      using Values = std::integral_constant<int, 2>;
      if (!has_bias) {
        if (edge) scores(Yes{}, None{}, i, mx);
        else scores(No{}, None{}, i, mx);
      } else if (bias_pairs) {
        if (edge) scores(Yes{}, Pairs{}, i, mx);
        else scores(No{}, Pairs{}, i, mx);
      } else {
        if (edge) scores(Yes{}, Values{}, i, mx);
        else scores(No{}, Values{}, i, mx);
      }
      // online softmax; m_run starts finite, so exp never sees (-inf) - (-inf)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp_of<T>(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const float pe = exp_of<T>(sacc[e] - m_run[(e >> 1) & 1]);
        l_run[(e >> 1) & 1] += pe;
        sacc[e] = pe;
      }
      if constexpr (kF) {
        // k8 step j is n8 chunk j, in the permuted key order of V^T
#pragma unroll
        for (int j = 0; j < PSTEPS; ++j) {
          split_a(sacc[4 * j], ph[j][0], pl[j][0]);
          split_a(sacc[4 * j + 2], ph[j][1], pl[j][1]);
          split_a(sacc[4 * j + 1], ph[j][2], pl[j][2]);
          split_a(sacc[4 * j + 3], ph[j][3], pl[j][3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        // k16 step s is n8 chunks 2s and 2s + 1 as they stand
#pragma unroll
        for (int s = 0; s < PSTEPS; ++s) {
          ph[s][0] = pack_bf16(sacc[8 * s], sacc[8 * s + 1]);
          ph[s][1] = pack_bf16(sacc[8 * s + 2], sacc[8 * s + 3]);
          ph[s][2] = pack_bf16(sacc[8 * s + 4], sacc[8 * s + 5]);
          ph[s][3] = pack_bf16(sacc[8 * s + 6], sacc[8 * s + 7]);
        }
      }
    };
    // every register a product reads or writes is settled before
    // wgmma.fence (no instruction that defines one may sink past it, or
    // ptxas serializes the products)
    auto fence_all = [&] {
      fence_operands(sacc);
      fence_operands(qh);
      fence_operands(ph);
      fence_operands(o);
      if constexpr (kF) {
        fence_operands(ql);
        fence_operands(pl);
      }
      wgmma_fence();
    };
    auto wait_s = [&] {
      fence_operands(sacc);
      fence_operands(qh);
      if constexpr (kF) fence_operands(ql);
    };

    if (n > 0) {
      if constexpr (!kDefer) {
        // S, softmax, P V a tile
        for (int i = 0; i < n; ++i) {
          ready(i);
          if (i == 0) COSY_PHASE(2);
          fence_all();
          issue_s(i);
          wgmma_commit();
          wgmma_wait<0>();
          wait_s();
          if (i == 0) COSY_PHASE(3);
          softmax(i);
          if (i == 0) COSY_PHASE(8);
          fence_all();
          issue_pv(i);
          wgmma_commit();
          wgmma_wait<0>();
          finish_pv(i);
        }
      } else {
        // tile i's P V and tile i + 1's S issued together
        ready(0);
        COSY_PHASE(2);
        fence_all();
        issue_s(0);
        wgmma_commit();
        wgmma_wait<0>();
        wait_s();
        COSY_PHASE(3);
        softmax(0);
        COSY_PHASE(8);
        for (int i = 1; i < n; ++i) {
          ready(i);
          fence_all();
          issue_pv(i - 1);
          wgmma_commit();
          issue_s(i);
          wgmma_commit();
          wgmma_wait<1>();
          finish_pv(i - 1);
          wgmma_wait<0>();
          wait_s();
          softmax(i);
        }
        fence_all();
        issue_pv(n - 1);
        wgmma_commit();
        wgmma_wait<0>();
        finish_pv(n - 1);
      }
    }
    COSY_PHASE(5);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    if (splits == 1) {
      T* op = static_cast<T*>(p.out) + b * p.ob + h * p.oh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + (r ? lr1 : lr0);
        if (row >= Tq) continue;
        const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < kD / 8; ++j)
          store_pair(op + row * p.ot + j * 8 + 2 * t,
                     make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv));
      }
      COSY_PHASE(7);
      return;
    }
  }

  // split over keys: (o, m, l) of every rank meet in shared memory, over the
  // ring once every thread of the block is done with it
  constexpr int OLD = kD + 4;  // a row of the o tile, in floats
  float* Os = reinterpret_cast<float*>(smem);  // [kBQ][OLD]
  float* Ms = Os + kBQ * OLD;                   // [kBQ]
  float* Ls = Ms + kBQ;                         // [kBQ]
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = r ? lr1 : lr0;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        store_pair(Os + lr * OLD + j * 8 + 2 * t, make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]));
      if (t == 0) {
        Ms[lr] = m_run[r];
        Ls[lr] = l_run[r];
      }
    }
  }
  cluster.sync();
  // rank r combines rows r, r + splits, ...; the sums run over the ranks in
  // order, so they are the same sums on every run
  T* op = static_cast<T*>(p.out) + b * p.ob + h * p.oh;
  for (int idx = threadIdx.x; idx < ((kBQ - rank + splits - 1) / splits) * (kD / 2);
       idx += L::kThreads) {
    const int lr = rank + (idx / (kD / 2)) * splits, c = (idx % (kD / 2)) * 2;
    const int row = q0 + lr;
    if (row >= Tq) continue;
    float m = kNegBias;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, cluster.map_shared_rank(Ms, i)[lr]);
    float l = 0.f, ox = 0.f, oy = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float w = exp_of<T>(cluster.map_shared_rank(Ms, i)[lr] - m);
      l += w * cluster.map_shared_rank(Ls, i)[lr];
      const float2 oi = load_pair(cluster.map_shared_rank(Os, i) + lr * OLD + c);
      ox += w * oi.x;
      oy += w * oi.y;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    store_pair(op + row * p.ot + c, make_float2(ox * inv, oy * inv));
  }
  COSY_PHASE(6);
  cluster.sync();  // no block leaves while its tiles are being read
  COSY_PHASE(7);
}

template <typename T, bool kBanded>
cudaError_t launch(const AttnArgs& args, int B, int kv_splits, cudaStream_t stream) {
  using L = AttnSmem<T>;
  auto kernel = flash_attention_kernel<T, kBanded>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.H * args.q_tiles, B, kv_splits);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  if (kv_splits > 1) {
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = kv_splits;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kBanded>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* bias,
             const int* k_valid, void* out, int B, int H, int T, int S, int d,
             const long long* strides, float scale, int window, int kv_splits,
             void* stream) {
  if (d != kD || B <= 0 || H <= 0 || T <= 0 || S <= 0 || B > 65535 || kv_splits < 1 ||
      kv_splits > 8 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  const long long es = f32 ? 4 : 2;
  AttnArgs args{};
  // (d, t|s, h, b) with the views' byte strides; the stride of an axis of
  // one index is never taken, so it is given as if the axes were packed
  auto map = [&](CUtensorMap* m, const void* ptr, int rows, int box, const long long* st) {
    const long long dims[4] = {kD, rows, H, B};
    long long bytes[3] = {st[2] * es, st[1] * es, st[0] * es};
    long long packed = kD * es;
    for (int i = 0; i < 3; ++i) {
      if (dims[i + 1] == 1) bytes[i] = packed;
      packed = bytes[i] * dims[i + 1];
    }
    return make_tensor_map_strided(m, ptr, f32, 4, dims, bytes, box);
  };
  cudaError_t err = map(&args.q_map, q, T, kBQ, strides);
  if (err == cudaSuccess) err = map(&args.k_map, k, S, kBK, strides + 3);
  if (err == cudaSuccess) err = map(&args.v_map, v, S, kBK, strides + 6);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the bias by TMA where its rows are 16-byte multiples
  args.bias_tma = bias != nullptr && (S * es) % 16 == 0;
  if (args.bias_tma) {
    const long long dims[3] = {S, T, B};
    const long long bytes[2] = {S * es, static_cast<long long>(T) * S * es};
    err = make_tensor_map_strided(&args.bias_map, bias, f32, 3, dims, bytes, kBQ);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  args.bias = bias;
  args.k_valid = k_valid;
  args.out = out;
  args.ob = strides[9];
  args.oh = strides[10];
  args.ot = strides[11];
  args.H = H;
  args.T = T;
  args.S = S;
  args.q_tiles = (T + kBQ - 1) / kBQ;
  args.window = window;
  args.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f32 ? launch<float, kBanded>(args, B, kv_splits, s)
                              : launch<__nv_bfloat16, kBanded>(args, B, kv_splits, s));
}

}  // namespace
}  // namespace cosy

#ifdef COSY_TRACE
// the phase times of the last COSY_TRACE launch (ops/phase_trace.py)
extern "C" int cosy_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cosy::trace_ns, sizeof(cosy::trace_ns)));
}
#endif

// q/k/v/out: (B, H, T|S, d) views given by element strides (12 values:
// q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t), d contiguous,
// every pointer and stride a multiple of 16 bytes.  bias: contiguous
// (B, T, S) of the input type from a 16-byte-aligned start, or null.
// k_valid: (B,) int32 on the device, or null (= S).  kv_splits: 1 to 8
// blocks share a query tile's keys.  Returns a cudaError_t code.
extern "C" int cosy_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const int* k_valid, void* out, int B, int H,
                                    int T, int S, int d, const long long* strides,
                                    float scale, int kv_splits, void* stream) {
  return cosy::dispatch<false>(dtype, q, k, v, bias, k_valid, out, B, H, T, S, d,
                               strides, scale, 0, kv_splits, stream);
}

// Kernel C.  q/k/v/out as above with S == T; no bias; a key is admitted when
// |t - s| <= window and s < k_valid[b] (k_valid null = T).  ``window`` is
// clamped to T (every key in reach), which keeps the position arithmetic in
// int range.  Returns a cudaError_t code.
extern "C" int cosy_banded_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* k_valid, void* out,
                                     int B, int H, int T, int d,
                                     const long long* strides, float scale,
                                     int window, int kv_splits, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  return cosy::dispatch<true>(dtype, q, k, v, nullptr, k_valid, out, B, H, T, T, d,
                              strides, scale, window < T ? window : T, kv_splits, stream);
}
