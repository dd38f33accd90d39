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
// What bounds it on an H100: at the estimator's shapes (d = 64, T = S = 156
// to 2 600, B*H = 16) the work is 4*B*H*T*S*d flops against (3+1)*B*H*T*d
// elements of q/k/v/out plus the B*T*S bias, i.e. operations, not bytes; at
// the short shapes (T = 156: 48 blocks of 64 rows) and at T = 128 with
// S = 8320 (32 blocks, each walking 130 key tiles alone) it is the number of
// blocks in flight.
//
// What the kernel does about it:
//  - Both products run on the tensor cores (mma.cuh): bf16 through
//    mma.sync.m16n8k16, f32 through error-compensated 3xTF32 on
//    mma.sync.m16n8k8, which holds the f32 tolerance (atol = rtol = 1e-5
//    against the exact plain version) where single-pass TF32 does not.  A
//    warp owns 16 query rows.  The score fragment of a 64-key tile stays in
//    registers: scale, bias, masks, the row max and sum (two shuffles within
//    the quad) and the exponentials are applied there, and the probabilities,
//    rounded to the input type, are the A operand of P V as they stand.  No
//    score tile goes through shared memory.
//  - K and V tiles of 64 keys are double-buffered with 16-byte cp.async
//    copies, so the next tile loads while this one is multiplied; two block
//    barriers a tile.  Rows are padded by 16 bytes, which keeps ldmatrix and
//    the scalar tf32 fragment loads free of bank conflicts.  A bias row is
//    not 16-byte aligned (S may be odd), so the bias is read with plain loads
//    straight into the score fragment's layout, one tile ahead of its use.
//  - Enough blocks: a block has 64 query rows (4 warps; 32-row blocks of 2
//    warps were measured and lost), and the wrapper picks a split of the key
//    range over the blocks of a thread block cluster (gridDim.z) from
//    (B*H, T, S, window).  Each block of a cluster
//    keeps its unnormalised o, running max m and sum l in its own shared
//    memory; after a cluster barrier each block combines a share of the rows
//    over all ranks in rank order through distributed shared memory
//    (weights exp(m_i - m), one division) and writes them.  A split that
//    holds only masked keys has m_i = -1e10 and l_i = its key count, so a
//    fully masked row still comes out as the uniform average over all S
//    keys; a split that walks no tile has l_i = 0 and o_i = 0 and weighs
//    nothing.  No atomics: the result is the same on every run.
//
// Kernel C: banded (windowed) self-attention, the kBanded instantiation of the
// same kernel.  Replaces the Pallas kernel of banded_attention
// (cosy_tpu/ops/flash_attention.py:313, kernel _make_banded_kernel :275): a
// query attends keys with |t - s| <= window and s < k_valid[b]; no bias;
// S == T.  The TPU kernel loads three Bq-wide key tiles (previous, own, next)
// per query block, because a block spec names whole tiles, and masks the rest
// by position.  Here a block walks only the keys of
// [q0 - window, q0 + Bq - 1 + window] & [0, min(T, k_valid[b])) in 64-key tiles,
// so no clamped duplicate tile exists and no fully masked tile is loaded; a
// key inside the walked range but outside a row's band has its score
// REPLACED by -1e10, as in the Pallas kernel.  The walk shortens the work to
// 4*B*H*T*(2*window+1)*d flops, bound by operations.
// A row with no admissible key (t >= k_valid[b] + window, discarded by the
// caller) gives the finite average over the keys its block walked, or 0 when
// the block walked none; the Pallas kernel averages over its three padded
// tiles there.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace cosy {
namespace {

namespace cg = cooperative_groups;

constexpr int kD = 64;    // head dim
constexpr int kBKV = 64;  // keys per shared-memory tile

struct Strides {  // element strides of the (b, h, t) axes; d is contiguous
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

template <typename T>
__device__ __forceinline__ float exp_of(float x);
template <>
__device__ __forceinline__ float exp_of<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ float exp_of<__nv_bfloat16>(float x) { return __expf(x); }

// One block: WARPS * 16 query rows of one (b, h), over the key tiles of its
// rank in the cluster (blockIdx.z of gridDim.z splits).
template <typename T, int WARPS, bool kBanded>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ bias,
                       const int* __restrict__ k_valid, T* __restrict__ out,
                       int H, int Tq, int S, Strides st, float scale, int window) {
  using MM = Mma<T>;
  constexpr int kThreads = WARPS * 32;
  constexpr int BQ = WARPS * 16;
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = kD / EPC;        // chunks a row
  constexpr int LD = kD + EPC;         // padded row: 68 f32 (272 B), 72 bf16 (144 B)
  constexpr int OLD = kD + 4;          // row of the combine's o tile, in floats
  static_assert(BQ * (OLD + 2) * 4 <= (BQ + 4 * kBKV) * LD * (int)sizeof(T),
                "the combine's tiles fit over the K/V ring");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                // [2][kBKV][LD]
  T* Vs = Ks + 2 * kBKV * LD;          // [2][kBKV][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int kv = k_valid != nullptr ? k_valid[b] : S;
  // keys this q tile walks: all of [0, S), or the band's reach of the tile
  // cut at the valid keys (global positions; no overflow for window <= S)
  const int s_begin = kBanded ? max(0, q0 - window) : 0;
  const int s_end = kBanded ? min(min(S, kv), q0 + BQ + window) : S;
  // ... and the tiles of them that are this rank's
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kBKV - 1) / kBKV : 0;
  const int per_rank = (n_tiles + splits - 1) / splits;
  const int tile_begin = min(n_tiles, rank * per_rank);
  const int tile_end = min(n_tiles, tile_begin + per_rank);

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const T* bp = bias != nullptr ? bias + (long long)b * Tq * S : nullptr;

  // rows past the end are zero-filled: a zero V row keeps p = 0 times it finite
  auto load_kv = [&](int tile) {
    const int s0 = s_begin + tile * kBKV;
    T* ks = Ks + (tile & 1) * kBKV * LD;
    T* vs = Vs + (tile & 1) * kBKV * LD;
    for (int c = tid; c < kBKV * CPR; c += kThreads) {
      const int r = c / CPR, ch = c % CPR, s = s0 + r;
      const bool ok = s < s_end;
      cp_async_16(ks + r * LD + ch * EPC, ok ? kp + s * st.kt + ch * EPC : kp, ok);
      cp_async_16(vs + r * LD + ch * EPC, ok ? vp + s * st.vt + ch * EPC : vp, ok);
    }
  };

  for (int c = tid; c < BQ * CPR; c += kThreads) {
    const int r = c / CPR, ch = c % CPR, t = q0 + r;
    const bool ok = t < Tq;
    cp_async_16(Qs + r * LD + ch * EPC, ok ? qp + t * st.qt + ch * EPC : qp, ok);
  }
  if (tile_begin < tile_end) load_kv(tile_begin);
  cp_async_commit();

  // this thread's rows of the tile (fragment rows g and g + 8 of its warp)
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m_run[2] = {kNegBias, kNegBias};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // The bias of this thread's scores in a tile (fragment order).  It is
  // asked for one tile ahead, right after the previous tile's bias has been
  // used, so that the loads fly under a P V and a Q K^T product.  Rows of an
  // even S are 4-byte aligned in bf16 too: then a (2t, 2t+1) pair is one load.
  float bv[kBKV / 8][4];
  const bool bias_pairs = (S & 1) == 0;
  auto load_bias = [&](int tile) {
    const int s0 = s_begin + tile * kBKV;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row[r], s = s0 + j * 8 + 2 * t4;
        const T* src = bp + (long long)t * S + s;
        float b0 = 0.f, b1 = 0.f;
        if (t < Tq && s < s_end) {
          if (bias_pairs) {
            const float2 pr = load_pair(src);
            b0 = pr.x;
            b1 = pr.y;
          } else {
            b0 = to_f(src[0]);
            if (s + 1 < s_end) b1 = to_f(src[1]);
          }
        }
        bv[j][2 * r] = b0;
        bv[j][2 * r + 1] = b1;
      }
  };
  if (bp != nullptr && tile_begin < tile_end) load_bias(tile_begin);

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    if (tile + 1 < tile_end) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const int s0 = s_begin + tile * kBKV;
    const T* ks = Ks + (tile & 1) * kBKV * LD;
    const T* vs = Vs + (tile & 1) * kBKV * LD;

    // scores of 16 rows x 64 keys, in C fragments
    float sc[kBKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; kk += MM::kK) {
      typename MM::A a;
      MM::load_a(a, Qs + warp * 16 * LD + kk, LD, lane);
      typename MM::B kb[kBKV / 8];
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) MM::load_b(kb[j], ks + j * 8 * LD + kk, LD, lane);
      mma_grid<MM, 1, kBKV / 8>(&sc, &a, kb);
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row[e >> 1], s = s0 + j * 8 + 2 * t4 + (e & 1);
        float val;
        if (s >= s_end) {
          val = -INFINITY;  // not a key: excluded, never averaged in
        } else {
          val = sc[j][e] * scale;
          if (bp != nullptr) val += bv[j][e];
          if (s >= kv) val = kNegBias;
          if (kBanded && abs(t - s) > window) val = kNegBias;
        }
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    if (bp != nullptr && tile + 1 < tile_end) load_bias(tile + 1);

    // online softmax; m_run starts finite, so exp never sees (-inf) - (-inf)
    float alpha[2];
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
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp_of<T>(sc[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += pe;
        sc[j][e] = pe;
      }
    // o = alpha o + P V, P taken from the score fragments (rounded to T
    // there).  The tile's product goes into a zeroed fragment and is added
    // on the CUDA cores: the tensor cores add by truncation, and a chain over
    // thousands of keys would drift (mma.cuh)
    float pv[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += MM::kK) {
      typename MM::A pa;
      MM::a_from_acc(pa, &sc[kk / 8][0]);
      typename MM::B vb[kD / 8];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) MM::load_b_kn(vb[j], vs + kk * LD + j * 8, LD, lane);
      mma_grid<MM, 1, kD / 8>(&pv, &pa, vb);
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
    __syncthreads();  // the tile is consumed before the next load lands on it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  T* op = out + b * st.ob + h * st.oh;

  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Tq) continue;
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        store_pair(op + row[r] * st.ot + j * 8 + 2 * t4,
                   make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv));
    }
    cp_async_wait<0>();
    return;
  }

  // split over keys: (o, m, l) of every rank meet in shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* Os = reinterpret_cast<float*>(smem);  // [BQ][OLD], over the ring
  float* Ms = Os + BQ * OLD;                   // [BQ]
  float* Ls = Ms + BQ;                         // [BQ]
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with Q and the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + r * 8;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      store_pair(Os + lr * OLD + j * 8 + 2 * t4, make_float2(o[j][2 * r], o[j][2 * r + 1]));
    if (t4 == 0) {
      Ms[lr] = m_run[r];
      Ls[lr] = l_run[r];
    }
  }
  cluster.sync();
  // rank r combines rows r, r + splits, ...; the sums run over the ranks in
  // order, so they are the same sums on every run
  for (int idx = tid; idx < ((BQ - rank + splits - 1) / splits) * (kD / 2); idx += kThreads) {
    const int lr = rank + (idx / (kD / 2)) * splits, c = (idx % (kD / 2)) * 2;
    const int t = q0 + lr;
    if (t >= Tq) continue;
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
    store_pair(op + t * st.ot + c, make_float2(ox * inv, oy * inv));
  }
  cluster.sync();  // no block leaves while its tiles are being read
}

template <typename T, int WARPS, bool kBanded>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const int* k_valid, void* out, int B, int H, int Tq, int S,
                   const Strides& st, float scale, int window, int kv_splits,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, WARPS, kBanded>;
  constexpr int BQ = WARPS * 16;
  constexpr int kSmem = (BQ + 4 * kBKV) * (kD * (int)sizeof(T) + 16);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Tq + BQ - 1) / BQ, B * H, kv_splits);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = kv_splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias), k_valid, static_cast<T*>(out),
      H, Tq, S, st, scale, window);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool kBanded>
cudaError_t launch_rows(int block_q, const void* q, const void* k, const void* v,
                        const void* bias, const int* k_valid, void* out, int B, int H,
                        int Tq, int S, const Strides& st, float scale, int window,
                        int kv_splits, cudaStream_t s) {
  if (block_q != 64) return cudaErrorInvalidValue;  // the one instantiation
  return launch<T, 4, kBanded>(q, k, v, bias, k_valid, out, B, H, Tq, S, st, scale, window,
                               kv_splits, s);
}

template <bool kBanded>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* bias,
             const int* k_valid, void* out, int B, int H, int T, int S, int d,
             const long long* strides, float scale, int window, int block_q,
             int kv_splits, void* stream) {
  if (d != kD || B <= 0 || H <= 0 || T <= 0 || S <= 0 || B * H > 65535 || kv_splits < 1 ||
      kv_splits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = launch_rows<float, kBanded>(block_q, q, k, v, bias, k_valid, out, B, H, T, S, st,
                                      scale, window, kv_splits, s);
  } else if (dtype == kBF16) {
    err = launch_rows<__nv_bfloat16, kBanded>(block_q, q, k, v, bias, k_valid, out, B, H, T,
                                              S, st, scale, window, kv_splits, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace cosy

// q/k/v/out: (B, H, T|S, d) views given by element strides (12 values:
// q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t), d contiguous,
// every pointer and row start 16-byte aligned.  bias: contiguous (B, T, S) of
// the input type from a 16-byte-aligned start, or null.  k_valid: (B,) int32 on the device, or null (= S).
// block_q: query rows a block, 64; kv_splits: 1 to 8 blocks share a query
// tile's keys.  Returns a cudaError_t code.
extern "C" int cosy_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const int* k_valid, void* out, int B, int H,
                                    int T, int S, int d, const long long* strides,
                                    float scale, int block_q, int kv_splits,
                                    void* stream) {
  return cosy::dispatch<false>(dtype, q, k, v, bias, k_valid, out, B, H, T, S, d,
                               strides, scale, 0, block_q, kv_splits, stream);
}

// Kernel C.  q/k/v/out as above with S == T; no bias; a key is admitted when
// |t - s| <= window and s < k_valid[b] (k_valid null = T).  ``window`` is
// clamped to T (every key in reach), which keeps the position arithmetic in
// int range.  Returns a cudaError_t code.
extern "C" int cosy_banded_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* k_valid, void* out,
                                     int B, int H, int T, int d,
                                     const long long* strides, float scale,
                                     int window, int block_q, int kv_splits,
                                     void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  return cosy::dispatch<true>(dtype, q, k, v, nullptr, k_valid, out, B, H, T, T, d,
                              strides, scale, window < T ? window : T, block_q,
                              kv_splits, stream);
}
