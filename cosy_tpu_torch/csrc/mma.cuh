// Tensor-core and asynchronous-copy building blocks of the Hopper kernels:
// cp.async (16-byte global -> shared copies with zero fill), ldmatrix and the
// warp-level mma.sync instructions, behind one interface per element type;
// then the pieces the block's kernels share: the stream of K slices through
// a cp.async ring, one slice's product and the tanh GELU.
//
//   Mma<__nv_bfloat16>: mma.sync.m16n8k16, bf16 x bf16 -> f32.  A product of
//     two bf16 values is exact in f32, so only the order of the sum differs
//     from a scalar f32 loop.
//   Mma<float>: error-compensated 3xTF32 on mma.sync.m16n8k8.  Each f32
//     operand x is split into hi = tf32(x) and lo = tf32(x - hi); the product
//     is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation, small terms
//     first.  hi + lo carries 21-22 mantissa bits, so the result stays within
//     a few 1e-7 relative of an exact f32 product per term, where single-pass
//     TF32 (10 mantissa bits, ~5e-4) would break the kernels' f32 tolerances.
//     The tensor cores add into their f32 accumulator by truncation, not by
//     rounding to nearest, so a long chain of mma steps drifts in one
//     direction (measured: 6e-5 at K = 1024 against 1e-5 at K = 256).  The
//     kernels therefore keep a chain short (kPromote): one K slice or one
//     key tile is summed into a zeroed fragment, which is then added to the
//     running sum on the CUDA cores, with rounding to nearest.
//
// Fragment layouts (g = lane / 4, t = lane % 4), from the PTX ISA:
//   C m16n8 (f32):  c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   A m16k16 (bf16 pairs): a0 (g, 2t..) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B k16n8  (bf16 pairs): b0 (k 2t.., n g) b1 (k 2t+8.., n g)
//   A m16k8  (tf32): a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4)
//   B k8n8   (tf32): b0 (k t, n g) b1 (k t+4, n g)
#pragma once

#include <cstdint>

#include "common.cuh"

namespace cosy {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (src is
// then not read but must still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;  // depth of one mma step
  static constexpr bool kPromote = false;  // bf16 tolerances do not need it
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  // A fragment of the 16 x 16 block at `tile` of a row-major shared tile
  // with `ld` elements a row
  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld, int lane) {
    const T* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
                 : "r"(smem_u32(p)));
  }
  // B fragment (k16 x n8) from a tile stored [n][k] (rows are output
  // columns): `tile` points at (n0, k0)
  static __device__ __forceinline__ void load_b(B& b, const T* tile, int ld, int lane) {
    const T* p = tile + (lane & 7) * ld + ((lane >> 3) & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b.r[0]), "=r"(b.r[1])
                 : "r"(smem_u32(p)));
  }
  // B fragment (k16 x n8) from a tile stored [k][n]: `tile` points at (k0, n0)
  static __device__ __forceinline__ void load_b_kn(B& b, const T* tile, int ld, int lane) {
    const T* p = tile + (lane & 15) * ld;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b.r[0]), "=r"(b.r[1])
                 : "r"(smem_u32(p)));
  }
  // A fragment (16 rows x 16 k) from two neighbouring C fragments
  // (c[0..3] the n-tile of k 0..7, c[4..7] of k 8..15), rounded to bf16;
  // pairs with load_b_kn
  static __device__ __forceinline__ void a_from_acc(A& a, const float* c) {
    a.r[0] = pack_bf16(c[0], c[1]);
    a.r[1] = pack_bf16(c[2], c[3]);
    a.r[2] = pack_bf16(c[4], c[5]);
    a.r[3] = pack_bf16(c[6], c[7]);
  }
  // c += a b is kPasses mma steps; a caller runs one pass over all of its
  // independent accumulators before the next, so that no mma waits for the
  // one issued just before it
  static constexpr int kPasses = 1;
  template <int kPass>
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  static constexpr bool kPromote = true;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(tile[g * ld + t], a.hi[0], a.lo[0]);
    split_tf32(tile[(g + 8) * ld + t], a.hi[1], a.lo[1]);
    split_tf32(tile[g * ld + t + 4], a.hi[2], a.lo[2]);
    split_tf32(tile[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_b(B& b, const T* tile, int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(tile[g * ld + t], b.hi[0], b.lo[0]);
    split_tf32(tile[g * ld + t + 4], b.hi[1], b.lo[1]);
  }
  // [k][n] tile for a product whose A operand came from a_from_acc: a C
  // fragment holds columns 2t and 2t+1 where an A fragment wants t and t+4,
  // so the eight k of a step are taken in the order 0,2,4,6,1,3,5,7 on both
  // operands (a sum does not care), and nothing moves between lanes
  static __device__ __forceinline__ void load_b_kn(B& b, const T* tile, int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(tile[(2 * t) * ld + g], b.hi[0], b.lo[0]);
    split_tf32(tile[(2 * t + 1) * ld + g], b.hi[1], b.lo[1]);
  }
  // A fragment (16 rows x 8 k) from one C fragment c[0..3]; see load_b_kn
  static __device__ __forceinline__ void a_from_acc(A& a, const float* c) {
    split_tf32(c[0], a.hi[0], a.lo[0]);
    split_tf32(c[2], a.hi[1], a.lo[1]);
    split_tf32(c[1], a.hi[2], a.lo[2]);
    split_tf32(c[3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma1(float* c, const uint32_t* a, const uint32_t* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // the three products of the compensated scheme, small terms first
  static constexpr int kPasses = 3;
  template <int kPass>
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    if constexpr (kPass == 0) mma1(c, a.lo, b.hi);
    else if constexpr (kPass == 1) mma1(c, a.hi, b.lo);
    else mma1(c, a.hi, b.hi);
  }
};

// c[i][j] += a[i] b[j] over an MT x NT grid of fragments, pass by pass
template <typename MM, int MT, int NT, int kPass = 0>
__device__ __forceinline__ void mma_grid(float (*c)[NT][4], const typename MM::A* a,
                                         const typename MM::B* b) {
  if constexpr (kPass < MM::kPasses) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) MM::template mma<kPass>(c[i][j], a[i], b[j]);
    mma_grid<MM, MT, NT, kPass + 1>(c, a, b);
  }
}

// ---------------------------------------------------------------------------
// The block's products: one mainloop for the GEMM kernel (with or without
// its LayerNorm prologue) and the three products of the block tail
// ---------------------------------------------------------------------------

constexpr int kSliceBytes = 128;  // K advances 128 bytes of a row at a time
constexpr int kRowBytes = 144;    // a slice row in shared memory, padded

// COSY_TRACE builds (ops/phase_trace.py's, never the library's) record
// %globaltimer at numbered phases of block 0, thread 0 into trace_ns
#ifdef COSY_TRACE
__device__ long long trace_ns[32];
#define COSY_PHASE(i)                                                         \
  do {                                                                        \
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) { \
      long long t_;                                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
      trace_ns[i] = t_;                                                       \
    }                                                                         \
  } while (0)
#else
#define COSY_PHASE(i)
#endif

// K advances through a ring of shared-memory stages in slices of
// kSliceBytes a row, filled by 16-byte cp.async copies.  The slices a
// kernel multiplies form one stream: a kernel of several products (the
// block tail) numbers them across its products, so that the copies of the
// next product's first slices are in flight while the block finishes the
// previous one, reduces across its cluster or normalises.
//
// stream_start issues slices 0 .. STAGES-2; stream_slices then consumes the
// n slices first .. first + n - 1 in order, one __syncthreads() a slice,
// issuing slice i + STAGES - 1 as slice i is consumed.  issue(i) starts the
// copies of stream slice i into stage i % STAGES (no commit).  One commit a
// slice (an empty one past the end) keeps the count of groups uniform, so
// cp.async.wait_group STAGES - 2 means "slice i has landed".
template <int STAGES, typename Issue>
__device__ __forceinline__ void stream_start(int total, Issue issue) {
  static_assert(STAGES >= 2, "the ring needs two stages");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
}
template <int STAGES, typename Issue, typename Compute>
__device__ __forceinline__ void stream_slices(int first, int n, int total, Issue issue,
                                              Compute compute) {
  for (int it = 0; it < n; ++it) {
    const int i = first + it;
    cp_async_wait<STAGES - 2>();  // slice i has landed
    __syncthreads();              // ... for every thread, and slice i-1 is consumed
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);
    cp_async_commit();
    compute(i % STAGES, it);
  }
}

// the copies of one K slice of ROWS rows into a stage (rows kRowBytes
// apart): row r from row(r) + k0, zero for rows >= valid or K >= k_len
template <typename T, int ROWS, int kThreads, typename Row>
__device__ __forceinline__ void load_slice_rows(T* dst, Row row, int valid, int k0, int k_len) {
  constexpr int EPC = 16 / sizeof(T), CPR = kSliceBytes / 16, LD = kRowBytes / sizeof(T);
  for (int c = threadIdx.x; c < ROWS * CPR; c += kThreads) {
    const int r = c / CPR, ch = c % CPR, gk = k0 + ch * EPC;
    const bool ok = r < valid && gk < k_len;
    cp_async_16(dst + r * LD + ch * EPC, ok ? row(r) + gk : row(0), ok);
  }
}

// acc (BM x BN, WARPS_M x WARPS_N warps, each a (BM / WARPS_M) x
// (BN / WARPS_N) part as m16n8 fragments) += the product of one K slice:
// A rows lda elements apart at the slice's first k (a stage, or a tile
// resident in shared memory whose rows are 16 mod 128 bytes apart, which
// keeps the fragment loads free of bank conflicts) and W's BN rows of a
// stage.  Under Mma<float> (kPromote) the slice is summed into a zeroed
// fragment and added to acc on the CUDA cores, rounding to nearest.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__device__ __forceinline__ void slice_product(
    float (&acc)[BM / WARPS_M / 16][BN / WARPS_N / 8][4], const T* a, int lda, const T* w) {
  using MM = Mma<T>;
  constexpr int BK = kSliceBytes / sizeof(T);   // 32 f32 or 64 bf16 values
  constexpr int LD = kRowBytes / sizeof(T);     // padded stage row, in elements
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must hold whole fragments");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* as = a + (warp / WARPS_N) * WM * lda;
  const T* ws = w + (warp % WARPS_N) * WN * LD;
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
    typename MM::A af[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) MM::load_a(af[i], as + i * 16 * lda + kk, lda, lane);
    typename MM::B bf[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) MM::load_b(bf[j], ws + j * 8 * LD + kk, LD, lane);
    if constexpr (MM::kPromote) mma_grid<MM, MT, NT>(part, af, bf);
    else mma_grid<MM, MT, NT>(acc, af, bf);
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

// the epilogue's activation: none, GELU by the tanh approximation, or exact
// (erf) GELU, the estimator's gelu_approximate=False
enum Act : int { kNone = 0, kGeluTanh = 1, kGeluErf = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (act == kGeluErf) return 0.5f * v * (1.f + erff(v * 0.70710678f));
  return v;
}

}  // namespace cosy
