// Hopper's own machinery for the block's products: a ring of shared-memory
// stages filled by the Tensor Memory Accelerator (TMA), completion reported
// to mbarriers, and warpgroup products (wgmma.mma_async) that read B from
// the ring and A from registers; and, for blocks that share work across a
// thread block cluster, pushes into a peer's shared memory that complete on
// the peer's own mbarrier.  Kernels B1 (ln_gemm.cu), B2 (block_tail.cu) and
// A / C (flash_attention.cu) are built on it; the pieces are kernel-agnostic.
//
//   TmaRing<STAGES>: one producer thread issues the copies of stream slice i
//     into stage i % STAGES (acquire: the stage's consumers have released
//     it; expect: the bytes the copies will bring); consumers wait for
//     slice i to land and release it when their products are done.  Phase
//     parities follow from i alone, so no state beyond the barriers.
//   Tensor maps: a row-major 2-D tensor read as boxes of (rows, 128 bytes),
//     128-byte swizzled (the layout wgmma reads with a SWIZZLE_128B
//     descriptor: 8 rows of 128 bytes an atom, 16-byte chunk c of row r at
//     chunk c ^ (r % 8)).  cuTensorMapEncodeTiled is reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.  Rows past
//     the tensor's end land as zeros, and count in the expected bytes.
//     make_tensor_map_strided reads a tensor of up to five dimensions with
//     any byte strides (a view such as the heads of a (B, T, 3, H, d)
//     product), dimension 0 contiguous; each dimension is bounded on its
//     own, so a box that runs past the end of dimension 1 takes zeros there
//     and never the rows of the next index of dimension 2.
//   Pushes: bulk_push copies bytes of this block's shared memory into block
//     `rank` of the cluster (cp.async.bulk, addresses from mapa) and reports
//     them to that block's mbarrier (complete_tx), which the receiver alone
//     waits on (mbar_wait_cluster: acquire at cluster scope); the sender
//     learns of it only through the receiver (its source stays in place and
//     the block stays resident until the receiver says so, for instance at
//     a cluster barrier after its wait).  mbar_arrive_remote is an
//     arrival without data on a peer's barrier.  A block may push or arrive
//     remotely only after cluster_wait() of the cluster barrier that follows
//     the barriers' initialisation (cluster_arrive() after init).
//   Wgmma<T, N>::rs: D (64 x N, f32) += A (64 x k, registers) B (k x N,
//     shared, K-major, 128-byte swizzle); k is 8 TF32 values (f32 words,
//     of which the tensor cores read the top 19 bits) or 16 bf16 values.
//     Wgmma<bf16, N, 1> reads B MN-major instead (the transpose bit: N
//     contiguous, a 128-byte row of N values a k); with N one 128-byte
//     atom wide, wgmma_desc describes that tile too.  TF32 has no such form.
//     The register fragments follow mma.sync's: warp w of the group owns
//     rows 16w .. 16w + 15; lane (g = lane / 4, t = lane % 4) holds
//       tf32 A: (g, t) (g+8, t) (g, t+4) (g+8, t+4)
//       bf16 A: (g, 2t..2t+1) (g+8, 2t..) (g, 2t+8..2t+9) (g+8, 2t+8..)
//       D, n8 chunk j: (g, 8j+2t) (g, 8j+2t+1) (g+8, 8j+2t) (g+8, 8j+2t+1)
//
// Ordering rules the users keep: a generic-proxy write to shared memory
// that wgmma or TMA will read (a split tile) is followed by
// fence_proxy_async() in the writing thread, then a barrier; registers a
// product reads or writes are touched only after wgmma_wait and fenced
// (fence_operands) on both sides of the asynchronous window.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked

#include "mma.cuh"

namespace cosy {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed.  A build with
// -DCOSY_WAIT_LIMIT=n traps after n polls instead of waiting for ever (a
// first run of a changed protocol: the launch fails, the card is not hung)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
#ifdef COSY_WAIT_LIMIT
  long long polls = 0;
#endif
  do {
#ifdef COSY_WAIT_LIMIT
    if (++polls > COSY_WAIT_LIMIT) __trap();
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the same wait with acquire at cluster scope: for a phase that peers'
// pushes or remote arrivals complete
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done;
#ifdef COSY_WAIT_LIMIT
  long long polls = 0;
#endif
  do {
#ifdef COSY_WAIT_LIMIT
    if (++polls > COSY_WAIT_LIMIT) __trap();
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared by the generic proxy, of which the first
// `bytes` (0 to 16) are read and the rest land as zeros (with 0, src is not
// read but must still be a valid address); and one arrival on `bar` once
// every such copy this thread issued before it has landed (.noinc: the
// barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_chunk(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// clusters: the split cluster barrier, pushes into a peer's shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of p (this block's shared memory) in block `rank`
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// `bytes` (a multiple of 16) from src in this block to dst in block `rank`
// (both 16-byte aligned, dst and bar given as this block's addresses of the
// same layout), completion reported to that block's barrier `bar`
__device__ __forceinline__ void bulk_push(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(mapa(dst, rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(mapa(bar, rank))
      : "memory");
}
// one arrival, released at cluster scope, on barrier `bar` of block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   mapa(bar, rank))
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA, proxies, named barriers
// ---------------------------------------------------------------------------

// box (c1 .. c1 + rows, c0 .. c0 + 128 bytes) of `map` into dst (1024-byte
// aligned), completion to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// the same for maps of three and four dimensions (make_tensor_map_strided)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// the box of `map` at (c0, c1) from src (1024-byte aligned, written by the
// generic proxy and fenced); tma_store_wait: the stores have read src
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier ID (1..15; 0 is __syncthreads) over THREADS threads
template <int ID, int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}

// ---------------------------------------------------------------------------
// the ring of stages
// ---------------------------------------------------------------------------

template <int STAGES>
struct TmaRing {
  uint64_t full[STAGES], empty[STAGES];

  // one thread; `consumers` arrivals release a stage
  __device__ __forceinline__ void init(int consumers) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  // producer: stage i % STAGES is free for slice i; then announce its bytes
  __device__ __forceinline__ uint64_t* acquire(int i, uint32_t bytes) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    mbar_arrive_expect(&full[s], bytes);
    return &full[s];
  }
  // consumers: slice i has landed in stage i % STAGES
  __device__ __forceinline__ void wait(int i) { mbar_wait(&full[i % STAGES], (i / STAGES) & 1); }
  // consumers (one arrival each of `consumers`): done with slice i
  __device__ __forceinline__ void release(int i) { mbar_arrive(&empty[i % STAGES]); }
};

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a K-major operand tile whose rows are 128 bytes, 128-byte
// swizzled, 8-row atoms 1024 bytes apart; p is the atom-aligned start plus
// the byte offset of the k step within the row
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of these registers across the
// asynchronous window of a product
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <typename V, int R, int N>
__device__ __forceinline__ void fence_operands(V (&d)[R][N]) {
#pragma unroll
  for (int r = 0; r < R; ++r) fence_operands(d[r]);
}

#define COSY_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define COSY_D16 COSY_D8(0), COSY_D8(8)
#define COSY_D32 COSY_D16, COSY_D8(16), COSY_D8(24)
#define COSY_D64 COSY_D32, COSY_D8(32), COSY_D8(40), COSY_D8(48), COSY_D8(56)
#define COSY_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define COSY_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define COSY_R64                                                                          \
  COSY_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
           "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
           "%62, %63"
// D (N/2 f32 a thread) = A (4 b32 registers) x B (descriptor) + (scale_d ? D : 0)
#define COSY_WGMMA_RS(INST, REGS, A0, A1, A2, A3, DESC, SCALE, TAIL, OUTS)                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n" INST " {" REGS "}, {" A0 \
               ", " A1 ", " A2 ", " A3 "}, " DESC ", p, " TAIL ";\n}\n"                     \
               : OUTS                                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d))

template <typename T, int N, int kTransB = 0>
struct Wgmma;

template <>
struct Wgmma<float, 32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32", COSY_R16, "%16",
                  "%17", "%18", "%19", "%20", "%21", "1, 1", COSY_D16);
  }
};
template <>
struct Wgmma<float, 64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32", COSY_R32, "%32",
                  "%33", "%34", "%35", "%36", "%37", "1, 1", COSY_D32);
  }
};
template <>
struct Wgmma<float, 128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32", COSY_R64, "%64",
                  "%65", "%66", "%67", "%68", "%69", "1, 1", COSY_D64);
  }
};
template <>
struct Wgmma<__nv_bfloat16, 32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16", COSY_R16, "%16",
                  "%17", "%18", "%19", "%20", "%21", "1, 1, 0", COSY_D16);
  }
};
template <>
struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", COSY_R32, "%32",
                  "%33", "%34", "%35", "%36", "%37", "1, 1, 0", COSY_D32);
  }
};
template <>
struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", COSY_R64, "%64",
                  "%65", "%66", "%67", "%68", "%69", "1, 1, 0", COSY_D64);
  }
};

// B MN-major (the transpose bit): P V with V landed as (keys, d), d contiguous
template <>
struct Wgmma<__nv_bfloat16, 64, 1> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    COSY_WGMMA_RS("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", COSY_R32, "%32",
                  "%33", "%34", "%35", "%36", "%37", "1, 1, 1", COSY_D32);
  }
};

#undef COSY_WGMMA_RS
#undef COSY_R64
#undef COSY_R32
#undef COSY_R16
#undef COSY_D64
#undef COSY_D32
#undef COSY_D16
#undef COSY_D8

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

inline TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// `map` reads the row-major (rows, cols) tensor at ptr (f32 or bf16) as
// boxes of box_rows rows and 128 bytes of columns, 128-byte swizzled
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* ptr, bool f32, int rows,
                                   int cols, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int es = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / es),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// `map` reads the tensor at ptr (f32 or bf16) of `rank` (2 to 5) dimensions:
// dims[0] contiguous values, dims[i] at byte stride strides[i - 1] (each a
// multiple of 16), as boxes of 128 bytes of dimension 0 by box_rows of
// dimension 1 (and one of each further dimension), 128-byte swizzled.
// Every dimension is bounded on its own: what lies past dims[1] lands as
// zeros, whatever the next index of dimension 2 holds.
inline cudaError_t make_tensor_map_strided(CUtensorMap* map, const void* ptr, bool f32,
                                           int rank, const long long* dims,
                                           const long long* strides, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rank < 2 || rank > 5) return cudaErrorInvalidValue;
  const int es = f32 ? 4 : 2;
  cuuint64_t gd[5], gs[4];
  cuuint32_t box[5], steps[5];
  for (int i = 0; i < rank; ++i) {
    if (dims[i] <= 0) return cudaErrorInvalidValue;
    gd[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 ? static_cast<cuuint32_t>(128 / es) : i == 1 ? box_rows : 1;
    steps[i] = 1;
    if (i > 0) {
      if (strides[i - 1] <= 0 || strides[i - 1] % 16 != 0) return cudaErrorInvalidValue;
      gs[i - 1] = static_cast<cuuint64_t>(strides[i - 1]);
    }
  }
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), gd, gs, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace cosy
