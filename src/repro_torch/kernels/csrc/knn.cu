// Hand-written Hopper (sm_90a) KNN squared-L2 distance kernels.
//
//   knn_kernel       <- _knn_kernel / knn_distances in src/repro/kernels/knn.py
//   knn_wgmma_kernel <- the same, on the tensor cores (bf16, D % 8 == 0,
//                       16-byte-aligned bases; see its own note below)
//
// For queries q (Q, D) and database rows x (N, D), f32 or bf16, each
// writes the (Q, N) f32 matrix
//     out[i, j] = (|q_i|^2 - 2 q_i . x_j) + |x_j|^2
// in the matmul form the Pallas kernel uses, every product and sum in
// f32 (bf16 inputs are widened exactly on load; a bf16 x bf16 product is
// exact in f32).
//
// Translation from the TPU: the Pallas grid (Q / blk_q, N / blk_n) loads
// a whole (blk, D) query tile and db tile into VMEM and runs the dot on
// the MXU; it needs Q and N divisible by its blocks.
//
// knn_kernel, the CUDA-core kernel (f32 inputs, and bf16 ones that the
// tensor-core kernel does not take): one thread block owns a 64 x 64
// output tile and loops over D in slabs of 32: each slab of q and x is
// widened to f32 in shared memory (stored k-major so that a thread reads
// its 4 queries and 4 db rows as two float4s), each of the 256 threads
// accumulates a 4 x 4 block of q.x in registers, and threads 0..127
// accumulate the 64 + 64 squared norms of the tile from the same slabs.
// The tile is written once.  Ragged Q, N and D are masked in the kernel
// (SIFT-scale databases of 10^6 rows are divisible by no power of two):
// rows and columns past D load as 0 and add nothing, outputs past Q or N
// are not stored.  16-byte loads are used when D and the base pointers
// allow them (D a multiple of 8, so that a group of 8 columns never
// straddles a row's end), 16-byte stores when N is a multiple of 4.
//
// In both kernels the arithmetic of one output does not depend on where
// its tile lies (the same slab order, no split over D, no atomics), so a
// db split into chunks gives the same bits as the whole.
//
// What bounds them on an H100: at the offload shape (Q = 256, a chunk of
// N = 125,000 rows, D = 1024, bf16) the function reads 256 MB of db and
// writes 128 MB of distances (0.115 ms at 3.35 TB/s) and does 65.5 GFLOP
// (0.066 ms at the bf16 tensor-core peak), so its bound is the bytes.
// knn_kernel's f32 FMAs on the CUDA cores (67 TFLOP/s peak) cannot reach
// it; knn_wgmma_kernel's tensor cores can.
//
// Each entry point returns the cudaError_t of its launch (0 = success).

#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int BQ = 64;        // queries per tile
constexpr int BN = 64;        // db rows per tile
constexpr int BK = 32;        // columns of D per slab
constexpr int LD = BQ + 4;    // k-major row length in shared memory; keeps
                              // the float4 reads aligned

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Widen 8 consecutive values at src (16-byte aligned for bf16; for f32
// two 16-byte loads) into v.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One slab (64 rows x 32 columns from column k0) of a row-major (rows, D)
// matrix into the k-major tile dst[k * LD + r], widened to f32; zeros
// past `rows` and past D.
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(const T* src, int rows, int D,
                                          int r0, int k0, float* dst) {
  const int tid = threadIdx.x;
  if (VEC) {
    // 64 rows x 4 groups of 8 columns: one group per thread
    const int r = tid >> 2, c = (tid & 3) * 8;
    float v[8];
    if (r0 + r < rows && k0 + c < D) {
      load8(src + (size_t)(r0 + r) * D + k0 + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * LD + r] = v[e];
  } else {
    // consecutive threads on consecutive columns: 8 passes of 8 rows
#pragma unroll
    for (int p = 0; p < (BQ * BK) / NT; ++p) {
      const int e = p * NT + tid;
      const int r = e / BK, c = e % BK;
      float v = 0.f;
      if (r0 + r < rows && k0 + c < D) {
        v = to_f<T>(src[(size_t)(r0 + r) * D + k0 + c]);
      }
      dst[c * LD + r] = v;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
knn_kernel(const T* __restrict__ q, const T* __restrict__ x,
           float* __restrict__ out, int Q, int N, int D) {
  __shared__ __align__(16) float q_s[BK * LD];
  __shared__ __align__(16) float x_s[BK * LD];
  __shared__ float norm_s[BQ + BN];     // |q|^2 of the tile's queries, then
                                        // |x|^2 of its db rows
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, q0 = blockIdx.y * BQ;
  const int ty = tid / 16, tx = tid % 16;   // rows 4ty.., columns 4tx..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;                     // threads 0..127: one norm each

  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();                    // the previous slab is consumed
    load_slab<T, VEC>(q, Q, D, q0, k0, q_s);
    load_slab<T, VEC>(x, N, D, n0, k0, x_s);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&q_s[k * LD + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&x_s[k * LD + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (tid < BQ + BN) {
      const float* col = tid < BQ ? &q_s[tid] : &x_s[tid - BQ];
#pragma unroll 8
      for (int k = 0; k < BK; ++k) norm = fmaf(col[k * LD], col[k * LD], norm);
    }
  }
  if (tid < BQ + BN) norm_s[tid] = norm;
  __syncthreads();

  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r >= Q) break;
    const float q2 = norm_s[r];
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = __fadd_rn(__fsub_rn(q2, 2.f * acc[i][j]), norm_s[BQ + 4 * tx + j]);
    }
    const int c = n0 + 4 * tx;
    float* dst = out + (size_t)(q0 + r) * N + c;
    if (vec_out && c + 4 <= N) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N) dst[j] = o[j];
    }
  }
}

template <typename T>
int run_knn(const void* q, const void* x, float* out, int Q, int N, int D,
            cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (Q + BQ - 1) / BQ);
  // (out comes from the wrapper's torch.empty, which is 16-byte aligned)
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (aligned && D % 8 == 0) {
    knn_kernel<T, true><<<grid, NT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(x), out, Q, N, D);
  } else {
    knn_kernel<T, false><<<grid, NT, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(x), out, Q, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// knn_wgmma_kernel: a TN GEMM on the tensor cores, TMA-fed.
//
// One block owns a 128-query x 128-db-row output tile and walks D in
// slabs of 64 columns (128 bytes of bf16, the span of the 128-byte
// swizzle).  Nine warps:
//   * warp 8, the producer: one thread starts the TMA loads
//     (cp.async.bulk.tensor.2d, 128-byte swizzle, zero fill past Q, N and
//     D) of each slab's q tile and x tile into a ring of 3 stages, each
//     with an mbarrier "full" (the bytes landed) and "empty" (all 8
//     consumer warps are done with the stage);
//   * warps 0-7, two consumer warpgroups: warpgroup g multiplies query
//     rows 64g..64g+63 of the tile by its 128 db rows with four
//     wgmma.mma_async m64n128k16 per slab, both bf16 operands K-major
//     from shared memory as they lie in memory, f32 accumulators in
//     registers.  While the wgmmas run, consumer thread t sums the
//     squares of its tile row (a query row for t < 128, a db row after)
//     from the same slab on the CUDA cores: bf16 widened exactly, fmaf
//     over D in logical column order (the swizzle is undone in the
//     address), so a norm does not depend on where its row lies.
// The epilogue forms __fadd_rn(__fsub_rn(q2, 2 qx), x2), as knn_kernel
// does, stages the f32 tile in shared memory (the ring, free by then)
// and writes it as 16-byte rows (scalar stores at a ragged edge or when
// N % 4 != 0).
// Reading each db byte from HBM once: at Q = 256 the two query halves of
// a db tile are neighbouring blocks in launch order (blockIdx.x % n_qt is
// the query tile), and with two blocks resident on an SM the second finds
// the db slabs in L2.  Every block reads its 128 queries (256 KB at
// D = 1024) from L2.
// --------------------------------------------------------------------------

constexpr int WG_BM = 128;            // queries per tile
constexpr int WG_BN = 128;            // db rows per tile
constexpr int WG_BK = 64;             // columns of D per slab (128 bytes)
constexpr int WG_STAGES = 3;
constexpr int WG_CONSUMERS = 256;     // warps 0-7
constexpr int WG_THREADS = WG_CONSUMERS + 32;
constexpr int WG_TILE_BYTES = WG_BM * WG_BK * 2;   // = WG_BN * WG_BK * 2
constexpr int WG_OUT_LD = WG_BN + 8;  // f32 staging row: conflict-free float2
constexpr int WG_RING_BYTES = 2 * WG_STAGES * WG_TILE_BYTES;
constexpr size_t WG_SMEM = 1024 /* alignment slack */ + WG_RING_BYTES +
                           sizeof(float) * (WG_BM + WG_BN) +
                           sizeof(uint64_t) * 2 * WG_STAGES;
static_assert(WG_BM * WG_OUT_LD * 4 <= WG_RING_BYTES, "staging fits the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), base 1024-aligned.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |   // start address / 16
         ((uint64_t)1 << 16) |                 // LBO (unused when swizzled)
         ((uint64_t)(1024 >> 4) << 32) |       // SBO / 16
         ((uint64_t)1 << 62);                  // 128-byte swizzle
}

__device__ __forceinline__ void wg_fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, warpgroup fragments) += A (64 x 16) * B (128 x 16)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(WG_THREADS, 2)
knn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap x_map,
                 float* __restrict__ out, int Q, int N, int D) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* q_tiles = base;                              // [stage][128][64] bf16
  unsigned char* x_tiles = base + WG_STAGES * WG_TILE_BYTES;  // [stage][128][64] bf16
  float* norm_s = reinterpret_cast<float*>(base + WG_RING_BYTES);  // q2 | x2
  uint64_t* bars = reinterpret_cast<uint64_t*>(norm_s + WG_BM + WG_BN);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + WG_STAGES);

  const int n_qt = (Q + WG_BM - 1) / WG_BM;
  const int q0 = (blockIdx.x % n_qt) * WG_BM;
  const int n0 = (blockIdx.x / n_qt) * WG_BN;
  const int n_slabs = (D + WG_BK - 1) / WG_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {
    // producer
    if (lane == 0) {
      for (int k = 0; k < n_slabs; ++k) {
        const int s = k % WG_STAGES;
        mbar_wait(empty0 + 8 * s, ((k / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * WG_TILE_BYTES);
        tma_load_2d(smem_addr(q_tiles + s * WG_TILE_BYTES), &q_map,
                    full0 + 8 * s, k * WG_BK, q0);
        tma_load_2d(smem_addr(x_tiles + s * WG_TILE_BYTES), &x_map,
                    full0 + 8 * s, k * WG_BK, n0);
      }
    }
    return;
  }

  // consumers
  const int g = tid >> 7;                 // warpgroup: query rows 64g..
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float norm = 0.f;                       // tile row tid: q row, then x row
  const int nrow = tid & (WG_BM - 1);
  for (int k = 0; k < n_slabs; ++k) {
    const int s = k % WG_STAGES;
    mbar_wait(full0 + 8 * s, (k / WG_STAGES) & 1);
    const uint32_t qa = smem_addr(q_tiles + s * WG_TILE_BYTES) + g * 64 * 128;
    const uint32_t xa = smem_addr(x_tiles + s * WG_TILE_BYTES);
    wg_fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)     // 32 bytes per k step
      wgmma_m64n128k16(acc, wg_desc(qa + 32 * kk), wg_desc(xa + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    {
      const unsigned char* row =
          (tid < WG_BM ? q_tiles : x_tiles) + s * WG_TILE_BYTES + nrow * 128;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 raw16 =
            *reinterpret_cast<const uint4*>(row + ((c ^ (nrow & 7)) << 4));
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw16);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          norm = fmaf(f.x, f.x, norm);
          norm = fmaf(f.y, f.y, norm);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: both warpgroups are past their last wgmma, and every TMA
  // write has landed, before the ring is reused as the f32 staging tile
  norm_s[tid] = norm;
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
  float* stage = reinterpret_cast<float*>(base);           // [128][WG_OUT_LD]
  {
    const int w = (tid >> 5) & 3;
    const int r0 = g * 64 + w * 16 + (lane >> 2);
    const float q2a = norm_s[r0], q2b = norm_s[r0 + 8];
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float x2a = norm_s[WG_BM + c], x2b = norm_s[WG_BM + c + 1];
      *reinterpret_cast<float2*>(&stage[r0 * WG_OUT_LD + c]) = make_float2(
          __fadd_rn(__fsub_rn(q2a, 2.f * acc[4 * j]), x2a),
          __fadd_rn(__fsub_rn(q2a, 2.f * acc[4 * j + 1]), x2b));
      *reinterpret_cast<float2*>(&stage[(r0 + 8) * WG_OUT_LD + c]) = make_float2(
          __fadd_rn(__fsub_rn(q2b, 2.f * acc[4 * j + 2]), x2a),
          __fadd_rn(__fsub_rn(q2b, 2.f * acc[4 * j + 3]), x2b));
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
  const bool vec_out = (N % 4) == 0;
  for (int i = tid; i < WG_BM * (WG_BN / 4); i += WG_CONSUMERS) {
    const int r = i / (WG_BN / 4), c = 4 * (i % (WG_BN / 4));
    const int gq = q0 + r, gn = n0 + c;
    if (gq >= Q || gn >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(&stage[r * WG_OUT_LD + c]);
    float* dst = out + (size_t)gq * N + gn;
    if (vec_out && gn + 4 <= N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < N) dst[e] = o[e];
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so that the library links against the CUDA runtime
// alone.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, D) row-major bf16 matrix as TMA boxes of 128 rows x 64 columns
// with the 128-byte swizzle; zero fill past its edges.
bool encode_rows(CUtensorMap* map, const void* ptr, int rows, int D) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {WG_BK, WG_BM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int run_knn_wgmma(const void* q, const void* x, float* out, int Q, int N,
                  int D, cudaStream_t s) {
  if (D % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, x_map;
  if (!encode_rows(&q_map, q, Q, D) || !encode_rows(&x_map, x, N, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      knn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((Q + WG_BM - 1) / WG_BM) *
                           ((N + WG_BN - 1) / WG_BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  knn_wgmma_kernel<<<(unsigned)blocks, WG_THREADS, WG_SMEM, s>>>(
      q_map, x_map, out, Q, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_knn_distances(int dtype, const void* q, const void* x, float* out,
                     int Q, int N, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_knn<__nv_bfloat16>(q, x, out, Q, N, D, s)
                    : run_knn<float>(q, x, out, Q, N, D, s);
}

// bf16 only, D % 8 == 0, 16-byte-aligned q and x (the wrapper's route);
// anything else, or a tensor map that fails to encode, returns
// cudaErrorInvalidValue.
int rt_knn_distances_wgmma(const void* q, const void* x, float* out, int Q,
                           int N, int D, void* stream) {
  return run_knn_wgmma(q, x, out, Q, N, D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
