// Hand-written Hopper (sm_90a) KNN squared-L2 distance kernel.
//
//   knn_kernel <- _knn_kernel / knn_distances in src/repro/kernels/knn.py
//
// For queries q (Q, D) and database rows x (N, D), f32 or bf16, it
// writes the (Q, N) f32 matrix
//     out[i, j] = (|q_i|^2 - 2 q_i . x_j) + |x_j|^2
// in the matmul form the Pallas kernel uses, every product and sum in
// f32 (bf16 inputs are widened exactly on load).
//
// Translation from the TPU: the Pallas grid (Q / blk_q, N / blk_n) loads
// a whole (blk, D) query tile and db tile into VMEM and runs the dot on
// the MXU; it needs Q and N divisible by its blocks.  Here one thread
// block owns a 64 x 64 output tile and loops over D in slabs of 32:
// each slab of q and x is widened to f32 in shared memory (stored k-major
// so that a thread reads its 4 queries and 4 db rows as two float4s),
// each of the 256 threads accumulates a 4 x 4 block of q.x in registers,
// and threads 0..127 accumulate the 64 + 64 squared norms of the tile
// from the same slabs.  The tile is written once.  Ragged Q, N and D are
// masked in the kernel (SIFT-scale databases of 10^6 rows are divisible
// by no power of two): rows and columns past D load as 0 and add
// nothing, outputs past Q or N are not stored.  The arithmetic of one
// output does not depend on where its tile lies, so a db split into
// chunks gives the same bits as the whole.
//
// What bounds it on an H100: at the offload shape (Q = 256, a chunk of
// N = 125,000 rows, D = 1024, bf16) it reads 256 MB of db and writes
// 128 MB of distances (0.115 ms at 3.35 TB/s) and does 65.5 GFLOP (0.066
// ms at the bf16 tensor-core peak), so its bound is the bytes.  This
// version does the products with f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), which is what the Pallas kernel computes (f32 operands, f32
// accumulation); wgmma on bf16 operands with f32 accumulation is later
// work.  16-byte loads are used when D and the base pointers allow them
// (D a multiple of 8, so that a group of 8 columns never straddles a
// row's end), 16-byte stores when N is a multiple of 4.
//
// The entry point returns the cudaError_t of its launch (0 = success).

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

}  // namespace

extern "C" {

int rt_knn_distances(int dtype, const void* q, const void* x, float* out,
                     int Q, int N, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_knn<__nv_bfloat16>(q, x, out, Q, N, D, s)
                    : run_knn<float>(q, x, out, Q, N, D, s);
}

}  // extern "C"
