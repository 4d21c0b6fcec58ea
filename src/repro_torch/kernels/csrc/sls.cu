// Hand-written Hopper (sm_90a) SparseLengthsSum (embedding-bag) kernel.
//
//   sls_kernel <- _sls_kernel / sls in src/repro/kernels/sls.py
//
// For a table (V, D) f32 or bf16, indices (B, L) int32 and optional
// weights (B, L) f32, it writes the (B, D) f32 pooled bags
//     out[b] = sum over l in order of table[idx[b, l]] * w[b, l]
// with each product and each sum rounded in f32 (no FMA), as the Pallas
// kernel and the plain version compute them; weights = null means 1.
// An index outside [0, V) adds nothing: -1 is the padding of a short
// bag, and the kernel branches before the load, so it never reads a row
// outside the table.
//
// Translation from the TPU: the Pallas kernel keeps the table in HBM
// (memory_space ANY), gives each grid step `blk_b` bags and walks each
// bag's L slots with a row DMA per slot; it needs B % blk_b == 0.  Here
// one warp owns one bag and a 256-column slice of D (a second grid axis
// covers wider rows), 4 bags to a block, any B.  The warp loads 32 of
// its bag's indices and weights at once, one per lane, and hands them
// round with shuffles; it issues the row loads of 4 slots before it adds
// any of them, so 4 rows of every warp are in flight, and then adds them
// in slot order.  Each lane holds 8 columns of the running sum in
// registers; the sum is written once.  Nothing is staged in shared
// memory.
//
// What bounds it on an H100: the gathered rows.  At the offload shape
// (B = 4096 bags of up to 100 slots, half of them valid on average, D =
// 256 f32, a 1 GB table far larger than the 50 MB L2) it reads ~212 MB
// of rows, 3.3 MB of indices, weights and output: ~0.064 ms at 3.35
// TB/s.  The rows are random 1 KB reads, so the design's job is to keep
// enough of them in flight (4 per warp, 32 warps per SM).  16-byte loads
// when D is a multiple of 8 and the table is 16-byte aligned; otherwise
// each lane takes every 32nd column with scalar loads.
//
// The entry point returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BAGS = 4;          // warps (bags) per block
constexpr int NT = 32 * BAGS;
constexpr int SLICE = 256;       // columns per warp: 8 per lane
constexpr int U = 4;             // slots whose rows are loaded together
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The lane's 8 columns of one row: c0 = slice start + 8 lane .. + 7 with
// VEC, else slice start + lane + 32 e; zeros past D.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* row, int c0, int lane,
                                         int D, float* v) {
  if (VEC) {
    const int c = c0 + 8 * lane;
    if (c < D) {
      load8(row + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + lane + 32 * e;
      v[e] = c < D ? to_f<T>(row[c]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
sls_kernel(const T* __restrict__ table, const int* __restrict__ idx,
           const float* __restrict__ w, float* __restrict__ out, int B,
           int L, int V, int D) {
  const int lane = threadIdx.x % 32;
  const int bag = blockIdx.x * BAGS + threadIdx.x / 32;
  if (bag >= B) return;                 // a whole warp; no block barrier
  const int c0 = blockIdx.y * SLICE;
  const int* bag_idx = idx + (size_t)bag * L;
  const float* bag_w = w != nullptr ? w + (size_t)bag * L : nullptr;

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    const int my_i = lane < n ? __ldg(bag_idx + l0 + lane) : -1;
    const float my_w = (bag_w != nullptr && lane < n)
                           ? __ldg(bag_w + l0 + lane) : 1.f;
    for (int k = 0; k < n; k += U) {
      int row_at[U];
      float wt[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        row_at[u] = __shfl_sync(FULL, my_i, (k + u) & 31);
        wt[u] = __shfl_sync(FULL, my_w, (k + u) & 31);
        ok[u] = k + u < n && row_at[u] >= 0 && row_at[u] < V;
      }
      float r[U][8];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
          load_row<T, VEC>(table + (size_t)row_at[u] * D, c0, lane, D, r[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(r[u][e], wt[u]));
        }
      }
    }
  }

  float* dst = out + (size_t)bag * D;
  if (VEC) {
    const int c = c0 + 8 * lane;
    if (c < D) {
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(dst + c + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < D) dst[c] = acc[e];
    }
  }
}

template <typename T>
int run_sls(const void* table, const int* idx, const float* w, float* out,
            int B, int L, int V, int D, cudaStream_t s) {
  const dim3 grid((B + BAGS - 1) / BAGS, (D + SLICE - 1) / SLICE);
  // (out comes from the wrapper's torch.empty, which is 16-byte aligned)
  if (reinterpret_cast<uintptr_t>(table) % 16 == 0 && D % 8 == 0) {
    sls_kernel<T, true><<<grid, NT, 0, s>>>(static_cast<const T*>(table),
                                            idx, w, out, B, L, V, D);
  } else {
    sls_kernel<T, false><<<grid, NT, 0, s>>>(static_cast<const T*>(table),
                                             idx, w, out, B, L, V, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_sls(int dtype, const void* table, const int* idx, const float* w,
           float* out, int B, int L, int V, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_sls<__nv_bfloat16>(table, idx, w, out, B, L, V, D, s)
                    : run_sls<float>(table, idx, w, out, B, L, V, D, s);
}

}  // extern "C"
