// Hand-written Hopper (sm_90a) Mamba2 SSD chunked scan.
//
//   ssd_kernel <- _ssd_kernel / ssd_scan in src/repro/kernels/ssd.py
//
// The recurrence, per row b and head h, over the sequence s, with a
// single group (B and C shared by all heads):
//     state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T     (P x N, f32)
//     y_t     = state_t C_t
// computed chunk by chunk in its SSD form.  For a chunk of rows [t0,
// t0 + CL), with cum the inclusive cumsum of dt A inside the chunk:
//     G    = (C B^T) o exp(cum_i - cum_j) o dt_j, masked to j <= i
//     y    = G x + (C state^T) o exp(cum_i)
//     state <- state exp(cum_last) + x^T (B o exp(cum_last - cum_j) dt_j)
//
// Translation from the TPU: the Pallas grid (B, H, n_chunks) carries the
// (P, N) state in VMEM along its sequential chunk axis.  Here one thread
// block owns (b, h, a PT-column slice of P): the rows of the state are
// independent, so the slice needs no other block's state, and splitting
// P gives B*H*P/PT blocks (128 at the full-width shape, one per SM)
// where whole heads would give 32.  A loop over chunks inside the block
// takes the place of the chunk axis; the state slice lives in shared
// memory in f32 from the first chunk to the last.  Each block recomputes
// the chunk's C B^T, which its head and P slice share with the others.
//
// Numerics: every decay is the exponential of a difference that is <= 0
// (cum is non-increasing, since dt >= 0 and A < 0), never a product of
// exp(cum_i) and exp(-cum_j): inside a chunk cum reaches about -50 at
// the full-width dt (~0.8) and A = -1, and exp(+50) would lose the sum.
// A row with dt = 0 (the padded tail of a prompt) decays by exp(0) = 1
// and adds 0, so it leaves the state exactly as it was.  Any S: rows of
// the last chunk past S are loaded as zeros with dt = 0, and not stored.
//
// What bounds it on an H100: at the prefill shape (S = 512, H = 32,
// P = 64, N = 128, bf16) it moves ~5.5 MB and does ~1 GFLOP, so its bound
// is the bytes (~1.6 us at 3.35 TB/s).  This version does every product
// with f32 FMAs on the CUDA cores out of shared memory, far from that
// bound; wgmma for C B^T, G x and the state update, and one C B^T shared
// across the heads, are later work.
//
// The entry point returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int CL = 64;    // sequence rows per chunk
constexpr int PT = 16;    // columns of P (rows of the state) per block

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct SsdArgs {
  const void* x;          // (B, S, H, P)  T
  const float* dt;        // (B, S, H)
  const float* A;         // (H,)
  const void* bm;         // (B, S, N)     T
  const void* cm;         // (B, S, N)     T
  const float* init;      // (B, H, P, N)  or null: zeros
  void* y;                // (B, S, H, P)  T
  float* final_state;     // (B, H, P, N)
  int S, H, P, N;
};

// Shared memory, in floats.  Rows of B, C and the state are padded by
// one float so that threads walking neighbouring rows hit distinct banks.
__host__ __device__ inline size_t ssd_smem_floats(int N) {
  const size_t LN = (size_t)N + 1;
  return PT * LN + 2 * CL * LN + (size_t)CL * PT + (size_t)CL * (CL + 1) +
         4 * CL;
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(const SsdArgs a) {
  extern __shared__ float sm[];
  const int S = a.S, H = a.H, P = a.P, N = a.N, LN = N + 1, LG = CL + 1;
  const int b = blockIdx.x / H, h = blockIdx.x % H, p0 = blockIdx.y * PT;
  const int tid = threadIdx.x;
  float* st_s = sm;                   // PT x LN   the carried state slice
  float* b_s = st_s + PT * LN;        // CL x LN
  float* c_s = b_s + CL * LN;         // CL x LN
  float* x_s = c_s + CL * LN;         // CL x PT
  float* g_s = x_s + CL * PT;         // CL x LG
  float* cum_s = g_s + CL * LG;       // CL
  float* dt_s = cum_s + CL;           // CL
  float* w_s = dt_s + CL;             // CL: exp(cum_last - cum_j) dt_j
  float* e_s = w_s + CL;              // CL: exp(cum_i)

  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);
  T* y = static_cast<T*>(a.y);
  const float A = a.A[h];
  const size_t state_base = ((size_t)b * H + h) * P * N;

  for (int e = tid; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    st_s[p * LN + n] = (a.init != nullptr && p0 + p < P)
                           ? a.init[state_base + (size_t)(p0 + p) * N + n]
                           : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += CL) {
    const int len = min(CL, S - t0);
    __syncthreads();   // the previous chunk is done with b_s, x_s, w_s
    for (int i = tid; i < CL; i += NT)
      dt_s[i] = i < len ? a.dt[((size_t)b * S + t0 + i) * H + h] : 0.f;
    for (int e = tid; e < CL * N; e += NT) {
      const int r = e / N, n = e % N;
      const size_t off = ((size_t)b * S + t0 + r) * N + n;
      b_s[r * LN + n] = r < len ? to_f(bm[off]) : 0.f;
      c_s[r * LN + n] = r < len ? to_f(cm[off]) : 0.f;
    }
    for (int e = tid; e < CL * PT; e += NT) {
      const int r = e / PT, p = e % PT;
      x_s[e] = (r < len && p0 + p < P)
                   ? to_f(x[(((size_t)b * S + t0 + r) * H + h) * P + p0 + p])
                   : 0.f;
    }
    __syncthreads();
    if (tid == 0) {    // inclusive cumsum of dt A, in sequence order
      float c = 0.f;
      for (int i = 0; i < CL; ++i) {
        c += dt_s[i] * A;
        cum_s[i] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum_s[CL - 1];
    for (int i = tid; i < CL; i += NT) {
      w_s[i] = expf(cum_last - cum_s[i]) * dt_s[i];
      e_s[i] = expf(cum_s[i]);
    }
    // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    for (int e = tid; e < CL * CL; e += NT) {
      const int i = e / CL, j = e % CL;
      float g = 0.f;
      if (j <= i) {
        const float* ci = c_s + i * LN;
        const float* bj = b_s + j * LN;
        for (int n = 0; n < N; ++n) g = fmaf(ci[n], bj[n], g);
        g *= expf(cum_s[i] - cum_s[j]) * dt_s[j];
      }
      g_s[i * LG + j] = g;
    }
    __syncthreads();
    // y_i = sum_{j <= i} G[i][j] x_j + exp(cum_i) (C_i . state_p)
    for (int e = tid; e < CL * PT; e += NT) {
      const int i = e / PT, p = e % PT;
      if (i >= len || p0 + p >= P) continue;
      const float* gi = g_s + i * LG;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(gi[j], x_s[j * PT + p], intra);
      const float* ci = c_s + i * LN;
      const float* sp = st_s + p * LN;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], sp[n], inter);
      y[(((size_t)b * S + t0 + i) * H + h) * P + p0 + p] =
          from_f<T>(fmaf(inter, e_s[i], intra));
    }
    __syncthreads();   // every y has read the state it needs
    // state_p,n <- state_p,n exp(cum_last) + sum_j x_j,p B_j,n w_j
    const float decay = expf(cum_last);
    for (int e = tid; e < PT * N; e += NT) {
      const int p = e / N, n = e % N;
      float upd = 0.f;
      for (int j = 0; j < len; ++j)
        upd = fmaf(x_s[j * PT + p], b_s[j * LN + n] * w_s[j], upd);
      st_s[p * LN + n] = fmaf(st_s[p * LN + n], decay, upd);
    }
  }
  __syncthreads();
  for (int e = tid; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    if (p0 + p < P)
      a.final_state[state_base + (size_t)(p0 + p) * N + n] = st_s[p * LN + n];
  }
}

template <typename T>
int run_ssd(const SsdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(a.N);
  auto kernel = ssd_kernel<T>;
  // shared memory above 48 KB must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.H, (a.P + PT - 1) / PT);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16.
extern "C" {

int rt_ssd_scan(int dtype, const void* x, const float* dt, const float* A,
                const void* bm, const void* cm, const float* init, void* y,
                float* final_state, int B, int S, int H, int P, int N,
                void* stream) {
  SsdArgs a = {};
  a.x = x; a.dt = dt; a.A = A; a.bm = bm; a.cm = cm; a.init = init;
  a.y = y; a.final_state = final_state;
  a.S = S; a.H = H; a.P = P; a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_ssd<__nv_bfloat16>(a, B, s)
                    : run_ssd<float>(a, B, s);
}

}  // extern "C"
