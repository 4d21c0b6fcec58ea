// Hand-written Hopper (sm_90a) Mamba2 SSD chunked scan.
//
//   ssd_chunk_tc_kernel + ssd_pass_kernel + ssd_out_tc_kernel (bf16),
//   ssd_kernel (f32, other widths)
//     <- _ssd_kernel / ssd_scan in src/repro/kernels/ssd.py
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
// (P, N) state in VMEM along its sequential chunk axis and does the three
// products as MXU matmuls.  Here the chunk axis is taken in parallel on the
// tensor-core route (bf16, P = 64, N = 128, the served model's heads): the
// states are linear in the chunks, so every chunk's local state (from a
// zero state) is computed at once, a short ordered pass over the chunks
// (state_c = exp(cum_last_c) state_{c-1} + local_c) gives the state
// entering each chunk, and every chunk's outputs follow at once (its note
// below).  C B^T, which one group shares across every head and P column,
// is computed once per (row, chunk).  f32 and other widths keep
// ssd_kernel, on the CUDA cores: one block per (b, h, a PT-column slice of
// P) walks the chunks in order with the state slice in shared memory, and
// recomputes the chunk's C B^T.  An f32 x, B and C would need hi / lo
// halves on every operand (three mmas a product); the served path is bf16.
//
// Numerics: every decay is the exponential of a difference that is <= 0
// (cum is non-increasing, since dt >= 0 and A < 0), never a product of
// exp(cum_i) and exp(-cum_j): inside a chunk cum reaches about -50 at
// the full-width dt (~0.8) and A = -1, and exp(+50) would lose the sum.
// A row with dt = 0 (the padded tail of a prompt) decays by exp(0) = 1
// and adds exactly 0, so it leaves the state exactly as it was: a chunk
// of such rows passes the state on unchanged, and a padded prompt's last
// real chunk sees the same inputs as the unpadded prompt's.  Any S: rows
// of the last chunk past S are loaded as zeros with dt = 0, and not
// stored.  No float atomics: equal inputs give equal bits, and row b of a
// batch equals that row alone.
//
// What bounds it on an H100: at the prefill shape (S = 512, H = 32,
// P = 64, N = 128, bf16) it moves ~5.5 MB and does ~1 GFLOP, so its bound
// is the bytes (~1.66 us at 3.35 TB/s).  The CUDA-core kernel did every
// product with f32 FMAs out of shared memory (two shared loads an FMA:
// ~20 us a chunk), one block walking all 8 chunks.  The tensor-core route
// puts the products on mma.sync and spreads (chunk, head) over 256 blocks
// a launch; what is left is three launches and the f32 chunk states
// (8 MB at S = 512) written, read and rewritten through L2 by the pass.
//
// The entry point returns the cudaError_t of its launches (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

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

// --------------------------------------------------------------------------
// The tensor-core route (bf16, P = 64, N = 128: mamba2_370m's heads), in
// three launches over a workspace of f32 chunk states, C B^T and cumsums:
//   1. ssd_chunk_tc_kernel, grid (B * chunks, H + 1): block (b, c, h < H)
//      takes the chunk's cumsum of dt A (a warp scan), stores it, and
//      computes the chunk's local state x^T (B o w), w_j = exp(cum_last -
//      cum_j) dt_j, from a zero state; block (b, c, H) computes the
//      chunk's C B^T, once for every head and P column;
//   2. ssd_pass_kernel: the ordered pass over the chunks, one thread for 4
//      elements of one (b, h) state: state_c = exp(cum_last_c) state_{c-1}
//      + local_c, each chunk's slot overwritten with the state entering it;
//   3. ssd_out_tc_kernel, grid (B * chunks, H): y = (G o decay) x +
//      (C state^T) o exp(cum_i) from the state entering the chunk.
// Every product runs on mma.sync m16n8k16 (bf16 in, f32 accumulators).
// An f32 operand (x o w, G o decay, the state) goes in as two bf16 halves,
// hi = bf16(v) and lo = bf16(v - hi), ~16 bits of it, each half with its
// own mma into the same accumulators; B, C and x are bf16 already, so
// their products are exact.  4 warps a block; tiles in shared memory as
// 16-byte-padded rows, read by ldmatrix (.trans where the tile is stored
// k-major).
// --------------------------------------------------------------------------

constexpr int TC_P = 64, TC_N = 128, TC_T = 128;
constexpr int XRB = TC_P * 2 + 16;     // bytes of a padded bf16 row of P
constexpr int NRB = TC_N * 2 + 16;     // ... of N
constexpr int GRB = CL * 2 + 16;       // ... of a chunk

struct SsdTcArgs {
  const __nv_bfloat16* x;    // (B, S, H, P)
  const float* dt;           // (B, S, H)
  const float* A;            // (H,)
  const __nv_bfloat16* bm;   // (B, S, N)
  const __nv_bfloat16* cm;   // (B, S, N)
  const float* init;         // (B, H, P, N) or null: zeros
  __nv_bfloat16* y;          // (B, S, H, P)
  float* final_state;        // (B, H, P, N)
  float* states;             // (B, chunks, H, P, N)
  float* cb;                 // (B, chunks, CL, CL)
  float* cum;                // (B, chunks, H, CL)
  int S, H, nc;
};

// the hi and lo bf16 halves of two floats, each packed as a pair
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ void bf16x8(const uint4 v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// rows [0, len) of a (rows, width) bf16 tile at `src` (row stride `ld`
// elements) into shared memory rows of `rb` bytes; rows past len zeroed
__device__ __forceinline__ void tile_async(uint32_t dst, const __nv_bfloat16* src,
                                           size_t ld, int width, int rb, int len) {
  const int ch = width / 8;
  for (int e = threadIdx.x; e < CL * ch; e += TC_T) {
    const int r = e / ch, cc = e % ch;
    const bool ok = r < len;
    cp_async16(dst + r * rb + cc * 16, ok ? src + r * ld + cc * 8 : src, ok);
  }
}

__global__ void __launch_bounds__(TC_T) ssd_chunk_tc_kernel(const SsdTcArgs a) {
  extern __shared__ __align__(128) unsigned char tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, l7 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.nc, c = blockIdx.x % a.nc, h = blockIdx.y;
  const int t0 = c * CL, len = min(CL, a.S - t0);
  const size_t bc = (size_t)b * a.nc + c;
  const uint32_t sa = smem_u32(tsm);
  const uint32_t b_s = sa;                       // [CL][NRB]  B
  tile_async(b_s, a.bm + ((size_t)b * a.S + t0) * TC_N, TC_N, TC_N, NRB, len);

  if (h == a.H) {
    // C B^T: warp w rows i [16w, 16w + 16), all 64 j, k over N
    const uint32_t c_s = sa + CL * NRB;          // [CL][NRB]  C
    tile_async(c_s, a.cm + ((size_t)b * a.S + t0) * TC_N, TC_N, TC_N, NRB, len);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < TC_N; k0 += 16) {
      uint32_t af[4];
      ldsm_x4(c_s + (warp * 16 + (mi & 1) * 8 + l7) * NRB + (k0 + (mi >> 1) * 8) * 2, af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(b_s + (np * 16 + (mi >> 1) * 8 + l7) * NRB + (k0 + (mi & 1) * 8) * 2, bf);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    float* cb = a.cb + bc * CL * CL;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(cb + (warp * 16 + g + 8 * hh) * CL + nt * 8 + 2 * t4) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    return;
  }

  cp_async_commit();
  const uint32_t xh_s = sa + CL * NRB, xl_s = xh_s + CL * XRB;   // [CL][XRB]
  float* dt_s = reinterpret_cast<float*>(tsm + CL * NRB + 2 * CL * XRB);
  float* cum_s = dt_s + CL;
  // the inclusive cumsum of dt A over the chunk: a warp scan over each
  // half, then the first half's total added to the second
  if (tid < CL) {
    const float dtv = tid < len ? a.dt[((size_t)b * a.S + t0 + tid) * a.H + h] : 0.f;
    float v = dtv * a.A[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    dt_s[tid] = dtv;
    cum_s[tid] = v;
  }
  __syncthreads();
  if (tid >= 32 && tid < CL) cum_s[tid] += cum_s[31];
  __syncthreads();
  if (tid < CL) a.cum[(bc * a.H + h) * CL + tid] = cum_s[tid];
  const float cum_last = cum_s[CL - 1];
  // x o w as hi and lo bf16 tiles [j][p]; rows past len are zero (dt = 0)
  for (int e = tid; e < CL * (TC_P / 8); e += TC_T) {
    const int j = e / (TC_P / 8), cc = e % (TC_P / 8);
    float f[8];
    if (j < len) {
      bf16x8(*reinterpret_cast<const uint4*>(
                 a.x + (((size_t)b * a.S + t0 + j) * a.H + h) * TC_P + cc * 8), f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    const float w = expf(cum_last - cum_s[j]) * dt_s[j];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair(f[2 * i] * w, f[2 * i + 1] * w, hi[i], lo[i]);
    *reinterpret_cast<uint4*>(tsm + CL * NRB + j * XRB + cc * 16) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tsm + CL * NRB + CL * XRB + j * XRB + cc * 16) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  cp_async_wait<0>();
  __syncthreads();
  // local[p][n] = sum_j (x o w)[j][p] B[j][n]: warp w rows p [16w, 16w + 16)
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < CL; k0 += 16) {
    uint32_t ah[4], al[4];
    const uint32_t ao = (k0 + (mi >> 1) * 8 + l7) * XRB + (warp * 16 + (mi & 1) * 8) * 2;
    ldsm_x4_trans(xh_s + ao, ah);
    ldsm_x4_trans(xl_s + ao, al);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(b_s + (k0 + (mi & 1) * 8 + l7) * NRB + (np * 16 + (mi >> 1) * 8) * 2, bf);
      mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
      mma_bf16(acc[2 * np], al, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
      mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
    }
  }
  float* st = a.states + (bc * a.H + h) * TC_P * TC_N;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(st + (warp * 16 + g + 8 * hh) * TC_N + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
}

constexpr int PASS_T = 256;

__global__ void __launch_bounds__(PASS_T) ssd_pass_kernel(const SsdTcArgs a, int B) {
  constexpr int PN4 = TC_P * TC_N / 4;
  const size_t e = (size_t)blockIdx.x * PASS_T + threadIdx.x;
  if (e >= (size_t)B * a.H * PN4) return;
  const int q = e % PN4, h = (e / PN4) % a.H, b = e / PN4 / a.H;
  float4 s = a.init ? reinterpret_cast<const float4*>(a.init)[e]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < a.nc; ++c) {
    const size_t bch = ((size_t)b * a.nc + c) * a.H + h;
    const float decay = expf(a.cum[bch * CL + CL - 1]);
    float4* slot = reinterpret_cast<float4*>(a.states + bch * TC_P * TC_N) + q;
    const float4 loc = *slot;
    *slot = s;
    s = make_float4(fmaf(s.x, decay, loc.x), fmaf(s.y, decay, loc.y),
                    fmaf(s.z, decay, loc.z), fmaf(s.w, decay, loc.w));
  }
  reinterpret_cast<float4*>(a.final_state)[e] = s;
}

// shared memory of ssd_out_tc_kernel, bytes
constexpr int OUT_C = 0, OUT_X = OUT_C + CL * NRB, OUT_GH = OUT_X + CL * XRB,
              OUT_GL = OUT_GH + CL * GRB, OUT_SH = OUT_GL + CL * GRB,
              OUT_SL = OUT_SH + TC_P * NRB, OUT_F = OUT_SL + TC_P * NRB,
              OUT_SMEM = OUT_F + 3 * CL * 4;

__global__ void __launch_bounds__(TC_T) ssd_out_tc_kernel(const SsdTcArgs a) {
  extern __shared__ __align__(128) unsigned char tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, l7 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.nc, c = blockIdx.x % a.nc, h = blockIdx.y;
  const int t0 = c * CL, len = min(CL, a.S - t0);
  const size_t bc = (size_t)b * a.nc + c, bch = bc * a.H + h;
  const uint32_t sa = smem_u32(tsm);
  tile_async(sa + OUT_C, a.cm + ((size_t)b * a.S + t0) * TC_N, TC_N, TC_N, NRB, len);
  tile_async(sa + OUT_X, a.x + ((size_t)b * a.S + t0) * a.H * TC_P + h * TC_P,
             (size_t)a.H * TC_P, TC_P, XRB, len);
  cp_async_commit();
  float* cum_s = reinterpret_cast<float*>(tsm + OUT_F);
  float* dt_s = cum_s + CL;
  float* e_s = dt_s + CL;
  if (tid < CL) {
    const float cv = a.cum[bch * CL + tid];
    cum_s[tid] = cv;
    dt_s[tid] = tid < len ? a.dt[((size_t)b * a.S + t0 + tid) * a.H + h] : 0.f;
    e_s[tid] = expf(cv);
  }
  // the state entering the chunk, [p][n], as hi and lo bf16 halves
  const float4* s_in = reinterpret_cast<const float4*>(a.states + bch * TC_P * TC_N);
  for (int e = tid; e < TC_P * TC_N / 4; e += TC_T) {
    const int p = e / (TC_N / 4), n4 = e % (TC_N / 4);
    const float4 v = s_in[e];
    uint32_t hi[2], lo[2];
    split_pair(v.x, v.y, hi[0], lo[0]);
    split_pair(v.z, v.w, hi[1], lo[1]);
    *reinterpret_cast<uint2*>(tsm + OUT_SH + p * NRB + n4 * 8) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(tsm + OUT_SL + p * NRB + n4 * 8) = make_uint2(lo[0], lo[1]);
  }
  __syncthreads();                         // cum, dt
  // G[i][j] = (C B^T)[i][j] exp(cum_i - cum_j) dt_j for j <= i, else 0
  const float4* cb = reinterpret_cast<const float4*>(a.cb + bc * CL * CL);
  for (int e = tid; e < CL * CL / 4; e += TC_T) {
    const int i = e / (CL / 4), j0 = (e % (CL / 4)) * 4;
    const float4 v = cb[e];
    const float cv[4] = {v.x, v.y, v.z, v.w};
    float gv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      gv[k] = j <= i ? cv[k] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
    }
    uint32_t hi[2], lo[2];
    split_pair(gv[0], gv[1], hi[0], lo[0]);
    split_pair(gv[2], gv[3], hi[1], lo[1]);
    *reinterpret_cast<uint2*>(tsm + OUT_GH + i * GRB + j0 * 2) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(tsm + OUT_GL + i * GRB + j0 * 2) = make_uint2(lo[0], lo[1]);
  }
  cp_async_wait<0>();
  __syncthreads();
  // warp w: rows i [16w, 16w + 16), all 64 p (8 n-tiles)
  float gx[8][4], cs[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { gx[nt][e] = 0.f; cs[nt][e] = 0.f; }
  // (G o decay) x: the j blocks up to the diagonal
  for (int k0 = 0; k0 <= warp * 16; k0 += 16) {
    uint32_t ah[4], al[4];
    const uint32_t ao = (warp * 16 + (mi & 1) * 8 + l7) * GRB + (k0 + (mi >> 1) * 8) * 2;
    ldsm_x4(sa + OUT_GH + ao, ah);
    ldsm_x4(sa + OUT_GL + ao, al);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(sa + OUT_X + (k0 + (mi & 1) * 8 + l7) * XRB + (np * 16 + (mi >> 1) * 8) * 2, bf);
      mma_bf16(gx[2 * np], ah, bf[0], bf[1]);
      mma_bf16(gx[2 * np], al, bf[0], bf[1]);
      mma_bf16(gx[2 * np + 1], ah, bf[2], bf[3]);
      mma_bf16(gx[2 * np + 1], al, bf[2], bf[3]);
    }
  }
  // C state^T over N
#pragma unroll 2
  for (int k0 = 0; k0 < TC_N; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(sa + OUT_C + (warp * 16 + (mi & 1) * 8 + l7) * NRB + (k0 + (mi >> 1) * 8) * 2, af);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const uint32_t bo = (np * 16 + (mi >> 1) * 8 + l7) * NRB + (k0 + (mi & 1) * 8) * 2;
      uint32_t bh[4], bl[4];
      ldsm_x4(sa + OUT_SH + bo, bh);
      ldsm_x4(sa + OUT_SL + bo, bl);
      mma_bf16(cs[2 * np], af, bh[0], bh[1]);
      mma_bf16(cs[2 * np], af, bl[0], bl[1]);
      mma_bf16(cs[2 * np + 1], af, bh[2], bh[3]);
      mma_bf16(cs[2 * np + 1], af, bl[2], bl[3]);
    }
  }
  // y = (C state^T) exp(cum_i) + (G o decay) x
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = warp * 16 + g + 8 * hh;
    if (i >= len) continue;
    const float ei = e_s[i];
    __nv_bfloat16* yr = a.y + (((size_t)b * a.S + t0 + i) * a.H + h) * TC_P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(yr + nt * 8 + 2 * t4) = __floats2bfloat162_rn(
          fmaf(cs[nt][2 * hh], ei, gx[nt][2 * hh]),
          fmaf(cs[nt][2 * hh + 1], ei, gx[nt][2 * hh + 1]));
  }
}

constexpr int CHUNK_SMEM = CL * NRB + 2 * CL * XRB + 2 * CL * 4;   // >= 2 CL NRB

int run_ssd_tc(const SsdTcArgs& a, int B, cudaStream_t stream) {
  static bool opted = false;               // shared memory above 48 KB
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_out_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, OUT_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  ssd_chunk_tc_kernel<<<dim3(B * a.nc, a.H + 1), TC_T, CHUNK_SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n4 = (size_t)B * a.H * TC_P * TC_N / 4;
  ssd_pass_kernel<<<(unsigned)((n4 + PASS_T - 1) / PASS_T), PASS_T, 0, stream>>>(a, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_out_tc_kernel<<<dim3(B * a.nc, a.H), TC_T, OUT_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16.
// route 1 (the tensor cores) takes bf16 with P = 64 and N = 128, 16-byte
// aligned x, B, C and init, and a workspace `ws` of B * chunks * (H P N +
// CL CL + H CL) floats (ssd.ssd_workspace); route 0 (the CUDA cores) takes
// the rest and no workspace.
extern "C" {

int rt_ssd_scan(int dtype, const void* x, const float* dt, const float* A,
                const void* bm, const void* cm, const float* init, void* y,
                float* final_state, float* ws, int B, int S, int H, int P,
                int N, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || P != TC_P || N != TC_N || ws == nullptr)
      return (int)cudaErrorInvalidValue;
    SsdTcArgs a = {};
    a.x = static_cast<const __nv_bfloat16*>(x); a.dt = dt; a.A = A;
    a.bm = static_cast<const __nv_bfloat16*>(bm);
    a.cm = static_cast<const __nv_bfloat16*>(cm);
    a.init = init; a.y = static_cast<__nv_bfloat16*>(y);
    a.final_state = final_state;
    a.S = S; a.H = H; a.nc = (S + CL - 1) / CL;
    const size_t chunks = (size_t)B * a.nc;
    a.states = ws;
    a.cb = ws + chunks * H * TC_P * TC_N;
    a.cum = a.cb + chunks * CL * CL;
    return run_ssd_tc(a, B, s);
  }
  SsdArgs a = {};
  a.x = x; a.dt = dt; a.A = A; a.bm = bm; a.cm = cm; a.init = init;
  a.y = y; a.final_state = final_state;
  a.S = S; a.H = H; a.P = P; a.N = N;
  return dtype == 1 ? run_ssd<__nv_bfloat16>(a, B, s)
                    : run_ssd<float>(a, B, s);
}

}  // extern "C"
