// Hand-written Hopper (sm_90a) dequant-fused matmul of quantized serving.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quant.py:
//   _q8_matmul_kernel  (quant_matmul, q8_0)
//   _q4k_matmul_kernel (quant_matmul, q4_k)
// out[i, c] = sum_k x[i, k] * w[k, c], f32 arithmetic, written in x's type
// (bf16 or f32), where the weight is stored as 32-row blocks of the input
// axis:
//   q8_0: quants (nB, 32, n) int8,  w = q * scale[kb, c]
//   q4_k: quants (nB, 16, n) uint8, byte j of a block holds row 2j in its
//         low nibble and row 2j+1 in its high one; w = q * scale + min.
// Each weight is dequantized exactly as the plain version does it: a
// product and, for q4_k, a sum, each rounded on its own (__fmul_rn,
// __fadd_rn: never contracted into an FMA), so the kernel and
// ref.quant_matmul_reference differ only in the order of the f32 sum.
//
// Translation from the TPU: the Pallas grid (m/bm, n/bn, nB) walks the
// blocks of d in order on one core, accumulating in VMEM scratch.  Here the
// blocks of d are split across thread blocks ("splits", chosen in
// quant.quant_plan from the shape alone); each split writes its f32 partial
// sums to a workspace and a second pass (splitk_reduce) adds them in split
// order.  No float atomics: the sum's order is fixed, so equal inputs give
// equal bits on every run, which keeps the port's bitwise invariants
// (streamed == per-token, paged == dense) under quantization.
//
// What bounds it on an H100:
//   decode (m = 4): a GEMV.  Every packed weight byte is read once and used
//   for 4 rows: 8 flops per q8_0 byte, far below the 295 flop/byte ridge,
//   so it is bound by HBM bytes (3.35 TB/s); w_gate in q8_0 (37.7 MB of
//   quants + 4.7 MB of scales) has a 12.7 us bound.  The skinny kernel
//   reads the quants with 16-byte loads, neighbouring threads on
//   neighbouring columns, and converts bytes to floats with the 2^23 trick
//   (a logic op and a subtraction) instead of the quarter-rate I2F.
//   wk / wv (n = 256) give only 2 column tiles, so the split over d is what
//   fills the card.
//   prefill (m <= 512): bound by operations (2 m d n flops; 989 TFLOP/s
//   bf16 on the tensor cores).  The tiled kernel does its products on the
//   CUDA cores in f32 (67 TFLOP/s peak), a 64 x 128 tile per block with
//   one dequantized 32 x 128 weight tile in shared memory at a time.
//   mma.sync / wgmma, TMA and double buffering are later work.
//
// The ragged edges of m, n and d are masked in the kernels: rows of x past
// m and lanes past d load as zero (so a padded q4_k lane, which
// dequantizes to its min, adds nothing); columns past n are neither loaded
// nor stored.  16-byte loads are used only when n % 16 == 0 and the weight
// leaves are 16-byte aligned (VEC); otherwise bytes are loaded one by one.
// VEC changes the loads only, never the arithmetic.
//
// The entry point returns the cudaError_t of its launches (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;          // rows of d per quant block
constexpr int NT = 256;         // threads per block
constexpr int FMT_Q8 = 0, FMT_Q4 = 1;

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

// exact byte -> float: 2^23 + b is a float whose low mantissa bits are b
__device__ __forceinline__ float u4f(uint32_t nib) {
  return __int_as_float(0x4B000000u | nib) - 8388608.f;
}
__device__ __forceinline__ float i8f(uint32_t byte) {   // byte of an int8
  return __int_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.f;
}

struct QArgs {
  const void* x;           // (m, d) in T
  const uint8_t* q;        // (nB, 32, n) int8 or (nB, 16, n) uint8
  const float* scales;     // (nB, n)
  const float* mins;       // (nB, n), q4_k only
  void* out;               // (m, n) in T, when splits == 1
  float* ws;               // (splits, m, n) f32 partials, when splits > 1
  int m, d, n, nB;
  int per_split;           // quant blocks per split
};

// One 16-byte row piece of the quants, as 16 bytes in 4 words.
template <bool VEC>
__device__ __forceinline__ void load16(const uint8_t* p, int valid, uint32_t w[4]) {
  if (VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0u;
    for (int c = 0; c < valid && c < 16; ++c) w[c / 4] |= (uint32_t)p[c] << (8 * (c % 4));
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t w[4], int c) {
  return (w[c / 4] >> (8 * (c % 4))) & 0xFFu;
}

// 16 consecutive f32 of a (nB, n) row, zero past n.
template <bool VEC>
__device__ __forceinline__ void load16f(const float* p, int valid, float out[16]) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) out[c] = c < valid ? p[c] : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_out(const QArgs& a, int split, int row, int col, float v) {
  if (a.ws) a.ws[((size_t)split * a.m + row) * a.n + col] = v;
  else static_cast<T*>(a.out)[(size_t)row * a.n + col] = from_f<T>(v);
}

// --------------------------------------------------------------------------
// Skinny (m <= 16, decode): grid (n / 128, splits, m / 4).  Thread (kl, cg)
// of a block owns 16 columns (cg of 8) and, in each pass, one quant block
// (kl of 32) of the split: it walks the block's 32 rows with one 16-byte
// load each and keeps 4 x 16 f32 sums.  The 32 k-lanes are then added in
// a fixed tree: shuffles inside a warp, then the 8 warps in order.
// --------------------------------------------------------------------------

constexpr int SK_R = 4;                 // rows of x per block
constexpr int SK_CG = 8;                // column groups of 16: 128 columns
constexpr int SK_KL = NT / SK_CG;       // 32 k-lanes
constexpr int SK_XLD = QB + 1;          // padded row of x in shared memory

template <typename T, int FMT, bool VEC>
__global__ void __launch_bounds__(NT) skinny_kernel(QArgs a) {
  __shared__ float x_s[SK_R][SK_KL * SK_XLD];
  __shared__ float red[NT / 32][SK_R][SK_CG * 16];
  const int tid = threadIdx.x, cg = tid % SK_CG, kl = tid / SK_CG;
  const int lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.x * (SK_CG * 16) + cg * 16;
  const int row0 = blockIdx.z * SK_R;
  const int kb0 = blockIdx.y * a.per_split;
  const int kb1 = min(a.nB, kb0 + a.per_split);
  const int valid = a.n - col0;           // columns of this thread in range
  const T* x = static_cast<const T*>(a.x);

  float acc[SK_R][16];
#pragma unroll
  for (int i = 0; i < SK_R; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;

  for (int cb = kb0; cb < kb1; cb += SK_KL) {
    const int nkb = min(SK_KL, kb1 - cb);
    __syncthreads();
    for (int e = tid; e < SK_R * nkb * QB; e += NT) {
      const int i = e / (nkb * QB), kk = e % (nkb * QB);
      const int row = row0 + i, k = cb * QB + kk;
      float v = 0.f;
      if (row < a.m && k < a.d) v = to_f(x[(size_t)row * a.d + k]);
      x_s[i][(kk / QB) * SK_XLD + kk % QB] = v;
    }
    __syncthreads();
    if (kl >= nkb || valid <= 0) continue;
    const int kb = cb + kl;
    const float* xs = &x_s[0][kl * SK_XLD];
    float s[16], mn[16];
    load16f<VEC>(a.scales + (size_t)kb * a.n + col0, valid, s);
    if (FMT == FMT_Q4) load16f<VEC>(a.mins + (size_t)kb * a.n + col0, valid, mn);
    if (FMT == FMT_Q8) {
      const uint8_t* qp = a.q + (size_t)kb * QB * a.n + col0;
#pragma unroll 4
      for (int r = 0; r < QB; ++r) {
        uint32_t w4[4];
        load16<VEC>(qp + (size_t)r * a.n, valid, w4);
        float xv[SK_R];
#pragma unroll
        for (int i = 0; i < SK_R; ++i) xv[i] = xs[i * SK_KL * SK_XLD + r];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float w = __fmul_rn(i8f(byte_of(w4, c)), s[c]);
#pragma unroll
          for (int i = 0; i < SK_R; ++i) acc[i][c] = fmaf(xv[i], w, acc[i][c]);
        }
      }
    } else {
      const uint8_t* qp = a.q + (size_t)kb * (QB / 2) * a.n + col0;
#pragma unroll 2
      for (int j = 0; j < QB / 2; ++j) {
        uint32_t w4[4];
        load16<VEC>(qp + (size_t)j * a.n, valid, w4);
        float x0[SK_R], x1[SK_R];
#pragma unroll
        for (int i = 0; i < SK_R; ++i) {
          x0[i] = xs[i * SK_KL * SK_XLD + 2 * j];
          x1[i] = xs[i * SK_KL * SK_XLD + 2 * j + 1];
        }
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const uint32_t b = byte_of(w4, c);
          const float w0 = __fadd_rn(__fmul_rn(u4f(b & 0xFu), s[c]), mn[c]);
          const float w1 = __fadd_rn(__fmul_rn(u4f(b >> 4), s[c]), mn[c]);
#pragma unroll
          for (int i = 0; i < SK_R; ++i) {
            acc[i][c] = fmaf(x0[i], w0, acc[i][c]);
            acc[i][c] = fmaf(x1[i], w1, acc[i][c]);
          }
        }
      }
    }
  }

  // the 4 k-lanes of a warp (lanes cg, cg+8, cg+16, cg+24) ...
#pragma unroll
  for (int i = 0; i < SK_R; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[i][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][c] = v;
    }
  if (lane < SK_CG) {
#pragma unroll
    for (int i = 0; i < SK_R; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][i][cg * 16 + c] = acc[i][c];
  }
  __syncthreads();
  // ... then the 8 warps, in order
  for (int e = tid; e < SK_R * SK_CG * 16; e += NT) {
    const int i = e / (SK_CG * 16), c = e % (SK_CG * 16);
    const int row = row0 + i, col = blockIdx.x * (SK_CG * 16) + c;
    if (row >= a.m || col >= a.n) continue;
    float v = 0.f;
    for (int w = 0; w < NT / 32; ++w) v += red[w][i][c];
    store_out<T>(a, blockIdx.y, row, col, v);
  }
}

// --------------------------------------------------------------------------
// Tiled (m > 16, prefill): grid (n / 128, splits, m / 64).  Per quant block
// of the split: the 64 x 32 tile of x (transposed) and the dequantized
// 32 x 128 weight tile go to shared memory, then each thread adds a 4 x 8
// piece of the output tile over the block's 32 rows, in order.
// --------------------------------------------------------------------------

constexpr int TB_M = 64, TB_N = 128, TM = 4, TN = 8;
constexpr int TB_XLD = TB_M + 4;        // keeps float4 reads of x aligned

template <typename T, int FMT, bool VEC>
__global__ void __launch_bounds__(NT) tiled_kernel(QArgs a) {
  __shared__ __align__(16) float x_s[QB][TB_XLD];
  __shared__ __align__(16) float w_s[QB][TB_N];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.z * TB_M, n0 = blockIdx.x * TB_N;
  const int kb0 = blockIdx.y * a.per_split;
  const int kb1 = min(a.nB, kb0 + a.per_split);
  const T* x = static_cast<const T*>(a.x);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    __syncthreads();
    for (int e = tid; e < TB_M * QB; e += NT) {
      const int i = e / QB, kk = e % QB;
      const int row = m0 + i, k = kb * QB + kk;
      float v = 0.f;
      if (row < a.m && k < a.d) v = to_f(x[(size_t)row * a.d + k]);
      x_s[kk][i] = v;
    }
    if (FMT == FMT_Q8) {
      // thread -> one row of the block, 16 columns: one 16-byte load
      const int r = tid / 8, c0 = (tid % 8) * 16, col = n0 + c0;
      const int valid = a.n - col;
      float w[16];
      if (valid > 0) {
        uint32_t w4[4];
        float s[16];
        load16<VEC>(a.q + ((size_t)kb * QB + r) * a.n + col, valid, w4);
        load16f<VEC>(a.scales + (size_t)kb * a.n + col, valid, s);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          w[c] = c < valid ? __fmul_rn(i8f(byte_of(w4, c)), s[c]) : 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) w[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        *reinterpret_cast<float4*>(&w_s[r][c0 + c]) =
            make_float4(w[c], w[c + 1], w[c + 2], w[c + 3]);
    } else {
      // thread -> one byte row (rows 2j, 2j+1), 8 columns
      const int j = tid / 16, c0 = (tid % 16) * 8, col = n0 + c0;
      const int valid = a.n - col;
      float lo[8], hi[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) { lo[c] = 0.f; hi[c] = 0.f; }
      if (valid > 0) {
        const uint8_t* qp = a.q + ((size_t)kb * (QB / 2) + j) * a.n + col;
        const float* sp = a.scales + (size_t)kb * a.n + col;
        const float* mp = a.mins + (size_t)kb * a.n + col;
        uint32_t b2[2] = {0u, 0u};
        if (VEC) {
          const uint2 v = *reinterpret_cast<const uint2*>(qp);
          b2[0] = v.x; b2[1] = v.y;
        } else {
          for (int c = 0; c < valid && c < 8; ++c) b2[c / 4] |= (uint32_t)qp[c] << (8 * (c % 4));
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c < valid) {
            const uint32_t b = (b2[c / 4] >> (8 * (c % 4))) & 0xFFu;
            const float s = sp[c], mn = mp[c];
            lo[c] = __fadd_rn(__fmul_rn(u4f(b & 0xFu), s), mn);
            hi[c] = __fadd_rn(__fmul_rn(u4f(b >> 4), s), mn);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 8; c += 4) {
        *reinterpret_cast<float4*>(&w_s[2 * j][c0 + c]) =
            make_float4(lo[c], lo[c + 1], lo[c + 2], lo[c + 3]);
        *reinterpret_cast<float4*>(&w_s[2 * j + 1][c0 + c]) =
            make_float4(hi[c], hi[c + 1], hi[c + 2], hi[c + 3]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < QB; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&x_s[k][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&w_s[k][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&w_s[k][tx * TN + 4]);
      const float xa[TM] = {av.x, av.y, av.z, av.w};
      const float wb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < a.n) store_out<T>(a, blockIdx.y, row, col, acc[i][j]);
    }
  }
}

// The splits' partials, added in split order.
template <typename T>
__global__ void __launch_bounds__(NT) splitk_reduce(const float* ws, void* out,
                                                   int splits, int mn) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += ws[(size_t)s * mn + e];
  static_cast<T*>(out)[e] = from_f<T>(v);
}

template <typename T, int FMT, bool VEC>
int launch(const QArgs& a, int splits, int skinny, cudaStream_t stream) {
  const int col_tiles = (a.n + TB_N - 1) / TB_N;
  if (skinny) {
    dim3 grid(col_tiles, splits, (a.m + SK_R - 1) / SK_R);
    skinny_kernel<T, FMT, VEC><<<grid, NT, 0, stream>>>(a);
  } else {
    dim3 grid(col_tiles, splits, (a.m + TB_M - 1) / TB_M);
    tiled_kernel<T, FMT, VEC><<<grid, NT, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int mn = a.m * a.n;
  splitk_reduce<T><<<(mn + NT - 1) / NT, NT, 0, stream>>>(a.ws, a.out, splits, mn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const QArgs& a, int fmt, int splits, int skinny, int vec,
             cudaStream_t s) {
  if (fmt == FMT_Q8)
    return vec ? launch<T, FMT_Q8, true>(a, splits, skinny, s)
               : launch<T, FMT_Q8, false>(a, splits, skinny, s);
  return vec ? launch<T, FMT_Q4, true>(a, splits, skinny, s)
             : launch<T, FMT_Q4, false>(a, splits, skinny, s);
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16;
// fmt: 0 = q8_0, 1 = q4_k.  ws is null when splits == 1.
extern "C" int rt_quant_matmul(int dtype, int fmt, const void* x,
                               const void* quants, const float* scales,
                               const float* mins, void* out, float* ws,
                               int m, int d, int n, int nB, int splits,
                               int per_split, int skinny, int vec,
                               void* stream) {
  QArgs a = {};
  a.x = x; a.q = static_cast<const uint8_t*>(quants); a.scales = scales;
  a.mins = mins; a.out = out; a.ws = splits > 1 ? ws : nullptr;
  a.m = m; a.d = d; a.n = n; a.nB = nB; a.per_split = per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, fmt, splits, skinny, vec, s)
                    : dispatch<float>(a, fmt, splits, skinny, vec, s);
}
