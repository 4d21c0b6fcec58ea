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
// The CUDA-core kernels (skinny, tiled) dequantize each weight exactly as
// the plain version does it: a product and, for q4_k, a sum, each rounded
// on its own (__fmul_rn, __fadd_rn: never contracted into an FMA), so they
// and ref.quant_matmul_reference differ only in the order of the f32 sum.
// The tensor-core kernel (quant_tc_kernel) regroups the sum per quant block
// instead: sum_kb s[kb, c] (x q)_kb [+ min[kb, c] sum_k x], with exact bf16
// products and every scale applied in f32; against the plain version it
// differs by f32 roundings of the same size (see its note).
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
//   bf16 on the tensor cores).  bf16 x takes quant_tc_kernel: mma.sync on
//   the tensor cores, 128 x 128 output tiles, cp.async into a 3-stage
//   ring (its note below).  f32 x takes the tiled kernel, whose products run on
//   the CUDA cores in f32 (67 TFLOP/s peak), a 64 x 128 tile per block
//   with one dequantized 32 x 128 weight tile in shared memory at a time.
//   wgmma and TMA are later work.
//
// The ragged edges of m, n and d are masked in the kernels: rows of x past
// m and lanes past d load as zero (so a padded q4_k lane, which
// dequantizes to its min, adds nothing); columns past n are neither loaded
// nor stored.  16-byte loads are used only when n % 16 == 0 and the weight
// leaves are 16-byte aligned (VEC); otherwise bytes are loaded one by one.
// VEC changes the loads only, never the arithmetic.  The route (skinny,
// tiled, tensor cores) and the splits come from quant.quant_route and
// quant.quant_plan, from the shape, dtype and alignment alone.
//
// The entry point returns the cudaError_t of its launches (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma.cuh"

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

// --------------------------------------------------------------------------
// Tensor-core prefill (bf16 x, m > 16): quant_tc_kernel<FMT>.  It takes
// d % 8 == 0, n % 16 == 0 and 16-byte-aligned x and weight leaves
// (quant.quant_route sends the rest to tiled_kernel).  Grid (m / 128,
// splits, n / 128): the m tiles of one column tile are neighbours, so the
// blocks in flight share each weight tile through L2 and it leaves HBM
// once.  8 warps, 2 along m by 4 along n, each owning a 64 x 32 piece of
// the 128 x 128 output tile.  For each quant block kb of the split:
//   * cp.async brings the 128 x 32 bf16 tile of x (rows padded to 80
//     bytes), the block's quant rows and its scale (and min) row into a
//     ring of TCQ_STAGES stages; rows past m, lanes past d and columns past
//     n are zero-filled;
//   * the quants are widened to bf16 in shared memory (exact: |q| <= 127
//     for q8_0, 0..15 for q4_k, whose byte j holds rows 2j and 2j + 1),
//     into one of two tiles, and for q4_k each row of x is summed over the
//     block in f32;
//   * part = x q over the block's 32 rows is two mma.sync m16n8k16 k steps
//     (bf16 in, f32 accumulators into a zeroed part), A by ldmatrix from
//     the x tile, B by ldmatrix.trans from the widened quants;
//   * in registers, acc += scale[kb, c] part (+ min[kb, c] xsum[i, kb]).
// Block kb + TCQ_STAGES - 1's copy, block kb + 1's widening and block
// kb's products share one interval between two barriers, and each m-tile
// is folded as soon as its mmas are done, which keeps a thread within 128
// registers: two blocks share an SM, so one block's copies, widening and
// fold run beside the other's mmas.  That is the Pallas kernel's x @ (q *
// s [+ min]) regrouped per block: the products x q are exact, every scale
// is applied in f32, and no dequantized weight is rounded to bf16.
// What bounds it: the main path's prefill shapes are bound by operations
// (2 m d n flops at 989 TFLOP/s); this kernel runs well below that.  Its
// copies alone take about a third of its time (x is read again from L2
// for each 128-column tile), the mmas (mma.sync, not wgmma) a third, and
// the fold, which waits on each tile's mmas, most of the rest (PERF.md).
// --------------------------------------------------------------------------

// The parts of quant_tc_kernel that run: 3, the whole kernel.  Fewer only
// in the timing builds of kernels/quant_tc_parts.py, whose results are
// wrong: 0, the copies alone; 1, and the mmas (summed without the scales);
// 2, and the widening.
#ifndef QUANT_TC_PARTS
#define QUANT_TC_PARTS 3
#endif

constexpr int TCQ_M = 128, TCQ_N = 128, TCQ_STAGES = 4;
constexpr int TCQ_WN = TCQ_N / 32;        // warps along n, 2 along m
constexpr int TCQ_T = 64 * TCQ_WN;        // threads
constexpr int TCQ_MINB = 512 / TCQ_T;     // blocks per SM at <= 128 registers
constexpr int TCQ_QCH = TCQ_N / 16;       // 16-byte pieces of a quant row
constexpr int TCQ_SCH = TCQ_N / 4;        // 16-byte pieces of a scale row
constexpr int TCQ_XT = TCQ_T / TCQ_M;     // threads summing one x row
constexpr int TCQ_XRB = QB * 2 + 16;      // padded bf16 row of the x tile
constexpr int TCQ_WRB = TCQ_N * 2 + 16;   // padded bf16 row of the quants

template <int FMT>
struct TcqLayout {                        // bytes of shared memory
  static constexpr int QROWS = FMT == FMT_Q8 ? QB : QB / 2;
  static constexpr int X_B = TCQ_M * TCQ_XRB;
  static constexpr int Q_B = QROWS * TCQ_N;
  static constexpr int S_B = TCQ_N * 4;   // one f32 row: scales, then mins
  static constexpr int STAGE = X_B + Q_B + S_B * (FMT == FMT_Q4 ? 2 : 1);
  static constexpr int W_B = QB * TCQ_WRB;             // one widened tile
  static constexpr int W_OFF = TCQ_STAGES * STAGE;     // 2 widened tiles
  static constexpr int XS_OFF = W_OFF + 2 * W_B;       // 2 q4_k row sums
  static constexpr int SMEM = XS_OFF + (FMT == FMT_Q4 ? 2 * TCQ_M * 4 : 0);
};

template <int FMT>
__global__ void __launch_bounds__(TCQ_T, TCQ_MINB) quant_tc_kernel(QArgs a) {
  using L = TcqLayout<FMT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sa = smem_u32(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / TCQ_WN, wn = warp % TCQ_WN;
  const int m0 = blockIdx.x * TCQ_M, n0 = blockIdx.z * TCQ_N;
  const int kb0 = blockIdx.y * a.per_split;
  const int nkb = min(a.nB, kb0 + a.per_split) - kb0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  // quant block kb0 + t into stage t % TCQ_STAGES
  auto load = [&](int t) {
    const int kb = kb0 + t;
    const uint32_t st = sa + (t % TCQ_STAGES) * L::STAGE;
    for (int c = tid; c < TCQ_M * 4; c += TCQ_T) {      // x: 4 chunks a row
      const int r = c >> 2, cc = c & 3;
      const int row = m0 + r, k = kb * QB + cc * 8;
      const bool ok = row < a.m && k < a.d;
      cp_async16(st + r * TCQ_XRB + cc * 16,
                 ok ? x + (size_t)row * a.d + k : x, ok);
    }
    for (int c = tid; c < L::QROWS * TCQ_QCH; c += TCQ_T) {   // quants
      const int r = c / TCQ_QCH, cc = c % TCQ_QCH, col = n0 + cc * 16;
      const bool ok = col < a.n;
      cp_async16(st + L::X_B + r * TCQ_N + cc * 16,
                 ok ? a.q + ((size_t)kb * L::QROWS + r) * a.n + col : a.q, ok);
    }
    if (tid < TCQ_SCH * (FMT == FMT_Q4 ? 2 : 1)) {      // scales, mins
      const int which = tid / TCQ_SCH, cc = tid % TCQ_SCH, col = n0 + cc * 4;
      const bool ok = col < a.n;
      const float* src = which ? a.mins : a.scales;
      cp_async16(st + L::X_B + L::Q_B + which * L::S_B + cc * 16,
                 ok ? src + (size_t)kb * a.n + col : src, ok);
    }
  };
  // stage t's quants widened to bf16 into tile t & 1 (and, for q4_k, the
  // f32 row sums of its x tile into row-sum buffer t & 1)
  float* xsum = reinterpret_cast<float*>(smem_raw + L::XS_OFF);
  auto widen = [&](int t) {
    const int st = (t % TCQ_STAGES) * L::STAGE;
    const unsigned char* qs = smem_raw + st + L::X_B;
    unsigned char* w = smem_raw + L::W_OFF + (t & 1) * L::W_B;
    if (FMT == FMT_Q8) {
      // one 16-byte piece of a quant row -> 16 bf16
      const int r = tid / TCQ_QCH, cc = tid % TCQ_QCH;
      const uint4 v = *reinterpret_cast<const uint4*>(qs + r * TCQ_N + cc * 16);
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = pack_bf16(i8f(wd[i] & 0xFFu), i8f((wd[i] >> 8) & 0xFFu));
        o[2 * i + 1] = pack_bf16(i8f((wd[i] >> 16) & 0xFFu), i8f(wd[i] >> 24));
      }
      uint4* dst = reinterpret_cast<uint4*>(w + r * TCQ_WRB + cc * 32);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      return;
    }
    if (tid < TCQ_N) {
      // byte row j -> rows 2j (low nibbles) and 2j + 1 (high nibbles)
      const int j = tid / TCQ_QCH, cc = tid % TCQ_QCH;
      const uint4 v = *reinterpret_cast<const uint4*>(qs + j * TCQ_N + cc * 16);
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = wd[i];
        lo[2 * i] = pack_bf16(u4f(b & 0xFu), u4f((b >> 8) & 0xFu));
        lo[2 * i + 1] = pack_bf16(u4f((b >> 16) & 0xFu), u4f((b >> 24) & 0xFu));
        hi[2 * i] = pack_bf16(u4f((b >> 4) & 0xFu), u4f((b >> 12) & 0xFu));
        hi[2 * i + 1] = pack_bf16(u4f((b >> 20) & 0xFu), u4f(b >> 28));
      }
      uint4* d0 = reinterpret_cast<uint4*>(w + 2 * j * TCQ_WRB + cc * 32);
      uint4* d1 = reinterpret_cast<uint4*>(w + (2 * j + 1) * TCQ_WRB + cc * 32);
      d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    // the f32 sum of x's row over the block: TCQ_XT threads a row, each
    // over its lanes in order, then the threads' sums by a fixed tree
    const int r = tid / TCQ_XT, h = tid % TCQ_XT;
    const uint4* xr = reinterpret_cast<const uint4*>(
        smem_raw + st + r * TCQ_XRB + h * (QB * 2 / TCQ_XT));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < QB / 8 / TCQ_XT; ++i) {
      const uint4 v = xr[i];
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum += __uint_as_float(wd[e] << 16);
        sum += __uint_as_float(wd[e] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int o = 1; o < TCQ_XT; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (h == 0) xsum[(t & 1) * TCQ_M + r] = sum;
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // ldmatrix.x4: lanes 8m..8m+7 give the row addresses of matrix m.  A (x
  // tile) for m-tile mt, k step ks: + mt 16 XRB + ks 32; B (quants, rows
  // of k) for n-tiles (2p, 2p + 1), k step ks: + ks 16 WRB + p 32
  const int mi = lane >> 3, l7 = lane & 7;
  const uint32_t a_off =
      (wm * 64 + (mi & 1) * 8 + l7) * TCQ_XRB + (mi >> 1) * 16;
  const uint32_t b_off =
      L::W_OFF + ((mi & 1) * 8 + l7) * TCQ_WRB + (mi >> 1) * 16 + wn * 64;

  // The pipeline: block t + STAGES - 1 is copied, block t + 1 widened and
  // block t multiplied in the same interval between two barriers; the
  // copies land in a ring of TCQ_STAGES stages, the widened tiles
  // alternate between two buffers.
#pragma unroll
  for (int t = 0; t < TCQ_STAGES - 1; ++t) {
    if (t < nkb) load(t);
    cp_async_commit();
  }
  cp_async_wait<TCQ_STAGES - 2>();
  __syncthreads();
  widen(0);
  for (int t = 0; t < nkb; ++t) {
    cp_async_wait<TCQ_STAGES - 3>();
    __syncthreads();                      // t + 1 landed, t widened, t - 1 read
    if (t + TCQ_STAGES - 1 < nkb) load(t + TCQ_STAGES - 1);
    cp_async_commit();
    const int st = (t % TCQ_STAGES) * L::STAGE;
    const uint32_t wt = (t & 1) * L::W_B;

    // B fragments of both k steps for the warp's 4 n-tiles; the next
    // block's widening runs while they load
    uint32_t bf[2][2][4];
#pragma unroll
    for (int ks = 0; ks < 2 * (QUANT_TC_PARTS >= 1); ++ks)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4_trans(sa + b_off + wt + ks * 16 * TCQ_WRB + p * 32, bf[ks][p]);
    if (QUANT_TC_PARTS >= 2 && t + 1 < nkb) widen(t + 1);
    const float* sc = reinterpret_cast<const float*>(smem_raw + st + L::X_B +
                                                     L::Q_B);
    const float* xs = xsum + (t & 1) * TCQ_M;
    // per m-tile: part = x q over the block (two k steps into zeroed
    // accumulators), then acc += scale part (+ min xsum); element e of
    // (mt, nt) is row 64 wm + 16 mt + (lane >> 2) + 8 (e >> 1), column
    // 32 wn + 8 nt + 2 (lane & 3) + (e & 1)
#pragma unroll
    for (int mt = 0; mt < 4 * (QUANT_TC_PARTS >= 1); ++mt) {
      uint32_t af[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(sa + st + a_off + mt * 16 * TCQ_XRB + ks * 32, af[ks]);
      float part[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(part[2 * p], af[ks], bf[ks][p][0], bf[ks][p][1]);
          mma_bf16(part[2 * p + 1], af[ks], bf[ks][p][2], bf[ks][p][3]);
        }
      if (QUANT_TC_PARTS < 3) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
        continue;
      }
      float x0 = 0.f, x1 = 0.f;
      if (FMT == FMT_Q4) {
        const int row = wm * 64 + mt * 16 + (lane >> 2);
        x0 = xs[row];
        x1 = xs[row + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + 2 * (lane & 3);
        const float2 s2 = *reinterpret_cast<const float2*>(sc + col);
        float* c = acc[mt][nt];
        c[0] = fmaf(s2.x, part[nt][0], c[0]);
        c[1] = fmaf(s2.y, part[nt][1], c[1]);
        c[2] = fmaf(s2.x, part[nt][2], c[2]);
        c[3] = fmaf(s2.y, part[nt][3], c[3]);
        if (FMT == FMT_Q4) {
          const float2 mn2 = *reinterpret_cast<const float2*>(sc + TCQ_N + col);
          c[0] = fmaf(mn2.x, x0, c[0]);
          c[1] = fmaf(mn2.y, x0, c[1]);
          c[2] = fmaf(mn2.x, x1, c[2]);
          c[3] = fmaf(mn2.y, x1, c[3]);
        }
      }
    }
  }

  // epilogue: pairs of columns straight from the accumulators
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (row >= a.m || col >= a.n) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (a.ws) {
          *reinterpret_cast<float2*>(
              a.ws + ((size_t)blockIdx.y * a.m + row) * a.n + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + (size_t)row * a.n + col) =
              __floats2bfloat162_rn(v0, v1);
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

constexpr int ROUTE_SKINNY = 0, ROUTE_TILED = 1, ROUTE_TC = 2;

// The splits' reduction, when there are splits.
template <typename T>
int reduce(const QArgs& a, int splits, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int mn = a.m * a.n;
  splitk_reduce<T><<<(mn + NT - 1) / NT, NT, 0, stream>>>(a.ws, a.out, splits, mn);
  return (int)cudaGetLastError();
}

template <typename T, int FMT, bool VEC>
int launch(const QArgs& a, int splits, int route, cudaStream_t stream) {
  const int col_tiles = (a.n + TB_N - 1) / TB_N;
  if (route == ROUTE_TC) {
    // bf16 x and the 16-byte loads only (the wrapper's route)
    if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC) {
      using L = TcqLayout<FMT>;
      cudaError_t err = cudaFuncSetAttribute(
          quant_tc_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          L::SMEM);
      if (err != cudaSuccess) return (int)err;
      dim3 grid((a.m + TCQ_M - 1) / TCQ_M, splits, (a.n + TCQ_N - 1) / TCQ_N);
      quant_tc_kernel<FMT><<<grid, TCQ_T, L::SMEM, stream>>>(a);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route == ROUTE_SKINNY) {
    dim3 grid(col_tiles, splits, (a.m + SK_R - 1) / SK_R);
    skinny_kernel<T, FMT, VEC><<<grid, NT, 0, stream>>>(a);
  } else {
    dim3 grid(col_tiles, splits, (a.m + TB_M - 1) / TB_M);
    tiled_kernel<T, FMT, VEC><<<grid, NT, 0, stream>>>(a);
  }
  return reduce<T>(a, splits, stream);
}

template <typename T>
int dispatch(const QArgs& a, int fmt, int splits, int route, int vec,
             cudaStream_t s) {
  if (fmt == FMT_Q8)
    return vec ? launch<T, FMT_Q8, true>(a, splits, route, s)
               : launch<T, FMT_Q8, false>(a, splits, route, s);
  return vec ? launch<T, FMT_Q4, true>(a, splits, route, s)
             : launch<T, FMT_Q4, false>(a, splits, route, s);
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16;
// fmt: 0 = q8_0, 1 = q4_k; route: 0 = skinny, 1 = tiled, 2 = tensor cores
// (bf16 and vec only, else cudaErrorInvalidValue).  ws is null when
// splits == 1.
extern "C" int rt_quant_matmul(int dtype, int fmt, const void* x,
                               const void* quants, const float* scales,
                               const float* mins, void* out, float* ws,
                               int m, int d, int n, int nB, int splits,
                               int per_split, int route, int vec,
                               void* stream) {
  QArgs a = {};
  a.x = x; a.q = static_cast<const uint8_t*>(quants); a.scales = scales;
  a.mins = mins; a.out = out; a.ws = splits > 1 ? ws : nullptr;
  a.m = m; a.d = d; a.n = n; a.nB = nB; a.per_split = per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, fmt, splits, route, vec, s)
                    : dispatch<float>(a, fmt, splits, route, vec, s);
}
