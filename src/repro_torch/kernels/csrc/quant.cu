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
// The tiled kernel (f32 prefill) dequantizes each weight exactly as the
// plain version does it: a product and, for q4_k, a sum, each rounded on
// its own (__fmul_rn, __fadd_rn: never contracted into an FMA), so it and
// ref.quant_matmul_reference differ only in the order of the f32 sum.
// The skinny kernel (decode) and the tensor-core kernel (bf16 prefill)
// regroup the sum per quant block instead: sum_kb s[kb, c] (x q)_kb
// [+ min[kb, c] sum_k x], the integer quants exact, every scale applied in
// f32 (exact products for bf16 x); against the plain version they differ
// by f32 roundings of the same size, within 1e-5 (|x| @ |W|).
//
// Translation from the TPU: the Pallas grid (m/bm, n/bn, nB) walks the
// blocks of d in order on one core, accumulating in VMEM scratch.  Here the
// blocks of d are split across thread blocks ("splits", chosen from the
// shape alone by quant.quant_plan and quant.skinny_plan).  The skinny
// kernel adds its splits' partials inside one launch: its splits are the
// blocks of a thread-block cluster, which add each other's partials in
// rank order through distributed shared memory.  The tiled and tensor-core
// kernels write f32 partials to a workspace and a second pass
// (splitk_reduce) adds them in split order.  No float atomics: the sum's
// order is fixed, so equal inputs give equal bits on every run, which
// keeps the port's bitwise invariants (streamed == per-token, paged ==
// dense) under quantization.
//
// What bounds it on an H100:
//   decode (m = 4): a GEMV.  Every packed weight byte is read once and used
//   for 4 rows: 8 flops per q8_0 byte, far below the 295 flop/byte ridge,
//   so it is bound by HBM bytes (3.35 TB/s); w_gate in q8_0 (37.7 MB of
//   quants + 4.7 MB of scales) has a 12.7 us bound.  Two ceilings follow:
//   bytes in flight, and instruction issue.  Both skinny kernels keep up
//   to three 8 KB stages of cp.async in flight a block and add their
//   splits inside one launch.  On the CUDA cores (skinny_kernel) each byte
//   costs a byte permute, a subtraction and 4 FMAs (~8 us of issue at
//   w_gate at full rate; measured, the kernel reached no more than the
//   PR 13 kernel: latency, not issue, held it, PERF.md); its grid is one
//   wave of three blocks a SM (quant.skinny_plan: 384 blocks at the wide
//   decode shapes, 64 at wk / wv).  On the tensor cores (skinny_tc_kernel,
//   bf16 x) a weight costs ~2 logic ops and half a bf16 add, the products
//   and their sums going to mma.sync: it is the decode route of the
//   served bf16 model, ~1.4x the CUDA-core kernel's speed at w_gate.
//   wk / wv (n = 256) move 0.9 MB: launch latency, not bytes, sets their
//   time, and the CUDA-core kernel's narrower tiles give it more blocks.
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
// tiled, tensor cores) and the splits come from quant.quant_route,
// quant.quant_plan and quant.skinny_plan, from the shape, dtype and
// alignment alone.
//
// The entry point returns the cudaError_t of its launches (0 = success).

#include <cooperative_groups.h>
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
// Skinny (m <= 16, decode): skinny_kernel<T, FMT, VEC, TN>, one launch.
// Grid (column tiles x splits, m / 4), launched as clusters of `splits`
// blocks along x: the blocks of a cluster share one TN-column tile and
// take consecutive ranges of `per_split` quant blocks of d.  128 threads:
// thread (cg, rg) owns TN / 16 columns (cg of 16) and rows
// [4 rg, 4 rg + 4) of every quant block of its range (rg of 8), so every
// thread works on every quant block, whatever the range or the tile.
//   * cp.async brings `ks` quant blocks a stage (their quant rows, scale
//     row and, for q4_k, min row) into a ring of SK_STAGES stages; the
//     rows of x of the range are widened to f32 once, four rows of x per
//     k as one float4, into shared memory (in windows of SK_XW blocks);
//   * per quant block, part = x q over the thread's 4 rows, the integer
//     quants widened exactly (2^23 + byte, less the bias), then
//     acc += scale part (+ min sum x): the products are exact for bf16 x
//     and every scale is applied in f32, as in quant_tc_kernel;
//   * the 8 row groups' sums are added in order in shared memory, then
//     the cluster's blocks add their partials in rank order through
//     distributed shared memory (rank r adds a slice of the columns) and
//     write the output.  No workspace, no second launch, no atomics.
// The split is quant.skinny_plan(n, nB): a function of n and the number
// of quant blocks only, never of m or of the other rows of x, so a row's
// bits do not depend on the batch it is in.
// --------------------------------------------------------------------------

constexpr int SK_T = 128;               // threads a block
constexpr int SK_M = 4;                 // rows of x a block
constexpr int SK_CG = 16;               // column groups
constexpr int SK_RG = SK_T / SK_CG;     // 8 row groups
constexpr int SK_WR = QB / SK_RG;       // 4 rows of each quant block a thread
constexpr int SK_STAGES = 4;
constexpr int SK_XW = 64;               // quant blocks of x in shared memory

struct SkinnyLayout {                   // bytes of dynamic shared memory
  int q_b, s_b, stage, xs_off, total;
};

__host__ __device__ inline SkinnyLayout skinny_layout(int fmt, int tn, int ks,
                                                      int per) {
  SkinnyLayout L;
  L.q_b = ks * (fmt == FMT_Q8 ? QB : QB / 2) * tn;
  L.s_b = ks * tn * 4;
  L.stage = L.q_b + L.s_b * (fmt == FMT_Q4 ? 2 : 1);
  const int ring = SK_STAGES * L.stage;
  const int red = (SK_RG + 1) * SK_M * tn * 4;   // the sums, then the partial
  L.xs_off = ring > red ? ring : red;
  L.total = L.xs_off + (per < SK_XW ? per : SK_XW) * QB * SK_M * 4;
  return L;
}

// N = 2, 4 or 8 bytes of shared memory as words
template <int N>
__device__ __forceinline__ void load_bytes(const unsigned char* p,
                                           uint32_t wd[(N + 3) / 4]) {
  if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    wd[0] = v.x;
    wd[1] = v.y;
  } else if constexpr (N == 4) {
    wd[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    wd[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// q8_0: the N bytes of a quant row piece as exact floats: 2^23 + (q + 128)
// is a float whose low byte is q ^ 0x80 (one byte permute), less 2^23 + 128
template <int N>
__device__ __forceinline__ void widen_q8(const unsigned char* p, float w[N]) {
  uint32_t wd[(N + 3) / 4];
  load_bytes<N>(p, wd);
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) wd[i] ^= 0x80808080u;
#pragma unroll
  for (int c = 0; c < N; ++c)
    w[c] = __int_as_float(__byte_perm(wd[c / 4], 0x4B000000u, 0x7540u | (c % 4)))
           - 8388736.f;
}

// q4_k: byte c of the piece holds row 2j (low nibble) and 2j + 1 (high)
template <int N>
__device__ __forceinline__ void widen_q4(const unsigned char* p, float lo[N],
                                         float hi[N]) {
  uint32_t wd[(N + 3) / 4];
  load_bytes<N>(p, wd);
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) {
    const uint32_t l = wd[i] & 0x0F0F0F0Fu, h = (wd[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int c = 0; c < 4 && 4 * i + c < N; ++c) {
      lo[4 * i + c] = __int_as_float(__byte_perm(l, 0x4B000000u, 0x7540u | c)) - 8388608.f;
      hi[4 * i + c] = __int_as_float(__byte_perm(h, 0x4B000000u, 0x7540u | c)) - 8388608.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void lds_f(const float* p, float v[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = f.x; v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int FMT, bool VEC, int TN>
__global__ void __launch_bounds__(SK_T, 3) skinny_kernel(QArgs a, int ks, int cs) {
  constexpr int CPT = TN / SK_CG;       // columns a thread
  constexpr int QROWS = FMT == FMT_Q8 ? QB : QB / 2;
  constexpr int NSC = FMT == FMT_Q4 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SkinnyLayout L = skinny_layout(FMT, TN, ks, a.per_split);
  const int tid = threadIdx.x, cg = tid % SK_CG, rg = tid / SK_CG;
  const int rank = blockIdx.x % cs, n0 = (blockIdx.x / cs) * TN;
  const int row0 = blockIdx.y * SK_M;
  const int kb0 = rank * a.per_split, kb1 = min(a.nB, kb0 + a.per_split);
  const int nst = (kb1 - kb0 + ks - 1) / ks;
  const T* x = static_cast<const T*>(a.x);
  float4* xs = reinterpret_cast<float4*>(smem_raw + L.xs_off);

  // stage t: quant blocks [kb0 + t ks, + ks) into ring slot t % SK_STAGES;
  // rows past kb1 and columns past n are zero-filled
  auto load = [&](int t) {
    unsigned char* st = smem_raw + (t % SK_STAGES) * L.stage;
    const int kbs = kb0 + t * ks, nk = min(ks, kb1 - kbs);
    if (VEC) {
      constexpr int QCH = TN / 16, SCH = TN / 4;
      const uint32_t sa = smem_u32(st);
      for (int c = tid; c < ks * QROWS * QCH; c += SK_T) {
        const int r = c / QCH, col = n0 + (c % QCH) * 16;
        const bool ok = r < nk * QROWS && col < a.n;
        cp_async16(sa + c * 16,
                   ok ? a.q + ((size_t)kbs * QROWS + r) * a.n + col : a.q, ok);
      }
      for (int c = tid; c < NSC * ks * SCH; c += SK_T) {
        const int which = c / (ks * SCH), kbl = (c / SCH) % ks;
        const int col = n0 + (c % SCH) * 4;
        const bool ok = kbl < nk && col < a.n;
        const float* src = which ? a.mins : a.scales;
        cp_async16(sa + L.q_b + c * 16,
                   ok ? src + (size_t)(kbs + kbl) * a.n + col : src, ok);
      }
    } else {
      for (int e = tid; e < ks * QROWS * TN; e += SK_T) {
        const int r = e / TN, col = n0 + e % TN;
        st[e] = (r < nk * QROWS && col < a.n)
                    ? a.q[((size_t)kbs * QROWS + r) * a.n + col] : 0;
      }
      float* sc = reinterpret_cast<float*>(st + L.q_b);
      for (int e = tid; e < NSC * ks * TN; e += SK_T) {
        const int which = e / (ks * TN), kbl = (e / TN) % ks, col = n0 + e % TN;
        const float* src = which ? a.mins : a.scales;
        sc[e] = (kbl < nk && col < a.n) ? src[(size_t)(kbs + kbl) * a.n + col] : 0.f;
      }
    }
  };
  // the window of x from quant block kbw on, four rows a float4, zero
  // past m and past d
  auto load_x = [&](int kbw) {
    const int nk = min(SK_XW, kb1 - kbw);
    for (int e = tid; e < nk * QB; e += SK_T) {
      const int k = kbw * QB + e;
      float v[SK_M];
#pragma unroll
      for (int i = 0; i < SK_M; ++i) {
        const int row = row0 + i;
        v[i] = (row < a.m && k < a.d) ? to_f(x[(size_t)row * a.d + k]) : 0.f;
      }
      xs[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[SK_M][CPT];
#pragma unroll
  for (int i = 0; i < SK_M; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int t = 0; t < SK_STAGES - 1; ++t) {
    if (t < nst) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();                      // stage t landed; t - 1 and the window read
    if (t + SK_STAGES - 1 < nst) load(t + SK_STAGES - 1);
    cp_async_commit();
    if ((t * ks) % SK_XW == 0) {
      load_x(kb0 + t * ks);
      __syncthreads();
    }
    const unsigned char* st = smem_raw + (t % SK_STAGES) * L.stage;
    const float* sc = reinterpret_cast<const float*>(st + L.q_b);
    const int nk = min(ks, kb1 - (kb0 + t * ks));
    const float4* xw = xs + ((t * ks) % SK_XW) * QB + rg * SK_WR;
    for (int kbl = 0; kbl < nk; ++kbl) {
      const float4* xk = xw + kbl * QB;
      float s[CPT], part[SK_M][CPT];
      lds_f<CPT>(sc + kbl * TN + cg * CPT, s);
      if (FMT == FMT_Q8) {
        const unsigned char* qr = st + (kbl * QB + rg * SK_WR) * TN + cg * CPT;
#pragma unroll
        for (int j = 0; j < SK_WR; ++j) {
          const float4 xv = xk[j];
          const float xa[SK_M] = {xv.x, xv.y, xv.z, xv.w};
          float w[CPT];
          widen_q8<CPT>(qr + j * TN, w);
#pragma unroll
          for (int i = 0; i < SK_M; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              part[i][c] = j == 0 ? xa[i] * w[c] : fmaf(xa[i], w[c], part[i][c]);
        }
#pragma unroll
        for (int i = 0; i < SK_M; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(s[c], part[i][c], acc[i][c]);
      } else {
        float mn[CPT], px[SK_M];
        lds_f<CPT>(sc + ks * TN + kbl * TN + cg * CPT, mn);
        const unsigned char* qr =
            st + (kbl * (QB / 2) + rg * (SK_WR / 2)) * TN + cg * CPT;
#pragma unroll
        for (int j = 0; j < SK_WR / 2; ++j) {
          const float4 v0 = xk[2 * j], v1 = xk[2 * j + 1];
          const float x0[SK_M] = {v0.x, v0.y, v0.z, v0.w};
          const float x1[SK_M] = {v1.x, v1.y, v1.z, v1.w};
          float lo[CPT], hi[CPT];
          widen_q4<CPT>(qr + j * TN, lo, hi);
#pragma unroll
          for (int i = 0; i < SK_M; ++i) {
            px[i] = j == 0 ? x0[i] + x1[i] : (px[i] + x0[i]) + x1[i];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              part[i][c] = j == 0 ? x0[i] * lo[c] : fmaf(x0[i], lo[c], part[i][c]);
              part[i][c] = fmaf(x1[i], hi[c], part[i][c]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < SK_M; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[i][c] = fmaf(s[c], part[i][c], acc[i][c]);
            acc[i][c] = fmaf(mn[c], px[i], acc[i][c]);
          }
      }
    }
  }

  // the row groups' sums, added in order, into this block's partial
  cp_async_wait<0>();
  __syncthreads();                        // the ring is free
  float* red = reinterpret_cast<float*>(smem_raw);            // [RG][M][TN]
  float* part = red + SK_RG * SK_M * TN;                 // [M][TN]
#pragma unroll
  for (int i = 0; i < SK_M; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      red[(rg * SK_M + i) * TN + cg * CPT + c] = acc[i][c];
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int e = tid; e < SK_M * TN; e += SK_T) {
    float v = red[e];
#pragma unroll
    for (int g = 1; g < SK_RG; ++g) v += red[g * SK_M * TN + e];
    const int row = row0 + e / TN, col = n0 + e % TN;
    if (cs == 1) {
      if (row < a.m && col < a.n) out[(size_t)row * a.n + col] = from_f<T>(v);
    } else {
      part[e] = v;
    }
  }
  if (cs == 1) return;
  // the cluster's partials, in rank order; rank r writes its slice
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int slice = SK_M * TN / cs;
  for (int e = rank * slice + tid; e < (rank + 1) * slice; e += SK_T) {
    float v = 0.f;
    for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(part, q)[e];
    const int row = row0 + e / TN, col = n0 + e % TN;
    if (row < a.m && col < a.n) out[(size_t)row * a.n + col] = from_f<T>(v);
  }
  cluster.sync();                         // no block leaves while read
}

// --------------------------------------------------------------------------
// Skinny on the tensor cores (bf16 x, 16-byte-aligned x and weight leaves,
// d % 8 == 0): skinny_tc_kernel<FMT>, the same grid, clusters, ring and
// reduction as skinny_kernel, with 128-column tiles and the products on
// mma.sync m16n8k16: A = the block's 4 rows of x (rows 4..15 zero), B = the
// quants.  Warp w owns columns [32 w, 32 w + 32) of the tile and every
// quant block of the split.  The quant rows sit in the ring as bytes (rows
// padded to 144 bytes); ldmatrix.trans on them, read as 16-bit pairs,
// gives lane (g, t) bytes (2t, 2g), (2t, 2g + 1), (2t + 1, 2g),
// (2t + 1, 2g + 1) of an 8 x 16-byte matrix: the even bytes are the B
// fragment of column 2g, the odd bytes that of column 2g + 1, so one load
// feeds two mmas (even and odd columns).  The bytes are widened to bf16 in
// registers, exactly: q8_0 as (128 + q & 127) - (128 + q & 128) (two
// logic ops and a bf16 addition a pair, q in [-128, 127]); q4_k as
// (128 + nibble) - 128, a byte giving the pair (row 2j, row 2j + 1) of one
// column (the A fragment takes the matching 4 lanes of x).  Per quant
// block, part = x q over its 32 rows (two k steps into zeroed
// accumulators), then acc += scale part (+ min sum x), as in skinny_kernel.
// A stage holds STC_KS quant blocks, unrolled: 2 where the grid is more
// than a wave (w_gate: 768 blocks), 4 where it is less (w_down, wq: 192),
// so each block keeps more bytes in flight (quant.skinny_plan; measured,
// PERF.md).
// --------------------------------------------------------------------------

constexpr int STC_N = 128;              // columns a tile
constexpr int STC_QRS = STC_N + 16;     // bytes of a padded quant row

struct SkinnyTcLayout {                 // bytes of dynamic shared memory
  int q_b, s_b, stage, part_off, x_off, xrs, xsum_off, total;
};

__host__ __device__ inline SkinnyTcLayout skinny_tc_layout(int fmt, int ks,
                                                           int per) {
  SkinnyTcLayout L;
  const int xw = per < SK_XW ? per : SK_XW;
  L.q_b = ks * (fmt == FMT_Q8 ? QB : QB / 2) * STC_QRS;
  L.s_b = ks * STC_N * 4;
  L.stage = L.q_b + L.s_b * (fmt == FMT_Q4 ? 2 : 1);
  L.part_off = SK_STAGES * L.stage;                 // [M][N] f32
  L.x_off = L.part_off + SK_M * STC_N * 4;          // [M][xrs] bf16
  L.xrs = xw * QB * 2 + 16;
  L.xsum_off = L.x_off + SK_M * L.xrs;              // [M][SK_XW] f32
  L.total = L.xsum_off + (fmt == FMT_Q4 ? SK_M * SK_XW * 4 : 0);
  return L;
}

// a + b on bf16 pairs; exact here: every sum is a small integer
__device__ __forceinline__ uint32_t hadd_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// bytes 0 and 2 of w (int8 quants) as an exact bf16 pair:
// (128 + (q & 127)) + -(128 + (q & 128)), the second term's sign bit set
// in the same logic op that builds it
__device__ __forceinline__ uint32_t q8_pair(uint32_t w) {
  return hadd_bf16x2((w & 0x007F007Fu) | 0x43004300u,
                     (w & 0x00800080u) | 0xC300C300u);
}

// byte p of w (two q4_k nibbles: rows 2j, 2j + 1) as an exact bf16 pair:
// (128 + nibble) + -128
template <int P>
__device__ __forceinline__ uint32_t q4_pair(uint32_t w, uint32_t w4) {
  constexpr uint32_t SEL = P | (P << 4) | ((4 + P) << 8) | ((4 + P) << 12);
  return hadd_bf16x2((__byte_perm(w, w4, SEL) & 0x000F000Fu) | 0x43004300u,
                     0xC300C300u);
}

template <int FMT, int STC_KS>       // STC_KS: quant blocks a stage, 2 or 4
__global__ void __launch_bounds__(SK_T, 8 / STC_KS) skinny_tc_kernel(QArgs a, int cs) {
  constexpr int QROWS = FMT == FMT_Q8 ? QB : QB / 2;
  constexpr int NSC = FMT == FMT_Q4 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SkinnyTcLayout L = skinny_tc_layout(FMT, STC_KS, a.per_split);
  const uint32_t sa = smem_u32(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, l7 = lane & 7;
  const int rank = blockIdx.x % cs, n0 = (blockIdx.x / cs) * STC_N;
  const int row0 = blockIdx.y * SK_M;
  const int kb0 = rank * a.per_split, kb1 = min(a.nB, kb0 + a.per_split);
  const int nst = (kb1 - kb0 + STC_KS - 1) / STC_KS;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  float* xsum = reinterpret_cast<float*>(smem_raw + L.xsum_off);

  auto load = [&](int t) {
    const uint32_t st = sa + (t % SK_STAGES) * L.stage;
    const int kbs = kb0 + t * STC_KS, nk = min(STC_KS, kb1 - kbs);
    constexpr int QCH = STC_N / 16, SCH = STC_N / 4;
#pragma unroll
    for (int c = tid; c < STC_KS * QROWS * QCH; c += SK_T) {
      const int r = c / QCH, cc = c % QCH, col = n0 + cc * 16;
      const bool ok = r < nk * QROWS && col < a.n;
      cp_async16(st + r * STC_QRS + cc * 16,
                 ok ? a.q + ((size_t)kbs * QROWS + r) * a.n + col : a.q, ok);
    }
    for (int c = tid; c < NSC * STC_KS * SCH; c += SK_T) {
      const int which = c / (STC_KS * SCH), kbl = (c / SCH) % STC_KS;
      const int col = n0 + (c % SCH) * 4;
      const bool ok = kbl < nk && col < a.n;
      const float* src = which ? a.mins : a.scales;
      cp_async16(st + L.q_b + c * 16,
                 ok ? src + (size_t)(kbs + kbl) * a.n + col : src, ok);
    }
  };
  // the window of x from quant block kbw on: 4 rows of bf16, zero past m
  // and past d (d % 8 == 0, so a 16-byte piece is all in or all out)
  auto load_x = [&](int kbw) {
    const int nch = min(SK_XW, kb1 - kbw) * (QB / 8);
    for (int c = tid; c < SK_M * nch; c += SK_T) {
      const int i = c / nch, k = kbw * QB + (c % nch) * 8, row = row0 + i;
      const bool ok = row < a.m && k < a.d;
      cp_async16(sa + L.x_off + i * L.xrs + (c % nch) * 16,
                 ok ? x + (size_t)row * a.d + k : x, ok);
    }
  };
  // q4_k: each row of x summed over each quant block of the window, in order
  auto sum_x = [&](int kbw) {
    const int nk = min(SK_XW, kb1 - kbw);
    for (int e = tid; e < SK_M * nk; e += SK_T) {
      const int i = e / nk, kbl = e % nk;
      const uint4* p = reinterpret_cast<const uint4*>(
          smem_raw + L.x_off + i * L.xrs + kbl * QB * 2);
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < QB / 8; ++v) {
        const uint4 q = p[v];
        const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          s += __uint_as_float(wd[h] << 16);
          s += __uint_as_float(wd[h] & 0xffff0000u);
        }
      }
      xsum[i * SK_XW + kbl] = s;
    }
  };

  float acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[h][j] = 0.f;

  load_x(kb0);
#pragma unroll
  for (int t = 0; t < SK_STAGES - 1; ++t) {
    if (t < nst) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();                      // stage t (and the window) landed
    if (t + SK_STAGES - 1 < nst) load(t + SK_STAGES - 1);
    cp_async_commit();
    const int kw = (t * STC_KS) % SK_XW;  // this stage's place in the window
    if (kw == 0) {
      if (t > 0) {                        // a later window: d > 64 blocks a split
        load_x(kb0 + t * STC_KS);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (FMT == FMT_Q4) {
        sum_x(kb0 + t * STC_KS);
        __syncthreads();
      }
    }
    const uint32_t st = sa + (t % SK_STAGES) * L.stage;
    const float4* sc = reinterpret_cast<const float4*>(
        smem_raw + (t % SK_STAGES) * L.stage + L.q_b);
    const int nk = min(STC_KS, kb1 - (kb0 + t * STC_KS));
    const uint32_t xa = sa + L.x_off + g * L.xrs;
    // the stage's B fragments first (both quant blocks), then its A
    // fragments, so the loads of one block overlap the mmas of the other
    constexpr int NLD = FMT == FMT_Q8 ? 2 : 1;
    uint32_t r[STC_KS][NLD][4];
#pragma unroll
    for (int kbl = 0; kbl < STC_KS; ++kbl)
#pragma unroll
      for (int s = 0; s < NLD; ++s) {
        if (FMT == FMT_Q8)
          ldsm_x4_trans(st + (kbl * QB + 16 * s + (mi & 1) * 8 + l7) * STC_QRS +
                            warp * 32 + (mi >> 1) * 16, r[kbl][s]);
        else
          ldsm_x4_trans(st + (kbl * (QB / 2) + (mi >> 1) * 8 + l7) * STC_QRS +
                            warp * 32 + (mi & 1) * 16, r[kbl][s]);
      }
    uint32_t af[STC_KS][2][2];            // [block][k step][a0, a2]
#pragma unroll
    for (int kbl = 0; kbl < STC_KS; ++kbl)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        af[kbl][s][0] = af[kbl][s][1] = 0u;
        const int kx = (kw + kbl) * QB + 16 * s;   // k in the window
        if (g < SK_M && kbl < nk) {
          if (FMT == FMT_Q8) {
            asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(af[kbl][s][0])
                         : "r"(xa + (kx + 2 * t4) * 2));
            asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(af[kbl][s][1])
                         : "r"(xa + (kx + 8 + 2 * t4) * 2));
          } else {
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(af[kbl][s][0]), "=r"(af[kbl][s][1])
                         : "r"(xa + (kx + 4 * t4) * 2));
          }
        }
      }
#pragma unroll
    for (int kbl = 0; kbl < STC_KS; ++kbl) {
      if (kbl >= nk) break;
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t a4[4] = {af[kbl][s][0], 0u, af[kbl][s][1], 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (FMT == FMT_Q8) {
            const uint32_t lo = r[kbl][s][2 * h], hi = r[kbl][s][2 * h + 1];
            mma_bf16(part[2 * h], a4, q8_pair(lo), q8_pair(hi));
            mma_bf16(part[2 * h + 1], a4, q8_pair(lo >> 8), q8_pair(hi >> 8));
          } else {
            const uint32_t w = r[kbl][0][2 * s + h], w4 = w >> 4;
            mma_bf16(part[2 * h], a4, q4_pair<0>(w, w4), q4_pair<2>(w, w4));
            mma_bf16(part[2 * h + 1], a4, q4_pair<1>(w, w4), q4_pair<3>(w, w4));
          }
        }
      }
      // lane (g, t): row g, columns 32 warp + 16 h + 4 t + (0, 1, 2, 3) =
      // even c0, odd c0, even c1, odd c1
      const float xs = FMT == FMT_Q4 && g < SK_M ? xsum[g * SK_XW + kw + kbl] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 s4 = sc[kbl * (STC_N / 4) + warp * 8 + 4 * h + t4];
        acc[h][0] = fmaf(s4.x, part[2 * h][0], acc[h][0]);
        acc[h][1] = fmaf(s4.y, part[2 * h + 1][0], acc[h][1]);
        acc[h][2] = fmaf(s4.z, part[2 * h][1], acc[h][2]);
        acc[h][3] = fmaf(s4.w, part[2 * h + 1][1], acc[h][3]);
        if (FMT == FMT_Q4) {
          const float4 m4 = sc[(STC_KS + kbl) * (STC_N / 4) + warp * 8 + 4 * h + t4];
          acc[h][0] = fmaf(m4.x, xs, acc[h][0]);
          acc[h][1] = fmaf(m4.y, xs, acc[h][1]);
          acc[h][2] = fmaf(m4.z, xs, acc[h][2]);
          acc[h][3] = fmaf(m4.w, xs, acc[h][3]);
        }
      }
    }
  }

  cp_async_wait<0>();
  float* part = reinterpret_cast<float*>(smem_raw + L.part_off);   // [M][N]
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  if (cs == 1) {
    if (g < SK_M && row0 + g < a.m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + warp * 32 + 16 * h + 4 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < a.n)
            out[(size_t)(row0 + g) * a.n + col + j] = __float2bfloat16(acc[h][j]);
      }
    }
    return;
  }
  if (g < SK_M) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + g * STC_N + warp * 32 + 16 * h + 4 * t4) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
  // the cluster's partials, in rank order; rank r writes its slice
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int slice = SK_M * STC_N / cs;
  for (int e = rank * slice + tid; e < (rank + 1) * slice; e += SK_T) {
    float v = 0.f;
    for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(part, q)[e];
    const int row = row0 + e / STC_N, col = n0 + e % STC_N;
    if (row < a.m && col < a.n) out[(size_t)row * a.n + col] = __float2bfloat16(v);
  }
  cluster.sync();                         // no block leaves while read
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

constexpr int ROUTE_TILED = 1, ROUTE_TC = 2;   // 0, the skinny route: its own entry

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
  } else if (route == ROUTE_TILED) {
    dim3 grid(col_tiles, splits, (a.m + TB_M - 1) / TB_M);
    tiled_kernel<T, FMT, VEC><<<grid, NT, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
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

// The skinny route: one launch of clusters of `cs` blocks.
template <typename T, int FMT, bool VEC, int TN>
int launch_skinny(const QArgs& a, int cs, int ks, cudaStream_t stream) {
  const SkinnyLayout L = skinny_layout(FMT, TN, ks, a.per_split);
  auto kernel = skinny_kernel<T, FMT, VEC, TN>;
  static int opted = 48 << 10;            // shared memory opted into so far
  if (L.total > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    opted = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.n + TN - 1) / TN) * cs, (a.m + SK_M - 1) / SK_M, 1);
  cfg.blockDim = dim3(SK_T, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, ks, cs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, int FMT, bool VEC>
int skinny_tile(const QArgs& a, int tn, int cs, int ks, cudaStream_t s) {
  switch (tn) {
    case 128: return launch_skinny<T, FMT, VEC, 128>(a, cs, ks, s);
    case 64: return launch_skinny<T, FMT, VEC, 64>(a, cs, ks, s);
    case 32: return launch_skinny<T, FMT, VEC, 32>(a, cs, ks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core skinny route: bf16 x, the 16-byte loads, d % 8 == 0.
template <int FMT, int STC_KS>
int launch_skinny_tc(const QArgs& a, int cs, cudaStream_t stream) {
  const SkinnyTcLayout L = skinny_tc_layout(FMT, STC_KS, a.per_split);
  auto kernel = skinny_tc_kernel<FMT, STC_KS>;
  static int opted = 48 << 10;            // shared memory opted into so far
  if (L.total > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    opted = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.n + STC_N - 1) / STC_N) * cs, (a.m + SK_M - 1) / SK_M, 1);
  cfg.blockDim = dim3(SK_T, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, cs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch_skinny(const QArgs& a, int fmt, int vec, int tn, int cs, int ks,
                    int tc, cudaStream_t s) {
  if (a.m > 16 || cs < 1 || cs > 8 || ks < 1 || ks > SK_XW ||
      (ks & (ks - 1)) != 0 || (SK_M * tn) % cs != 0)
    return (int)cudaErrorInvalidValue;
  if (tc) {
    if (!std::is_same<T, __nv_bfloat16>::value || !vec || tn != STC_N ||
        (ks != 2 && ks != 4) || a.d % 8 != 0)
      return (int)cudaErrorInvalidValue;
    if (fmt == FMT_Q8)
      return ks == 2 ? launch_skinny_tc<FMT_Q8, 2>(a, cs, s)
                     : launch_skinny_tc<FMT_Q8, 4>(a, cs, s);
    return ks == 2 ? launch_skinny_tc<FMT_Q4, 2>(a, cs, s)
                   : launch_skinny_tc<FMT_Q4, 4>(a, cs, s);
  }
  if (fmt == FMT_Q8)
    return vec ? skinny_tile<T, FMT_Q8, true>(a, tn, cs, ks, s)
               : skinny_tile<T, FMT_Q8, false>(a, tn, cs, ks, s);
  return vec ? skinny_tile<T, FMT_Q4, true>(a, tn, cs, ks, s)
             : skinny_tile<T, FMT_Q4, false>(a, tn, cs, ks, s);
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16;
// fmt: 0 = q8_0, 1 = q4_k; route: 1 = tiled, 2 = tensor cores (bf16 and
// vec only), anything else cudaErrorInvalidValue (the skinny route is
// rt_quant_skinny).  ws is null when splits == 1.
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

// The skinny route (m <= 16): tile_cols 32, 64 or 128; `splits` blocks a
// cluster (1..8), `per_split` quant blocks each, `ks` (a power of two up
// to 64) quant blocks a pipeline stage: quant.skinny_plan.  tc = 1 takes
// skinny_tc_kernel (bf16 x, vec, 16-byte-aligned x, d % 8 == 0, 128
// columns a tile, 2 or 4 quant blocks a stage), else
// cudaErrorInvalidValue.
extern "C" int rt_quant_skinny(int dtype, int fmt, const void* x,
                               const void* quants, const float* scales,
                               const float* mins, void* out, int m, int d,
                               int n, int nB, int tile_cols, int splits,
                               int per_split, int ks, int vec, int tc,
                               void* stream) {
  QArgs a = {};
  a.x = x; a.q = static_cast<const uint8_t*>(quants); a.scales = scales;
  a.mins = mins; a.out = out; a.ws = nullptr;
  a.m = m; a.d = d; a.n = n; a.nB = nB; a.per_split = per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dispatch_skinny<__nv_bfloat16>(a, fmt, vec, tile_cols, splits, ks, tc, s)
             : dispatch_skinny<float>(a, fmt, vec, tile_cols, splits, ks, tc, s);
}
