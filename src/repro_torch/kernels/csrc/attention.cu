// Hand-written Hopper (sm_90a) attention kernels of the serving main path.
//
// Each is the port of one Pallas TPU kernel in
// src/repro/kernels/flash_attention.py:
//
//   decode_split_tc_kernel<HD, KV, PARTIAL> or decode_split_kernel<T, KV,
//   PARTIAL>, then decode_merge_kernel<T, PARTIAL>
//       <- _decode_fused_kernel / decode_attention_fused (PARTIAL = false)
//       <- _decode_partial_kernel / decode_attention_partial (PARTIAL)
//       <- decode_attention_fused_partial (PARTIAL = false, raw epilogue)
//       Flash decode of one query token per row.  The fused variant runs
//       against the whole KV cache: dense or paged (a per-row page table
//       indexing the row's own (KH, S, hd) panel), per-row `pos`, optional
//       sliding window, GQA, the current token's `extra` partial merged
//       before the normalisation.  Its int8 variant (the `has_scales`
//       branch of the Pallas kernel) reads int8 K/V pools with one f32
//       scale per physical page, looked up through the same indirection
//       as the rows.  The partial variant writes the raw, unnormalised
//       (acc, m, l) of a KV chunk under an explicit (B, C) mask, m = -inf
//       for an empty row.  The fused partial (the mesh decode's producer,
//       one head group a rank) runs the fused route and writes the raw
//       (acc, m, l) after the `extra` merge in place of the normalised
//       output: normalised by the same f32 division, the gathered groups
//       give the fused output's bits.  The KV range is split across blocks at fixed
//       logical rows and merged in split order (see the note above the
//       kernels); the split runs on the tensor cores for bf16 q with HD 64,
//       80, 128 or 256 and at most 16 query heads per KV head, on the CUDA
//       cores for the rest (f32, and other head dims such as 96).
//   flash_kernel          <- _flash_kernel / flash_attention
//       Causal / sliding-window GQA prefill attention with online softmax,
//       on the CUDA cores in f32: the kernel for f32 inputs and for head
//       dims the tensor-core kernel does not take.
//   flash_tc_kernel<HD>   <- _flash_kernel / flash_attention
//       The same function on the tensor cores, for bf16 with HD 64, 80,
//       128 or 256 (see its own note below).
//
// Translation from the TPU: the Pallas grids run their innermost KV axis in
// order on one core and carry (acc, m, l) in VMEM scratch between grid
// steps.  For prefill one thread block owns one (row, head, q tile), and a
// loop over KV tiles inside the block takes the place of the sequential
// grid axis.  For decode the KV axis is split across blocks instead, each
// writing its split's (acc, m, l) in f32, and a second kernel merges them
// in split order.  bf16 or f32 I/O, converted with the intrinsics.
//
// What bounds them on an H100: decode reads every valid K/V byte once and
// does 4 flops per byte pair, far below the 295 flop/byte ridge, so it is
// bound by HBM bytes (3.35 TB/s); the int8 variant halves those bytes.
// At the main path's shapes (B = 4, KH = 2, S = 1024) those bytes are a
// few hundred KB, far too few for the bound to show: one block per
// (row, KV head) walking the whole cache left 124 of 132 SMs idle, so the
// split puts every 64-row split on a block of its own (up to 128 blocks),
// and a block's latency (copies, a few dozen mmas, barriers) sets the
// time; at hd 64 a split holds a whole chunk of up to 128 rows (see the
// split's note).  Prefill is bound by operations (989 TFLOP/s
// bf16 on the tensor cores); flash_kernel does its products on the CUDA
// cores in f32, far below that bound, and flash_tc_kernel on the tensor
// cores.
//
// Prefill tiles that the mask empties entirely are skipped.  That is
// bitwise the same as visiting them: a fully masked tile leaves m
// unchanged, so alpha is exp(0) = 1 and p = 0, and acc * 1 + 0 and l * 1 +
// 0 are exact.
//
// Each entry point returns the cudaError_t of its launches (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // the Pallas kernels' mask sentinel
constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --------------------------------------------------------------------------
// Prefill: one block per (row b, head h, q tile of BQ rows); KV tiles of BK
// rows walk the causal (and window) range in order.
// --------------------------------------------------------------------------

constexpr int BQ = 32;
constexpr int BK = 64;

struct FlashArgs {
  const void* q;     // (B, S, H, hd)
  const void* k;     // (B, S, KH, hd)
  const void* v;
  void* out;         // (B, S, H, hd)
  int S, H, KH, HD;
  int causal, window;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT) flash_kernel(FlashArgs a) {
  extern __shared__ float sm[];
  const int HD = a.HD, LD = HD + 1;
  float* q_s = sm;                    // BQ * LD
  float* k_s = q_s + BQ * LD;         // BK * LD
  float* v_s = k_s + BK * LD;         // BK * LD
  float* p_s = v_s + BK * LD;         // BQ * BK
  float* acc_s = p_s + BQ * BK;       // BQ * HD
  float* m_s = acc_s + BQ * HD;       // BQ
  float* l_s = m_s + BQ;              // BQ
  float* al_s = l_s + BQ;             // BQ
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.KH);
  const int q0 = blockIdx.x * BQ;
  const int S = a.S;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qpos = q0 + r;
    float x = 0.f;
    if (qpos < S) x = to_f(qp[(((size_t)b * S + qpos) * a.H + h) * HD + d]) * a.scale;
    q_s[r * LD + d] = x;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += NT) { m_s[r] = NEG_INF; l_s[r] = 0.f; }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = a.causal ? q_last + 1 : S;                       // exclusive
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;   // inclusive
  auto is_valid = [&](int qpos, int kpos) -> bool {
    bool ok = kpos < S;
    if (a.causal) ok = ok && kpos <= qpos;
    if (a.window > 0) ok = ok && kpos > qpos - a.window;
    return ok;
  };
  __syncthreads();

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kpos = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kpos < S) {
        const size_t off = (((size_t)b * S + kpos) * a.KH + kh) * HD + d;
        kv = to_f(kp[off]);
        vv = to_f(vp[off]);
      }
      k_s[r * LD + d] = kv;
      v_s[r * LD + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      float s = NEG_INF;
      if (is_valid(q0 + r, k0 + c)) {
        const float* qq = q_s + r * LD;
        const float* kk = k_s + c * LD;
        float acc = 0.f;
        for (int d = 0; d < HD; ++d) acc = fmaf(qq[d], kk[d], acc);
        s = acc;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += NWARP) {
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, p_s[r * BK + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = is_valid(q0 + r, k0 + c) ? expf(p_s[r * BK + c] - m_new) : 0.f;
        p_s[r * BK + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        al_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const float* pp = p_s + r * BK;
      float s = 0.f;
      for (int c = 0; c < BK; ++c) s = fmaf(pp[c], v_s[c * LD + d], s);
      acc_s[i] = acc_s[i] * al_s[r] + s;
    }
    __syncthreads();
  }

  T* op = static_cast<T*>(a.out);
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qpos = q0 + r;
    if (qpos < S)
      op[(((size_t)b * S + qpos) * a.H + h) * HD + d] =
          from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-20f));
  }
}

// --------------------------------------------------------------------------
// Prefill on the tensor cores: flash_tc_kernel<HD>, bf16, HD 64, 80, 128
// or 256.
//
// The FlashAttention-2 layout.  One block of 4 warps per (row b, head h,
// q tile of 64 rows); each warp owns 16 query rows.  The q tiles are
// launched longest causal range first (blockIdx.y = 0 is the last tile),
// so the long tiles do not trail the grid.  The block reads its KV head
// h / (H / KH) straight from the (B, S, KH, hd) layout.
//   * K/V tiles of 64 rows are copied by cp.async (16 bytes a thread,
//     zero-filled past S) into a double-buffered ring in shared memory:
//     the next tile lands while the current one is multiplied.  Rows are
//     padded by 16 bytes, so every ldmatrix of 8 rows hits 8 distinct
//     bank groups and every shared address is a per-thread base plus a
//     constant.  K and V fragments are double-buffered in registers, so
//     the next step's ldmatrix is in flight while this step's mmas run.
//   * S = Q K^T with mma.sync m16n8k16 (bf16 operands, f32 accumulators);
//     Q's A fragments stay in registers for the whole KV loop.  The f32
//     scores are multiplied by hd^-0.5 after the product (the Pallas
//     kernel scales q in f32 first: one f32 rounding of the score apart).
//   * The causal, window and ragged-S masks and the online softmax run in
//     registers; a row's (m, l) are reduced over the 4 threads of a quad
//     with shuffles.  No score goes through shared memory.  The masks are
//     applied only to tiles that a warp's rows see in part (the diagonal,
//     the window's edge, the ragged end); the exponentials are ex2 of
//     scores in log2 units.
//   * O += P V keeps P's precision: p_hi = bf16(p) and p_lo = bf16(p -
//     p_hi) go through two mmas into the same f32 accumulator, so P keeps
//     ~16 bits, where bf16 alone would keep 8 (the plain version and the
//     Pallas kernel keep P in f32, and the split keeps the kernel no
//     less precise than them; it costs 1.5x the tensor-core FLOPs, a
//     size this latency-bound barely feels).  P's C fragments are the
//     next mma's A fragments register for register; V's B fragments come
//     from ldmatrix.trans.
//   * The epilogue multiplies by 1 / max(l, 1e-20) (the plain version
//     divides: one f32 rounding apart), rounds to bf16 and stores through
//     shared memory as 16-byte rows.
// Fully masked tiles are skipped as in flash_kernel; within a visited
// tile a warp's fully masked rows add p = 0 and keep their (m, l, O).
// What bounds it: at a prefill of S = 512 one block's serial chain of
// S / 64 KV tiles does, not the card's throughput (the same prompt with
// one block per SM takes ~3/4 of the full grid's time; PERF.md).
//
// HD 256 (gemma3_12b) keeps the layout but not the register budget: a
// warp's 16 x 256 O accumulator is 128 f32 a thread, and Q's fragments
// held for the whole loop would add 64 more, past the 255-register cap
// once S, the K fragments and the addresses are counted.  So at HD 256
// Q's fragments are read again from the Q tile with ldmatrix at each k
// step (one more ldmatrix per 2 mmas), and the KV tile is 32 rows
// (tc_bk), which halves S and the K fragments; the ring then takes 101 KB
// of shared memory, two blocks to an SM.  HD 64 and 128 compile as
// before.
//
// HD 80 (opt_2_7b) is 5 x 16: 5 k steps of Q K^T and 5 pairs of n-tiles of
// P V, all from the same code, with no padded column in device memory or
// in the mmas.  Only the copies differ: a row is 10 chunks of 16 bytes,
// which do not divide the 128 threads into whole rows, so the copies walk
// a tile's 640 chunks flat, 5 a thread (tile_copy_flat).  A padded row of
// 176 bytes still puts the 8 rows of an ldmatrix 12 banks apart.
// --------------------------------------------------------------------------

constexpr int TC_BQ = 64;            // query rows per block (16 per warp)
constexpr int TC_BK = 64;            // KV rows per tile
constexpr int TC_NT = 128;           // 4 warps

// KV rows per tile of flash_tc_kernel<HD>: TC_BK, halved at HD 256
template <int HD>
__host__ __device__ constexpr int tc_bk() { return HD > 128 ? TC_BK / 2 : TC_BK; }

// The max and the sum of 2 or 4 partial values, as a tree
template <int N>
__device__ __forceinline__ float tree_max(const float (&t)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 values");
  if constexpr (N == 4) return fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3]));
  else return fmaxf(t[0], t[1]);
}
template <int N>
__device__ __forceinline__ float tree_sum(const float (&t)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 values");
  if constexpr (N == 4) return (t[0] + t[1]) + (t[2] + t[3]);
  else return t[0] + t[1];
}

// The split of two f32 weights into bf16 hi = bf16(x) and lo =
// bf16(x - hi) halves, each pair packed (x in bits 0-15).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16),
                 y - __uint_as_float(hi & 0xffff0000u));
}

// 2^x, one MUFU op; 2^(-huge) = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile's online softmax for a thread's two rows (qpos), in
// registers.  s holds the raw scores of its NJ n-tiles (8 KV rows each; 8,
// or 4 at HD 256) on entry (element e
// of n-tile j: row qpos[e >> 1], column c0 + 8 j + (e & 1)) and the
// weights p on exit.  Scores are taken in log2 units, s * hd^-0.5 *
// log2(e), so that p = 2^(s2 - m) is one ex2; (m, l) are reduced over the
// quad with shuffles, l kept as this thread's partial sum.  MASK: apply
// the causal, window and ragged-S masks (a tile the rows see only partly).
// A row with no valid score yet keeps l = 0 and o = 0 whatever its m.
template <bool MASK, int NJ>
__device__ __forceinline__ void tile_softmax(float (&s)[NJ][4], float (&m_r)[2],
                                             float (&l_r)[2], float (&alpha)[2],
                                             const int (&qpos)[2], int c0,
                                             const FlashArgs& a, float scale2) {
  auto valid = [&](int j, int e) -> bool {
    if (!MASK) return true;
    const int kpos = c0 + 8 * j + (e & 1), qp = qpos[e >> 1];
    bool ok = kpos < a.S;
    if (a.causal) ok = ok && kpos <= qp;
    if (a.window > 0) ok = ok && kpos > qp - a.window;
    return ok;
  };
  // the max over the raw scores (scale2 > 0 keeps their order), as a tree
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!valid(j, e)) s[j][e] = NEG_INF;
  }
  float mx[2], rsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t4[NJ / 2];
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j)
      t4[j] = fmaxf(fmaxf(s[2 * j][2 * i], s[2 * j][2 * i + 1]),
                    fmaxf(s[2 * j + 1][2 * i], s[2 * j + 1][2 * i + 1]));
    mx[i] = tree_max(t4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i] * scale2);
    alpha[i] = ex2(m_r[i] - m_new);
    m_r[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = valid(j, e) ? ex2(fmaf(s[j][e], scale2, -m_r[e >> 1])) : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t4[NJ / 2];
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j)
      t4[j] = (s[2 * j][2 * i] + s[2 * j][2 * i + 1]) +
              (s[2 * j + 1][2 * i] + s[2 * j + 1][2 * i + 1]);
    rsum[i] = tree_sum(t4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rsum[i];
}

// Bytes of one shared-memory row of a (rows, HD) bf16 tile: padded by 16
// bytes, so the 8 rows an ldmatrix reads start 4 banks apart and hit 8
// distinct bank groups, and every address is a base plus a constant.
template <int HD>
__host__ __device__ constexpr int tc_row_bytes() { return (HD + 8) * 2; }

// cp.async of a tile of ROWS rows of a (rows, HD) bf16 panel (row stride
// `stride` elements, `src` at its row 0) into padded shared rows at `dst`,
// for head dims whose HD / 8 chunks a row do not divide the TC_NT
// threads: chunk c = tid + TC_NT i of the tile's ROWS x HD / 8, rows
// row0 + r at or past S zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void tile_copy_flat(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               size_t stride, int row0,
                                               int S, int tid) {
  constexpr int CH = HD / 8, RB = tc_row_bytes<HD>();
  static_assert(ROWS * CH % TC_NT == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / TC_NT; ++i) {
    const int c = tid + TC_NT * i, r = c / CH, cc = c % CH;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * RB + cc * 16,
               src + (size_t)(ok ? row0 + r : 0) * stride + cc * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_NT) flash_tc_kernel(FlashArgs a) {
  static_assert(HD == 64 || HD == 80 || HD == 128 || HD == 256,
                "HD: 64, 80, 128 or 256");
  constexpr int CH = HD / 8;             // 16-byte chunks per row
  constexpr int KSTEP = HD / 16;         // k steps of Q K^T; n-tile pairs of P V
  constexpr int RB = tc_row_bytes<HD>();
  constexpr int BK = tc_bk<HD>();        // KV rows per tile
  constexpr int NJ = BK / 8;             // n-tiles of S
  constexpr bool Q_REGS = HD <= 128;     // Q's fragments held in registers
  constexpr int TILE_B = BK * RB;        // one K or V tile
  constexpr int RPI = TC_NT / CH;        // rows one pass of copies covers
  constexpr bool FLAT = TC_NT % CH != 0; // HD 80: tile_copy_flat
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Q tile (later the output tile), then 2 stages of (K tile, V tile)
  const uint32_t q_sa = smem_u32(smem_raw), kv_sa = q_sa + TC_BQ * RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const int S = a.S;
  const size_t q_row = (size_t)a.H * HD, kv_row = (size_t)a.KH * HD;

  // copies: this thread moves chunk cc of rows cr + RPI i of every tile
  // (FLAT: the panels' row 0 is qg, kg, vg less cc 8)
  const int cr = tid / CH, cc = tid % CH;
  const uint32_t cp_off = cr * RB + cc * 16;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            ((size_t)b * S * a.H + h) * HD + cc * 8;
  const size_t kv0 = ((size_t)b * S * a.KH + kh) * HD + cc * 8;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + kv0;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + kv0;
  if constexpr (FLAT) {
    tile_copy_flat<HD, TC_BQ>(q_sa, qg - cc * 8, q_row, q0, S, tid);
  } else {
#pragma unroll
    for (int i = 0; i < TC_BQ / RPI; ++i) {
      const int qp = q0 + cr + RPI * i;
      const bool ok = qp < S;
      cp_async16(q_sa + cp_off + i * RPI * RB,
                 qg + (size_t)(ok ? qp : 0) * q_row, ok);
    }
  }
  auto load_kv = [&](int t, int stage) {
    if constexpr (FLAT) {
      const uint32_t dst = kv_sa + stage * 2 * TILE_B;
      tile_copy_flat<HD, BK>(dst, kg - cc * 8, kv_row, t * BK, S, tid);
      tile_copy_flat<HD, BK>(dst + TILE_B, vg - cc * 8, kv_row, t * BK, S,
                             tid);
    } else {
      const uint32_t dst = kv_sa + stage * 2 * TILE_B + cp_off;
#pragma unroll
      for (int i = 0; i < BK / RPI; ++i) {
        const int kpos = t * BK + cr + RPI * i;
        const bool ok = kpos < S;
        const size_t off = (size_t)(ok ? kpos : 0) * kv_row;
        cp_async16(dst + i * RPI * RB, kg + off, ok);
        cp_async16(dst + TILE_B + i * RPI * RB, vg + off, ok);
      }
    }
  };

  const int q_last = min(q0 + TC_BQ, S) - 1;
  const int k_hi = a.causal ? q_last + 1 : S;                       // exclusive
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;   // inclusive
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;
  load_kv(t_lo, 0);
  cp_async_commit();                    // Q and the first K/V tile
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix.x4: lanes 8m..8m+7 give the row addresses of matrix m
  const int mi = lane >> 3, l7 = lane & 7;
  // Q's A fragments: a0..a3 = (rows 0-7 | 8-15) x (k 0-7 | 8-15); held in
  // registers (Q_REGS) or read again at each k step (HD 256)
  const uint32_t qa =
      q_sa + (warp * 16 + (mi & 1) * 8 + l7) * RB + (mi >> 1) * 16;
  uint32_t qf[Q_REGS ? KSTEP : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) ldsm_x4(qa + kk * 32, qf[kk]);
  }
  // K's B fragments for n-tiles (2p, 2p+1) and k step kk: + p 16 RB + kk 32
  const uint32_t k_off = ((mi >> 1) * 8 + l7) * RB + (mi & 1) * 16;
  // V's (transposed) for KV rows 16 kk.. and n-tiles (2p, 2p+1):
  // + kk 16 RB + p 32
  const uint32_t v_off = TILE_B + ((mi & 1) * 8 + l7) * RB + (mi >> 1) * 16;

  float o[2 * KSTEP][4];
#pragma unroll
  for (int j = 0; j < 2 * KSTEP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + warp * 16 + (lane >> 2),
                       q0 + warp * 16 + (lane >> 2) + 8};
  const float scale2 = a.scale * 1.4426950408889634f;   // hd^-0.5 log2(e)

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t st_sa = kv_sa + stage * 2 * TILE_B;

    // the masks apply only where the tile is not wholly inside every
    // row's range for this warp's 16 rows
    const int c0 = t * BK + 2 * (lane & 3);
    const int w_lo = q0 + warp * 16, k_last = t * BK + BK - 1;
    const bool full = k_last < S && (!a.causal || k_last <= w_lo) &&
                      (a.window <= 0 || t * BK > w_lo + 15 - a.window);

    // S = Q K^T: NJ n-tiles of 8 KV rows
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      // K fragments double-buffered over k steps: step kk + 1's loads are
      // in flight while step kk's mmas run
      uint32_t kb[2][NJ / 2][4];
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p)
        ldsm_x4(st_sa + k_off + p * 16 * RB, kb[0][p]);
#pragma unroll
      for (int kk = 0; kk < KSTEP; ++kk) {
        if (kk + 1 < KSTEP) {
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p)
            ldsm_x4(st_sa + k_off + p * 16 * RB + (kk + 1) * 32,
                    kb[(kk + 1) & 1][p]);
        }
        if constexpr (Q_REGS) {
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p) {
            mma_bf16(s[2 * p], qf[kk], kb[kk & 1][p][0], kb[kk & 1][p][1]);
            mma_bf16(s[2 * p + 1], qf[kk], kb[kk & 1][p][2],
                     kb[kk & 1][p][3]);
          }
        } else {
          uint32_t qk[4];
          ldsm_x4(qa + kk * 32, qk);
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p) {
            mma_bf16(s[2 * p], qk, kb[kk & 1][p][0], kb[kk & 1][p][1]);
            mma_bf16(s[2 * p + 1], qk, kb[kk & 1][p][2], kb[kk & 1][p][3]);
          }
        }
      }
    }

    // the online softmax
    float alpha[2];
    if (full)
      tile_softmax<false, NJ>(s, m_r, l_r, alpha, qpos, c0, a, scale2);
    else
      tile_softmax<true, NJ>(s, m_r, l_r, alpha, qpos, c0, a, scale2);
#pragma unroll
    for (int j = 0; j < 2 * KSTEP; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P V over NJ / 2 k steps of 16 KV rows; P's A fragment for k
    // step kk is n-tiles 2kk and 2kk+1 of S, split into bf16 hi and lo
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // V fragments double-buffered over n-tile pairs
      uint32_t vb[2][4];
      ldsm_x4_trans(st_sa + v_off + kk * 16 * RB, vb[0]);
#pragma unroll
      for (int p = 0; p < KSTEP; ++p) {
        if (p + 1 < KSTEP)
          ldsm_x4_trans(st_sa + v_off + kk * 16 * RB + (p + 1) * 32,
                        vb[(p + 1) & 1]);
        const uint32_t* b = vb[p & 1];
        mma_bf16(o[2 * p], ph, b[0], b[1]);
        mma_bf16(o[2 * p + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * p], pl, b[0], b[1]);
        mma_bf16(o[2 * p + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                    // the stage is free for tile t + 2
  }

  // epilogue: the warp's 16 rows, normalised, through its own rows of the
  // Q tile
  float l_inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_inv[i] = 1.f / fmaxf(l, 1e-20f);
  }
  unsigned char* row0 = smem_raw + (warp * 16 + (lane >> 2)) * RB +
                        4 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2 * KSTEP; ++j) {
    *reinterpret_cast<uint32_t*>(row0 + j * 16) =
        pack_bf16(o[j][0] * l_inv[0], o[j][1] * l_inv[0]);
    *reinterpret_cast<uint32_t*>(row0 + 8 * RB + j * 16) =
        pack_bf16(o[j][2] * l_inv[1], o[j][3] * l_inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) +
                      ((size_t)b * S * a.H + h) * HD;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(og + (size_t)(q0 + r) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(smem_raw + r * RB + c * 16);
  }
}

// --------------------------------------------------------------------------
// Decode, split over the KV sequence: decode_split_tc_kernel (bf16 q, bf16
// or int8 pools, HD 64 / 80 / 128 / 256, G <= 16) or decode_split_kernel
// (the rest), then decode_merge_kernel.
//
// The grid is (B * KH, n_split): block (b kh, j) owns the logical KV rows
// [j split, j split + split) of row b, KV head kh, for the G = H / KH query
// heads of the group.  split = decode_split_rows(blk_c, HD) divides the
// page, so a split lies inside one page: one page-table lookup gives its
// physical base, and an int8 split has one K and one V scale.  n_split =
// ceil(rows / split) comes from the cache's length, its chunk and HD
// alone, never from B, KH, G or pos, so every decode step launches the
// same grid and a head group of the mesh splits as the whole does.  Each
// block writes its split's raw (acc, m, l) to a workspace.  A block whose
// rows all lie outside the row's [lo, hi) (for the partial: whose rows
// the mask empties) writes the empty partial m = NEG_INF, l = 0, acc = 0
// and reads nothing else.  decode_merge_kernel then folds the splits of
// each (row, head) in split order, an empty one weighted by 0
// (merge_dim).  The fused variant merges `extra` and
// normalises, the partial writes the raw (acc, m, l).  No float atomics:
// the order of every sum is fixed by the logical rows, so a paged and a
// dense walk over the same logical data give the same bits, and a row's
// output does not depend on the other rows of the batch.
// --------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;               // (B, 1, H, hd)
  const void* k;               // (B, KH, S, hd), T or int8
  const void* v;
  const int* pos;              // fused: (B,) last valid logical slot
  const uint8_t* valid;        // partial: (B, S) mask
  const int* pages;            // fused, paged: (B, n_log) physical page ids
  int n_log;
  const float* acc_e;          // fused: optional extra partial (B, H, hd)
  const float* m_e;            //   (B, H)
  const float* l_e;            //   (B, H)
  const float* k_scale;        // fused, int8 K/V: (B, KH, n_sc) per
  const float* v_scale;        //   physical page
  int n_sc;
  void* out;                   // fused: (B, 1, H, hd) in q's type
  float* acc_out;              // partial, fused partial: (B, H, hd)
  float* m_out;                // partial, fused partial: (B, H)
  float* l_out;                // partial, fused partial: (B, H)
  float* ws_acc;               // (B, KH, n_split, G, hd) split partials
  float* ws_m;                 // (B, KH, n_split, G)
  float* ws_l;                 // (B, KH, n_split, G)
  int H, KH, S, HD;
  int blk_c;                   // fused: chunk (= page) length
  int split, n_split;          // rows per split (<= 128, divides blk_c)
  int window;                  // fused: 0 = no lower bound
  float scale;
};

constexpr int DS_TILE = 64;          // KV rows a tile: 4 warps x 16
constexpr int DS_SPLIT_MAX = 2 * DS_TILE;   // most rows a split holds
// tiles a tensor-core split may hold: two at HD 64, one at the others
// (their O accumulators, 2 to 8 times HD 64's, stay out of a tile loop)
__host__ __device__ constexpr int ds_tiles(int hd) { return hd == 64 ? 2 : 1; }
constexpr int DS_NT = 128;           // tensor-core split: 4 warps
constexpr int DS_GMAX = 16;          // query heads of a group, padded to 16

// Block (blockIdx.x, blockIdx.y)'s rows: logical [L0, L0 + len) of row b,
// and the row's attended range [lo, hi) (the partial's mask is per slot).
template <bool PARTIAL>
__device__ __forceinline__ void split_rows(const DecodeArgs& a, int b,
                                           int& L0, int& len, int& lo,
                                           int& hi) {
  const int n_rows = (!PARTIAL && a.pages) ? a.n_log * a.blk_c : a.S;
  L0 = blockIdx.y * a.split;
  len = min(a.split, n_rows - L0);
  lo = 0;
  hi = n_rows;
  if (!PARTIAL) {
    const int pos = a.pos[b];
    hi = min(hi, pos + 1);
    if (a.window > 0) lo = max(0, pos - a.window + 1);
  }
}

// The split's physical first row and its page (the scale's index).
__device__ __forceinline__ int split_page(const DecodeArgs& a, bool paged,
                                          int b, int L0, int& phys0) {
  int page = L0 / a.blk_c;
  phys0 = L0;
  if (paged) {
    page = a.pages[(size_t)b * a.n_log + page];
    phys0 = page * a.blk_c + L0 % a.blk_c;
  }
  return page;
}

// Whether the block has any row to attend: the fused range test, or the
// partial's mask over the split (uniform across the block).
template <bool PARTIAL>
__device__ __forceinline__ bool split_any(const DecodeArgs& a, int b, int L0,
                                          int len, int lo, int hi) {
  if (!PARTIAL) return max(lo, L0) < min(hi, L0 + len);
  const uint8_t* vrow = a.valid + (size_t)b * a.S + L0;
  int any = 0;
  for (int r = threadIdx.x; r < len; r += blockDim.x) any |= vrow[r];
  return __syncthreads_or(any) != 0;
}

template <bool PARTIAL>
__device__ __forceinline__ bool slot_valid(const DecodeArgs& a, int b,
                                           int kpos, int lo, int hi) {
  if (PARTIAL) return a.valid[(size_t)b * a.S + kpos] != 0;
  return kpos >= lo && kpos < hi;
}

// The empty partial of a split with nothing to attend.
__device__ __forceinline__ void write_empty(const DecodeArgs& a, size_t part0,
                                            int G) {
  for (int i = threadIdx.x; i < G * a.HD; i += blockDim.x)
    a.ws_acc[part0 * a.HD + i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    a.ws_m[part0 + g] = NEG_INF;
    a.ws_l[part0 + g] = 0.f;
  }
}

// Splits whose m, l and acc a merge thread loads in one round.
constexpr int DM_BATCH = 8;

// The splits of one (row b, head h), dim d, in split order: the largest m
// (exact in any order), then acc and l of every split weighted by
// exp(m_j - m), an empty split (m_j = NEG_INF, acc and l 0) by 0, so that
// adding it changes no bit and no load waits on a branch; the loads go
// out DM_BATCH splits at a time.  Fused: the current token's (acc, m, l)
// merged, then normalised, or with acc_out set (the fused partial)
// written raw; partial: the raw (acc, m, l).  A raw m is -inf when
// nothing was attended.
template <typename T, bool PARTIAL>
__device__ __forceinline__ void merge_dim(const DecodeArgs& a, int b, int h,
                                          int d) {
  const int G = a.H / a.KH, kh = h / G, g = h % G, n = a.n_split;
  const size_t first = ((size_t)b * a.KH + kh) * n * G + g;
  const size_t head = (size_t)b * a.H + h;
  const float* m_j = a.ws_m + first;
  const float* l_j = a.ws_l + first;
  const float* x_j = a.ws_acc + first * a.HD + d;
  float m = NEG_INF;
#pragma unroll 8
  for (int j = 0; j < n; ++j) m = fmaxf(m, m_j[(size_t)j * G]);
  float acc = 0.f, l = 0.f;
  for (int j0 = 0; j0 < n; j0 += DM_BATCH) {
    float mj[DM_BATCH], lj[DM_BATCH], xj[DM_BATCH];
#pragma unroll
    for (int k = 0; k < DM_BATCH; ++k) {
      const size_t p = (size_t)min(j0 + k, n - 1) * G;
      mj[k] = m_j[p];
      lj[k] = l_j[p];
      xj[k] = x_j[p * a.HD];
    }
#pragma unroll
    for (int k = 0; k < DM_BATCH; ++k) {
      if (j0 + k < n) {
        const float w = mj[k] <= NEG_INF / 2 ? 0.f : expf(mj[k] - m);
        acc = fmaf(xj[k], w, acc);
        l = fmaf(lj[k], w, l);
      }
    }
  }
  if (PARTIAL) {
    a.acc_out[head * a.HD + d] = acc;
    if (d == 0) {
      // NEG_INF sentinel -> -inf so a merge ignores empty partials
      a.m_out[head] = m <= NEG_INF / 2 ? -INFINITY : m;
      a.l_out[head] = l;
    }
    return;
  }
  float mr = m;
  if (a.acc_e) {
    // the current token's (acc, m, l), merged before normalisation; each
    // product rounded before the sum, as the plain version's and the
    // chunked schedule's torch merges round them, whatever the compiler
    // would contract: with one chunk that schedule's output is this one's,
    // bit for bit (chip_smoke.py, rp vs bs)
    const float me = a.m_e[head];
    const float mm = fmaxf(m, me);
    const float a1 = expf(m - mm), a2 = expf(me - mm);
    acc = __fadd_rn(__fmul_rn(acc, a1), __fmul_rn(a.acc_e[head * a.HD + d], a2));
    l = __fadd_rn(__fmul_rn(l, a1), __fmul_rn(a.l_e[head], a2));
    mr = mm;
  }
  if (a.acc_out) {
    // the fused partial: a head group's statistics, normalised by the
    // caller after they are gathered (the same division as below)
    a.acc_out[head * a.HD + d] = acc;
    if (d == 0) {
      a.m_out[head] = mr <= NEG_INF / 2 ? -INFINITY : mr;
      a.l_out[head] = l;
    }
    return;
  }
  static_cast<T*>(a.out)[head * a.HD + d] = from_f<T>(acc / fmaxf(l, 1e-20f));
}

// CUDA-core split: the f32 route (and the shapes the tensor-core kernel
// does not take).  T: the type of q; KV: the type of the pools, T or int8_t
// (then each element is dequantized as q * scale in f32, as the plain
// version does).  The G x len scores, then G x HD sums, on the CUDA cores.
template <typename T, typename KV, bool PARTIAL>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeArgs a) {
  constexpr bool SCALED = std::is_same<KV, int8_t>::value;
  extern __shared__ float sm[];
  const int b = blockIdx.x / a.KH, kh = blockIdx.x % a.KH;
  const int G = a.H / a.KH, HD = a.HD, TK = a.split, LD = HD + 1;
  float* q_s = sm;                    // G * HD, pre-scaled query
  float* k_s = q_s + G * HD;          // TK * LD
  float* v_s = k_s + TK * LD;         // TK * LD
  float* p_s = v_s + TK * LD;         // G * TK scores, then probabilities
  float* m_s = p_s + G * TK;          // G
  float* l_s = m_s + G;               // G
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t part0 = ((size_t)blockIdx.x * a.n_split + blockIdx.y) * G;

  int L0, len, lo, hi;
  split_rows<PARTIAL>(a, b, L0, len, lo, hi);
  if (!split_any<PARTIAL>(a, b, L0, len, lo, hi)) {
    write_empty(a, part0, G);
    return;
  }
  int phys0;
  const int page = split_page(a, !PARTIAL && a.pages, b, L0, phys0);
  float ksc = 1.f, vsc = 1.f;
  if (SCALED) {
    const size_t si = ((size_t)b * a.KH + kh) * a.n_sc + page;
    ksc = a.k_scale[si];
    vsc = a.v_scale[si];
  }
  const T* qg = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kh * G) * HD;
  const size_t base = (((size_t)b * a.KH + kh) * a.S + phys0) * HD;
  const KV* kb = static_cast<const KV*>(a.k) + base;
  const KV* vb = static_cast<const KV*>(a.v) + base;
  for (int i = tid; i < G * HD; i += NT) q_s[i] = to_f(qg[i]) * a.scale;
  for (int i = tid; i < len * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float kv = to_f(kb[i]), vv = to_f(vb[i]);
    if (SCALED) {                 // the reference's quants * scale, in f32
      kv = __fmul_rn(kv, ksc);
      vv = __fmul_rn(vv, vsc);
    }
    k_s[r * LD + d] = kv;
    v_s[r * LD + d] = vv;
  }
  __syncthreads();

  for (int i = tid; i < G * TK; i += NT) {
    const int g = i / TK, c = i % TK;
    float s = NEG_INF;
    if (c < len && slot_valid<PARTIAL>(a, b, L0 + c, lo, hi)) {
      const float* qq = q_s + g * HD;
      const float* kk = k_s + c * LD;
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc = fmaf(qq[d], kk[d], acc);
      s = acc;
    }
    p_s[i] = s;
  }
  __syncthreads();

  for (int g = warp; g < G; g += NWARP) {
    float mx = NEG_INF;
    for (int c = lane; c < len; c += 32) mx = fmaxf(mx, p_s[g * TK + c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < len; c += 32) {
      const bool ok = slot_valid<PARTIAL>(a, b, L0 + c, lo, hi);
      const float p = ok ? expf(p_s[g * TK + c] - mx) : 0.f;
      p_s[g * TK + c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    const float* pp = p_s + g * TK;
    float s = 0.f;
    for (int c = 0; c < len; ++c) s = fmaf(pp[c], v_s[c * LD + d], s);
    a.ws_acc[part0 * HD + i] = s;
  }
  for (int g = tid; g < G; g += NT) {
    a.ws_m[part0 + g] = m_s[g];
    a.ws_l[part0 + g] = l_s[g];
  }
}

// cp.async.wait_group with a count known only at run time (0 to 3: the
// K and V groups of a split's at most two tiles).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// The tensor-core split's shared memory: the Q tile (G heads padded to 16
// rows), the max partials of two tiles and the sum partials of the 4
// warps, then one stage per tile of the split: the bf16 K and V tiles
// and, for int8 pools, the int8 rows they are widened from.
constexpr int DS_RED_BYTES = (2 * 4 * 16 + 4 * 16) * 4;
template <int HD>
__host__ __device__ constexpr int ds_stage0() {
  return DS_GMAX * tc_row_bytes<HD>() + DS_RED_BYTES;
}
template <int HD, bool I8>
__host__ __device__ constexpr int ds_stage_bytes() {
  return 2 * DS_TILE * tc_row_bytes<HD>() + (I8 ? 2 * DS_TILE * (HD + 16) : 0);
}

// Tensor-core split, after flash_tc_kernel: 4 warps; the split's rows are
// walked in tiles of 64, and warp w owns rows 16 w .. 16 w + 15 of each.
//   * The G query heads, padded with zero rows to 16, are the A operand of
//     mma.sync m16n8k16 (bf16 in, f32 accumulators); K and V come from
//     shared memory through ldmatrix (V transposed), rows padded by 16
//     bytes.  Every tile's K and V are issued up front by 16-byte cp.async,
//     one copy group each (Q goes with tile 0's K) into a stage of their
//     own: tile 1 lands while tile 0 is multiplied, and V while the scores
//     are formed.  Rows past the split are zero-filled.
//   * int8 pools: the int8 rows are copied as they are and widened to bf16
//     in shared memory (exact: int8 values are bf16 integers).  The
//     split's page has one K and one V scale: the K scale multiplies the
//     f32 scores after the product, the V scale the split's f32 P V.  No
//     dequantized q * scale is ever rounded to bf16.
//   * The scores are multiplied by hd^-0.5 after the product (the plain
//     version scales q in f32 first: one f32 rounding apart).  A tile's row
//     max goes over a quad by shuffles, then over the 4 warps through
//     shared memory, in warp order; the running m, and the warp's l and O,
//     are rescaled by exp(m_old - m_new) at each tile (the online softmax;
//     with one tile it is the plain softmax of the split, bit for bit).
//   * P V keeps P's precision as flash_tc_kernel does: p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi) through two mmas into one f32 accumulator.
//     The 4 warps' O and l are summed through shared memory in warp order.
// What bounds it: the K/V bytes it must read (4 flops a byte pair, far
// under the ridge) and, at the main path's shapes, one block's chain of
// latencies.  At hd 64 the two shapes that lost to cuDNN were set by that
// chain and by the merge: whisper's dense cross read (B 4, 20 heads on 20
// KV heads, 1,500 frames in chunks of 125) ran 60 splits of 25 rows a row,
// 4,800 blocks each paying the copies, three barriers and the O reduction
// for 6.4 KB of K/V with 39 of 64 tile rows zero, and a merge whose threads
// walked the 60 splits as a chain of dependent L2 reads (half the device
// time: PERF.md, Findings); granite_moe_3b (24 heads on 8, page 128) ran
// 1,024 blocks of 16 KB and a merge over 32 splits.  So at hd 64 a split is
// a whole chunk of up to 128 rows (whisper: one split of 125 rows a chunk,
// 12 a row, 960 blocks of 32 KB; granite: 16 splits of 128), walked in two
// tiles, and the merge loads DM_BATCH splits at a time with no branch
// before them.  Two ways of folding the merge into this launch were built
// and measured slower (PERF.md, Findings): a ticket a (row, KV head), the
// last block to finish merging (every block's fence and ticket atomic add
// two L2 round trips to its life, and the tickets' memset is a launch too),
// and the splits of a (row, KV head) as one thread-block cluster merging
// through distributed shared memory (80 clusters of 12 blocks do not fit
// one wave).  At HD 80, 128 and 256 a split is one tile of at most 64 rows,
// as before: their O accumulators, 2 to 8 times HD 64's, stay out of a tile
// loop, and their code is the earlier kernel's.  HD 256 keeps the layout:
// Q's fragments are read per k step, the warp's O (128 f32 a thread) is the
// one large register array, and the 4 x 16 f32 rows of the O reduction fill
// stage 0's K and V tiles exactly; HD 80 is 5 k steps and 5 n-tile pairs of
// the same code, an int8 row 5 chunks.  MHA (whisper, opt_2_7b) fills 1 of
// the mma's 16 rows: there the split is bound by its bytes and latency, not
// by the mmas.
template <int HD, typename KV, bool PARTIAL>
__global__ void __launch_bounds__(DS_NT) decode_split_tc_kernel(DecodeArgs a) {
  static_assert(HD == 64 || HD == 80 || HD == 128 || HD == 256,
                "HD: 64, 80, 128 or 256");
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  constexpr int RB = tc_row_bytes<HD>();       // padded bf16 row
  constexpr int CH = HD / 8;                   // 16-byte chunks, bf16 row
  constexpr int KSTEP = HD / 16;               // k steps of Q K^T
  constexpr int RB8 = HD + 16;                 // padded int8 row
  constexpr int CH8 = HD / 16;                 // 16-byte chunks, int8 row
  constexpr int TILE = DS_TILE * RB;           // a bf16 K or V tile
  constexpr int STAGE = ds_stage_bytes<HD, I8>();
  constexpr int OLD = HD + 8;                  // padded f32 row of O
  // stage t: K tile, V tile, then (int8) the int8 K and V rows
  constexpr int RED_OFF = DS_GMAX * RB, ST_OFF = ds_stage0<HD>();
  static_assert(4 * 16 * OLD * 4 <= 2 * TILE, "O reduction fits K and V");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sa = smem_u32(smem_raw);
  float* red_m = reinterpret_cast<float*>(smem_raw + RED_OFF);   // [2][4][16]
  float* red_l = red_m + 2 * 4 * 16;                             // [4][16]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.KH, kh = blockIdx.x % a.KH;
  const int G = a.H / a.KH;
  const size_t part0 = ((size_t)blockIdx.x * a.n_split + blockIdx.y) * G;

  constexpr int TILES = ds_tiles(HD);
  int L0, len, lo, hi;
  split_rows<PARTIAL>(a, b, L0, len, lo, hi);
  if (!split_any<PARTIAL>(a, b, L0, len, lo, hi)) {
    write_empty(a, part0, G);
    return;
  }
  int phys0;
  const int page = split_page(a, !PARTIAL && a.pages, b, L0, phys0);
  const int n_tiles = TILES == 1 ? 1 : (len + DS_TILE - 1) / DS_TILE;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            ((size_t)b * a.H + (size_t)kh * G) * HD;
  for (int c = tid; c < DS_GMAX * CH; c += DS_NT) {
    const int r = c / CH, cc = c % CH;
    const bool ok = r < G;
    cp_async16(sa + r * RB + cc * 16, qg + (size_t)(ok ? r : 0) * HD + cc * 8,
               ok);
  }
  const size_t base = (((size_t)b * a.KH + kh) * a.S + phys0) * HD;
  // tile t's rows of K or V into shared memory at `off`
  auto load = [&](const void* src, int t, int off) {
    const int r0 = t * DS_TILE;
    if (I8) {
      const int8_t* g = static_cast<const int8_t*>(src) + base;
      for (int c = tid; c < DS_TILE * CH8; c += DS_NT) {
        const int r = c / CH8, cc = c % CH8;
        const bool ok = r0 + r < len;
        cp_async16(sa + off + r * RB8 + cc * 16,
                   g + (size_t)(ok ? r0 + r : 0) * HD + cc * 16, ok);
      }
    } else {
      const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(src) + base;
      for (int c = tid; c < DS_TILE * CH; c += DS_NT) {
        const int r = c / CH, cc = c % CH;
        const bool ok = r0 + r < len;
        cp_async16(sa + off + r * RB + cc * 16,
                   g + (size_t)(ok ? r0 + r : 0) * HD + cc * 8, ok);
      }
    }
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int st = ST_OFF + t * STAGE;
    load(a.k, t, I8 ? st + 2 * TILE : st);
    cp_async_commit();                       // (Q and) tile t's K
    load(a.v, t, I8 ? st + 2 * TILE + DS_TILE * RB8 : st + TILE);
    cp_async_commit();                       // tile t's V
  }
  // int8 rows -> bf16 rows, 16 values a step
  auto widen = [&](int src_off, int dst_off) {
    for (int c = tid; c < DS_TILE * CH8; c += DS_NT) {
      const int r = c / CH8, cc = c % CH8;
      const uint4 w = *reinterpret_cast<const uint4*>(
          smem_raw + src_off + r * RB8 + cc * 16);
      const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // byte e of the word, sign-extended: (int)(w << (24 - 8 e)) >> 24
        const uint32_t x = wd[i];
        o[2 * i] = pack_bf16((float)(static_cast<int>(x << 24) >> 24),
                             (float)(static_cast<int>(x << 16) >> 24));
        o[2 * i + 1] = pack_bf16((float)(static_cast<int>(x << 8) >> 24),
                                 (float)(static_cast<int>(x) >> 24));
      }
      uint4* dst = reinterpret_cast<uint4*>(smem_raw + dst_off + r * RB + cc * 32);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };
  float ksc = 1.f, vsc = 1.f;
  if (I8) {
    const size_t si = ((size_t)b * a.KH + kh) * a.n_sc + page;
    ksc = a.k_scale[si];
    vsc = a.v_scale[si];
  }

  const int mi = lane >> 3, l7 = lane & 7;
  // element e of n-tile j: head row[e >> 1], tile row
  // 16 warp + 8 j + 2 (lane & 3) + (e & 1)
  const int row[2] = {lane >> 2, (lane >> 2) + 8};
  const float qk = a.scale;
  float m_run[2], l_w[2];
  float o[2 * KSTEP][4];
#pragma unroll
  for (int j = 0; j < 2 * KSTEP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // tile 0 sets (m, l) and O; a later tile rescales them first (its
  // copy of the unrolled body knows t)
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    if (TILES > 1 && t == n_tiles) break;
    const int st = ST_OFF + t * STAGE;
    if constexpr (TILES == 1)
      cp_async_wait<1>();                    // Q and K
    else
      cp_async_wait_upto(2 * (n_tiles - 1 - t) + 1);   // Q, tile t's K
    __syncthreads();
    if (I8) {
      widen(st + 2 * TILE, st);
      __syncthreads();
    }
    // S = Q K^T over the warp's 16 rows of the tile: 2 n-tiles of 8
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const uint32_t qa = sa + ((mi & 1) * 8 + l7) * RB + (mi >> 1) * 16;
      const uint32_t ka = sa + st + (warp * 16 + (mi >> 1) * 8 + l7) * RB +
                          (mi & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < KSTEP; ++kk) {
        uint32_t qf[4], kf[4];
        ldsm_x4(qa + kk * 32, qf);
        ldsm_x4(ka + kk * 32, kf);
        mma_bf16(s[0], qf, kf[0], kf[1]);
        mma_bf16(s[1], qf, kf[2], kf[3]);
      }
    }
    bool ok[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = t * DS_TILE + warp * 16 + 8 * j + 2 * (lane & 3) + (e & 1);
        ok[j][e] = c < len && slot_valid<PARTIAL>(a, b, L0 + c, lo, hi);
        s[j][e] = ok[j][e] ? (I8 ? s[j][e] * ksc * qk : s[j][e] * qk)
                           : NEG_INF;
      }
    float* rm = red_m + (t & 1) * 64;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                       fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if ((lane & 3) == 0) rm[warp * 16 + row[i]] = mx;
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mt = fmaxf(fmaxf(rm[row[i]], rm[16 + row[i]]),
                             fmaxf(rm[32 + row[i]], rm[48 + row[i]]));
      if (t == 0) {
        m_run[i] = mt;
      } else {
        const float m_new = fmaxf(m_run[i], mt);
        alpha[i] = expf(m_run[i] - m_new);
        m_run[i] = m_new;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = ok[j][e] ? expf(s[j][e] - m_run[e >> 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = (s[0][2 * i] + s[0][2 * i + 1]) +
                  (s[1][2 * i] + s[1][2 * i + 1]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_w[i] = t == 0 ? sum : l_w[i] * alpha[i] + sum;
    }
    if constexpr (TILES == 1)
      cp_async_wait<0>();                    // V
    else
      cp_async_wait_upto(2 * (n_tiles - 1 - t));     // tile t's V
    __syncthreads();
    if (I8) {
      widen(st + 2 * TILE + DS_TILE * RB8, st + TILE);
      __syncthreads();
    }

    // O_w = O_w alpha + P V over the warp's 16 rows (one k step), P split
    // into hi / lo
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
    if (t > 0) {
#pragma unroll
      for (int j = 0; j < 2 * KSTEP; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }
    }
    const uint32_t va = sa + st + TILE +
                        (warp * 16 + (mi & 1) * 8 + l7) * RB + (mi >> 1) * 16;
#pragma unroll
    for (int p = 0; p < KSTEP; ++p) {
      uint32_t vf[4];
      ldsm_x4_trans(va + p * 32, vf);
      mma_bf16(o[2 * p], ph, vf[0], vf[1]);
      mma_bf16(o[2 * p + 1], ph, vf[2], vf[3]);
      mma_bf16(o[2 * p], pl, vf[0], vf[1]);
      mma_bf16(o[2 * p + 1], pl, vf[2], vf[3]);
    }
  }
  __syncthreads();                           // every tile is read
  float* red_o = reinterpret_cast<float*>(smem_raw + ST_OFF);  // [4][16][OLD]
#pragma unroll
  for (int j = 0; j < 2 * KSTEP; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(red_o + (warp * 16 + row[0]) * OLD + col) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(red_o + (warp * 16 + row[1]) * OLD + col) =
        make_float2(o[j][2], o[j][3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if ((lane & 3) == 0) red_l[warp * 16 + row[i]] = l_w[i];
  // every thread holds its rows' m (one tile: the max of red_m, below);
  // warp 0's quad leaders write it
  if (TILES > 1 && warp == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < G) a.ws_m[part0 + row[i]] = m_run[i];
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += DS_NT) {
    const int g = i / HD, d = i % HD;
    const float acc = ((red_o[g * OLD + d] + red_o[(16 + g) * OLD + d]) +
                       red_o[(32 + g) * OLD + d]) +
                      red_o[(48 + g) * OLD + d];
    a.ws_acc[part0 * HD + i] = I8 ? acc * vsc : acc;
  }
  for (int g = tid; g < G; g += DS_NT) {
    if (TILES == 1)
      a.ws_m[part0 + g] = fmaxf(fmaxf(red_m[g], red_m[16 + g]),
                                fmaxf(red_m[32 + g], red_m[48 + g]));
    a.ws_l[part0 + g] = ((red_l[g] + red_l[16 + g]) + red_l[32 + g]) +
                        red_l[48 + g];
  }
}

// The merge of either split kernel's splits: one block per (b, h), a
// thread per dim (merge_dim).
constexpr int DM_NT = 128;

template <typename T, bool PARTIAL>
__global__ void __launch_bounds__(DM_NT) decode_merge_kernel(DecodeArgs a) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  for (int d = threadIdx.x; d < a.HD; d += DM_NT)
    merge_dim<T, PARTIAL>(a, b, h, d);
}

// Shared memory above 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The CUDA-core split's shared memory: q, K, V, scores, (m, l).
size_t decode_smem(int G, int HD, int TK) {
  return sizeof(float) * ((size_t)G * HD + (size_t)2 * TK * (HD + 1) +
                          (size_t)G * TK + 2 * (size_t)G);
}

// The tensor-core split's shared memory for splits of `split` rows: one
// stage per 64-row tile.
template <int HD, bool I8>
size_t decode_tc_smem(int split) {
  return (size_t)ds_stage0<HD>() +
         (size_t)((split + DS_TILE - 1) / DS_TILE) * ds_stage_bytes<HD, I8>();
}

// The split kernel on the grid (B * KH, n_split), then the merge on B * H
// blocks.  tc: the tensor-core split (bf16 q, HD 64, 80, 128 or 256,
// G <= 16, at most ds_tiles(HD) tiles a split); anything else it is asked
// for is refused with cudaErrorInvalidValue.
template <typename T, typename KV, bool PARTIAL>
int run_decode(const DecodeArgs& a, int B, int tc, cudaStream_t stream) {
  const dim3 grid(B * a.KH, a.n_split);
  cudaError_t err;
  if (a.split < 1 || a.split > DS_SPLIT_MAX) return (int)cudaErrorInvalidValue;
  if (tc) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      constexpr bool I8 = std::is_same<KV, int8_t>::value;
      if (a.H / a.KH > DS_GMAX ||
          (a.HD != 64 && a.HD != 80 && a.HD != 128 && a.HD != 256) ||
          a.split > ds_tiles(a.HD) * DS_TILE)
        return (int)cudaErrorInvalidValue;
      auto kernel = a.HD == 256   ? decode_split_tc_kernel<256, KV, PARTIAL>
                    : a.HD == 128 ? decode_split_tc_kernel<128, KV, PARTIAL>
                    : a.HD == 80  ? decode_split_tc_kernel<80, KV, PARTIAL>
                                  : decode_split_tc_kernel<64, KV, PARTIAL>;
      const size_t smem = a.HD == 256   ? decode_tc_smem<256, I8>(a.split)
                          : a.HD == 128 ? decode_tc_smem<128, I8>(a.split)
                          : a.HD == 80  ? decode_tc_smem<80, I8>(a.split)
                                        : decode_tc_smem<64, I8>(a.split);
      err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<grid, DS_NT, smem, stream>>>(a);
    } else {
      return (int)cudaErrorInvalidValue;      // bf16 q only
    }
  } else {
    const size_t smem = decode_smem(a.H / a.KH, a.HD, a.split);
    auto kernel = decode_split_kernel<T, KV, PARTIAL>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NT, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T, PARTIAL><<<B * a.H, DM_NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The workspace of B * KH * n_split * G rows: acc (hd floats a row), then
// m, then l.
void set_workspace(DecodeArgs& a, float* ws, int B) {
  const size_t rows = (size_t)B * a.KH * a.n_split * (a.H / a.KH);
  a.ws_acc = ws;
  a.ws_m = ws + rows * a.HD;
  a.ws_l = a.ws_m + rows;
}

template <typename T>
int run_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (a.HD + 1) +
                                       (size_t)2 * BK * (a.HD + 1) +
                                       (size_t)BQ * BK + (size_t)BQ * a.HD + 3 * BQ);
  auto kernel = flash_kernel<T>;
  dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int run_flash_tc(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(TC_BQ + 4 * tc_bk<HD>()) * tc_row_bytes<HD>();
  auto kernel = flash_tc_kernel<HD>;
  dim3 grid(B * a.H, (a.S + TC_BQ - 1) / TC_BQ);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TC_NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16.
extern "C" {

// k_scale / v_scale non-null: k and v are int8 pools with n_sc scales per
// (row, KV head), one per physical page of blk_c rows.  ws: f32 workspace
// of B * KH * n_split * G * (hd + 2) floats.  tc: 1 = the tensor-core
// split.
int rt_decode_fused(int dtype, int tc, const void* q, const void* k,
                    const void* v, const int* pos, const int* pages, int n_log,
                    const float* acc_e, const float* m_e, const float* l_e,
                    const float* k_scale, const float* v_scale, int n_sc,
                    void* out, float* ws, int B, int H, int KH, int S, int HD,
                    int blk_c, int split, int n_split, int window, float scale,
                    void* stream) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.pages = pages; a.n_log = n_log;
  a.acc_e = acc_e; a.m_e = m_e; a.l_e = l_e; a.out = out;
  a.k_scale = k_scale; a.v_scale = v_scale; a.n_sc = n_sc;
  a.H = H; a.KH = KH; a.S = S; a.HD = HD; a.blk_c = blk_c;
  a.split = split; a.n_split = n_split; a.window = window; a.scale = scale;
  set_workspace(a, ws, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scale)
    return dtype == 1 ? run_decode<__nv_bfloat16, int8_t, false>(a, B, tc, s)
                      : run_decode<float, int8_t, false>(a, B, tc, s);
  return dtype == 1
             ? run_decode<__nv_bfloat16, __nv_bfloat16, false>(a, B, tc, s)
             : run_decode<float, float, false>(a, B, tc, s);
}

// The fused route with the raw-statistics epilogue: rt_decode_fused's
// inputs, and f32 acc (B, H, hd), m (B, H), l (B, H) in place of out.
int rt_decode_fused_partial(int dtype, int tc, const void* q, const void* k,
                            const void* v, const int* pos, const int* pages,
                            int n_log, const float* acc_e, const float* m_e,
                            const float* l_e, const float* k_scale,
                            const float* v_scale, int n_sc, float* acc,
                            float* m, float* l, float* ws, int B, int H,
                            int KH, int S, int HD, int blk_c, int split,
                            int n_split, int window, float scale,
                            void* stream) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.pages = pages; a.n_log = n_log;
  a.acc_e = acc_e; a.m_e = m_e; a.l_e = l_e;
  a.acc_out = acc; a.m_out = m; a.l_out = l;
  a.k_scale = k_scale; a.v_scale = v_scale; a.n_sc = n_sc;
  a.H = H; a.KH = KH; a.S = S; a.HD = HD; a.blk_c = blk_c;
  a.split = split; a.n_split = n_split; a.window = window; a.scale = scale;
  set_workspace(a, ws, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scale)
    return dtype == 1 ? run_decode<__nv_bfloat16, int8_t, false>(a, B, tc, s)
                      : run_decode<float, int8_t, false>(a, B, tc, s);
  return dtype == 1
             ? run_decode<__nv_bfloat16, __nv_bfloat16, false>(a, B, tc, s)
             : run_decode<float, float, false>(a, B, tc, s);
}

int rt_decode_partial(int dtype, int tc, const void* q, const void* k,
                      const void* v, const uint8_t* valid, float* acc,
                      float* m, float* l, float* ws, int B, int H, int KH,
                      int C, int HD, int split, int n_split, float scale,
                      void* stream) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v; a.valid = valid;
  a.acc_out = acc; a.m_out = m; a.l_out = l;
  a.H = H; a.KH = KH; a.S = C; a.HD = HD; a.blk_c = C;
  a.split = split; a.n_split = n_split; a.scale = scale;
  set_workspace(a, ws, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? run_decode<__nv_bfloat16, __nv_bfloat16, true>(a, B, tc, s)
             : run_decode<float, float, true>(a, B, tc, s);
}

int rt_flash_attention(int dtype, const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int KH, int HD,
                       int causal, int window, float scale, void* stream) {
  FlashArgs a = {};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.S = S; a.H = H; a.KH = KH; a.HD = HD; a.causal = causal;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_flash<__nv_bfloat16>(a, B, s)
                    : run_flash<float>(a, B, s);
}

// bf16 only, HD 64, 80, 128 or 256, 16-byte-aligned bases (the wrapper's
// route); any other HD is refused with cudaErrorInvalidValue.
int rt_flash_attention_tc(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int KH, int HD,
                          int causal, int window, float scale, void* stream) {
  FlashArgs a = {};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.S = S; a.H = H; a.KH = KH; a.HD = HD; a.causal = causal;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 256) return run_flash_tc<256>(a, B, s);
  if (HD == 128) return run_flash_tc<128>(a, B, s);
  if (HD == 80) return run_flash_tc<80>(a, B, s);
  if (HD == 64) return run_flash_tc<64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
