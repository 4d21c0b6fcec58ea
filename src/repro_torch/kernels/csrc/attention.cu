// Hand-written Hopper (sm_90a) attention kernels of the serving main path.
//
// Four kernels, each the port of one Pallas TPU kernel in
// src/repro/kernels/flash_attention.py:
//
//   decode_fused_kernel   <- _decode_fused_kernel / decode_attention_fused
//       One-shot flash decode of one query token per row against the whole
//       KV cache: (acc, m, l) accumulate over the cache inside one block,
//       the current token's `extra` partial is merged in the epilogue and
//       the normalised output is written once.  Dense or paged (per-row
//       page table indexing the row's own (KH, S, hd) panel), per-row
//       `pos`, optional sliding window, GQA.  Its int8 variant (the
//       `has_scales` branch of the Pallas kernel) reads int8 K/V pools
//       and multiplies each tile by its page's f32 scale as it lands in
//       shared memory, before the dots; the scale is looked up through
//       the same indirection as the tile (physical page pages[b, j] when
//       paged, page j when dense).  A tile never straddles a page, so it
//       has one scale, and paged == dense holds bitwise as for fp pools.
//   decode_partial_kernel <- _decode_partial_kernel / decode_attention_partial
//       The raw, unnormalised (acc, m, l) of one query token over a KV
//       chunk under an explicit (B, C) mask; m = -inf for an empty row.
//   flash_kernel          <- _flash_kernel / flash_attention
//       Causal / sliding-window GQA prefill attention with online softmax,
//       on the CUDA cores in f32: the kernel for f32 inputs and for head
//       dims the tensor-core kernel does not take.
//   flash_tc_kernel<HD>   <- _flash_kernel / flash_attention
//       The same function on the tensor cores, for bf16 with HD 64 or
//       128 (see its own note below).
//
// Translation from the TPU: the Pallas grids run their innermost KV axis in
// order on one core and carry (acc, m, l) in VMEM scratch between grid
// steps.  Here one thread block owns one (row, KV head) for decode and one
// (row, head, q tile) for prefill, and a loop over KV tiles inside the
// block takes the place of the sequential grid axis; (acc, m, l) live in
// shared memory in f32.  bf16 or f32 I/O, converted with the intrinsics.
//
// What bounds them on an H100: decode reads every valid K/V byte once and
// does 4 flops per byte pair, far below the 295 flop/byte ridge, so it is
// bound by HBM bytes (3.35 TB/s); the int8 variant halves those bytes.  At the main path's shapes it has only
// B*KH = 8 blocks for 132 SMs, so it runs far from that bound: a split
// over the sequence would fix that, and is left out on purpose, because
// a paged walk and a dense walk over the same logical data must take the
// identical reduction order (paged == dense, bitwise).  Prefill is bound
// by operations (989 TFLOP/s bf16 on the tensor cores); flash_kernel does
// its products on the CUDA cores in f32, far below that bound, and
// flash_tc_kernel on the tensor cores.
//
// Tiles that the mask empties entirely are skipped.  That is bitwise the
// same as visiting them: a fully masked tile leaves m unchanged, so alpha
// is exp(0) = 1 and p = 0, and acc * 1 + 0 and l * 1 + 0 are exact.
//
// Each entry point returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

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
// Decode: one block per (row b, KV head kh); the G = H / KH query heads of
// the group share every K/V tile.
// --------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;               // (B, 1, H, hd)
  const void* k;               // (B, KH, S, hd)
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
  void* out;                   // fused: (B, 1, H, hd) in the input type
  float* acc_out;              // partial: (B, H, hd)
  float* m_out;                // partial: (B, H)
  float* l_out;                // partial: (B, H)
  int H, KH, S, HD;
  int blk_c;                   // fused: chunk (= page) length
  int tile;                    // rows per KV tile; divides blk_c when fused
  int window;                  // fused: 0 = no lower bound
  float scale;
};

// T: the type of q and out; KV: the type of the K/V pools, T or int8_t
// (then with per-page scales).
template <typename T, typename KV, bool PARTIAL>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeArgs a) {
  constexpr bool SCALED = std::is_same<KV, int8_t>::value;
  extern __shared__ float sm[];
  const int b = blockIdx.x / a.KH, kh = blockIdx.x % a.KH;
  const int G = a.H / a.KH, HD = a.HD, TK = a.tile, LD = HD + 1;
  float* q_s = sm;                    // G * HD, pre-scaled query
  float* k_s = q_s + G * HD;          // TK * LD
  float* v_s = k_s + TK * LD;         // TK * LD
  float* p_s = v_s + TK * LD;         // G * TK scores, then probabilities
  float* acc_s = p_s + G * TK;        // G * HD
  float* m_s = acc_s + G * HD;        // G
  float* l_s = m_s + G;               // G
  float* al_s = l_s + G;              // G
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* qg = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kh * G) * HD;
  const size_t panel = ((size_t)b * a.KH + kh) * (size_t)a.S * HD;
  const KV* kb = static_cast<const KV*>(a.k) + panel;
  const KV* vb = static_cast<const KV*>(a.v) + panel;

  for (int i = tid; i < G * HD; i += NT) {
    q_s[i] = to_f(qg[i]) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) { m_s[g] = NEG_INF; l_s[g] = 0.f; }

  // logical rows visited: [lo, hi)
  const int n_rows = PARTIAL ? a.S : (a.pages ? a.n_log * a.blk_c : a.S);
  int lo = 0, hi = n_rows, pos = 0;
  if (!PARTIAL) {
    pos = a.pos[b];
    hi = min(hi, pos + 1);
    if (a.window > 0) lo = max(0, pos - a.window + 1);
  }
  const int t0 = lo / TK;
  const int t1 = hi > lo ? (hi + TK - 1) / TK : t0;
  const uint8_t* vrow = PARTIAL ? a.valid + (size_t)b * a.S : nullptr;
  auto is_valid = [&](int kpos) -> bool {
    if (PARTIAL) return kpos < n_rows && vrow[kpos] != 0;
    return kpos <= pos && (a.window <= 0 || kpos > pos - a.window);
  };
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int L0 = t * TK;
    const int nr = min(TK, n_rows - L0);
    if (PARTIAL) {
      int any = 0;
      for (int r = tid; r < nr; r += NT) any |= vrow[L0 + r];
      if (!__syncthreads_or(any)) continue;   // uniform across the block
    }
    int phys0 = L0, page = L0 / a.blk_c;
    if (!PARTIAL && a.pages) {
      page = a.pages[(size_t)b * a.n_log + page];
      phys0 = page * a.blk_c + (L0 % a.blk_c);
    }
    float ksc = 1.f, vsc = 1.f;
    if (SCALED) {
      const size_t si = ((size_t)b * a.KH + kh) * a.n_sc + page;
      ksc = a.k_scale[si];
      vsc = a.v_scale[si];
    }
    for (int i = tid; i < TK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      float kv = 0.f, vv = 0.f;
      if (r < nr) {
        const size_t off = (size_t)(phys0 + r) * HD + d;
        kv = to_f(kb[off]);
        vv = to_f(vb[off]);
        if (SCALED) {             // the reference's quants * scale, in f32
          kv = __fmul_rn(kv, ksc);
          vv = __fmul_rn(vv, vsc);
        }
      }
      k_s[r * LD + d] = kv;
      v_s[r * LD + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, c = i % TK;
      float s = NEG_INF;
      if (c < nr && is_valid(L0 + c)) {
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
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, p_s[g * TK + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < TK; c += 32) {
        const bool ok = c < nr && is_valid(L0 + c);
        const float p = ok ? expf(p_s[g * TK + c] - m_new) : 0.f;
        p_s[g * TK + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        al_s[g] = al;
        l_s[g] = l_s[g] * al + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      const float* pp = p_s + g * TK;
      float s = 0.f;
      for (int c = 0; c < TK; ++c) s = fmaf(pp[c], v_s[c * LD + d], s);
      acc_s[i] = acc_s[i] * al_s[g] + s;
    }
    __syncthreads();
  }

  const size_t head0 = (size_t)b * a.H + (size_t)kh * G;
  if (PARTIAL) {
    for (int i = tid; i < G * HD; i += NT) a.acc_out[head0 * HD + i] = acc_s[i];
    for (int g = tid; g < G; g += NT) {
      const float m = m_s[g];
      // NEG_INF sentinel -> -inf so a merge ignores empty partials
      a.m_out[head0 + g] = m <= NEG_INF / 2 ? -INFINITY : m;
      a.l_out[head0 + g] = l_s[g];
    }
    return;
  }
  T* out = static_cast<T*>(a.out) + head0 * HD;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float acc = acc_s[i], l = l_s[g];
    if (a.acc_e) {
      // the current token's (acc, m, l), merged before normalisation
      const float m = m_s[g], me = a.m_e[head0 + g];
      const float mm = fmaxf(m, me);
      const float a1 = expf(m - mm), a2 = expf(me - mm);
      acc = acc * a1 + a.acc_e[(head0 + g) * HD + d] * a2;
      l = l * a1 + a.l_e[head0 + g] * a2;
    }
    out[i] = from_f<T>(acc / fmaxf(l, 1e-20f));
  }
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
// Prefill on the tensor cores: flash_tc_kernel<HD>, bf16, HD 64 or 128.
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
// --------------------------------------------------------------------------

constexpr int TC_BQ = 64;            // query rows per block (16 per warp)
constexpr int TC_BK = 64;            // KV rows per tile
constexpr int TC_NT = 128;           // 4 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
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
// registers.  s holds the raw scores of its 8 n-tiles on entry (element e
// of n-tile j: row qpos[e >> 1], column c0 + 8 j + (e & 1)) and the
// weights p on exit.  Scores are taken in log2 units, s * hd^-0.5 *
// log2(e), so that p = 2^(s2 - m) is one ex2; (m, l) are reduced over the
// quad with shuffles, l kept as this thread's partial sum.  MASK: apply
// the causal, window and ragged-S masks (a tile the rows see only partly).
// A row with no valid score yet keeps l = 0 and o = 0 whatever its m.
template <bool MASK>
__device__ __forceinline__ void tile_softmax(float (&s)[8][4], float (&m_r)[2],
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
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!valid(j, e)) s[j][e] = NEG_INF;
  }
  float mx[2], rsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t4[j] = fmaxf(fmaxf(s[2 * j][2 * i], s[2 * j][2 * i + 1]),
                    fmaxf(s[2 * j + 1][2 * i], s[2 * j + 1][2 * i + 1]));
    mx[i] = fmaxf(fmaxf(t4[0], t4[1]), fmaxf(t4[2], t4[3]));
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
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = valid(j, e) ? ex2(fmaf(s[j][e], scale2, -m_r[e >> 1])) : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t4[j] = (s[2 * j][2 * i] + s[2 * j][2 * i + 1]) +
              (s[2 * j + 1][2 * i] + s[2 * j + 1][2 * i + 1]);
    rsum[i] = (t4[0] + t4[1]) + (t4[2] + t4[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rsum[i];
}

// Bytes of one shared-memory row of a (rows, HD) bf16 tile: padded by 16
// bytes, so the 8 rows an ldmatrix reads start 4 banks apart and hit 8
// distinct bank groups, and every address is a base plus a constant.
template <int HD>
__host__ __device__ constexpr int tc_row_bytes() { return (HD + 8) * 2; }

template <int HD>
__global__ void __launch_bounds__(TC_NT) flash_tc_kernel(FlashArgs a) {
  static_assert(HD % 64 == 0, "HD: 64 or 128");
  constexpr int CH = HD / 8;             // 16-byte chunks per row
  constexpr int KSTEP = HD / 16;         // k steps of Q K^T; n-tile pairs of P V
  constexpr int RB = tc_row_bytes<HD>();
  constexpr int TILE_B = TC_BK * RB;     // one K or V tile
  constexpr int RPI = TC_NT / CH;        // rows one pass of copies covers
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
  const int cr = tid / CH, cc = tid % CH;
  const uint32_t cp_off = cr * RB + cc * 16;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            ((size_t)b * S * a.H + h) * HD + cc * 8;
  const size_t kv0 = ((size_t)b * S * a.KH + kh) * HD + cc * 8;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + kv0;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + kv0;
#pragma unroll
  for (int i = 0; i < TC_BQ / RPI; ++i) {
    const int qp = q0 + cr + RPI * i;
    const bool ok = qp < S;
    cp_async16(q_sa + cp_off + i * RPI * RB, qg + (size_t)(ok ? qp : 0) * q_row,
               ok);
  }
  auto load_kv = [&](int t, int stage) {
    const uint32_t dst = kv_sa + stage * 2 * TILE_B + cp_off;
#pragma unroll
    for (int i = 0; i < TC_BK / RPI; ++i) {
      const int kpos = t * TC_BK + cr + RPI * i;
      const bool ok = kpos < S;
      const size_t off = (size_t)(ok ? kpos : 0) * kv_row;
      cp_async16(dst + i * RPI * RB, kg + off, ok);
      cp_async16(dst + TILE_B + i * RPI * RB, vg + off, ok);
    }
  };

  const int q_last = min(q0 + TC_BQ, S) - 1;
  const int k_hi = a.causal ? q_last + 1 : S;                       // exclusive
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;   // inclusive
  const int t_lo = k_lo / TC_BK, t_hi = (k_hi + TC_BK - 1) / TC_BK;
  load_kv(t_lo, 0);
  cp_async_commit();                    // Q and the first K/V tile
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix.x4: lanes 8m..8m+7 give the row addresses of matrix m
  const int mi = lane >> 3, l7 = lane & 7;
  // Q's A fragments: a0..a3 = (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  uint32_t qf[KSTEP][4];
  {
    const uint32_t qa =
        q_sa + (warp * 16 + (mi & 1) * 8 + l7) * RB + (mi >> 1) * 16;
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
    const int c0 = t * TC_BK + 2 * (lane & 3);
    const int w_lo = q0 + warp * 16, k_last = t * TC_BK + TC_BK - 1;
    const bool full = k_last < S && (!a.causal || k_last <= w_lo) &&
                      (a.window <= 0 || t * TC_BK > w_lo + 15 - a.window);

    // S = Q K^T: 8 n-tiles of 8 KV rows
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      // K fragments double-buffered over k steps: step kk + 1's loads are
      // in flight while step kk's mmas run
      uint32_t kb[2][4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ldsm_x4(st_sa + k_off + p * 16 * RB, kb[0][p]);
#pragma unroll
      for (int kk = 0; kk < KSTEP; ++kk) {
        if (kk + 1 < KSTEP) {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            ldsm_x4(st_sa + k_off + p * 16 * RB + (kk + 1) * 32,
                    kb[(kk + 1) & 1][p]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          mma_bf16(s[2 * p], qf[kk], kb[kk & 1][p][0], kb[kk & 1][p][1]);
          mma_bf16(s[2 * p + 1], qf[kk], kb[kk & 1][p][2], kb[kk & 1][p][3]);
        }
      }
    }

    // the online softmax
    float alpha[2];
    if (full)
      tile_softmax<false>(s, m_r, l_r, alpha, qpos, c0, a, scale2);
    else
      tile_softmax<true>(s, m_r, l_r, alpha, qpos, c0, a, scale2);
#pragma unroll
    for (int j = 0; j < 2 * KSTEP; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P V over 4 k steps of 16 KV rows; P's A fragment for k step kk
    // is n-tiles 2kk and 2kk+1 of S, split into bf16 hi and lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
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

// Shared memory above 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t decode_smem(int G, int HD, int TK) {
  return sizeof(float) * ((size_t)2 * G * HD + (size_t)2 * TK * (HD + 1) +
                          (size_t)G * TK + 3 * (size_t)G);
}

template <typename T, typename KV, bool PARTIAL>
int run_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = decode_smem(a.H / a.KH, a.HD, a.tile);
  auto kernel = decode_kernel<T, KV, PARTIAL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * a.KH), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  const size_t smem = (size_t)(TC_BQ + 4 * TC_BK) * tc_row_bytes<HD>();
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
// (row, KV head), one per physical page of blk_c rows.
int rt_decode_fused(int dtype, const void* q, const void* k, const void* v,
                    const int* pos, const int* pages, int n_log,
                    const float* acc_e, const float* m_e, const float* l_e,
                    const float* k_scale, const float* v_scale, int n_sc,
                    void* out, int B, int H, int KH, int S, int HD,
                    int blk_c, int tile, int window, float scale,
                    void* stream) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.pages = pages; a.n_log = n_log;
  a.acc_e = acc_e; a.m_e = m_e; a.l_e = l_e; a.out = out;
  a.k_scale = k_scale; a.v_scale = v_scale; a.n_sc = n_sc;
  a.H = H; a.KH = KH; a.S = S; a.HD = HD; a.blk_c = blk_c; a.tile = tile;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scale)
    return dtype == 1 ? run_decode<__nv_bfloat16, int8_t, false>(a, B, s)
                      : run_decode<float, int8_t, false>(a, B, s);
  return dtype == 1 ? run_decode<__nv_bfloat16, __nv_bfloat16, false>(a, B, s)
                    : run_decode<float, float, false>(a, B, s);
}

int rt_decode_partial(int dtype, const void* q, const void* k, const void* v,
                      const uint8_t* valid, float* acc, float* m, float* l,
                      int B, int H, int KH, int C, int HD, int tile,
                      float scale, void* stream) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v; a.valid = valid;
  a.acc_out = acc; a.m_out = m; a.l_out = l;
  a.H = H; a.KH = KH; a.S = C; a.HD = HD; a.blk_c = C; a.tile = tile;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_decode<__nv_bfloat16, __nv_bfloat16, true>(a, B, s)
                    : run_decode<float, float, true>(a, B, s);
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

// bf16 only, HD 64 or 128, 16-byte-aligned bases (the wrapper's route);
// any other HD is refused with cudaErrorInvalidValue.
int rt_flash_attention_tc(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int KH, int HD,
                          int causal, int window, float scale, void* stream) {
  FlashArgs a = {};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.S = S; a.H = H; a.KH = KH; a.HD = HD; a.causal = causal;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return run_flash_tc<128>(a, B, s);
  if (HD == 64) return run_flash_tc<64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
