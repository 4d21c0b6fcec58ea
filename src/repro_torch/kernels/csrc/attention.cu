// Hand-written Hopper (sm_90a) attention kernels of the serving main path.
//
// Three kernels, each the port of one Pallas TPU kernel in
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
//       Causal / sliding-window GQA prefill attention with online softmax.
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
// by operations (989 TFLOP/s bf16 on the tensor cores); this kernel does
// its products on the CUDA cores in f32, far below that bound.  wgmma,
// TMA and split-K are later work.
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

}  // extern "C"
