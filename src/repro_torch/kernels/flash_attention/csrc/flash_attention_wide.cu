// Flash attention forward for Hopper (sm_90a) at any head_dim: the
// counterpart of the Pallas kernel flash_attention_padded
// (src/repro/kernels/flash_attention/flash_attention.py:68) for the head
// dims the tensor-core kernels (flash_attention.cu, flash_attention_bf16.cu,
// built for 64, 80, 128 and 256) do not take: head_dim above 256, in
// float32, bfloat16 and float16.
//
//   q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> o (B, Sq, H, hd),
//
// query head h reads kv head h / (H / KV).  What the reference's kernel
// computes: float32 attention on the widened values, per kv tile s = (q .
// k) * scale; masked entries are NEG = -1e30 and weigh 0; m_new = max(m,
// rowmax s); p = exp(s - m_new); l = exp(m - m_new) * l + rowsum p; acc =
// acc * exp(m - m_new) + p . v; o = acc / max(l, 1e-30), rounded once to
// the output's dtype.  Masks: query < Sq, key < Skv, causal (q >= k),
// window (q - k < window).
//
// A simple design, on the CUDA cores, float32 FMA throughout:
//
//   * A block takes 64 query rows of one (batch, head) and one chunk of
//     DC = 128 output columns (the grid's third dimension), and walks the
//     key tiles of 32 keys that its rows can see.  Each block recomputes
//     its rows' scores over the FULL head_dim, 64 columns of q and K at a
//     time through shared memory, so no head_dim is capped and no block
//     holds more than 128 output columns: at head_dim 512 the scores are
//     computed four times over (a column chunk each).
//   * 256 threads: thread t holds row t / 4 and, of each tile, the scores
//     of keys 8 (t % 4) .. + 7 and the output columns 32 (t % 4) .. + 31 of
//     its chunk (32 float32 accumulators).  A row's four threads are
//     adjacent lanes: its max and its sum take two xor shuffles.
//   * P goes to shared memory (each row's 32 weights), V's tile columns
//     beside it, in the space the scores' q and K chunks used.
//   * Elements are loaded at their own dtype and widened exactly.
//
// Bound: operations (4 B H hd S^2 / 2 FLOP causal, plus the scores'
// recomputation per column chunk) on the FMA units; its times are in
// PERF.md.  No backward, as the reference's kernel has none.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows a block
constexpr int BK = 32;          // keys a tile
constexpr int DCH = 64;         // q and K columns a step of the scores
constexpr int DC = 128;         // output columns a block
constexpr int THREADS = 256;
constexpr int KPT = BK / 4;     // keys a thread
constexpr int CPT = DC / 4;     // output columns a thread
constexpr float NEG = -1e30f;

template <typename T> struct El;
template <> struct El<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct El<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};
template <> struct El<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void store(__half* p, float v) {
    *p = __float2half_rn(v);
  }
};

struct ScoreTiles {
  float q[BQ][DCH + 1];
  float k[BK][DCH + 1];
};
struct ValueTiles {
  float p[BQ][BK + 1];
  float v[BK][DC];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Sq,
                  int Skv, int H, int KV, int hd, float scale, int causal,
                  int window) {
  __shared__ union {
    ScoreTiles s;
    ValueTiles w;
  } sm;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int d0 = (int)blockIdx.z * DC;
  const int t = threadIdx.x, tr = t / 4, tk = t % 4;
  const int qi = q0 + tr;
  const int64_t q_row = (int64_t)H * hd, kv_row = (int64_t)KV * hd;
  const T* const qb = q + (int64_t)b * Sq * q_row + (int64_t)h * hd;
  const T* const kb = k + (int64_t)b * Skv * kv_row + (int64_t)g * hd;
  const T* const vb = v + (int64_t)b * Skv * kv_row + (int64_t)g * hd;

  // the keys any valid query of this block can see
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  k_begin = k_begin / BK * BK;

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = NEG, l = 0.f;          // the row's max, this thread's sum part

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += DCH) {
      __syncthreads();
      for (int e = t; e < BQ * DCH; e += THREADS) {
        const int r = e / DCH, c = e % DCH;
        sm.s.q[r][c] = (q0 + r < Sq && c0 + c < hd)
            ? El<T>::load(qb + (int64_t)(q0 + r) * q_row + c0 + c) : 0.f;
      }
      for (int e = t; e < BK * DCH; e += THREADS) {
        const int r = e / DCH, c = e % DCH;
        sm.s.k[r][c] = (k0 + r < Skv && c0 + c < hd)
            ? El<T>::load(kb + (int64_t)(k0 + r) * kv_row + c0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DCH; ++c) {
        const float x = sm.s.q[tr][c];
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          sc[j] = fmaf(x, sm.s.k[tk * KPT + j][c], sc[j]);
      }
    }
    // the online softmax of this tile's scores
    bool vis[KPT];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kp = k0 + tk * KPT + j;
      vis[j] = qi < Sq && kp < Skv && (!causal || qi >= kp)
               && (window <= 0 || qi - kp < window);
      sc[j] = vis[j] ? sc[j] * scale : NEG;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      sc[j] = vis[j] ? expf(sc[j] - mn) : 0.f;
      ps += sc[j];
    }
    l = alpha * l + ps;
    __syncthreads();                 // every thread is done with q and K
#pragma unroll
    for (int j = 0; j < KPT; ++j) sm.w.p[tr][tk * KPT + j] = sc[j];
    for (int e = t; e < BK * DC; e += THREADS) {
      const int r = e / DC, c = e % DC;
      sm.w.v[r][c] = (k0 + r < Skv && d0 + c < hd)
          ? El<T>::load(vb + (int64_t)(k0 + r) * kv_row + d0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = sm.w.p[tr][kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        acc[j] = fmaf(p, sm.w.v[kk][tk * CPT + j], acc[j]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (qi >= Sq) return;
  const float den = fmaxf(l, 1e-30f);
  T* const dst = o + ((int64_t)b * Sq + qi) * q_row + (int64_t)h * hd + d0
                 + tk * CPT;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (d0 + tk * CPT + j < hd) El<T>::store(dst + j, acc[j] / den);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t hd,
           float scale, int causal, int64_t window, cudaStream_t stream) {
  if (KV <= 0 || H % KV != 0 || hd < 1) return (int)cudaErrorInvalidValue;
  const int64_t nq = (Sq + BQ - 1) / BQ, nd = (hd + DC - 1) / DC;
  if (B * H > 0x7fffffffLL || nq > 65535 || nd > 65535
      || Sq > 0x7fffffffLL - BQ || Skv > 0x7fffffffLL - BK
      || hd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return 0;
  const int win = window >= 0x7fffffffLL ? 0x7fffffff : (int)window;
  const dim3 grid((unsigned)(B * H), (unsigned)nq, (unsigned)nd);
  flash_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)Sq, (int)Skv,
      (int)H, (int)KV, (int)hd, scale, causal, win);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous, at the entry's
// dtype; any hd >= 1.  window <= 0: no window.
#define LAG_FLASH_WIDE_ENTRY(NAME, T)                                        \
  int NAME(const void* q, const void* k, const void* v, void* o, int64_t B, \
           int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t hd,      \
           float scale, int causal, int64_t window, void* stream) {         \
    return launch<T>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal,      \
                     window, (cudaStream_t)stream);                         \
  }

LAG_FLASH_WIDE_ENTRY(lag_flash_attention_wide_f32, float)
LAG_FLASH_WIDE_ENTRY(lag_flash_attention_wide_bf16, __nv_bfloat16)
LAG_FLASH_WIDE_ENTRY(lag_flash_attention_wide_f16, __half)

}  // extern "C"
