// Fused RMSNorm for Hopper (sm_90a).
//
// Hand-written CUDA replacement of the Pallas kernel rmsnorm_2d
// (_rmsnorm_kernel) of src/repro/kernels/rmsnorm/rmsnorm.py:
//
//   y = (x * rsqrt(mean(x^2) + eps)).astype(out) * scale.astype(out)
//
// row by row over x (rows, d), float32, bfloat16 or float16 (out is x's
// dtype).  The reference's order of operations is kept: the row is
// multiplied by the rsqrt first, then by the scale, two separate roundings
// to out's dtype.  In a 2-byte dtype the mean of squares and the rsqrt stay
// float32 on the widened row (widening is exact, float16's subnormals
// included); then y = T(T(x * r) * scale), scale already at x's dtype (the
// wrapper casts a float32 scale as the reference does), each rounding to
// nearest even (float16: into its subnormals, and to +-inf past 65504).
//
// Two kernels.  rmsnorm_stream_kernel (below) takes rows whose byte length
// is a multiple of 8 and whose base is 16-byte aligned, up to d = 8192: the
// prefill's rows.  rmsnorm_rows_kernel (at the end) takes every other row
// the reference's kernel takes: any d >= 1, any alignment, any width.
//
// Bound: bytes.  Each element is read once and written once with a few
// flops between, so at prefill (8192 rows x 2048, bfloat16) the kernel
// moves 67 MB: 0.020 ms at the H100's 3.35 TB/s, far above its arithmetic.
// Reaching it takes tens of KB in flight on every SM, which a design that
// loads rows into registers pays for in registers and occupancy.  So the
// kernel streams rows through shared memory, both ways by TMA:
//
//   * A PERSISTENT GRID: two blocks a SM (one in float32, with a ring twice
//     as deep), each walking the tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ...; the grid is cut so that
//     every block walks as many tiles.  A tile is tile_rows consecutive
//     rows of the contiguous x: one contiguous range, in and out.
//   * TMA BOTH WAYS: one elected thread (warp 0, the producer) brings each
//     tile into a ring of >= 3 stages with one 1D bulk copy (cp.async.bulk
//     ... complete_tx on the stage's `full` mbarrier).  The eight consumer
//     warps normalise the tile in place and arrive on its `written`
//     mbarrier; the producer writes the stage back to y with one bulk
//     store and, once the store has read it, refills it with the tile a
//     ring ahead.  The next tiles' bytes are in flight while the current
//     one is reduced and written, bytes in flight cost no registers, and
//     every access to device memory is a bulk transfer of whole lines.
//     The loads carry an L2 evict-first hint (nothing is read twice); the
//     stores none, which ran faster at the widest rows.
//   * 16-BYTE ACCESSES IN BOTH DTYPES: a thread step is a chunk of eight
//     consecutive elements (one 16-byte shared-memory access of bfloat16,
//     two of float32), kept in registers from the fold to the write-back.
//     A bfloat16 row of d = 4 (mod 8) is 8 (mod 16) bytes long: its
//     instantiation takes 8-byte accesses, tiles of an even number of rows
//     (so every bulk copy starts 16-byte aligned), and the producer's own
//     8-byte copies of the last 8 bytes of an odd last tile, in and out.
//   * THE SCALE IS READ ONCE PER BLOCK: a thread's chunks are the same in
//     every row, so it keeps their scale in registers.
//   * ONE ELEMENT-TO-THREAD MAP AND ONE FOLD ORDER FOR BOTH DTYPES, fixed by
//     d alone: a row belongs to a team of W warps (W = 1, 2, 4, 8, the least
//     with 128 W >= its chunks, so a thread holds at most four chunks);
//     thread t of the team takes chunks t, t + 32 W, ...; it folds each
//     chunk's elements in order with fmaf, then a fixed xor butterfly of
//     shuffles, then the team's W warp sums are added in warp order.  No
//     atomics, nothing crosses a row: the bfloat16 row's rsqrt is bitwise
//     the float32 kernel's on the widened row, and a row gives the same bits
//     in any launch, whatever the number of rows.
//
// Shared memory: HEADER + stages x stage bytes, at most 229,888 bytes a
// block in float32 and 115,200 in bfloat16 (stages of <= 32 KB).
//
// Against a register design (a warp or a block a row, the row held in
// registers, loads and stores from the threads) the stream is faster up to
// d 2048 and 2-4 % slower at the widest float32 rows; a build with the consumers' work removed runs no
// faster, so the rest is the bulk stream's own rate, not the fold.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError();
// lag_rmsnorm_plan reports the tiling a stream launch picks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = WARP * (1 + CONSUMER_WARPS);   // + the producer warp
constexpr int MAX_D = 8192;
constexpr int MAX_CHUNKS = 4;        // chunks of eight a thread of a team
constexpr int TILE_BYTES = 16384;    // a stage's target size
constexpr int RING_BYTES_PER_SM = 229376;   // the rings' target on one SM
constexpr int MAX_STAGES = 12;
constexpr int HEADER = 512;          // 2 x MAX_STAGES mbarriers, partials

// blocks a SM for elements of `size` bytes: a float32 stage holds half the
// rows of a bfloat16 one, so float32 runs one block a SM with a ring twice
// as deep
constexpr int blocks_per_sm(int size) { return size == 4 ? 1 : 2; }

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
      :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// an L2 cache policy: the lines a bulk copy touches leave the L2 first
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(evict_first())
      : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory, in a bulk group
// (no cache hint: an evict-first store was slower at the widest rows)
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
               "[%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Chunks of eight elements: Io<T, A16>::Raw holds one as loaded, widen()
// gives its eight floats, the first four valid always and the last four
// where `two` (the chunk is whole: 8c + 4 < d).  A16: rows 16-byte aligned.
template <typename T, bool A16> struct Io;

template <> struct Io<float, true> {
  struct Raw { float4 a, b; };
  static __device__ __forceinline__ Raw load(const float* p, bool two) {
    Raw r;
    r.a = *reinterpret_cast<const float4*>(p);
    r.b = two ? *reinterpret_cast<const float4*>(p + 4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    return r;
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  }
  // y = (v * r) * s: float32's two roundings are the products'
  static __device__ __forceinline__ void store(float* p, const float (&v)[8],
                                               float r, const float (&s)[8],
                                               bool two) {
    float4 a, b;
    a.x = __fmul_rn(__fmul_rn(v[0], r), s[0]);
    a.y = __fmul_rn(__fmul_rn(v[1], r), s[1]);
    a.z = __fmul_rn(__fmul_rn(v[2], r), s[2]);
    a.w = __fmul_rn(__fmul_rn(v[3], r), s[3]);
    *reinterpret_cast<float4*>(p) = a;
    if (two) {
      b.x = __fmul_rn(__fmul_rn(v[4], r), s[4]);
      b.y = __fmul_rn(__fmul_rn(v[5], r), s[5]);
      b.z = __fmul_rn(__fmul_rn(v[6], r), s[6]);
      b.w = __fmul_rn(__fmul_rn(v[7], r), s[7]);
      *reinterpret_cast<float4*>(p + 4) = b;
    }
  }
};

// two 2-byte values packed in 32 bits (the first in the low half), widened
// exactly, and two floats rounded to nearest even into them
template <typename T> struct Pair;

template <> struct Pair<bf16> {
  static __device__ __forceinline__ float2 widen(uint32_t u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
  static __device__ __forceinline__ uint32_t round(float a, float b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <> struct Pair<__half> {
  static __device__ __forceinline__ float2 widen(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  static __device__ __forceinline__ uint32_t round(float a, float b) {
    const __half2 p = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

// T(T(v0 * r) * s0), T(T(v1 * r) * s1), packed
template <typename T>
__device__ __forceinline__ uint32_t norm2(float v0, float v1, float r,
                                          float s0, float s1) {
  const float2 q = Pair<T>::widen(Pair<T>::round(__fmul_rn(v0, r),
                                                 __fmul_rn(v1, r)));
  return Pair<T>::round(__fmul_rn(q.x, s0), __fmul_rn(q.y, s1));
}

// a 2-byte T (bfloat16 or float16): a chunk of eight is one 16-byte
// access, or two 8-byte ones where the rows are not 16-byte aligned
template <typename T, bool A16> struct Io2 {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const T* p, bool two) {
    if (A16) return *reinterpret_cast<const uint4*>(p);
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint2 b = two ? *reinterpret_cast<const uint2*>(p + 4)
                        : make_uint2(0u, 0u);
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    float2 t = Pair<T>::widen(r.x); f[0] = t.x; f[1] = t.y;
    t = Pair<T>::widen(r.y); f[2] = t.x; f[3] = t.y;
    t = Pair<T>::widen(r.z); f[4] = t.x; f[5] = t.y;
    t = Pair<T>::widen(r.w); f[6] = t.x; f[7] = t.y;
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[8],
                                               float r, const float (&s)[8],
                                               bool two) {
    uint4 o;
    o.x = norm2<T>(v[0], v[1], r, s[0], s[1]);
    o.y = norm2<T>(v[2], v[3], r, s[2], s[3]);
    if (A16) {
      o.z = norm2<T>(v[4], v[5], r, s[4], s[5]);
      o.w = norm2<T>(v[6], v[7], r, s[6], s[7]);
      *reinterpret_cast<uint4*>(p) = o;
      return;
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(o.x, o.y);
    if (two) {
      o.z = norm2<T>(v[4], v[5], r, s[4], s[5]);
      o.w = norm2<T>(v[6], v[7], r, s[6], s[7]);
      *reinterpret_cast<uint2*>(p + 4) = make_uint2(o.z, o.w);
    }
  }
};

template <bool A16> struct Io<bf16, A16> : Io2<bf16, A16> {};
template <bool A16> struct Io<__half, A16> : Io2<__half, A16> {};

// x, y (rows, d) with d = 4 (mod 8) only where T is 2-byte and not A16;
// tiles of `tile_rows` rows (a multiple of 8 / W, even where not A16), a
// ring of `stages` stages of `stage_bytes` each after the HEADER
template <typename T, bool A16>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(sizeof(T)))
rmsnorm_stream_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      T* __restrict__ y, int64_t rows, int d, int W,
                      int64_t tile_rows, int stages, int stage_bytes,
                      float eps) {
  typedef Io<T, A16> io;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  float* const part = reinterpret_cast<float*>(smem + 16 * MAX_STAGES);
  unsigned char* const ring = smem + HEADER;
  const uint32_t full0 = smem_u32(bars), written0 = full0 + 8 * MAX_STAGES;

  const int64_t row_bytes = (int64_t)d * sizeof(T);
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(written0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // -- the producer: one thread moves every byte, in and out
    if (lane != 0) return;
    // a tile's offset in x and y, and its bytes
    auto span = [&](int64_t tile, uint32_t& bytes) {
      const int64_t r0 = tile * tile_rows;
      bytes = (uint32_t)((rows - r0 < tile_rows ? rows - r0 : tile_rows)
                         * row_bytes);
      return r0 * row_bytes;
    };
    auto load = [&](int64_t tile, int s) {
      uint32_t bytes;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x) + span(tile, bytes);
      unsigned char* dst = ring + (int64_t)s * stage_bytes;
      const uint32_t whole = bytes & ~15u;
      if (whole != bytes)            // 8 bytes of an odd bfloat16 tail
        *reinterpret_cast<uint2*>(dst + whole) =
            *reinterpret_cast<const uint2*>(src + whole);
      mbar_expect_tx(full0 + 8 * s, whole);
      if (whole) bulk_load(smem_u32(dst), src, whole, full0 + 8 * s);
    };
    {
      int s = 0;
      for (int64_t tile = blockIdx.x; tile < tiles && s < stages;
           tile += gridDim.x, ++s)
        load(tile, s);
    }
    int s = 0;
    uint32_t phase = 0;                // of this turn of the ring
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      mbar_wait(written0 + 8 * s, phase);
      uint32_t bytes;
      unsigned char* dst = reinterpret_cast<unsigned char*>(y)
                           + span(tile, bytes);
      const unsigned char* src = ring + (int64_t)s * stage_bytes;
      const uint32_t whole = bytes & ~15u;
      if (whole != bytes)
        *reinterpret_cast<uint2*>(dst + whole) =
            *reinterpret_cast<const uint2*>(src + whole);
      if (whole) bulk_store(dst, smem_u32(src), whole);
      const int64_t next = tile + (int64_t)stages * gridDim.x;
      if (next < tiles) {              // once the store has read the stage
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load(next, s);
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // -- a consumer warp, warp `wt` of team `team` (W warps a row)
  const int cw = warp - 1;
  const int team = cw / W, wt = cw % W, teams = CONSUMER_WARPS / W;
  const int tl = wt * WARP + lane, team_threads = W * WARP;
  const int chunks = (d + 7) / 8;

  float sc[MAX_CHUNKS][8];           // this thread's scale, once per block
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k) {
    const int c = tl + k * team_threads;
    if (c < chunks) {
      io::widen(io::load(scale + 8 * c, 8 * c + 4 < d), sc[k]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[k][e] = 0.f;
    }
  }

  int parity = 0;                    // of the team's partials
  int s = 0;
  uint32_t phase = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    mbar_wait(full0 + 8 * s, phase);
    const int64_t r0 = tile * tile_rows;
    const int nr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    unsigned char* stage = ring + (int64_t)s * stage_bytes;
    for (int r = team; r < nr; r += teams) {      // normalised in place
      T* const row = reinterpret_cast<T*>(stage + r * row_bytes);
      typename io::Raw v[MAX_CHUNKS];
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        const int c = tl + k * team_threads;
        if (c < chunks) v[k] = io::load(row + 8 * c, 8 * c + 4 < d);
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        const int c = tl + k * team_threads;
        if (c < chunks) {
          float f[8];
          io::widen(v[k], f);
          const int n = 8 * c + 4 < d ? 8 : 4;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < n) acc = fmaf(f[e], f[e], acc);
        }
      }
      acc = warp_sum(acc);
      if (W > 1) {                   // the team's warp sums, in warp order
        float* const p = part + parity * CONSUMER_WARPS + team * W;
        if (lane == 0) p[wt] = acc;
        bar_sync(1 + team, team_threads);
        acc = 0.f;
        for (int w = 0; w < W; ++w) acc += p[w];
        parity ^= 1;
      }
      const float rs = rsqrtf(acc / (float)d + eps);
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        const int c = tl + k * team_threads;
        if (c < chunks) {
          float f[8];
          io::widen(v[k], f);
          io::store(row + 8 * c, f, rs, sc[k], 8 * c + 4 < d);
        }
      }
    }
    // the writes, visible to the bulk store (the async proxy), then counted
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(written0 + 8 * s);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// per device: its SM count
constexpr int MAX_DEVICES = 16;
int sm_count[MAX_DEVICES];

int device_sms(int* dev) {
  cudaGetDevice(dev);
  if (*dev < 0 || *dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (sm_count[*dev] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sm_count[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return -(int)err;
  }
  return sm_count[*dev];
}

// the launch's plan for rows of d elements of `size` bytes
struct Plan {
  int W;              // warps a row's team
  int64_t tile_rows;  // rows a tile
  int stages;         // of each block's ring
  int stage_bytes;
};

Plan plan_of(int d, int size) {
  Plan p;
  const int chunks = (d + 7) / 8;
  p.W = 1;
  while (p.W < CONSUMER_WARPS && MAX_CHUNKS * WARP * p.W < chunks) p.W *= 2;
  const int teams = CONSUMER_WARPS / p.W;
  const int64_t row_bytes = (int64_t)d * size;
  const int64_t per = TILE_BYTES / (teams * row_bytes);
  p.tile_rows = (per > 1 ? per : 1) * teams;
  // a row of 8 mod 16 bytes: tiles of even rows (teams == 1 here)
  if (row_bytes % 16 && (p.tile_rows & 1)) p.tile_rows += teams;
  p.stage_bytes = (int)((p.tile_rows * row_bytes + 15) / 16 * 16);
  const int stages = RING_BYTES_PER_SM / blocks_per_sm(size) / p.stage_bytes;
  p.stages = stages < 3 ? 3 : stages > MAX_STAGES ? MAX_STAGES : stages;
  return p;
}

template <typename T, bool A16>
int launch_stream(const T* x, const T* scale, T* y, int64_t rows, int d,
                  float eps, cudaStream_t s) {
  auto kernel = rmsnorm_stream_kernel<T, A16>;
  static int smem_limit[MAX_DEVICES];     // this kernel's, set so far
  int dev = 0;
  const int sms = device_sms(&dev);
  if (sms < 0) return -sms;
  const Plan p = plan_of(d, sizeof(T));
  const int smem = HEADER + p.stages * p.stage_bytes;
  if (smem > smem_limit[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit[dev] = smem;
  }
  const int64_t tiles = (rows + p.tile_rows - 1) / p.tile_rows;
  const int64_t most = (int64_t)blocks_per_sm(sizeof(T)) * sms;
  const int64_t per_block = (tiles + most - 1) / most;   // tiles a block
  const unsigned grid = (unsigned)((tiles + per_block - 1) / per_block);
  kernel<<<grid, THREADS, smem, s>>>(x, scale, y, rows, d, p.W, p.tile_rows,
                                     p.stages, p.stage_bytes, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* scale, T* y, int64_t rows, int64_t d,
           float eps, cudaStream_t s) {
  if (d % 4 != 0 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return 0;
  if constexpr (sizeof(T) == 4) {
    return launch_stream<T, true>(x, scale, y, rows, (int)d, eps, s);
  } else {
    if (d % 8 == 0)
      return launch_stream<T, true>(x, scale, y, rows, (int)d, eps, s);
    return launch_stream<T, false>(x, scale, y, rows, (int)d, eps, s);
  }
}

// ---------------------------------------------------------------------------
// rmsnorm_rows_kernel: the rows the stream cannot take
// ---------------------------------------------------------------------------
//
// A row whose byte length is not a multiple of 8 or whose base is not
// 16-byte aligned (d = 1, 3, 17, 4099, ...), and a row wider than 8192 (d =
// 8200, 16384, 20000, ...): no TMA, no ring.  A row belongs to a team of W
// warps (W = 1, 2, 4, 8, the least with 256 W >= d, so a thread takes at
// most eight elements before the team is 8 warps), 8 / W teams a block of
// 256 threads, a grid-stride walk over the rows.
//
//   * LOADS BY VECTOR WHERE ALIGNED, ELSE BY ELEMENT: where d % 4 == 0 and
//     x, y and the scale are aligned to four elements (16 bytes of
//     float32, 8 of a 2-byte type), thread t of the team takes the groups
//     of four t, t + 32 W, ... of the row; elsewhere the elements t, t +
//     32 W, ...  Either way a warp's access is contiguous.
//   * THE ROW IS KEPT IN SHARED MEMORY WHERE IT FITS: the first pass folds
//     the squares and keeps what it read in the team's stash (each thread
//     reads back only what it wrote: no barrier); where the block's rows
//     do not fit (STASH_BYTES), the second pass reads the row again, from
//     L2 where it still is.
//   * THE FOLD: a thread folds its elements in order with fmaf (a group's
//     four in order), then a fixed xor butterfly of shuffles, then the
//     team's W warp sums in warp order: fixed by d and the vector flag,
//     the same bits in any launch; the 2-byte row's rsqrt is bitwise the
//     float32 kernel's on the widened row (tests/rmsnorm_fold.py emulates
//     it).  rsqrt(sum / d + eps) and the write as in the stream kernel.

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / WARP;
constexpr int STASH_BYTES = 98304;     // a block's stash: two blocks a SM

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float v, float r,
                                               float s) {
    *p = __fmul_rn(__fmul_rn(v, r), s);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v, float r,
                                                float4 s) {
    *reinterpret_cast<float4*>(p) = make_float4(
        __fmul_rn(__fmul_rn(v.x, r), s.x), __fmul_rn(__fmul_rn(v.y, r), s.y),
        __fmul_rn(__fmul_rn(v.z, r), s.z), __fmul_rn(__fmul_rn(v.w, r), s.w));
  }
};

template <typename T> struct Elem2 {
  static __device__ __forceinline__ float load(const T* p) {
    const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
    return Pair<T>::widen((uint32_t)u).x;
  }
  static __device__ __forceinline__ float4 load4(const T* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = Pair<T>::widen(u.x), b = Pair<T>::widen(u.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(T* p, float v, float r,
                                               float s) {
    const uint32_t o = norm2<T>(v, 0.f, r, s, 0.f);
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)(o & 0xffffu);
  }
  static __device__ __forceinline__ void store4(T* p, float4 v, float r,
                                                float4 s) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        norm2<T>(v.x, v.y, r, s.x, s.y), norm2<T>(v.z, v.w, r, s.z, s.w));
  }
};
template <> struct Elem<bf16> : Elem2<bf16> {};
template <> struct Elem<__half> : Elem2<__half> {};

// the team's warps a row of d elements
inline int rows_team_warps(int64_t d) {
  int W = 1;
  while (W < ROW_WARPS && (int64_t)ROW_THREADS * W < d) W *= 2;
  return W;
}

// x, y (rows, d); VEC: every row in groups of four aligned elements;
// stash: the block's rows kept in shared memory (teams x d elements)
template <typename T, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, int64_t rows, int64_t d, int W,
                    int stash, float eps) {
  typedef Elem<T> el;
  extern __shared__ __align__(16) unsigned char row_smem[];
  __shared__ float part[2][ROW_WARPS];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int team = warp / W, wt = warp % W, teams = ROW_WARPS / W;
  const int tl = wt * WARP + lane, tn = W * WARP;
  float* const keep = reinterpret_cast<float*>(row_smem) + team * d;
  int parity = 0;
  for (int64_t r = (int64_t)blockIdx.x * teams + team; r < rows;
       r += (int64_t)gridDim.x * teams) {
    const T* const xr = x + r * d;
    T* const yr = y + r * d;
    float acc = 0.f;
    if (VEC) {
      for (int64_t g = tl; g < d / 4; g += tn) {
        const float4 v = el::load4(xr + 4 * g);
        acc = fmaf(v.x, v.x, acc);
        acc = fmaf(v.y, v.y, acc);
        acc = fmaf(v.z, v.z, acc);
        acc = fmaf(v.w, v.w, acc);
        if (stash) reinterpret_cast<float4*>(keep)[g] = v;
      }
    } else {
      for (int64_t i = tl; i < d; i += tn) {
        const float v = el::load(xr + i);
        acc = fmaf(v, v, acc);
        if (stash) keep[i] = v;
      }
    }
    acc = warp_sum(acc);
    if (W > 1) {                       // the team's warp sums, in warp order
      float* const p = part[parity] + team * W;
      if (lane == 0) p[wt] = acc;
      bar_sync(1 + team, tn);
      acc = 0.f;
      for (int w = 0; w < W; ++w) acc += p[w];
      parity ^= 1;
    }
    const float rs = rsqrtf(acc / (float)d + eps);
    if (VEC) {
      for (int64_t g = tl; g < d / 4; g += tn) {
        const float4 v = stash ? reinterpret_cast<const float4*>(keep)[g]
                               : el::load4(xr + 4 * g);
        el::store4(yr + 4 * g, v, rs, el::load4(scale + 4 * g));
      }
    } else {
      for (int64_t i = tl; i < d; i += tn)
        el::store(yr + i, stash ? keep[i] : el::load(xr + i), rs,
                  el::load(scale + i));
    }
  }
}

template <typename T, bool VEC>
int launch_rows_as(const T* x, const T* scale, T* y, int64_t rows,
                   int64_t d, float eps, cudaStream_t s) {
  auto kernel = rmsnorm_rows_kernel<T, VEC>;
  static int smem_set[MAX_DEVICES];
  int dev = 0;
  const int sms = device_sms(&dev);
  if (sms < 0) return -sms;
  const int W = rows_team_warps(d), teams = ROW_WARPS / W;
  // the block's rows in shared memory where they fit, else read twice
  const int64_t keep = teams * d * (int64_t)sizeof(float);
  const int stash = keep <= STASH_BYTES;
  const int smem = stash ? (int)keep : 0;
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STASH_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = 1;
  }
  int64_t blocks = (rows + teams - 1) / teams;
  const int64_t most = (int64_t)sms * 16;
  if (blocks > most) blocks = most;
  kernel<<<(unsigned)blocks, ROW_THREADS, smem, s>>>(x, scale, y, rows, d,
                                                     W, stash, eps);
  return (int)cudaGetLastError();
}

// the rows kernel's launches by dtype (0 float32, 1 bfloat16, 2 float16)
// and by load (0 by element, 1 by vector), read by lag_rmsnorm_rows_counts
int64_t rows_counts[3][2];

template <typename T>
int launch_rows(const T* x, const T* scale, T* y, int64_t rows, int64_t d,
                float eps, cudaStream_t s, int which) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const uintptr_t a = (uintptr_t)x | (uintptr_t)y | (uintptr_t)scale;
  const bool vec = d % 4 == 0 && a % (4 * sizeof(T)) == 0;
  const int err = vec ? launch_rows_as<T, true>(x, scale, y, rows, d, eps, s)
                      : launch_rows_as<T, false>(x, scale, y, rows, d, eps, s);
  if (err == 0) ++rows_counts[which][vec];
  return err;
}

}  // namespace

extern "C" {

// x, y: (rows, d) float32, contiguous; scale: (d,) float32; all three
// 16-byte aligned; d a multiple of 4, at most 8192.
int lag_rmsnorm_f32(const void* x, const void* scale, void* y, int64_t rows,
                    int64_t d, float eps, void* stream) {
  return launch((const float*)x, (const float*)scale, (float*)y, rows, d, eps,
                (cudaStream_t)stream);
}

// the same in bfloat16: x, y (rows, d), scale (d,), all bfloat16
int lag_rmsnorm_bf16(const void* x, const void* scale, void* y, int64_t rows,
                     int64_t d, float eps, void* stream) {
  return launch((const bf16*)x, (const bf16*)scale, (bf16*)y, rows, d, eps,
                (cudaStream_t)stream);
}

// the same in float16: x, y (rows, d), scale (d,), all float16
int lag_rmsnorm_f16(const void* x, const void* scale, void* y, int64_t rows,
                    int64_t d, float eps, void* stream) {
  return launch((const __half*)x, (const __half*)scale, (__half*)y, rows, d,
                eps, (cudaStream_t)stream);
}

// the rows kernel, in each dtype: x, y (rows, d), scale (d,), contiguous,
// any d >= 1, any alignment of their elements
int lag_rmsnorm_rows_f32(const void* x, const void* scale, void* y,
                         int64_t rows, int64_t d, float eps, void* stream) {
  return launch_rows((const float*)x, (const float*)scale, (float*)y, rows,
                     d, eps, (cudaStream_t)stream, 0);
}

int lag_rmsnorm_rows_bf16(const void* x, const void* scale, void* y,
                          int64_t rows, int64_t d, float eps, void* stream) {
  return launch_rows((const bf16*)x, (const bf16*)scale, (bf16*)y, rows, d,
                     eps, (cudaStream_t)stream, 1);
}

int lag_rmsnorm_rows_f16(const void* x, const void* scale, void* y,
                         int64_t rows, int64_t d, float eps, void* stream) {
  return launch_rows((const __half*)x, (const __half*)scale, (__half*)y,
                     rows, d, eps, (cudaStream_t)stream, 2);
}

// the plan the stream entries launch for rows of d elements of `size`
// bytes (4 or 2): out = {warps a row, rows a tile, stages a ring, blocks a
// SM}
int lag_rmsnorm_plan(int64_t d, int64_t size, int64_t* out) {
  if (d % 4 != 0 || d <= 0 || d > MAX_D || (size != 4 && size != 2))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of((int)d, (int)size);
  out[0] = p.W;
  out[1] = p.tile_rows;
  out[2] = p.stages;
  out[3] = blocks_per_sm((int)size);
  return 0;
}

// the rows kernel's launches so far: out = {float32 by element, by vector,
// bfloat16 by element, by vector, float16 by element, by vector}
void lag_rmsnorm_rows_counts(int64_t* out) {
  for (int i = 0; i < 6; ++i) out[i] = rows_counts[i / 2][i % 2];
}

}  // extern "C"
