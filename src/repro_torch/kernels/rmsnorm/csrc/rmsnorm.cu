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
// 8200, 16384, 20000, ...).  The stream's design, with the alignment taken
// out of the device memory's way:
//
//   * THE ALIGNED COVER BY TMA: a tile is tile_rows consecutive rows of the
//     contiguous x, one byte range; the producer brings its 16-byte-aligned
//     cover (at most 15 bytes more at each end, inside the same aligned
//     words) into a shared-memory ring with 1D bulk copies, whatever the
//     alignment of x or of the rows.  The ring is one circular buffer (112
//     KB, two blocks a SM, up to d 8192; 224 KB, one block a SM, up to d
//     24576): a tile takes its cover's bytes where the last one ended (two
//     copies where it wraps), up to ROWS_SLOTS tiles in flight, so a wide
//     row (80 KB of float32 at d 20000) leaves room for the next ones and
//     narrow rows pack densely.  The bytes a bulk store still reads are
//     reclaimed only when a load needs them.
//   * ONE FOLD ORDER, BY d ALONE, THE STREAM'S: chunks of eight elements, a
//     team of W warps a row (W = 1, 2, 4, 8, the least with 128 W >= the
//     chunks), thread t of the team folds chunks t, t + 32 W, ... in order
//     (up to 12 a thread: d 24576), each chunk's elements in order with
//     fmaf, then the xor butterfly and the team's warp sums in warp order.
//     A chunk is read from shared memory at any element offset (the two or
//     three aligned 16-byte words that hold it, shifted into place), so the
//     bits depend on d alone: the row's rsqrt is the same at any alignment,
//     and equal to the stream kernel's where both take a width (a 2-byte
//     row one element off is bitwise the float32 stream's on the aligned
//     widened row).  Up to d 8192 a team folds two rows at once (one
//     barrier for both): at d 4099 a row is one team of eight warps, and a
//     row at a time left the SM waiting on each row's chain of reads,
//     shuffles and barrier.
//   * WRITES: where x's base and y's lie at the same 16-byte phase (y comes
//     from torch.empty_like: every aligned x), the consumers normalise the
//     tile in place and the producer writes its aligned interior to y with
//     bulk stores, the ragged ends (< 16 bytes each) by element; elsewhere
//     the consumers store y by element.
//   * THE SCALE IS READ ONCE PER BLOCK into registers (a thread's chunks
//     are the same in every row).
//   * Wider rows (d above 24576, or a row past half the ring) go through
//     rmsnorm_rows_global_kernel: a block of 256 threads a row, several
//     blocks a SM, the row read twice from device memory (L2), the same
//     fold order.
//
// float16 and bfloat16 run at one rate here (PERF.md); the earlier design
// (a warp's loads by element, synchronous) ran float16 1.4-1.7x slower.
// rsqrt(sum / d + eps) and the write as in the stream kernel.

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / WARP;
constexpr int ROWS_SLOTS = 24;          // tiles in flight a block
constexpr int ROWS_TILE = 16384;        // a tile's target bytes
constexpr int ROWS_HEADER = 1024;       // 2 x ROWS_SLOTS mbarriers, partials
constexpr int ROWS_SMEM = 229376;       // the ring(s) of one SM

// the rows kernel's two shapes: up to 8192 elements a row (four chunks a
// thread at most), two rows folded at once by a team, two blocks a SM; up
// to 24576 (twelve chunks a thread), a row at a time, one block a SM
template <int MAXC_>
struct RowsShape {
  static constexpr int MAXC = MAXC_;
  static constexpr int GROUP = MAXC == 4 ? 2 : 1;      // rows a team folds
  static constexpr int BLOCKS = MAXC == 4 ? 2 : 1;     // blocks a SM
  static constexpr int RING = ROWS_SMEM / BLOCKS;
  static constexpr int SMEM_BYTES = ROWS_HEADER + RING;
  static constexpr int MAX_D = MAXC * CONSUMER_WARPS * WARP * 8;
};
using RowsNarrow = RowsShape<4>;
using RowsWide = RowsShape<12>;

// a chunk of eight T as raw 32-bit words: widened to floats, and y = T(T(v
// * r) * s) packed back
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int WORDS = 8;
  static __device__ __forceinline__ void widen(const uint32_t (&u)[8],
                                               float (&f)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __uint_as_float(u[e]);
  }
  static __device__ __forceinline__ void norm(const float (&v)[8], float r,
                                              const float (&s)[8],
                                              uint32_t (&u)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      u[e] = __float_as_uint(__fmul_rn(__fmul_rn(v[e], r), s[e]));
  }
};
template <typename T> struct Chunk2 {
  static constexpr int WORDS = 4;
  static __device__ __forceinline__ void widen(const uint32_t (&u)[4],
                                               float (&f)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = Pair<T>::widen(u[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void norm(const float (&v)[8], float r,
                                              const float (&s)[8],
                                              uint32_t (&u)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = norm2<T>(v[2 * j], v[2 * j + 1], r, s[2 * j], s[2 * j + 1]);
  }
};
template <> struct Chunk<bf16> : Chunk2<bf16> {};
template <> struct Chunk<__half> : Chunk2<__half> {};

// element e of a chunk's words, as its raw bits
template <typename T>
__device__ __forceinline__ uint32_t elem_bits(const uint32_t* u, int e) {
  if (sizeof(T) == 4) return u[e];
  return (u[e >> 1] >> (16 * (e & 1))) & 0xffffu;
}

template <typename T>
__device__ __forceinline__ uint32_t get_elem(const void* p) {
  if (sizeof(T) == 4) return *reinterpret_cast<const uint32_t*>(p);
  return *reinterpret_cast<const unsigned short*>(p);
}

template <typename T>
__device__ __forceinline__ void put_elem(void* p, uint32_t bits) {
  if (sizeof(T) == 4) *reinterpret_cast<uint32_t*>(p) = bits;
  else *reinterpret_cast<unsigned short*>(p) = (unsigned short)bits;
}

// the first n (at most 8) elements at p as a chunk's words, zeros past them
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, int n,
                                           uint32_t (&u)[Chunk<T>::WORDS]) {
#pragma unroll
  for (int e = 0; e < Chunk<T>::WORDS; ++e) u[e] = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e >= n) continue;
    if (sizeof(T) == 4)
      u[e] = *reinterpret_cast<const uint32_t*>(p + e);
    else
      u[e >> 1] |= (uint32_t)*reinterpret_cast<const unsigned short*>(p + e)
                   << (16 * (e & 1));
  }
}

// a circular byte buffer of `size` bytes (a multiple of 16) in shared
// memory; offsets below 2 size
struct Ring {
  unsigned char* p;
  uint32_t size;
  __device__ __forceinline__ unsigned char* at(uint32_t off) const {
    return p + (off >= size ? off - size : off);
  }
};

// the chunk of eight T at byte `off` of the ring (any element offset): the
// aligned 16-byte words that hold it, shifted into place
template <typename T>
__device__ __forceinline__ void ring_chunk(const Ring& ring, uint32_t off,
                                           uint32_t (&u)[Chunk<T>::WORDS]) {
  constexpr int N = Chunk<T>::WORDS;         // words a chunk
  constexpr int NW = N / 4 + 1;              // aligned words that hold it
  uint32_t w[4 * NW];
  const uint32_t a = off & ~15u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 x = *reinterpret_cast<const uint4*>(ring.at(a + 16 * i));
    w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
  const uint32_t q = (off >> 2) & 3u, bits = (off & 3u) * 8u;
  uint32_t v[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j)
    v[j] = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
#pragma unroll
  for (int j = 0; j < N; ++j) u[j] = __funnelshift_r(v[j], v[j + 1], bits);
}

// the chunk's first n elements (words u) back at byte `off` of the ring
template <typename T>
__device__ __forceinline__ void ring_put(const Ring& ring, uint32_t off,
                                         const uint32_t (&u)[Chunk<T>::WORDS],
                                         int n) {
  constexpr int N = Chunk<T>::WORDS;
  if (n == 8 && (off & 15u) == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      *reinterpret_cast<uint4*>(ring.at(off + 16 * i)) =
          make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
  } else if (n == 8 && (off & 3u) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      *reinterpret_cast<uint32_t*>(ring.at(off + 4 * j)) = u[j];
  } else if (n == 8) {              // a 2-byte chunk at 2 (mod 4)
    put_elem<T>(ring.at(off), u[0]);
#pragma unroll
    for (int j = 0; j < N - 1; ++j)
      *reinterpret_cast<uint32_t*>(ring.at(off + 2 + 4 * j)) =
          __funnelshift_r(u[j], u[j + 1], 16);
    put_elem<T>(ring.at(off + 14), u[N - 1] >> 16);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n)
        put_elem<T>(ring.at(off + e * (uint32_t)sizeof(T)),
                    elem_bits<T>(u, e));
  }
}

// a tile: its rows, x's bytes [xs, xs + nr row_bytes) and their aligned
// cover [cs, cs + cover)
struct RowsTile {
  int nr;
  uint64_t xs, cs;
  uint32_t cover;
};

__device__ __forceinline__ RowsTile rows_tile(uint64_t xbase, int64_t rows,
                                              int64_t tile_rows,
                                              int64_t row_bytes,
                                              int64_t tile) {
  RowsTile t;
  const int64_t r0 = tile * tile_rows;
  t.nr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
  t.xs = xbase + (uint64_t)(r0 * row_bytes);
  t.cs = t.xs & ~(uint64_t)15;
  t.cover = (uint32_t)(((t.xs + (uint64_t)(t.nr * row_bytes) + 15)
                        & ~(uint64_t)15) - t.cs);
  return t;
}

// x, y (rows, d), tiles of tile_rows rows; in_place: x's base and y's at
// the same 16-byte phase (the tile normalised in the ring, written back by
// bulk stores), else y stored by element
template <typename T, class S>
__global__ void __launch_bounds__(THREADS, S::BLOCKS)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, int64_t rows, int d, int W,
                    int64_t tile_rows, int in_place, float eps) {
  typedef Chunk<T> ck;
  constexpr int N = ck::WORDS, MAXC = S::MAXC, GROUP = S::GROUP;
  constexpr uint32_t CB = 8 * sizeof(T);     // a chunk's bytes
  constexpr uint32_t RING = S::RING;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), written0 = full0 + 8 * ROWS_SLOTS;
  float* const part = reinterpret_cast<float*>(smem + 16 * ROWS_SLOTS);
  const Ring ring{smem + ROWS_HEADER, RING};
  const uint32_t ring_s = smem_u32(ring.p);

  const int64_t row_bytes = (int64_t)d * sizeof(T);
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const uint64_t xbase = (uint64_t)x, ybase = (uint64_t)y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ROWS_SLOTS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(written0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // -- the producer: every tile's cover in, the tiles written in place
    // out; the ring's bytes and slots taken and freed in tile order
    if (lane != 0) return;
    // ring bytes: taken by loads; stored (their bulk stores may still be
    // reading them); freed (reusable)
    uint64_t taken = 0, stored = 0, freed = 0;
    int64_t ld = blockIdx.x;
    int kl = 0, ks = 0;
    for (int64_t st = blockIdx.x; st < tiles; st += gridDim.x, ++ks) {
      for (; ld < tiles && kl - ks < ROWS_SLOTS; ld += gridDim.x, ++kl) {
        const RowsTile t = rows_tile(xbase, rows, tile_rows, row_bytes, ld);
        if (taken + t.cover - freed > RING) {
          if (stored == freed) break;     // the consumers hold the rest
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          freed = stored;
          if (taken + t.cover - freed > RING) break;
        }
        const uint32_t bar = full0 + 8 * (kl % ROWS_SLOTS);
        const uint32_t off = (uint32_t)(taken % RING);
        const uint32_t first = t.cover < RING - off ? t.cover : RING - off;
        mbar_expect_tx(bar, t.cover);
        bulk_load(ring_s + off, reinterpret_cast<const void*>(t.cs), first,
                  bar);
        if (first < t.cover)
          bulk_load(ring_s, reinterpret_cast<const void*>(t.cs + first),
                    t.cover - first, bar);
        taken += t.cover;
      }
      mbar_wait(written0 + 8 * (ks % ROWS_SLOTS),
                (uint32_t)(ks / ROWS_SLOTS) & 1u);
      const RowsTile t = rows_tile(xbase, rows, tile_rows, row_bytes, st);
      if (in_place) {
        // y's bytes [ys, ye): the aligned interior by bulk stores (two
        // where the ring wraps), the ends by element; y byte Y is at ring
        // offset base + (Y - (ys & ~15))
        const uint32_t base = (uint32_t)(stored % RING);
        const uint64_t ys = ybase + (t.xs - xbase);
        const uint64_t ye = ys + (uint64_t)(t.nr * row_bytes);
        const uint64_t y0 = ys & ~(uint64_t)15;
        const uint64_t a = (ys + 15) & ~(uint64_t)15, e = ye & ~(uint64_t)15;
        auto at = [&](uint64_t Y) { return ring.at(base + (uint32_t)(Y - y0)); };
        if (a < e) {
          const uint32_t off = (uint32_t)(ring.at(base + (uint32_t)(a - y0))
                                          - ring.p);
          const uint32_t bytes = (uint32_t)(e - a);
          const uint32_t first = bytes < RING - off ? bytes : RING - off;
          bulk_store(reinterpret_cast<void*>(a), ring_s + off, first);
          if (first < bytes)
            bulk_store(reinterpret_cast<void*>(a + first), ring_s,
                       bytes - first);
        }
        const uint64_t head_end = a < ye ? a : ye;
        const uint64_t tail = e > a ? e : a;
        for (uint64_t Y = ys; Y < head_end; Y += sizeof(T))
          put_elem<T>(reinterpret_cast<void*>(Y), get_elem<T>(at(Y)));
        for (uint64_t Y = tail; Y < ye; Y += sizeof(T))
          put_elem<T>(reinterpret_cast<void*>(Y), get_elem<T>(at(Y)));
      }
      // the ring's bytes are free once the stores have read them (the
      // loads above wait for that only when they need the bytes)
      stored += t.cover;
      if (!in_place) freed = stored;
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // -- a consumer warp, warp `wt` of team `team` (W warps a row)
  const int cw = warp - 1;
  const int team = cw / W, wt = cw % W, teams = CONSUMER_WARPS / W;
  const int tl = wt * WARP + lane, tn = W * WARP;
  const int chunks = (d + 7) / 8;

  uint32_t sw[MAXC][N];              // this thread's chunks of the scale
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    const int c = tl + k * tn;
    load_chunk<T>(scale + 8 * c, c < chunks ? d - 8 * c : 0, sw[k]);
  }

  int parity = 0;
  uint64_t taken = 0;
  int k_t = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k_t) {
    const RowsTile t = rows_tile(xbase, rows, tile_rows, row_bytes, tile);
    const int slot = k_t % ROWS_SLOTS;
    mbar_wait(full0 + 8 * slot, (uint32_t)(k_t / ROWS_SLOTS) & 1u);
    // x byte X of the tile is at ring offset start + (X - cs)
    const uint32_t start = (uint32_t)(taken % RING) + (uint32_t)(t.xs - t.cs);
    // the team's rows r, r + teams, ... GROUP at a time: their folds, one
    // barrier for the group's warp sums, their writes
    for (int r = team; r < t.nr; r += teams * GROUP) {
      float acc[GROUP];
      uint32_t row0[GROUP];
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        row0[b] = (start + (uint32_t)((r + b * teams) * row_bytes)) % RING;
        acc[b] = 0.f;
        if (r + b * teams >= t.nr) continue;
#pragma unroll
        for (int k = 0; k < MAXC; ++k) {
          const int c = tl + k * tn;
          if (c < chunks) {
            uint32_t u[N];
            float f[8];
            ring_chunk<T>(ring, row0[b] + (uint32_t)c * CB, u);
            ck::widen(u, f);
            const int n = d - 8 * c < 8 ? d - 8 * c : 8;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < n) acc[b] = fmaf(f[e], f[e], acc[b]);
          }
        }
        acc[b] = warp_sum(acc[b]);
      }
      if (W > 1) {                   // the team's warp sums, in warp order
        float* const p = part + parity * GROUP * CONSUMER_WARPS + team * W;
        if (lane == 0) {
#pragma unroll
          for (int b = 0; b < GROUP; ++b) p[b * CONSUMER_WARPS + wt] = acc[b];
        }
        bar_sync(1 + team, tn);
#pragma unroll
        for (int b = 0; b < GROUP; ++b) {
          acc[b] = 0.f;
          for (int w = 0; w < W; ++w) acc[b] += p[b * CONSUMER_WARPS + w];
        }
        parity ^= 1;
      }
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (r + b * teams >= t.nr) continue;
        const float rs = rsqrtf(acc[b] / (float)d + eps);
        T* const yr = y + (tile * tile_rows + r + b * teams) * (int64_t)d;
#pragma unroll
        for (int k = 0; k < MAXC; ++k) {
          const int c = tl + k * tn;
          if (c < chunks) {
            const uint32_t off = row0[b] + (uint32_t)c * CB;
            uint32_t u[N];
            float f[8], s[8];
            ring_chunk<T>(ring, off, u);
            ck::widen(u, f);
            ck::widen(sw[k], s);
            ck::norm(f, rs, s, u);
            const int n = d - 8 * c < 8 ? d - 8 * c : 8;
            if (in_place) {
              ring_put<T>(ring, off, u, n);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (e < n) put_elem<T>(yr + 8 * c + e, elem_bits<T>(u, e));
            }
          }
        }
      }
    }
    // the writes, visible to the bulk store (the async proxy), then counted
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(written0 + 8 * slot);
    taken += t.cover;
  }
}

// rows too wide for the ring: a block of 256 threads a row, the row read
// twice from device memory, the same fold order (chunks t, t + 256, ...)
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsnorm_rows_global_kernel(const T* __restrict__ x,
                           const T* __restrict__ scale, T* __restrict__ y,
                           int64_t rows, int64_t d, float eps) {
  typedef Chunk<T> ck;
  __shared__ float part[2][ROW_WARPS];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int64_t chunks = (d + 7) / 8;
  int parity = 0;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* const xr = x + r * d;
    float acc = 0.f;
    for (int64_t c = threadIdx.x; c < chunks; c += ROW_THREADS) {
      const int n = d - 8 * c < 8 ? (int)(d - 8 * c) : 8;
      uint32_t u[ck::WORDS];
      float f[8];
      load_chunk<T>(xr + 8 * c, n, u);
      ck::widen(u, f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) acc = fmaf(f[e], f[e], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) part[parity][warp] = acc;
    __syncthreads();
    acc = 0.f;
    for (int w = 0; w < ROW_WARPS; ++w) acc += part[parity][w];
    parity ^= 1;
    const float rs = rsqrtf(acc / (float)d + eps);
    for (int64_t c = threadIdx.x; c < chunks; c += ROW_THREADS) {
      const int n = d - 8 * c < 8 ? (int)(d - 8 * c) : 8;
      uint32_t u[ck::WORDS], w[ck::WORDS];
      float f[8], s[8];
      load_chunk<T>(xr + 8 * c, n, u);
      load_chunk<T>(scale + 8 * c, n, w);
      ck::widen(u, f);
      ck::widen(w, s);
      ck::norm(f, rs, s, u);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) put_elem<T>(y + r * d + 8 * c + e, elem_bits<T>(u, e));
    }
  }
}

// the rows kernel's launches by dtype (0 float32, 1 bfloat16, 2 float16)
// and by path (0 the ring, in place and bulk stores; 1 the ring, y stored
// by element; 2 the two-pass global kernel), read by lag_rmsnorm_rows_counts
int64_t rows_counts[3][3];

// the team's warps of a row of d elements (the stream's rule, any d)
inline int rows_team_warps(int64_t d) {
  const int64_t chunks = (d + 7) / 8;
  int W = 1;
  while (W < CONSUMER_WARPS && (int64_t)MAX_CHUNKS * WARP * W < chunks)
    W *= 2;
  return W;
}

template <typename T, class S>
int launch_rows_ring(const T* x, const T* scale, T* y, int64_t rows,
                     int64_t d, float eps, cudaStream_t s, int sms,
                     int dev, int in_place) {
  auto kernel = rmsnorm_rows_kernel<T, S>;
  static bool smem_set[MAX_DEVICES];
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const int W = rows_team_warps(d), teams = CONSUMER_WARPS / W;
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  // about ROWS_TILE bytes, a whole number of groups a team where the ring
  // takes two such tiles
  int64_t per = ROWS_TILE / (teams * row_bytes);
  per = per > 1 ? per : 1;
  const int64_t grouped = (per + S::GROUP - 1) / S::GROUP * S::GROUP;
  if (grouped * teams * row_bytes + 32 <= S::RING / 2) per = grouped;
  const int64_t tile_rows = per * teams;
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t most = (int64_t)sms * S::BLOCKS;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  kernel<<<grid, THREADS, S::SMEM_BYTES, s>>>(x, scale, y, rows, (int)d, W,
                                              tile_rows, in_place, eps);
  return (int)cudaGetLastError();
}

// the rows kernel's path for rows of d elements of `size` bytes, x and y
// at these addresses: 0 the ring written back in place (x's base and y's
// at one 16-byte phase), 1 the ring storing y by element, 2 the two-pass
// kernel; *shape: 0 RowsNarrow, 1 RowsWide
int rows_path(int64_t d, int64_t size, uintptr_t x, uintptr_t y, int* shape) {
  const int64_t row_bytes = d * size;
  *shape = d <= RowsNarrow::MAX_D && row_bytes + 32 <= RowsNarrow::RING / 2
               ? 0
           : d <= RowsWide::MAX_D && row_bytes + 32 <= RowsWide::RING / 2
               ? 1
               : -1;
  if (*shape < 0) return 2;
  return x % 16 == y % 16 ? 0 : 1;
}

template <typename T>
int launch_rows(const T* x, const T* scale, T* y, int64_t rows, int64_t d,
                float eps, cudaStream_t s, int which) {
  if (d < 1 || d > 0x7fffffffLL / 8) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int dev = 0;
  const int sms = device_sms(&dev);
  if (sms < 0) return -sms;
  int shape, err;
  const int path = rows_path(d, sizeof(T), (uintptr_t)x, (uintptr_t)y,
                             &shape);
  if (path == 2) {
    const int64_t blocks = rows < (int64_t)sms * 8 ? rows : (int64_t)sms * 8;
    rmsnorm_rows_global_kernel<T><<<(unsigned)blocks, ROW_THREADS, 0, s>>>(
        x, scale, y, rows, d, eps);
    err = (int)cudaGetLastError();
  } else if (shape == 0) {
    err = launch_rows_ring<T, RowsNarrow>(x, scale, y, rows, d, eps, s, sms,
                                          dev, path == 0);
  } else {
    err = launch_rows_ring<T, RowsWide>(x, scale, y, rows, d, eps, s, sms,
                                        dev, path == 0);
  }
  if (err == 0) ++rows_counts[which][path];
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

// the rows kernel's path (0, 1, 2 as launch_rows counts it) for rows of d
// elements of `size` bytes at x, their output at y
int lag_rmsnorm_rows_path(int64_t d, int64_t size, const void* x,
                          const void* y) {
  int shape;
  return rows_path(d, size, (uintptr_t)x, (uintptr_t)y, &shape);
}

// the rows kernel's launches so far, by dtype (float32, bfloat16, float16)
// and path (the ring in place, the ring storing y by element, the two-pass
// global kernel): out[3 * dtype + path]
void lag_rmsnorm_rows_counts(int64_t* out) {
  for (int i = 0; i < 9; ++i) out[i] = rows_counts[i / 3][i % 3];
}

}  // extern "C"
