// Fused RMSNorm for Hopper (sm_90a).
//
// Hand-written CUDA replacement of the Pallas kernel rmsnorm_2d
// (_rmsnorm_kernel) of src/repro/kernels/rmsnorm/rmsnorm.py:
//
//   y = (x * rsqrt(mean(x^2) + eps)).astype(out) * scale.astype(out)
//
// row by row over x (rows, d), float32 or bfloat16 (out is x's dtype).  The
// reference's order of operations is kept: the row is multiplied by the
// rsqrt first, then by the scale, two separate roundings to out's dtype.
// In bfloat16 the mean of squares and the rsqrt stay float32 on the widened
// row; then y = bf16(bf16(x * r) * scale), scale already at x's dtype (the
// wrapper casts a float32 scale as the reference does).
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
// lag_rmsnorm_plan reports the tiling a launch picks.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float2 widen2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// bf16(bf16(v0 * r) * s0), bf16(bf16(v1 * r) * s1), packed
__device__ __forceinline__ uint32_t norm2(float v0, float v1, float r,
                                          float s0, float s1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(v0, r),
                                                 __fmul_rn(v1, r));
  const float2 q = widen2(*reinterpret_cast<const uint32_t*>(&p));
  const __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(q.x, s0),
                                                 __fmul_rn(q.y, s1));
  return *reinterpret_cast<const uint32_t*>(&o);
}

template <bool A16> struct Io<bf16, A16> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const bf16* p, bool two) {
    if (A16) return *reinterpret_cast<const uint4*>(p);
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint2 b = two ? *reinterpret_cast<const uint2*>(p + 4)
                        : make_uint2(0u, 0u);
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    float2 t = widen2(r.x); f[0] = t.x; f[1] = t.y;
    t = widen2(r.y); f[2] = t.x; f[3] = t.y;
    t = widen2(r.z); f[4] = t.x; f[5] = t.y;
    t = widen2(r.w); f[6] = t.x; f[7] = t.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8],
                                               float r, const float (&s)[8],
                                               bool two) {
    uint4 o;
    o.x = norm2(v[0], v[1], r, s[0], s[1]);
    o.y = norm2(v[2], v[3], r, s[2], s[3]);
    if (A16) {
      o.z = norm2(v[4], v[5], r, s[4], s[5]);
      o.w = norm2(v[6], v[7], r, s[6], s[7]);
      *reinterpret_cast<uint4*>(p) = o;
      return;
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(o.x, o.y);
    if (two) {
      o.z = norm2(v[4], v[5], r, s[4], s[5]);
      o.w = norm2(v[6], v[7], r, s[6], s[7]);
      *reinterpret_cast<uint2*>(p + 4) = make_uint2(o.z, o.w);
    }
  }
};

// x, y (rows, d) with d = 4 (mod 8) only where T is bfloat16 and not A16;
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

// per device: SM count, and each kernel's shared-memory limit set so far
constexpr int MAX_DEVICES = 16;
int sm_count[MAX_DEVICES];
int smem_limit[3][MAX_DEVICES];

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
int launch_stream(int variant, const T* x, const T* scale, T* y,
                  int64_t rows, int d, float eps, cudaStream_t s) {
  auto kernel = rmsnorm_stream_kernel<T, A16>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan p = plan_of(d, sizeof(T));
  const int smem = HEADER + p.stages * p.stage_bytes;
  if (smem > smem_limit[variant][dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit[variant][dev] = smem;
  }
  const int64_t tiles = (rows + p.tile_rows - 1) / p.tile_rows;
  const int64_t most = (int64_t)blocks_per_sm(sizeof(T)) * sm_count[dev];
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
    return launch_stream<T, true>(0, x, scale, y, rows, (int)d, eps, s);
  } else {
    if (d % 8 == 0)
      return launch_stream<T, true>(1, x, scale, y, rows, (int)d, eps, s);
    return launch_stream<T, false>(2, x, scale, y, rows, (int)d, eps, s);
  }
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

// the plan both entries launch for rows of d elements of `size` bytes (4
// or 2): out = {warps a row, rows a tile, stages a ring, blocks a SM}
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

}  // extern "C"
