// Flash attention forward for Hopper (sm_90a) in bfloat16: q, k, v and o
// bfloat16, both products on the bfloat16 tensor cores (wgmma) with float32
// accumulators, K and V brought by the Tensor Memory Accelerator (TMA).
//
// Hand-written CUDA replacement of the Pallas kernel flash_attention_padded
// (src/repro/kernels/flash_attention/flash_attention.py:68; its body is
// _flash_kernel at :28) for bfloat16 operands: online-softmax GQA
// attention, forward only,
//
//   q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> o (B, Sq, H, hd),
//
// query head h reads kv head h / (H / KV).  It computes what the reference
// kernel computes on bfloat16 inputs: float32 attention on the widened
// values, rounded to bfloat16 once, at the store.  Per kv tile s = (q . k)
// * scale; masked entries are NEG = -1e30; m_new = max(m, rowmax s); p =
// exp(s - m_new) where unmasked, else 0; l = exp(m - m_new) * l + rowsum p;
// acc = acc * exp(m - m_new) + p . v; at the end o = acc / max(l, 1e-30)
// (a row that sees no key gives 0).  Masks: query < Sq, key < Skv, causal
// (q >= k), window (q - k < window), positions from 0 for q and k.  The
// float32 kernel is csrc/flash_attention.cu.
//
// Bound: operations.  At the serving path's shape (B 4, S 2048, H 32/KV 8,
// hd 64, causal) the two products take 4*B*H*hd*S(S+1)/2 = 68.7 GFLOP:
// 0.0695 ms at the H100's 989 TFLOP/s of dense bfloat16; the 84 MB of
// q/k/v/o take 0.025 ms.  This design does four bfloat16 products of that
// size (one for q.k^T, three for P.V, below): 0.139 ms.  The design:
//
//   * wgmma.mma_async m64nNk16 .f32.bf16.bf16.  A block has two consumer
//     warpgroups of 64 query rows each (BQ 128) and one producer
//     warpgroup; a consumer warpgroup keeps its scores, its output
//     accumulator and a fresh P.V accumulator in registers, in wgmma's
//     accumulator layout.  The producer hands its registers to the
//     consumers (setmaxnreg: 24 a producer thread, 240 a consumer thread).
//   * Scores: ONE bfloat16 product.  A product of two bfloat16 values (8
//     significant bits each) is exact in float32; the tensor cores sum the
//     exact products into the float32 accumulator.  q goes into shared
//     memory once (TMA, 128-byte swizzle, the layout wgmma reads as its A
//     operand); K is the B operand, K-major.  Where the scale is a power of
//     two (a run-time test: head_dim 64 and 256 at their own scale), it is
//     folded into q in shared memory once, exactly (but for values below
//     2^-126 of the widened q); elsewhere the scores are multiplied by it
//     after the product, as the reference does.
//   * P.V: P (float32, in [0, 1]) split into three bfloat16 terms, hi the
//     top 8 significant bits of p (its float's high half), mid those of p
//     - hi, lo those of p - hi - mid: p = hi + mid + lo exactly, float32's
//     24 bits (two terms leave up to 2^-15 p, which moves outputs near 0
//     past one bfloat16 ulp + 1e-6; tests/test_torch_kernels.py emulates
//     one, two and three).  P feeds wgmma from registers 16 keys at a
//     time (the float32 accumulator's layout is the A fragment's layout for
//     16-bit types); V is the B operand, MN-major (the transpose bit).  Per 16 keys the products run lo, mid, hi,
//     smallest first, into a fresh accumulator per tile, which is added to
//     the running one in float32 (round to nearest) after the rescale.
//   * K and V come through TMA (cp.async.bulk.tensor.4d over the (hd, KV,
//     Skv, B) tensors; GQA is the kv-head coordinate, K/V are never
//     repeated in memory) into a ring of two stages, each guarded by
//     mbarriers: K full, V full (the producer's expect-tx and the copy's
//     bytes), empty (every consumer thread's arrival).  One thread of the
//     producer issues every copy; the scores of tile t need only K, so
//     they start while V is still landing.  TMA's out-of-bounds fill zeroes
//     the keys past Skv and the query rows past Sq.
//   * Shared memory is 64-column chunks (128 bytes a row, 128-byte
//     swizzle; one TMA box each).  head_dim 80 (160 bytes a row) is one
//     64-column chunk and a 16-column chunk with the 32-byte swizzle (two
//     boxes, 64 + 16: no padding, no wasted products); its products run
//     over both chunks (m64n64 + m64n16 for P.V).
//   * Online softmax in the accumulator's layout: a thread holds columns
//     (2t, 2t+1) of rows g and g + 8 of each 8-key slab of its warp's 16
//     rows; the row max takes two __shfl_xor_sync within the quad, the row
//     sum stays a per-thread partial until the end.  exp(x) is exp2(x *
//     log2(e)) on the SFU.  Only tiles that some query of the warpgroup
//     sees only in part evaluate the mask per entry.
//   * The heaviest query tiles (last under causal) are launched first;
//     tiles that every query of the block has masked are never loaded, and
//     a warpgroup skips the products of tiles that every query of its own
//     has masked (p = 0 and alpha = 1 there: l and acc would come out
//     unchanged).  Positions in 32 bits (the launch refuses Sq or Skv
//     above 2^31 - 129), offsets in 64; any Sq and Skv, no padding.
//   * No inter-warpgroup ping-pong and no overlap of the softmax with the
//     next tile's products (bfloat16; float16 has both, below): each
//     warpgroup waits for its products.
//
// Instantiations (the C entry point picks one by head_dim), bfloat16:
//
//   hd   chunks   keys a tile  P.V passes          shared memory a block
//   64   64       128          1                   83,008 bytes
//   80   64 + 16  128          1                   103,488
//   128  64 x 2   64           1                   99,392
//   256  64 x 4   64           4 (64 columns each) 197,696
//
// One block an SM (3 x 128 threads at 168 registers each at launch).  At
// head_dim 128 a tile is 64 keys, and head_dim 256's P.V runs in four
// passes of 64 output columns (a fresh accumulator of 32 registers each,
// P's terms kept), so that the running output (64 / 128 registers), the
// fresh accumulator and P's three terms fit 240 registers: without a spill
// at 64, 80 and 128; at 256 ptxas spills about 200 bytes a thread, and 64
// keys a tile still ran faster on an H100 than 32 (PERF.md §6).
//
// Above head_dim 256, flash_wide_kernel (at the end; entry
// lag_flash_attention_wide_bf16, _f16 in the float16 build): the same
// products at 64 query rows a block, the output's columns split between
// the two consumer warpgroups.
//
// No backward: the reference's kernel has none either.
//
// FLOAT16 (the same source built again with -DLAG_FLASH_F16: entry point
// lag_flash_attention_f16, kernel flash_f16_kernel).  wgmma's .f16 operand
// type, which has the same instruction shapes and float32 accumulators; q,
// k, v and o float16, the output rounded to float16 once.
//   * Scores: one float16 product (11 x 11 significant bits: exact in
//     float32).  The scale is never folded into q (a power of two would
//     push q's small values into float16's subnormals): the scores are
//     multiplied by it after the product, as the reference does.
//   * P.V: float16's exponent floor is the trouble.  Its subnormals start
//     at 2^-14 and it flushes below 2^-24, so P split as bfloat16's is
//     would lose every weight below 2^-24 (a causal row of 2048 keys with
//     one dominant score loses up to about 1e-4 of l) and the lower terms'
//     bits.  So each term is scaled by an exact power of two: x = p * 2^14
//     (at most 16384), hi = f16(x) rounded to nearest, lo = f16((x - hi) *
//     2^12) (x - hi is exact; |lo| < 2^15); hi + lo * 2^-12 holds x to about
//     2^-23 of x for p >= 2^-28, and to 2^-51 absolute below.  Two terms
//     are enough (one misses by 2^-12 of p; tests/test_torch_f16.py
//     emulates the design, one term and the unscaled split).
//   * The order (one wait for both terms): the running output acc
//     is kept at x's scale (2^14 times the sum) and is itself the hi
//     term's accumulator: each tile, acc = acc * alpha (float32), then
//     hi . V is multiplied into acc and lo . V into a fresh accumulator f
//     in ONE commit group, waited on once; then acc = fma(f, 2^-12, acc)
//     (f * 2^-12 exact: one rounding); o = acc * 2^-14 / l at the end.
//   * The schedule: the tensor cores do not wait on the softmax.
//     Each tile, a warpgroup issues tile t + 1's q . k^T (one commit
//     group), then tile t's P . V (hi and lo: the next group), waits for
//     the scores alone (wgmma.wait_group 1) and runs tile t + 1's scale,
//     mask, exp2 and row sums while P . V multiplies; then it waits for
//     P . V, folds f into acc and splits tile t + 1's P into its two
//     terms.  So the next tile's scores live beside this tile's P terms:
//     a second score buffer of BK / 2 registers (at head_dim 256, which
//     has no room for it, the next scores follow this tile's P . V).
//     ptxas keeps wgmma asynchronous only where no other instruction
//     writes a wgmma's registers between its issue and its wait, and
//     where the products are not issued under a branch (else it waits
//     after every wgmma, and the overlap is lost).  So every ALU write
//     (acc * alpha) comes before the tile's one fence; the fresh
//     accumulators are never zeroed (each one's first product overwrites
//     it); and every tile runs the products, also one that masks all of
//     a warpgroup's queries (p = 0, alpha = 1: acc and l come out
//     unchanged), the last tile on a released stage's K, its scores
//     dropped.  The two consumer warpgroups take turns (ping-pong) at
//     issuing their products: named barriers 1 and 2 (bar.sync on its
//     own, bar.arrive on the other's), so one warpgroup's softmax runs
//     under the other's products.  K and V are released apart (an empty
//     mbarrier each): a tile's K once its scores are in, its V after its
//     P . V.
//
// Instantiations, float16 (registers a consumer thread: acc, f, P's two
// terms, the next tile's scores, of 240):
//
//   hd   keys a tile  P.V passes  stages  registers      shared memory
//   64   128          1           3       32+32+64+64    115,816 bytes
//   80   128          1           3       40+40+64+64    144,488
//   128  64           1           3       64+64+32+32    132,200
//   256  64           4           2       128+32+32      197,704
//
// At head_dim 256 the fresh accumulator takes 64 columns at a time (four
// passes, each waited on), and the next tile's scores are issued after
// this tile's P . V.  Ping-pong helped at 64 and 128 (2-3 %); 64 keys a
// tile at head_dim 80 ran 16 % slower than 128 on an H100 (PERF.md §6).

// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns the first CUDA error of the
// tensor-map encoding, the shared-memory attribute call or the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the operand type: wgmma's type string, the element, its tensor-map type
#ifdef LAG_FLASH_F16
#define WG_T "f16"
#define LAG_FLASH_ENTRY lag_flash_attention_f16
#define LAG_FLASH_WIDE_ENTRY lag_flash_attention_wide_f16
#else
#define WG_T "bf16"
#define LAG_FLASH_ENTRY lag_flash_attention_bf16
#define LAG_FLASH_WIDE_ENTRY lag_flash_attention_wide_bf16
#endif

namespace {

#ifdef LAG_FLASH_F16
typedef __half elem;
constexpr bool kF16 = true;
constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
#else
typedef __nv_bfloat16 elem;
constexpr bool kF16 = false;
constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
#endif
// P's terms, and what one P.V pass multiplies its accumulator by: bfloat16
// three unscaled terms; float16 two, the lo term scaled by 2^12 more
constexpr int TERMS = kF16 ? 2 : 3;
constexpr float X_SCALE = kF16 ? 16384.f : 1.f;          // x = p * 2^14
constexpr float LO_SCALE = 4096.f;                      // lo's extra 2^12

constexpr int NC = 2;                  // consumer warpgroups a block
constexpr int ROWS = 64;               // query rows of a warpgroup (m64)
constexpr int BQ = NC * ROWS;          // query rows of a block
constexpr int THREADS = 128 * (NC + 1);
constexpr int STAGES = 2;              // the K/V ring
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// one instantiation: head_dim HD as NCH 64-column chunks and a TAIL-column
// chunk (0 or 16), BK keys a tile, P.V in passes of PASS 64-column chunks
template <int HD_, int NCH_, int TAIL_, int BK_, int PASS_>
struct Shape {
  static constexpr int HD = HD_;
  static constexpr int NCH = NCH_;
  static constexpr int TAIL = TAIL_;
  static constexpr int BK = BK_;
  static constexpr int PASS = PASS_;
  static constexpr int HDP = 64 * NCH + TAIL;        // columns stored
  static constexpr int Q_BYTES = ROWS * HDP * 2;     // a warpgroup's q
  static constexpr int KV_BYTES = BK * HDP * 2;      // one K or V tile
  // 1 KB to align the base (the swizzle repeats every 1024 bytes), the
  // q tiles, the ring, 7 mbarriers (q; K full, V full, empty a stage)
  static constexpr int SMEM_BYTES =
      1024 + NC * Q_BYTES + STAGES * 2 * KV_BYTES + 64;
  static_assert(HD == HDP && (TAIL == 0 || TAIL == 16), "chunks");
  static_assert(BK % 16 == 0 && BK <= 128 && NCH % PASS == 0, "tiles");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

#ifdef LAG_FLASH_F16
// one float16 instantiation: Shape's fields and ST ring stages
template <int HD_, int NCH_, int TAIL_, int BK_, int PASS_, int ST_,
          bool OV_>
struct F16Shape {
  static constexpr int HD = HD_;
  static constexpr int NCH = NCH_;
  static constexpr int TAIL = TAIL_;
  static constexpr int BK = BK_;
  static constexpr int PASS = PASS_;
  static constexpr int ST = ST_;
  // tile t + 1's scores issued before tile t's P . V (else after it)
  static constexpr bool OVERLAP = OV_;
  static constexpr int HDP = 64 * NCH + TAIL;
  static constexpr int Q_BYTES = ROWS * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;
  // 1 KB to align, the q tiles, the ring, 1 + 4 ST mbarriers (q; K full,
  // V full, K empty, V empty a stage)
  static constexpr int SMEM_BYTES =
      1024 + NC * Q_BYTES + ST * 2 * KV_BYTES + 8 * (1 + 4 * ST);
  static_assert(HD == HDP && (TAIL == 0 || TAIL == 16), "chunks");
  static_assert(BK % 16 == 0 && BK <= 128 && NCH % PASS == 0, "tiles");
  static_assert(ST >= 2, "K of tile t + 1 is read while V of t is");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

using Hd64 = F16Shape<64, 1, 0, 128, 1, 3, true>;
using Hd80 = F16Shape<80, 1, 16, 128, 1, 3, true>;
using Hd128 = F16Shape<128, 2, 0, 64, 2, 3, true>;
using Hd256 = F16Shape<256, 4, 0, 64, 1, 2, false>;
#else
using Hd64 = Shape<64, 1, 0, 128, 1>;
using Hd80 = Shape<80, 1, 16, 128, 1>;
using Hd128 = Shape<128, 2, 0, 64, 2>;
using Hd256 = Shape<256, 4, 0, 64, 1>;
#endif


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

// one TMA box of a 4-D map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle (1: 128 bytes, 3: 32 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
         | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's commit groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

// named barriers of the two consumer warpgroups (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(NC * 128) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(NC * 128) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (+)= a . b, m64n32k16: a and b K-major in shared memory
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." WG_T "." WG_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= a . b, m64n64k16: a and b K-major in shared memory
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." WG_T "." WG_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= a . b, m64n128k16: a and b K-major in shared memory
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." WG_T "." WG_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= a . b, m64n16k16: a in registers, b MN-major in shared memory
__device__ __forceinline__ void mma_rs16(float (&d)[8],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." WG_T "." WG_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (+)= a . b, m64n64k16: a in registers, b MN-major in shared memory
__device__ __forceinline__ void mma_rs64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." WG_T "." WG_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ bool visible(int qi, int kp, int Skv, int causal,
                                        int window) {
  return kp < Skv && (!causal || qi >= kp)
         && (window <= 0 || qi - kp < window);
}

// online softmax of one tile's scores in place (scores -> weights p): sc[4j
// + e] is key k0 + 8j + 2tq + (e & 1) of row r0 (e < 2) or r1; returns the
// rescale factors alpha of rows r0 and r1.  kMasked: the mask is evaluated
// per entry (bit 4j + e of vis)
template <bool kMasked, int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint64_t vis, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (kMasked && !((vis >> i) & 1u)) sc[i] = NEG;
    if (i & 2) mx1 = fmaxf(mx1, sc[i]);
    else mx0 = fmaxf(mx0, sc[i]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = exp2_ftz((m0 - mn0) * LOG2E);
  al1 = exp2_ftz((m1 - mn1) * LOG2E);
  m0 = mn0;
  m1 = mn1;
  const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float p = exp2_ftz(fmaf(sc[i], LOG2E, -((i & 2) ? ml1 : ml0)));
    if (kMasked && !((vis >> i) & 1u)) p = 0.f;
    sc[i] = p;
    if (i & 2) ps1 += p;
    else ps0 += p;
  }
  l0 = al0 * l0 + ps0;
  l1 = al1 * l1 + ps1;
}

// the top 8 significant bits of x (a bfloat16 value, truncated)
__device__ __forceinline__ float top8(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// x = hi + mid + lo exactly, for x0 and x1 as bfloat16 pairs (x0 the low
// half): each term the top 8 significant bits of what the terms before it
// leave (x - hi and x - hi - mid are exact in float32), so three cover
// float32's 24
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const float r0 = x0 - top8(x0), r1 = x1 - top8(x1);
  const float s0 = r0 - top8(r0), s1 = r1 - top8(r1);
  hi = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  mid = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

// x0 = p0 * 2^14 and x1 as float16 pairs (x0 the low half): hi = f16(x)
// to nearest, lo = f16((x - hi) * 2^12); x - hi and both scalings exact
__device__ __forceinline__ void split2h(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const float x0 = __fmul_rn(p0, X_SCALE), x1 = __fmul_rn(p1, X_SCALE);
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l =
      __floats2half2_rn(__fmul_rn(__fsub_rn(x0, hf.x), LO_SCALE),
                        __fmul_rn(__fsub_rn(x1, hf.y), LO_SCALE));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// two floats rounded to nearest into an elem pair (the first the low half)
__device__ __forceinline__ uint32_t round2(float a, float b) {
#ifdef LAG_FLASH_F16
  const __half2 y = __floats2half2_rn(a, b);
#else
  const __nv_bfloat162 y = __floats2bfloat162_rn(a, b);
#endif
  return *reinterpret_cast<const uint32_t*>(&y);
}

// the shared address `a` anew, where it stands: the compiler cannot
// compute descriptors from it ahead of the wgmmas issued before, which
// would hold registers the accumulators need
__device__ __forceinline__ uint32_t anew(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// scores of one warpgroup: d = q . k^T over every 16-column k step (the
// 64-column chunks, then the tail chunk); q and K are K-major
template <class S>
__device__ __forceinline__ void scores(float (&d)[S::BK / 2], uint32_t qw,
                                       uint32_t ks) {
#pragma unroll
  for (int c = 0; c < S::NCH; ++c) {
    qw = anew(qw);
    ks = anew(ks);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t a = desc(qw + c * ROWS * 128 + 32 * j, 16, 1024, 1);
      const uint64_t b = desc(ks + c * S::BK * 128 + 32 * j, 16, 1024, 1);
      const int acc = c > 0 || j > 0;
      if constexpr (S::BK == 32) mma_ss32(d, a, b, acc);
      else if constexpr (S::BK == 64) mma_ss64(d, a, b, acc);
      else mma_ss128(d, a, b, acc);
    }
  }
  if constexpr (S::TAIL) {
    const uint64_t a = desc(qw + S::NCH * ROWS * 128, 16, 256, 3);
    const uint64_t b = desc(ks + S::NCH * S::BK * 128, 16, 256, 3);
    if constexpr (S::BK == 32) mma_ss32(d, a, b, 1);
    else if constexpr (S::BK == 64) mma_ss64(d, a, b, 1);
    else mma_ss128(d, a, b, 1);
  }
}

#ifdef LAG_FLASH_F16
// one float16 P . V pass over the output's chunks p0 .. p0 + PASS - 1 (and
// the tail chunk with the last pass): hi . V multiplied into the running
// output acc, lo . V into the fresh f / ft (its first product overwrites
// them), 16 keys a step, one commit group (not waited on here); the caller
// fences
template <class S, int TN>
__device__ __forceinline__ void pv_f16(float (&acc)[S::NCH][32],
                                       float (&acct)[TN],
                                       float (&f)[S::PASS][32],
                                       float (&ft)[TN],
                                       const uint32_t (&pf)[S::BK / 16][2][4],
                                       uint32_t vs, int p0) {
  constexpr int BK = S::BK, NCH = S::NCH, PASS = S::PASS;
  const bool tail = S::TAIL != 0 && p0 + PASS == NCH;
  const uint32_t vp = anew(vs);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < PASS; ++c) {
      const uint64_t d = desc(vp + (p0 + c) * BK * 128 + kk * 16 * 128,
                              BK * 128, 1024, 1);
      mma_rs64(acc[p0 + c], pf[kk][1], d, 1);
      mma_rs64(f[c], pf[kk][0], d, kk > 0);
    }
    if constexpr (S::TAIL != 0) {
      if (tail) {
        const uint64_t d =
            desc(vp + NCH * BK * 128 + kk * 16 * 32, 16, 256, 3);
        mma_rs16(acct, pf[kk][1], d, 1);
        mma_rs16(ft, pf[kk][0], d, kk > 0);
      }
    }
  }
  wgmma_commit();
}
#endif

#ifndef LAG_FLASH_F16
template <class S>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap qm,
                  const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm,
                  const __grid_constant__ CUtensorMap qtm,
                  const __grid_constant__ CUtensorMap ktm,
                  const __grid_constant__ CUtensorMap vtm,
                  elem* __restrict__ o, int Sq, int Skv, int H, int KV,
                  float scale, int causal, int window) {
  constexpr int BK = S::BK, NCH = S::NCH, TAIL = S::TAIL, PASS = S::PASS;
  constexpr int KV_BYTES = S::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;      // NC q tiles
  const uint32_t ring = q_s + NC * S::Q_BYTES;      // STAGES x (K, V)
  const uint32_t q_full = ring + STAGES * 2 * KV_BYTES;
  // per stage s: K full, V full, empty
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  // positions in 32 bits (the launch bounds Sq and Skv below 2^31 - 128),
  // the output's offsets in 64
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * BQ;

  // the keys any valid query of this block can see
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int t_begin = k_begin / BK;
  const int tiles = (k_end + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NC * S::Q_BYTES);
#pragma unroll
      for (int w = 0; w < NC; ++w) {
        const uint32_t dst = q_s + w * S::Q_BYTES;
        const int row = q0 + w * ROWS;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(dst + c * ROWS * 128, &qm, q_full, 64 * c, h, row, b);
        if (TAIL)
          tma_load(dst + NCH * ROWS * 128, &qtm, q_full, 64 * NCH, h, row,
                   b);
      }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (uint32_t)(i / STAGES) & 1u;
        if (i >= STAGES) mbar_wait(empty(s), ph ^ 1u);   // round i/S - 1 done
        const int row = (t_begin + i) * BK;
        const uint32_t ks = ring + s * 2 * KV_BYTES, vs = ks + KV_BYTES;
        mbar_expect_tx(k_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(ks + c * BK * 128, &km, k_full(s), 64 * c, g, row, b);
        if (TAIL)
          tma_load(ks + NCH * BK * 128, &ktm, k_full(s), 64 * NCH, g, row,
                   b);
        mbar_expect_tx(v_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(vs + c * BK * 128, &vm, v_full(s), 64 * c, g, row, b);
        if (TAIL)
          tma_load(vs + NCH * BK * 128, &vtm, v_full(s), 64 * NCH, g, row,
                   b);
      }
    }
    return;
  }

  // -- a consumer warpgroup: 64 query rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1;            // which consumer
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int gr = lane / 4, tq = lane % 4;          // accumulator row, pair
  const uint32_t qw = q_s + cw * S::Q_BYTES;
  const int wq0 = q0 + cw * ROWS;
  const int r0 = wq0 + 16 * warp + gr, r1 = r0 + 8;   // this thread's rows
  // the keys any valid query of this warpgroup can see
  const int wq_last = (wq0 + ROWS < Sq ? wq0 + ROWS : Sq) - 1;
  int wk_end = wq0 < Sq ? Skv : 0;
  if (causal && wq_last + 1 < wk_end) wk_end = wq_last + 1;
  int wk_begin = 0;
  if (window > 0 && wq0 - window + 1 > 0) wk_begin = wq0 - window + 1;

  mbar_wait(q_full, 0);
  // the scale folds into q exactly only where it is a power of two
  const uint32_t sbits = __float_as_uint(scale);
  const bool fold = (sbits & 0x7fffffu) == 0 && (sbits >> 23) != 0;
  if (fold) {
    uint32_t* const qp = reinterpret_cast<uint32_t*>(smem_raw + (qw - raw));
    for (int i = t; i < S::Q_BYTES / 4; i += 128) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qp + i));
      const __nv_bfloat162 y = __floats2bfloat162_rn(x.x * scale,
                                                     x.y * scale);
      qp[i] = *reinterpret_cast<const uint32_t*>(&y);
    }
    // the generic-proxy writes, visible to wgmma (the async proxy) of the
    // whole warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  }

  constexpr int TN = TAIL ? TAIL / 2 : 1;
  float acc[NCH][32];             // O; chunk c, [4j + e]: column 64c + 8j +
  float acct[TN];                 // 2tq + (e & 1) of row r0 (e < 2) or r1
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < TN; ++i) acct[i] = 0.f;
  float m0 = NEG, m1 = NEG;       // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;       // this thread's part of the sums

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (uint32_t)(i / STAGES) & 1u;
    const int k0 = (t_begin + i) * BK;
    const bool active = k0 < wk_end && k0 + BK > wk_begin;
    const uint32_t ks = ring + s * 2 * KV_BYTES, vs = ks + KV_BYTES;
    float al0 = 1.f, al1 = 1.f;
    // P's terms as A fragments, per 16 keys: lo, mid, hi
    uint32_t pf[BK / 16][TERMS][4];
    mbar_wait(k_full(s), ph);
    if (active) {
      float sc[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
      own(sc);
      wgmma_fence();
      scores<S>(sc, qw, ks);
      wgmma_commit_and_wait();
      own(sc);
      if (!fold) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
      }
      // the mask: evaluated per entry only where some query of the
      // warpgroup sees this tile in part
      const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= wq0)
                        && (window <= 0 || wq0 + ROWS - 1 - k0 < window);
      if (full) {
        softmax_tile<false, BK>(sc, 0, m0, m1, l0, l1, al0, al1);
      } else {
        uint64_t vis = 0;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int kp = k0 + 8 * (e / 4) + 2 * tq + (e & 1);
          if (visible((e & 2) ? r1 : r0, kp, Skv, causal, window))
            vis |= 1ull << e;
        }
        softmax_tile<true, BK>(sc, vis, m0, m1, l0, l1, al0, al1);
      }
      // A fragment of keys 16kk .. + 15: register r holds entries 8kk + 2r
      // and + 1 (rows g, g + 8, g, g + 8; keys 2tq, 2tq, 2tq + 8, 2tq + 8)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                 pf[kk][TERMS - 1][r], pf[kk][1][r], pf[kk][0][r]);
    }
    mbar_wait(v_full(s), ph);
    if (active) {
      // acc = acc * alpha + P . V, P . V into a fresh accumulator, in
      // passes of PASS 64-column chunks (the tail chunk with the last)
#pragma unroll
      for (int p0 = 0; p0 < NCH; p0 += PASS) {
        constexpr bool kTail = TAIL != 0;
        const bool tail = kTail && p0 + PASS == NCH;
        const uint32_t vp = anew(vs);
        float f[PASS][32];
        float ft[TN];
#pragma unroll
        for (int c = 0; c < PASS; ++c) {
#pragma unroll
          for (int e = 0; e < 32; ++e) f[c][e] = 0.f;
          own(f[c]);
        }
#pragma unroll
        for (int e = 0; e < TN; ++e) ft[e] = 0.f;
        own(ft);
        // one phase of all three terms
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int term = 0; term < TERMS; ++term) {
            const int accum = kk > 0 || term > 0;
#pragma unroll
            for (int c = 0; c < PASS; ++c)
              mma_rs64(f[c], pf[kk][term],
                       desc(vp + (p0 + c) * BK * 128 + kk * 16 * 128,
                            BK * 128, 1024, 1),
                       accum);
            if constexpr (kTail) {
              if (tail)
                mma_rs16(ft, pf[kk][term],
                         desc(vp + NCH * BK * 128 + kk * 16 * 32, 16, 256,
                              3),
                         accum);
            }
          }
        wgmma_commit_and_wait();
#pragma unroll
        for (int c = 0; c < PASS; ++c) own(f[c]);
        own(ft);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int term = 0; term < TERMS; ++term) own(pf[kk][term]);
#pragma unroll
        for (int c = 0; c < PASS; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc[p0 + c][e] = fmaf(acc[p0 + c][e], (e & 2) ? al1 : al0,
                                  f[c][e]);
        if (tail) {
#pragma unroll
          for (int e = 0; e < TN; ++e)
            acct[e] = fmaf(acct[e], (e & 2) ? al1 : al0, ft[e]);
        }
      }
    }
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  // row r0 (r1): columns 8j + 2tq and + 1 of each chunk are [4j] and [4j +
  // 1] ([4j + 2], [4j + 3])
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? r1 : r0;
    const float den = e ? den1 : den0;
    if (r < Sq) {
      elem* const dst = o + (((int64_t)b * Sq + r) * H + h) * S::HD + 2 * tq;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * j) = round2(
              acc[c][4 * j + 2 * e] / den, acc[c][4 * j + 2 * e + 1] / den);
        }
      if (TAIL) {
#pragma unroll
        for (int j = 0; j < TAIL / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 64 * NCH + 8 * j) = round2(
              acct[4 * j + 2 * e] / den, acct[4 * j + 2 * e + 1] / den);
        }
      }
    }
  }
}

#endif  // !LAG_FLASH_F16

#ifdef LAG_FLASH_F16
// float16 (see the header): tile t + 1's scores under tile t's P . V, hi . V
// into the running output and lo . V into a fresh accumulator in one commit
// group, the two consumer warpgroups taking turns at the tensor cores
template <class S>
__global__ void __launch_bounds__(THREADS, 1)
flash_f16_kernel(const __grid_constant__ CUtensorMap qm,
                 const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm,
                 const __grid_constant__ CUtensorMap qtm,
                 const __grid_constant__ CUtensorMap ktm,
                 const __grid_constant__ CUtensorMap vtm,
                 elem* __restrict__ o, int Sq, int Skv, int H, int KV,
                 float scale, int causal, int window) {
  constexpr int BK = S::BK, NCH = S::NCH, TAIL = S::TAIL, PASS = S::PASS;
  constexpr int ST = S::ST, KV_BYTES = S::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;      // NC q tiles
  const uint32_t ring = q_s + NC * S::Q_BYTES;      // ST x (K, V)
  const uint32_t q_full = ring + ST * 2 * KV_BYTES;
  // per stage s: K full, V full, K empty, V empty
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + ST + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * ST + s); };

  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * BQ;

  // the keys any valid query of this block can see
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int t_begin = k_begin / BK;
  const int tiles = (k_end + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), NC * 128);
      mbar_init(v_empty(s), NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- the producer warpgroup: one thread issues every copy; a stage's K
    // waits for its K to be released, its V for its V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NC * S::Q_BYTES);
#pragma unroll
      for (int w = 0; w < NC; ++w) {
        const uint32_t dst = q_s + w * S::Q_BYTES;
        const int row = q0 + w * ROWS;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(dst + c * ROWS * 128, &qm, q_full, 64 * c, h, row, b);
        if (TAIL)
          tma_load(dst + NCH * ROWS * 128, &qtm, q_full, 64 * NCH, h, row,
                   b);
      }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % ST;
        const uint32_t ph = (uint32_t)(i / ST) & 1u;
        const int row = (t_begin + i) * BK;
        const uint32_t ks = ring + s * 2 * KV_BYTES, vs = ks + KV_BYTES;
        if (i >= ST) mbar_wait(k_empty(s), ph ^ 1u);   // round i/ST - 1 done
        mbar_expect_tx(k_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(ks + c * BK * 128, &km, k_full(s), 64 * c, g, row, b);
        if (TAIL)
          tma_load(ks + NCH * BK * 128, &ktm, k_full(s), 64 * NCH, g, row,
                   b);
        if (i >= ST) mbar_wait(v_empty(s), ph ^ 1u);
        mbar_expect_tx(v_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(vs + c * BK * 128, &vm, v_full(s), 64 * c, g, row, b);
        if (TAIL)
          tma_load(vs + NCH * BK * 128, &vtm, v_full(s), 64 * NCH, g, row,
                   b);
      }
    }
    return;
  }

  // -- a consumer warpgroup: 64 query rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1;            // which consumer
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int gr = lane / 4, tq = lane % 4;          // accumulator row, pair
  const uint32_t qw = q_s + cw * S::Q_BYTES;
  const int wq0 = q0 + cw * ROWS;
  const int r0 = wq0 + 16 * warp + gr, r1 = r0 + 8;   // this thread's rows

  constexpr int TN = TAIL ? TAIL / 2 : 1;
  // O * 2^14: chunk c, [4j + e] is column 64c + 8j + 2tq + (e & 1) of row
  // r0 (e < 2) or r1
  float acc[NCH][32];
  float acct[TN];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < TN; ++i) acct[i] = 0.f;
  float m0 = NEG, m1 = NEG;       // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;       // this thread's part of the sums
  uint32_t pf[BK / 16][2][4];     // P's terms per 16 keys: lo, hi
  float al0 = 1.f, al1 = 1.f;     // the rescale that goes with pf

  // the scores of the tile at key k0 -> its weights p (scale, mask, online
  // softmax): the mask evaluated per entry only where some query of the
  // warpgroup sees the tile in part
  auto softmax = [&](float (&sc)[BK / 2], int k0, float& a0, float& a1) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
    const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= wq0)
                      && (window <= 0 || wq0 + ROWS - 1 - k0 < window);
    if (full) {
      softmax_tile<false, BK>(sc, 0, m0, m1, l0, l1, a0, a1);
    } else {
      uint64_t vis = 0;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int kp = k0 + 8 * (e / 4) + 2 * tq + (e & 1);
        if (visible((e & 2) ? r1 : r0, kp, Skv, causal, window))
          vis |= 1ull << e;
      }
      softmax_tile<true, BK>(sc, vis, m0, m1, l0, l1, a0, a1);
    }
  };
  // p -> its two float16 terms as A fragments of 16 keys: register r holds
  // entries 8kk + 2r and + 1 (rows g, g + 8, g, g + 8; keys 2tq, 2tq, 2tq +
  // 8, 2tq + 8)
  auto split = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2h(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pf[kk][1][r],
                pf[kk][0][r]);
  };

  // every ALU write to a wgmma's registers comes before the fence that
  // precedes it, and none between its issue and its wait: so ptxas keeps
  // the products asynchronous.  The fresh accumulators (f, ft, the
  // scores) are not zeroed: each one's first product overwrites it
  auto fresh = [&](float (&f)[PASS][32], float (&ft)[TN]) {
#pragma unroll
    for (int c = 0; c < PASS; ++c) own(f[c]);
    own(ft);
  };
  // acc += (lo . V) * 2^-12 for the pass at p0: the scaling exact, one
  // rounding
  auto fold = [&](float (&f)[PASS][32], float (&ft)[TN], int p0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) own(acc[c]);
    own(acct);
#pragma unroll
    for (int c = 0; c < PASS; ++c) own(f[c]);
    own(ft);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      own(pf[kk][0]);
      own(pf[kk][1]);
    }
#pragma unroll
    for (int c = 0; c < PASS; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[p0 + c][e] = fmaf(f[c][e], 1.f / LO_SCALE, acc[p0 + c][e]);
    if (TAIL && p0 + PASS == NCH) {
#pragma unroll
      for (int e = 0; e < TN; ++e)
        acct[e] = fmaf(ft[e], 1.f / LO_SCALE, acct[e]);
    }
  };

  mbar_wait(q_full, 0);
  if (tiles > 0) {
    // the first tile's scores, waited on at once
    const int k0 = t_begin * BK;
    float sc[BK / 2];
    own(sc);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    scores<S>(sc, qw, ring);
    wgmma_commit_and_wait();
    own(sc);
    mbar_arrive(k_empty(0));
    softmax(sc, k0, al0, al1);
    split(sc);
    // warpgroup 0 takes the first turn
    if (cw == 1) bar_arrive(1);
  }

  // Every tile runs the products, also one that masks all of this
  // warpgroup's queries (its p is 0 and its alpha 1: acc and l come out
  // unchanged), and the last tile multiplies a released stage's K (no copy
  // lands there any more) and drops the scores: one product more, and the
  // products are issued without a branch.
  for (int i = 0; i < tiles; ++i) {
    const int s = i % ST, sn = (i + 1) % ST;
    const bool next = i + 1 < tiles;
    const int kn = (t_begin + i + 1) * BK;
    const uint32_t vs = ring + s * 2 * KV_BYTES + KV_BYTES;
    const uint32_t ksn = ring + sn * 2 * KV_BYTES;
    float sc[BK / 2];               // the next tile's scores
    float f[PASS][32], ft[TN];      // lo . V, fresh each pass
    // acc = acc * alpha
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= (e & 2) ? al1 : al0;
    if (TAIL) {
#pragma unroll
      for (int e = 0; e < TN; ++e) acct[e] *= (e & 2) ? al1 : al0;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) own(acc[c]);
    own(acct);
    fresh(f, ft);
    own(sc);
    bar_sync(1 + cw);                              // this warpgroup's turn
    if (S::OVERLAP && next)
      mbar_wait(k_full(sn), (uint32_t)((i + 1) / ST) & 1u);
    mbar_wait(v_full(s), (uint32_t)(i / ST) & 1u);
    wgmma_fence();
    if constexpr (S::OVERLAP) {
      scores<S>(sc, qw, ksn);
      wgmma_commit();
    }
    pv_f16<S>(acc, acct, f, ft, pf, vs, 0);
    // the other warpgroup's turn (warpgroup 1 gives its last one to none)
    if (cw == 0 || next) bar_arrive(2 - cw);
    float an0 = 1.f, an1 = 1.f;
    if constexpr (S::OVERLAP) {
      // the next tile's scores: wait for them alone, and run its softmax
      // while this tile's P . V multiplies
      wgmma_wait<1>();
      own(sc);
      if (next) {
        mbar_arrive(k_empty(sn));
        softmax(sc, kn, an0, an1);
      }
    }
    wgmma_wait<0>();
    fold(f, ft, 0);
#pragma unroll
    for (int p0 = PASS; p0 < NCH; p0 += PASS) {
      fresh(f, ft);
      wgmma_fence();
      pv_f16<S>(acc, acct, f, ft, pf, vs, p0);
      wgmma_wait<0>();
      fold(f, ft, p0);
    }
    mbar_arrive(v_empty(s));
    if constexpr (!S::OVERLAP) {
      // the next tile's scores after this tile's P . V: they need no
      // registers while it multiplies
      if (next) mbar_wait(k_full(sn), (uint32_t)((i + 1) / ST) & 1u);
      own(sc);
      wgmma_fence();
      scores<S>(sc, qw, ksn);
      wgmma_commit_and_wait();
      own(sc);
      if (next) {
        mbar_arrive(k_empty(sn));
        softmax(sc, kn, an0, an1);
      }
    }
    if (next) {
      split(sc);
      al0 = an0;
      al1 = an1;
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  // row r0 (r1): columns 8j + 2tq and + 1 of each chunk are [4j] and [4j +
  // 1] ([4j + 2], [4j + 3]); acc * 2^-14 exact
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? r1 : r0;
    const float den = e ? den1 : den0;
    if (r < Sq) {
      elem* const dst = o + (((int64_t)b * Sq + r) * H + h) * S::HD + 2 * tq;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * j) = round2(
              acc[c][4 * j + 2 * e] * (1.f / X_SCALE) / den,
              acc[c][4 * j + 2 * e + 1] * (1.f / X_SCALE) / den);
        }
      if (TAIL) {
#pragma unroll
        for (int j = 0; j < TAIL / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 64 * NCH + 8 * j) = round2(
              acct[4 * j + 2 * e] * (1.f / X_SCALE) / den,
              acct[4 * j + 2 * e + 1] * (1.f / X_SCALE) / den);
        }
      }
    }
  }
}
#endif  // LAG_FLASH_F16

// ---------------------------------------------------------------------------
// head_dim above 256: flash_wide_kernel (entry LAG_FLASH_WIDE_ENTRY)
// ---------------------------------------------------------------------------
//
// The design above at 64 query rows a block, the output's columns split
// between the two consumer warpgroups.  A block takes one (batch, head), 64
// query rows and a slab of OC = 128 CW output columns (CW 64-column chunks
// a warpgroup: 3 up to head_dim 384, 4 up to 512); above 512 the grid's
// third dimension takes the slabs (ns = ceil(hd / OC) of them).
//   * Scores once per (64 rows, key tile), over the full head_dim: each
//     warpgroup multiplies ITS chunks of every slab's q and K (one 2-byte
//     product, k steps of 16 columns, m64n32k16), and the two partial
//     scores meet in shared memory: each warpgroup adds the other's to its
//     own, a + b = b + a, so both hold the same scores bit for bit and run
//     the same online softmax.  Then each runs P.V for its own chunks of
//     the slab (P split as above), from its own P in registers.
//   * q stays in shared memory where the head_dim is one slab (64 KB at
//     512); above, each key tile streams q's slab j with K's (q's buffer
//     released by the consumers after the slab's products).
//   * K (each slab) and V (the block's slab) through TMA into a ring of
//     two stages of 32 keys each (32 KB at 512), K and V with their own
//     full / empty mbarriers; the exchange is double-buffered by tile
//     parity, one 256-thread named barrier a tile.  At OC 512: 1 KB of
//     alignment, q 64 KB, the ring 128 KB, the exchange 32 KB.
//   * head_dims not a multiple of 64 need no padding: TMA zero-fills the
//     columns past hd (the wrapper pads hd to a multiple of 8, which the
//     tensor map's row stride needs); columns past hd are not stored.
//   * Registers a consumer thread: the output 32 CW floats, a 64-column
//     P.V accumulator, the scores (16) and P's terms (24 in bfloat16).

constexpr int WBK = 32;                 // keys a tile of the wide kernel

// CW 64-column chunks a warpgroup, OC = 128 CW columns a block
template <int CW_>
struct WideShape {
  static constexpr int CW = CW_;
  static constexpr int OC = 128 * CW;
  static constexpr int Q_BYTES = ROWS * OC * 2;
  static constexpr int KV_BYTES = WBK * OC * 2;
  // the partial scores: 2 (tile parity) x NC x 128 threads x WBK / 2
  static constexpr int X_BYTES = 2 * NC * 128 * (WBK / 2) * 4;
  // 1 KB to align, q, the ring, the exchange, 10 mbarriers
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + X_BYTES + 128;
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

using Wide384 = WideShape<3>;
using Wide512 = WideShape<4>;

template <class S>
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap qm,
                  const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm,
                  elem* __restrict__ o, int Sq, int Skv, int H, int KV,
                  int hd, int ns, float scale, int causal, int window) {
  constexpr int CW = S::CW, OC = S::OC, KV_BYTES = S::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;       // 2 CW chunks of q
  const uint32_t ring = q_s + S::Q_BYTES;            // STAGES x (K, V)
  const uint32_t xch = ring + STAGES * 2 * KV_BYTES;
  const uint32_t q_full = xch + S::X_BYTES, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 16u + 8u * s; };
  auto k_empty = [&](int s) { return q_full + 32u + 8u * s; };
  auto v_full = [&](int s) { return q_full + 48u + 8u * s; };
  auto v_empty = [&](int s) { return q_full + 64u + 8u * s; };

  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * ROWS;
  const int z0 = (int)blockIdx.z * OC;               // the block's slab

  const int q_last = (q0 + ROWS < Sq ? q0 + ROWS : Sq) - 1;
  int k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int t_begin = k_begin / WBK;
  const int tiles = (k_end + WBK - 1) / WBK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC * 128);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), NC * 128);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- the producer: q's slab (once, or each tile above one slab), K's
    // slabs, the block's slab of V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int kc = 0, qc = 0;                // K slabs and q slabs issued
      for (int i = 0; i < tiles; ++i) {
        const int row = (t_begin + i) * WBK;
        for (int j = 0; j < ns; ++j) {
          if (ns > 1 || i == 0) {
            if (qc > 0) mbar_wait(q_empty, (uint32_t)(qc - 1) & 1u);
            mbar_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
            for (int c = 0; c < 2 * CW; ++c)
              tma_load(q_s + c * ROWS * 128, &qm, q_full, j * OC + 64 * c,
                       h, q0, b);
            ++qc;
          }
          const int s = kc % STAGES;
          if (kc >= STAGES)
            mbar_wait(k_empty(s), ((uint32_t)(kc / STAGES) & 1u) ^ 1u);
          const uint32_t ks = ring + s * 2 * KV_BYTES;
          mbar_expect_tx(k_full(s), KV_BYTES);
#pragma unroll
          for (int c = 0; c < 2 * CW; ++c)
            tma_load(ks + c * WBK * 128, &km, k_full(s), j * OC + 64 * c, g,
                     row, b);
          ++kc;
        }
        const int s = i % STAGES;
        if (i >= STAGES)
          mbar_wait(v_empty(s), ((uint32_t)(i / STAGES) & 1u) ^ 1u);
        const uint32_t vs = ring + s * 2 * KV_BYTES + KV_BYTES;
        mbar_expect_tx(v_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < 2 * CW; ++c)
          tma_load(vs + c * WBK * 128, &vm, v_full(s), z0 + 64 * c, g, row,
                   b);
      }
    }
    return;
  }

  // -- a consumer warpgroup: chunks cw CW .. cw CW + CW - 1 of each slab
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int r0 = q0 + 16 * warp + gr, r1 = r0 + 8;
  float* const xbuf = reinterpret_cast<float*>(smem_raw + (xch - raw));

  float acc[CW][32];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  int kc = 0, qc = 0;
  for (int i = 0; i < tiles; ++i) {
    const int k0 = (t_begin + i) * WBK;
    float sc[WBK / 2];
#pragma unroll
    for (int e = 0; e < WBK / 2; ++e) sc[e] = 0.f;
    for (int j = 0; j < ns; ++j) {
      if (ns > 1 || i == 0) {
        mbar_wait(q_full, (uint32_t)qc & 1u);
        ++qc;
      }
      const int s = kc % STAGES;
      mbar_wait(k_full(s), (uint32_t)(kc / STAGES) & 1u);
      const uint32_t ks = ring + s * 2 * KV_BYTES;
      own(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const uint32_t qa = anew(q_s + (cw * CW + c) * ROWS * 128);
        const uint32_t kb = anew(ks + (cw * CW + c) * WBK * 128);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          mma_ss32(sc, desc(qa + 32 * jj, 16, 1024, 1),
                   desc(kb + 32 * jj, 16, 1024, 1), j > 0 || c > 0 || jj > 0);
      }
      wgmma_commit_and_wait();
      own(sc);
      mbar_arrive(k_empty(s));
      ++kc;
      if (ns > 1) mbar_arrive(q_empty);
    }
    // the two partial scores: publish this warpgroup's, add the other's
    float* const mine = xbuf + ((i & 1) * NC + cw) * (WBK / 2) * 128 + t;
    const float* const other =
        xbuf + ((i & 1) * NC + (cw ^ 1)) * (WBK / 2) * 128 + t;
#pragma unroll
    for (int e = 0; e < WBK / 2; ++e) mine[128 * e] = sc[e];
    asm volatile("bar.sync 1, %0;\n" :: "n"(NC * 128) : "memory");
#pragma unroll
    for (int e = 0; e < WBK / 2; ++e) sc[e] = (sc[e] + other[128 * e]) * scale;

    float al0, al1;
    const bool full = k0 + WBK <= Skv && (!causal || k0 + WBK - 1 <= q0)
                      && (window <= 0 || q0 + ROWS - 1 - k0 < window);
    if (full) {
      softmax_tile<false, WBK>(sc, 0, m0, m1, l0, l1, al0, al1);
    } else {
      uint64_t vis = 0;
#pragma unroll
      for (int e = 0; e < WBK / 2; ++e) {
        const int kp = k0 + 8 * (e / 4) + 2 * tq + (e & 1);
        if (visible((e & 2) ? r1 : r0, kp, Skv, causal, window))
          vis |= 1ull << e;
      }
      softmax_tile<true, WBK>(sc, vis, m0, m1, l0, l1, al0, al1);
    }
    uint32_t pf[WBK / 16][TERMS][4];
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kF16)
          split2h(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                  pf[kk][TERMS - 1][r], pf[kk][0][r]);
        else
          split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                 pf[kk][TERMS - 1][r], pf[kk][1][r], pf[kk][0][r]);
      }

    const int s = i % STAGES;
    mbar_wait(v_full(s), (uint32_t)(i / STAGES) & 1u);
    const uint32_t vs = ring + s * 2 * KV_BYTES + KV_BYTES;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const uint32_t vp = anew(vs + (cw * CW + c) * WBK * 128);
      float f[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) f[e] = 0.f;
      own(f);
#pragma unroll
      for (int ph = 0; ph < (kF16 ? 2 : 1); ++ph) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
          for (int term = kF16 ? ph : 0; term < (kF16 ? ph + 1 : TERMS);
               ++term)
            mma_rs64(f, pf[kk][term],
                     desc(vp + kk * 16 * 128, WBK * 128, 1024, 1),
                     kk > 0 || term > 0);
        wgmma_commit_and_wait();
        own(f);
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
          for (int term = 0; term < TERMS; ++term) own(pf[kk][term]);
        if (kF16 && ph == 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) f[e] *= 1.f / LO_SCALE;
          own(f);
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[c][e] = fmaf(acc[c][e], (e & 2) ? al1 : al0,
                         f[e] * (1.f / X_SCALE));
    }
    mbar_arrive(v_empty(s));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? r1 : r0;
    const float den = e ? den1 : den0;
    if (r < Sq) {
      elem* const dst = o + (((int64_t)b * Sq + r) * H + h) * hd;
#pragma unroll
      for (int c = 0; c < CW; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = z0 + (cw * CW + c) * 64 + 8 * j + 2 * tq;
          if (col < hd)
            *reinterpret_cast<uint32_t*>(dst + col) = round2(
                acc[c][4 * j + 2 * e] / den, acc[c][4 * j + 2 * e + 1] / den);
        }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over a contiguous 2-byte (batch, rows, heads, hd) tensor:
// boxes of `cols` columns (from any column) of one head, `box_rows` rows
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int64_t hd,
            int64_t heads, int64_t rows, int64_t batch, uint32_t cols,
            uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(hd * 2),
                                 (cuuint64_t)(heads * hd * 2),
                                 (cuuint64_t)(rows * heads * hd * 2)};
  const cuuint32_t box[4] = {cols, 1, box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, MAP_TYPE, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class S>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int64_t KV, float scale,
           int causal, int64_t window, cudaStream_t stream) {
  const int64_t nq = (Sq + BQ - 1) / BQ;
  if (B * H > 0x7fffffffLL || nq > 65535 || Sq > 0x7fffffffLL - BQ
      || Skv > 0x7fffffffLL - 128)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  // keys: with no key at all no tile is loaded; the maps stay valid
  const void* kb = Skv > 0 ? k : q;
  const void* vb = Skv > 0 ? v : q;
  const int64_t kv_heads = Skv > 0 ? KV : H, kv_rows = Skv > 0 ? Skv : Sq;
  CUtensorMap qm, km, vm, qtm, ktm, vtm;
  bool ok = encode(enc, &qm, q, S::HD, H, Sq, B, 64, ROWS,
                   CU_TENSOR_MAP_SWIZZLE_128B)
            && encode(enc, &km, kb, S::HD, kv_heads, kv_rows, B, 64, S::BK,
                      CU_TENSOR_MAP_SWIZZLE_128B)
            && encode(enc, &vm, vb, S::HD, kv_heads, kv_rows, B, 64, S::BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  qtm = qm;
  ktm = km;
  vtm = vm;
  if (S::TAIL)
    ok = ok && encode(enc, &qtm, q, S::HD, H, Sq, B, S::TAIL, ROWS,
                      CU_TENSOR_MAP_SWIZZLE_32B)
         && encode(enc, &ktm, kb, S::HD, kv_heads, kv_rows, B, S::TAIL, S::BK,
                   CU_TENSOR_MAP_SWIZZLE_32B)
         && encode(enc, &vtm, vb, S::HD, kv_heads, kv_rows, B, S::TAIL, S::BK,
                   CU_TENSOR_MAP_SWIZZLE_32B);
  if (!ok) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device and instantiation
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
#ifdef LAG_FLASH_F16
  const auto kernel = flash_f16_kernel<S>;
#else
  const auto kernel = flash_kernel<S>;
#endif
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)nq);
  // a window of 2^31 - 1 or more masks nothing a query can see
  const int win = window >= 0x7fffffffLL ? 0x7fffffff : (int)window;
  kernel<<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      qm, km, vm, qtm, ktm, vtm, (elem*)o, (int)Sq, (int)Skv, (int)H,
      (int)KV, scale, causal, win);
  return (int)cudaGetLastError();
}


// head_dim above 256 (hd a multiple of 8): the wide kernel at OC 384 up to
// head_dim 384, else at OC 512 with ceil(hd / 512) slabs
template <class S>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
                int64_t hd, float scale, int causal, int64_t window,
                cudaStream_t stream) {
  const int64_t nq = (Sq + ROWS - 1) / ROWS, ns = (hd + S::OC - 1) / S::OC;
  if (B * H > 0x7fffffffLL || nq > 65535 || ns > 65535
      || Sq > 0x7fffffffLL - ROWS || Skv > 0x7fffffffLL - 128
      || hd > 0x7fffffffLL || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const void* kb = Skv > 0 ? k : q;
  const void* vb = Skv > 0 ? v : q;
  const int64_t kv_heads = Skv > 0 ? KV : H, kv_rows = Skv > 0 ? Skv : Sq;
  CUtensorMap qm, km, vm;
  if (!(encode(enc, &qm, q, hd, H, Sq, B, 64, ROWS,
               CU_TENSOR_MAP_SWIZZLE_128B)
        && encode(enc, &km, kb, hd, kv_heads, kv_rows, B, 64, WBK,
                  CU_TENSOR_MAP_SWIZZLE_128B)
        && encode(enc, &vm, vb, hd, kv_heads, kv_rows, B, 64, WBK,
                  CU_TENSOR_MAP_SWIZZLE_128B)))
    return (int)cudaErrorInvalidValue;
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_wide_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)nq, (unsigned)ns);
  const int win = window >= 0x7fffffffLL ? 0x7fffffff : (int)window;
  flash_wide_kernel<S><<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      qm, km, vm, (elem*)o, (int)Sq, (int)Skv, (int)H, (int)KV, (int)hd,
      (int)ns, scale, causal, win);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); bfloat16 (float16 in the
// -DLAG_FLASH_F16 build: lag_flash_attention_f16), contiguous, 16-byte
// aligned.  window <= 0: no window.  hd 64, 80, 128 and 256 are built.
int LAG_FLASH_ENTRY(const void* q, const void* k, const void* v,
                             void* o, int64_t B, int64_t Sq, int64_t Skv,
                             int64_t H, int64_t KV, int64_t hd, float scale,
                             int causal, int64_t window, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (hd != Hd64::HD && hd != Hd80::HD && hd != Hd128::HD && hd != Hd256::HD)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == Hd64::HD)
    return launch<Hd64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window,
                        s);
  if (hd == Hd80::HD)
    return launch<Hd80>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window,
                        s);
  if (hd == Hd128::HD)
    return launch<Hd128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                         window, s);
  return launch<Hd256>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window,
                       s);
}

// head_dim above 256: q, o (B, Sq, H, hd), k, v (B, Skv, KV, hd), 2-byte as
// above, contiguous, 16-byte aligned, hd a multiple of 8
int LAG_FLASH_WIDE_ENTRY(const void* q, const void* k, const void* v,
                         void* o, int64_t B, int64_t Sq, int64_t Skv,
                         int64_t H, int64_t KV, int64_t hd, float scale,
                         int causal, int64_t window, void* stream) {
  if (KV <= 0 || H % KV != 0 || hd <= Hd256::HD || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= Wide384::OC)
    return launch_wide<Wide384>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale,
                                causal, window, s);
  return launch_wide<Wide512>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale,
                              causal, window, s);
}

}  // extern "C"
