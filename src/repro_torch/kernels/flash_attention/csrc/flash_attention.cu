// Flash attention forward for Hopper (sm_90a), float32 in and out, the two
// products on the tensor cores in split TF32 ("3xTF32") with float32
// accumulators (below).  bfloat16 operands have their own kernel,
// csrc/flash_attention_bf16.cu.
//
// Hand-written CUDA replacement of the Pallas kernel flash_attention_padded
// (_flash_kernel) of src/repro/kernels/flash_attention/flash_attention.py:
// online-softmax GQA attention, forward only,
//
//   q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> o (B, Sq, H, hd),
//
// query head h reads kv head h / (H / KV).  It computes what _flash_kernel
// computes: per kv tile s = (q . k) * scale; masked entries are
// NEG = -1e30; m_new = max(m, rowmax s); p = exp(s - m_new) where unmasked,
// else 0; l = exp(m - m_new) * l + rowsum p; acc = acc * exp(m - m_new) +
// p . v; at the end o = acc / max(l, 1e-30).  Masks: query < Sq, key < Skv,
// causal (q >= k), window (q - k < window), positions counted from 0 for
// both q and k, as in the reference.
//
// One templated source, four instantiations (the C entry point picks one
// by head_dim; any other head_dim is refused; the wrapper zero-pads a
// head_dim between to the next of them), and flash_wide_kernel (at the end,
// entry lag_flash_attention_wide_f32) for every head_dim above 256:
//
//   hd   stored  keys a tile  q's hi fragments  n tiles a P.V pass  warps  shared
//   64   64      64           registers         8 (all)            4      112 KB
//   80   96      32           registers         12 (all)           4      96 KB
//   128  128     16           shared memory     8 (two passes)     4      112 KB
//   256  256     16           shared memory     8 (two passes)     8      224 KB
//
// (shared memory a block; two blocks an SM at 64-128, one at 256: eight
// warps an SM each).  head_dim 256 (recurrentgemma) is head_dim 128's
// layout twice over: the block has two warps per 16 query rows, the warp
// of half hh owning columns [128 hh, 128 hh + 128) of q, K, V and the
// output (each K/V tile is stored as two 128-column sub-tiles, each laid
// out and swizzled as at 128), so a thread keeps 128's registers.  Each
// warp of a pair computes the scores over its half of hd; the two partial
// scores meet in shared memory (in the K-lo buffer, once every warp has
// read it; a 64-thread named barrier per pair) and each warp adds its
// partner's to its own: a + b = b + a exactly, so both hold the same bits
// and run the same online softmax, and each does P.V for its own columns.
// A warp's score product sums each 16 columns in a fresh accumulator,
// added to the running scores in float32 (round to nearest): a 256-term
// dot in one chain of tensor-core accumulations erred 3.2e-6 against a
// float64 evaluation at the serving shape, the plain float32 version 1.9e-6,
// this 1.1e-6 (PERF.md).  256 columns of q's hi and lo fill 128 KB of the
// 227 KB, so a block takes 224 KB and an SM one block of eight warps.  head_dim 80 is stored
// as 96 (the copy zero-fills columns 80..95 of every K/V row, q's are
// zero, the output's are not written): the fragment and swizzle arithmetic
// below wants whole groups of 32 columns, and the padding costs 20 % more
// tensor-core work.  At 80 and 128 the registers of q's hi fragments, the
// output accumulator, the fresh P.V accumulator and the scores do not fit
// 255 a thread at head_dim 64's 64-key tiles: at 80 the tiles are 32 keys (half
// the scores); at 128 q's hi fragments go to shared memory beside their
// lo, the tiles are 16 keys and the P.V product runs in two passes of 8 n
// tiles (half the fresh accumulator; P's split is recomputed per pass).
// Each shape was the fastest without a spill among those tried on an H100
// (PERF.md).
//
// Bound: operations.  At the serving path's shape (B 4, S 2048, H 32/KV 8,
// hd 64, causal) the two products take 4*B*H*hd*S(S+1)/2 = 68.7 GFLOP.
// The kernel runs them as three TF32 products each (below), 206 GFLOP on
// the tensor cores: 0.416 ms at the H100's 495 TFLOP/s of dense TF32.  The
// same work on the float32 FMA units would take 1.03 ms at 67 TFLOP/s; the
// 168 MB of q/k/v/o take 0.05 ms.  The design:
//
//   * Split TF32, float32-accurate.  Every operand x of both products is
//     split into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a product
//     a.b is lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), small terms first,
//     into one float32 accumulator (mma.sync m16n8k8 .tf32, f32 accumulate).
//     The dropped lo.lo term is below float32's rounding; one TF32 pass
//     would miss the plain version by ~1e-3 (tests/test_torch_kernels.py
//     emulates both).  Where the scale is a power of two (a run-time test:
//     hd 64 and 256 at their own scale hd^-0.5, 2^-3 and 2^-4) it is folded
//     into q once, exactly.  Elsewhere (80^-0.5, 128^-0.5, and the true
//     scale of a smaller head_dim zero-padded to a built one) the scores
//     are multiplied by the scale after the product, as the reference does.
//   * Tiles.  A block of 4 warps takes BQ = 64 query rows of one (b, h),
//     16 rows per warp (the m16 of the mma); the loop inside the block
//     (the TPU's sequential kv grid axis) runs over BK keys per tile.
//     Each warp keeps its q fragments for the whole loop (hi in registers
//     below hd 128, lo in its threads' own slots of shared memory, 16 KB a
//     block at hd 64, which keeps the kernel within 255 registers without
//     a spill),
//     its 16 x BK scores and its 16 x hd output accumulator in registers,
//     in the mma accumulator layout.
//   * K and V come through a two-stage cp.async ring in dynamic shared
//     memory; the copy of tile t + 1 runs under the work on tile t.  Keys
//     past Skv are zero-filled by the copy itself (src-size 0): no read
//     leaves the tensors.  Once a tile has landed, the block splits it in
//     place, once (hi over the copy, lo into one more buffer), so that the
//     four warps do not each split the same K and V: at hd 64, 2 x 32 KB of
//     ring, 32 KB of lo and q's 16 KB, 112 KB a block, two blocks an SM.
//   * 16-byte fragment reads.  Inside every 16 columns of hd the order of
//     the score product's k steps is relabelled (k step 2m takes columns
//     16m + 4t and 16m + 4t + 1 as its columns t and t + 4, k step 2m + 1
//     columns 16m + 4t + 2 and + 3), the same for q and K, so that one
//     float4 holds a thread's K fragments of two k steps.  The output's hd
//     columns are relabelled the same way (with NT = hd / 8 n tiles, n tile
//     n, column c is hd NT c + n), so that one float4 holds a thread's V
//     fragments of four n tiles and a thread writes 2 NT consecutive floats
//     of o.  Shared rows are unpadded, with their 16-byte chunks
//     XOR-swizzled by the key's low three bits: each quarter warp's reads
//     of K and of V hit all 32 banks once (at the stored hd 96 one V read
//     in three is a two-way conflict).
//   * Online softmax in the accumulator's layout: a thread holds columns
//     (2t, 2t+1) of rows g and g + 8 of each 8-key slab; the row max takes
//     two __shfl_xor_sync within the quad, the row sum stays a per-thread
//     partial until the end.  exp(x) is exp2(x * log2(e)) on the SFU.  Only
//     tiles that some query of the block sees only in part (the diagonal,
//     the window edge, the ragged last tile) evaluate the mask per entry.
//   * P.V with no shuffles: the accumulator gives a thread columns (2t,
//     2t+1) of a slab, the A fragment wants columns (t, t + 4).  Keys are
//     relabelled inside each 8-key slab (A column t is key 2t, column t + 4
//     key 2t + 1) and V's B fragment is read at the same keys: the sum over
//     keys is the same, in another order.  Each tile's P.V goes into a fresh
//     accumulator that is added to the running one in float32 (round to
//     nearest), so no long chain of tensor-core accumulations builds up.
//   * GQA in the index (K/V never repeated in memory), int64 offsets, the
//     heaviest query tiles (last under causal) launched first, and tiles
//     that every query of the block has masked (past the diagonal, before
//     the window) skipped: such a tile gives p = 0 everywhere and alpha =
//     1, so l and acc would come out of it unchanged.  Rows past Sq are
//     computed on zeros and not stored: any Sq and Skv, no padding.
//
// No backward: the reference's kernel has none either.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns the first CUDA error of the
// shared-memory attribute call or of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;               // row groups of a block
constexpr int BQ = 16 * WARPS;         // query rows per block, 16 per group
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// one instantiation: head_dim HD stored as HDP columns, BK keys a tile,
// the P.V product in passes of OG float4 chunks (4 OG n tiles) of the
// output, q's hi fragments in shared memory beside its lo (QS) or in
// registers, HALVES warps per 16 query rows each owning W = HDP / HALVES
// columns (a multiple of 32)
template <int HD_, int HDP_, int BK_, int OG_, bool QS_, int HALVES_ = 1>
struct Shape {
  static constexpr int HD = HD_;
  static constexpr int HDP = HDP_;
  static constexpr int BK = BK_;
  static constexpr int OG = OG_;
  static constexpr bool QS = QS_;
  static constexpr int HALVES = HALVES_;
  static constexpr int THREADS = 32 * WARPS * HALVES;
  static constexpr int W = HDP / HALVES;        // columns of one warp
  static constexpr int NT = W / 8;              // n tiles of a warp's output
  static constexpr int TILE = BK * HDP;         // floats of one K or V tile
  static constexpr int STAGE = 2 * TILE;        // one ring stage: K, V
  static constexpr int QLO = WARPS * HALVES * NT * 32 * 4;  // floats of q's lo
  // 2 ring stages, the lo of the current tile, q's lo (and hi) fragments
  static constexpr int SMEM_BYTES =
      (3 * STAGE + (QS ? 2 : 1) * QLO) * (int)sizeof(float);
  static_assert(W % 32 == 0 && HD <= HDP && HD % 4 == 0, "hd");
  static_assert(HALVES == 1 || HD == HDP, "split columns are not padded");
  static_assert((NT / 4) % OG == 0, "P.V passes");
  static_assert(TILE % (4 * THREADS) == 0 && BK % 8 == 0 && BK <= 64, "BK");
  // the partial scores a pair exchanges fit the K-lo buffer
  static_assert(HALVES == 1 || WARPS * HALVES * BK * 16 <= TILE, "exchange");
};

using Hd64 = Shape<64, 64, 64, 2, false>;
using Hd80 = Shape<80, 96, 32, 3, false>;
using Hd128 = Shape<128, 128, 16, 2, true>;
using Hd256 = Shape<256, 256, 16, 2, true, 2>;

// 2^x, flushing results below 2^-126 to 0 (a weight that small adds
// nothing a float32 sum of weights up to 1 and beyond can hold)
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to float32 precision, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += a . b in split TF32, small terms first; b0/b1 already split in
// shared memory (hi: bh, lo: bl)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float bh0,
                                     float bh1, float bl0, float bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// element offset of the 4-element chunk (16 bytes of float32) c of row r of
// a tile: chunks
// XOR-swizzled by r's low three bits.  A quarter warp reads K at rows
// {2i, 2i + 1} and chunks 4m .. 4m + 3, V at the four even (or odd) rows of
// an 8-key slab and chunks {cc, NT / 4 + cc}; the swizzle spreads both
// over the 8 chunk slots of 128 bytes (rows are a multiple of 128 bytes)
template <int HDP>
__device__ __forceinline__ int chunk_at(int r, int c) {
  const int sw = HDP == 128
      ? (((r & 1) << 2) | ((r >> 1) & 3))
      : ((((r ^ (r >> 2)) & 1) << 2) | ((r >> 1) & 1));
  return r * HDP + 4 * (c ^ sw);
}

// element offset of chunk c (of the whole row) of row r of a K or V tile:
// under HALVES > 1 the tile is HALVES sub-tiles of BK rows of W columns,
// each laid out as chunk_at<W>
template <class S>
__device__ __forceinline__ int tile_at(int r, int c) {
  if (S::HALVES == 1) return chunk_at<S::HDP>(r, c);
  return (c / (S::W / 4)) * S::BK * S::W + chunk_at<S::W>(r, c % (S::W / 4));
}

// four floats (16 bytes, bypassing L1) into shared memory, zero-filled
// where `in` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every group but the most recent one complete
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ bool visible(int64_t qi, int64_t kp, int64_t Skv,
                                        int causal, int64_t window) {
  return kp < Skv && (!causal || qi >= kp)
         && (window <= 0 || qi - kp < window);
}

// online softmax of one tile's scores in place (scores -> weights p);
// returns the rescale factors alpha of rows r0 and r1.  kMasked: bit
// 4j + e of vis says whether score sc[j][e] is visible; a tile every score
// of which is visible skips the bit tests
template <bool kMasked, int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 8][4],
                                             uint32_t vis, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked && !((vis >> (4 * j + e)) & 1u)) sc[j][e] = NEG;
      if (e < 2) mx0 = fmaxf(mx0, sc[j][e]);
      else mx1 = fmaxf(mx1, sc[j][e]);
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
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(sc[j][e], LOG2E, -(e < 2 ? ml0 : ml1)));
      if (kMasked && !((vis >> (4 * j + e)) & 1u)) p = 0.f;
      sc[j][e] = p;
      if (e < 2) ps0 += p;
      else ps1 += p;
    }
  l0 = al0 * l0 + ps0;
  l1 = al1 * l1 + ps1;
}

template <class S>
__global__ void __launch_bounds__(S::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
                 float scale, int causal, int64_t window) {
  constexpr int HD = S::HD, HDP = S::HDP, BK = S::BK, NT = S::NT;
  constexpr int W = S::W, THREADS = S::THREADS;
  constexpr int TILE = S::TILE, STAGE = S::STAGE;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;
  // the lo of the current tile (and, at HALVES 2, the pair's score exchange)
  float* const lo_buf = ring + 2 * STAGE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's row group and column half (columns hh W .. hh W + W - 1)
  const int wr = S::HALVES == 1 ? warp : warp % WARPS;
  const int hh = S::HALVES == 1 ? 0 : warp / WARPS;
  const int sub = hh * BK * W;                 // its sub-tile of K and V
  const int gr = lane / 4, tq = lane % 4;      // mma group row, thread in group
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;
  const int64_t g = h / (H / KV);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t r0 = q0 + wr * 16 + gr, r1 = r0 + 8;     // this thread's rows
  // the scale folds into q exactly only where it is a power of two
  const uint32_t sbits = __float_as_uint(scale);
  const bool fold = (sbits & 0x7fffffu) == 0 && (sbits >> 23) != 0;
  const float qscale = fold ? scale : 1.f;

  // q (* scale where it folds) as A fragments: [k step][a0..a3], a0 row
  // r0, a1 row r1, a2 row r0, a3 row r1; k step 2m takes hd 16m + 4tq (a0,
  // a1) and + 1 (a2, a3), k step 2m + 1 hd + 2 and + 3.  hi in registers,
  // lo in this thread's own slots of shared memory (one 16-byte slot per k
  // step, consecutive lanes on consecutive slots), which saves NT * 4
  // registers.  Columns past HD are zero
  uint32_t qh[NT][4];
  uint4* const qlo = reinterpret_cast<uint4*>(lo_buf + STAGE)
                     + warp * NT * 32 + lane;
  // under S::QS only
  uint4* const qhi = qlo + WARPS * S::HALVES * NT * 32;
  {
    uint32_t ql[NT][4];
    const float* qr0 =
        q + ((b * Sq + (r0 < Sq ? r0 : 0)) * H + h) * HD + hh * W;
    const float* qr1 =
        q + ((b * Sq + (r1 < Sq ? r1 : 0)) * H + h) * HD + hh * W;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < W / 16; ++m) {
      const bool col = HD == HDP || 4 * m + tq < HD / 4;
      const float4 x = r0 < Sq && col ? load4(qr0 + 4 * (4 * m + tq)) : zero;
      const float4 y = r1 < Sq && col ? load4(qr1 + 4 * (4 * m + tq)) : zero;
      split(x.x * qscale, qh[2 * m][0], ql[2 * m][0]);
      split(y.x * qscale, qh[2 * m][1], ql[2 * m][1]);
      split(x.y * qscale, qh[2 * m][2], ql[2 * m][2]);
      split(y.y * qscale, qh[2 * m][3], ql[2 * m][3]);
      split(x.z * qscale, qh[2 * m + 1][0], ql[2 * m + 1][0]);
      split(y.z * qscale, qh[2 * m + 1][1], ql[2 * m + 1][1]);
      split(x.w * qscale, qh[2 * m + 1][2], ql[2 * m + 1][2]);
      split(y.w * qscale, qh[2 * m + 1][3], ql[2 * m + 1][3]);
    }
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      qlo[32 * kk] = make_uint4(ql[kk][0], ql[kk][1], ql[kk][2], ql[kk][3]);
      if (S::QS)
        qhi[32 * kk] = make_uint4(qh[kk][0], qh[kk][1], qh[kk][2], qh[kk][3]);
    }
  }

  // the keys any valid query of this block can see
  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int64_t t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  // one tile of K and V into ring stage s: 4-element copies, a row of HDP /
  // 4 chunks per as many consecutive threads; keys past Skv and columns
  // past HD are zero-filled
  auto load_tile = [&](int64_t t, int s) {
    float* ks = ring + s * STAGE;
    float* vs = ks + TILE;
#pragma unroll
    for (int it = 0; it < TILE / 4 / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / (HDP / 4), c = i % (HDP / 4);
      const int64_t kp = t * BK + r;
      const bool in = kp < Skv && (HD == HDP || c < HD / 4);
      const int64_t idx = in ? ((b * Skv + kp) * KV + g) * HD + 4 * c : 0;
      cp_async4(ks + tile_at<S>(r, c), k + idx, in);
      cp_async4(vs + tile_at<S>(r, c), v + idx, in);
    }
    cp_async_commit();
  };

  float acc[NT][4];                       // O; n tile n, column c: hd NT c + n
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG, m1 = NEG;               // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;               // this thread's part of the sums

  if (t_begin < t_end) load_tile(t_begin, 0);
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int s = (int)((t - t_begin) & 1);
    float* const ks = ring + s * STAGE;
    float* const vs = ks + TILE;
    const float* const kh = ks + sub;     // this warp's columns of K, V
    const float* const vh = vs + sub;
    cp_async_wait_all();                  // tile t has landed
    __syncthreads();                      // ... for every thread, and every
                                          // warp is done with tile t - 1
    if (t + 1 < t_end) load_tile(t + 1, s ^ 1);
    // split tile t once: hi in place, lo into lo_buf (same offsets)
#pragma unroll
    for (int it = 0; it < STAGE / 4 / THREADS; ++it) {
      const int i = 4 * (it * THREADS + threadIdx.x);
      float4 x = *reinterpret_cast<float4*>(ks + i);
      uint32_t hx, lx, hy, ly, hz, lz, hw, lw;
      split(x.x, hx, lx);
      split(x.y, hy, ly);
      split(x.z, hz, lz);
      split(x.w, hw, lw);
      *reinterpret_cast<float4*>(ks + i) = make_float4(
          __uint_as_float(hx), __uint_as_float(hy), __uint_as_float(hz),
          __uint_as_float(hw));
      *reinterpret_cast<float4*>(lo_buf + i) = make_float4(
          __uint_as_float(lx), __uint_as_float(ly), __uint_as_float(lz),
          __uint_as_float(lw));
    }
    __syncthreads();
    const float* const kl = lo_buf + sub;
    const float* const vl = lo_buf + TILE + sub;
    const int64_t k0 = t * BK;

    // -- scores: sc[j] holds keys 8j + 2tq (+1) of rows r0 (0, 1), r1 (2, 3)
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int m = 0; m < W / 16; ++m) {
      uint32_t ql[2][4], qa[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 x = qlo[32 * (2 * m + u)];
        ql[u][0] = x.x; ql[u][1] = x.y; ql[u][2] = x.z; ql[u][3] = x.w;
        if (S::QS) {
          const uint4 y = qhi[32 * (2 * m + u)];
          qa[u][0] = y.x; qa[u][1] = y.y; qa[u][2] = y.z; qa[u][3] = y.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[u][e] = qh[2 * m + u][e];
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        // B = K^T at key 8j + gr: hd 16m + 4tq .. + 3, two k steps
        const int off = chunk_at<W>(8 * j + gr, 4 * m + tq);
        const float4 bh = load4(kh + off);
        // two k steps into d, three (split) TF32 products each
        auto step = [&](float (&d)[4]) {
          const float4 bl = load4(kl + off);
          mma3(d, qa[0], ql[0], bh.x, bh.y, bl.x, bl.y);
          mma3(d, qa[1], ql[1], bh.z, bh.w, bl.z, bl.w);
        };
        if (S::HALVES == 1) {
          step(sc[j]);
        } else {
          // 16 columns into a fresh accumulator, added in float32 (round
          // to nearest): no long chain of tensor-core accumulations
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          step(f);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += f[e];
        }
      }
    }
    if (!fold) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
    }
    if (S::HALVES == 2) {
      // the pair's partial scores: each warp publishes its own in the
      // K-lo buffer (every warp is done reading it) and adds its
      // partner's; a + b = b + a, so both warps hold the same scores
      float* const xs = lo_buf + warp * (BK / 8) * 4 * 32 + lane;
      const float* const xp = lo_buf + (warp ^ WARPS) * (BK / 8) * 4 * 32
                              + lane;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[32 * (4 * j + e)] = sc[j][e];
      asm volatile("bar.sync %0, 64;" :: "r"(1 + wr) : "memory");
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += xp[32 * (4 * j + e)];
    }

    // -- mask: one bit per score, all set unless some query of the block
    // sees this tile only in part
    uint32_t vis = 0xffffffffu;
    const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0)
                      && (window <= 0 || q0 + BQ - 1 - k0 < window);
    if (!full) {
      vis = 0u;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t kp = k0 + 8 * j + 2 * tq + (e & 1);
          if (visible(e < 2 ? r0 : r1, kp, Skv, causal, window))
            vis |= 1u << (4 * j + e);
        }
    }

    float al0, al1;
    if (full) softmax_tile<false, BK>(sc, vis, m0, m1, l0, l1, al0, al1);
    else softmax_tile<true, BK>(sc, vis, m0, m1, l0, l1, al0, al1);

    // -- acc = acc * alpha + P . V, P . V into a fresh accumulator, in
    // passes of OG float4 chunks (4 OG n tiles) of the output
#pragma unroll
    for (int c0 = 0; c0 < NT / 4; c0 += S::OG) {
      float ot[4 * S::OG][4];
#pragma unroll
      for (int n = 0; n < 4 * S::OG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ot[n][e] = 0.f;
#pragma unroll
      for (int js = 0; js < BK / 8; ++js) {
        // A = P of slab js, keys relabelled: column tq is key 2tq, column
        // tq + 4 key 2tq + 1
        uint32_t ph[4], pl[4];
        split(sc[js][0], ph[0], pl[0]);
        split(sc[js][2], ph[1], pl[1]);
        split(sc[js][1], ph[2], pl[2]);
        split(sc[js][3], ph[3], pl[3]);
#pragma unroll
        for (int cc = 0; cc < S::OG; ++cc) {
          // B = V at keys 8js + 2tq (b0) and + 1 (b1), hd NT gr + 4(c0 +
          // cc) .. + 3: n tiles 4(c0 + cc) .. + 3
          const int o0 = chunk_at<W>(8 * js + 2 * tq, NT / 4 * gr + c0 + cc);
          const int o1 = chunk_at<W>(8 * js + 2 * tq + 1,
                                     NT / 4 * gr + c0 + cc);
          const float4 h0 = load4(vh + o0);
          const float4 h1 = load4(vh + o1);
          const float4 w0 = load4(vl + o0);
          const float4 w1 = load4(vl + o1);
          mma3(ot[4 * cc], ph, pl, h0.x, h1.x, w0.x, w1.x);
          mma3(ot[4 * cc + 1], ph, pl, h0.y, h1.y, w0.y, w1.y);
          mma3(ot[4 * cc + 2], ph, pl, h0.z, h1.z, w0.z, w1.z);
          mma3(ot[4 * cc + 3], ph, pl, h0.w, h1.w, w0.w, w1.w);
        }
      }
#pragma unroll
      for (int n = 0; n < 4 * S::OG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * c0 + n][e] = fmaf(acc[4 * c0 + n][e], e < 2 ? al0 : al1,
                                    ot[n][e]);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  // row r0 (r1): hd NT (2tq + c) + n is acc[n][c] ([2 + c]): 2 NT
  // consecutive floats from hd 2 NT tq, those below HD stored
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int64_t r = e ? r1 : r0;
    const float den = e ? den1 : den0;
    if (r < Sq) {
      float* const dst = o + ((b * Sq + r) * H + h) * HD + hh * W;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int cc = 0; cc < NT / 4; ++cc) {
          const int col = NT * (2 * tq + c) + 4 * cc;
          if (HD == HDP || col < HD)
            *reinterpret_cast<float4*>(dst + col) = make_float4(
                acc[4 * cc][2 * e + c] / den, acc[4 * cc + 1][2 * e + c] / den,
                acc[4 * cc + 2][2 * e + c] / den,
                acc[4 * cc + 3][2 * e + c] / den);
        }
    }
  }
}

template <class S>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int64_t KV, float scale,
           int causal, int64_t window, cudaStream_t stream) {
  constexpr int smem_bytes = S::SMEM_BYTES;
  const int64_t nq = (Sq + BQ - 1) / BQ;
  if (B * H > 0x7fffffffLL || nq > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device and instantiation
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)nq);
  flash_fwd_kernel<S><<<grid, S::THREADS, smem_bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
      H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim above 256: flash_wide_kernel (entry lag_flash_attention_wide_f32)
// ---------------------------------------------------------------------------
//
// head_dim 256's layout widened: CWARPS (3 up to head_dim 384, 4 up to 512)
// warps per 16 query rows, each owning 128 columns of a slab of OC = 128
// CWARPS (its own 128-column sub-tile of every K and V tile, laid out and
// swizzled as at 128), two row groups a block (32 query rows: q's hi and lo
// fragments of 32 rows x 512 columns fill 128 KB).  Above 512 the grid's
// third dimension takes the output's slabs.
//   * Split TF32 as above, three products per float32 product.
//   * Scores once per (32 rows, key tile) over the full head_dim: each warp
//     multiplies its columns of every slab (16 columns at a time into a
//     fresh accumulator, added in float32), the CWARPS partial scores of a
//     row group meet in shared memory and every warp of the group adds
//     them in column-warp order, so all hold the same bits.
//   * q's fragments are split once into each thread's own slots of shared
//     memory where the head_dim is one slab; above, each key tile reloads
//     them per slab (from L2).
//   * An item stream through a three-stage cp.async ring: per key tile of
//     16 keys, K's slabs, then the block's slab of V; items n + 1 and n + 2
//     land under the work on item n, one barrier an item.  K's and V's
//     fragments are split into hi and lo as they are read (each by the two
//     row groups: no pass over the tile, no buffer of lo).  At OC 512: 3 x
//     32 KB of ring, 128 KB of q's fragments.
//   * Columns past hd (the wrapper pads hd to a multiple of 8) are
//     zero-filled by the copy and not stored.

constexpr int WBK = 16;                  // its keys a tile

template <int CWARPS_>
struct Wide {
  static constexpr int HALVES = CWARPS_; // warps per 16 query rows
  static constexpr int WROWS = 2;        // row groups of 16 a block
  static constexpr int W = 128;          // columns a warp
  static constexpr int HDP = W * HALVES; // OC: columns a slab
  static constexpr int BK = WBK;
  static constexpr int OG = 2;
  static constexpr int NT = W / 8;
  static constexpr int THREADS = 32 * WROWS * HALVES;
  static constexpr int BQ = 16 * WROWS;
  static constexpr int ITEM = BK * HDP;  // floats of a K slab or V slab
  static constexpr int STAGES = 3;
  static constexpr int QF = WROWS * HALVES * NT * 32 * 4;   // q's lo (hi)
  static constexpr int SMEM_BYTES =
      (STAGES * ITEM + 2 * QF) * (int)sizeof(float);
  static_assert(SMEM_BYTES <= 232448, "shared memory");
  static_assert(ITEM % (4 * THREADS) == 0, "item copies");
  static_assert(WROWS * HALVES * BK * 16 <= ITEM, "exchange");
};

using Wide384 = Wide<3>;
using Wide512 = Wide<4>;

template <class S>
__global__ void __launch_bounds__(S::THREADS, 1)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t hd,
                  int ns, float scale, int causal, int64_t window) {
  constexpr int BK = S::BK, NT = S::NT, W = S::W, OC = S::HDP;
  constexpr int THREADS = S::THREADS, ITEM = S::ITEM, BQW = S::BQ;
  constexpr int WROWS = S::WROWS;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;                // S::STAGES items

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % WROWS, cw = warp / WROWS;
  const int sub = cw * BK * W;
  const int gr = lane / 4, tq = lane % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;
  const int64_t g = h / (H / KV);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQW;
  const int64_t z0 = (int64_t)blockIdx.z * OC;
  const int64_t r0 = q0 + wr * 16 + gr, r1 = r0 + 8;

  uint4* const qlo = reinterpret_cast<uint4*>(ring + S::STAGES * ITEM)
                     + warp * NT * 32 + lane;
  uint4* const qhi = qlo + WROWS * S::HALVES * NT * 32;
  // this thread's q fragments of slab j, split, into its own slots
  auto load_q = [&](int j) {
    const int64_t c0 = (int64_t)j * OC + cw * W;
    const float* qr0 = q + ((b * Sq + (r0 < Sq ? r0 : 0)) * H + h) * hd + c0;
    const float* qr1 = q + ((b * Sq + (r1 < Sq ? r1 : 0)) * H + h) * hd + c0;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int m = 0; m < W / 16; ++m) {
      const bool col = c0 + 4 * (4 * m + tq) < hd;
      const float4 x = r0 < Sq && col ? load4(qr0 + 4 * (4 * m + tq)) : zero;
      const float4 y = r1 < Sq && col ? load4(qr1 + 4 * (4 * m + tq)) : zero;
      uint32_t hi[8], lo[8];
      split(x.x, hi[0], lo[0]);
      split(y.x, hi[1], lo[1]);
      split(x.y, hi[2], lo[2]);
      split(y.y, hi[3], lo[3]);
      split(x.z, hi[4], lo[4]);
      split(y.z, hi[5], lo[5]);
      split(x.w, hi[6], lo[6]);
      split(y.w, hi[7], lo[7]);
      qlo[32 * (2 * m)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      qhi[32 * (2 * m)] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      qlo[32 * (2 * m + 1)] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      qhi[32 * (2 * m + 1)] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  };

  const int64_t q_last = (q0 + BQW < Sq ? q0 + BQW : Sq) - 1;
  int64_t k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int64_t t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;
  const int64_t items = (t_end > t_begin ? t_end - t_begin : 0) * (ns + 1);

  // item n into ring stage s: key tile t_begin + n / (ns + 1); part p = n %
  // (ns + 1): K's slab p, or (p == ns) V's slab of this block
  auto load_item = [&](int64_t n, int s) {
    const int64_t kt = t_begin + n / (ns + 1);
    const int p = (int)(n % (ns + 1));
    const float* const src = p < ns ? k : v;
    const int64_t c0 = p < ns ? (int64_t)p * OC : z0;
    float* const dst = ring + s * ITEM;
#pragma unroll
    for (int it = 0; it < ITEM / 4 / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / (OC / 4), c = i % (OC / 4);
      const int64_t kp = kt * BK + r, col = c0 + 4 * c;
      const bool in = kp < Skv && col < hd;
      const int64_t idx = in ? ((b * Skv + kp) * KV + g) * hd + col : 0;
      cp_async4(dst + tile_at<S>(r, c), src + idx, in);
    }
    cp_async_commit();
  };

  if (ns == 1) load_q(0);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float sc[BK / 8][4];
  float al0 = 1.f, al1 = 1.f;

  for (int i = 0; i < S::STAGES - 1; ++i)
    if (i < items) load_item(i, i);
  for (int64_t n = 0; n < items; ++n) {
    const int s = (int)(n % S::STAGES);
    const int p = (int)(n % (ns + 1));
    const int64_t k0 = (t_begin + n / (ns + 1)) * BK;
    // item n has landed (n + 1 may still be on its way), for every thread;
    // every warp is done with item n - 1, whose stage takes item n + 2
    if (n + 1 < items) cp_async_wait_1();
    else cp_async_wait_all();
    __syncthreads();
    if (n + S::STAGES - 1 < items)
      load_item(n + S::STAGES - 1, (int)((n + S::STAGES - 1) % S::STAGES));
    float* const xs = ring + s * ITEM;
    const float* const xh = xs + sub;    // this warp's columns

    if (p < ns) {
      // -- this warp's part of the scores over slab p
      if (p == 0) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      if (ns > 1) load_q(p);
#pragma unroll
      for (int m = 0; m < W / 16; ++m) {
        uint32_t ql[2][4], qa[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint4 x = qlo[32 * (2 * m + u)];
          const uint4 y = qhi[32 * (2 * m + u)];
          ql[u][0] = x.x; ql[u][1] = x.y; ql[u][2] = x.z; ql[u][3] = x.w;
          qa[u][0] = y.x; qa[u][1] = y.y; qa[u][2] = y.z; qa[u][3] = y.w;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          // B = K^T at key 8j + gr: hd 16m + 4tq .. + 3, two k steps
          const float4 kx = load4(xh + chunk_at<W>(8 * j + gr, 4 * m + tq));
          uint32_t bh[4], bl[4];
          split(kx.x, bh[0], bl[0]);
          split(kx.y, bh[1], bl[1]);
          split(kx.z, bh[2], bl[2]);
          split(kx.w, bh[3], bl[3]);
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(f, qa[0], ql[0], __uint_as_float(bh[0]),
               __uint_as_float(bh[1]), __uint_as_float(bl[0]),
               __uint_as_float(bl[1]));
          mma3(f, qa[1], ql[1], __uint_as_float(bh[2]),
               __uint_as_float(bh[3]), __uint_as_float(bl[2]),
               __uint_as_float(bl[3]));
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += f[e];
        }
      }
      if (p + 1 < ns) continue;
      // the row group's partial scores, added in column-warp order by
      // every warp of the group, through this item's stage once every warp
      // is done reading it
      __syncthreads();
      float* const mine = xs + warp * (BK / 8) * 4 * 32 + lane;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[32 * (4 * j + e)] = sc[j][e];
      asm volatile("bar.sync %0, %1;" :: "r"(1 + wr), "r"(32 * S::HALVES)
                   : "memory");
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t = xs[wr * (BK / 8) * 4 * 32 + 32 * (4 * j + e) + lane];
#pragma unroll
          for (int c = 1; c < S::HALVES; ++c)
            t += xs[(c * WROWS + wr) * (BK / 8) * 4 * 32 + 32 * (4 * j + e)
                    + lane];
          sc[j][e] = t * scale;
        }
      uint32_t vis = 0xffffffffu;
      const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0)
                        && (window <= 0 || q0 + BQW - 1 - k0 < window);
      if (!full) {
        vis = 0u;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t kp = k0 + 8 * j + 2 * tq + (e & 1);
            if (visible(e < 2 ? r0 : r1, kp, Skv, causal, window))
              vis |= 1u << (4 * j + e);
          }
      }
      if (full) softmax_tile<false, BK>(sc, vis, m0, m1, l0, l1, al0, al1);
      else softmax_tile<true, BK>(sc, vis, m0, m1, l0, l1, al0, al1);
      continue;
    }

    // -- acc = acc * alpha + P . V for this warp's 128 columns
#pragma unroll
    for (int c0 = 0; c0 < NT / 4; c0 += S::OG) {
      float ot[4 * S::OG][4];
#pragma unroll
      for (int n2 = 0; n2 < 4 * S::OG; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) ot[n2][e] = 0.f;
#pragma unroll
      for (int js = 0; js < BK / 8; ++js) {
        uint32_t ph[4], pl[4];
        split(sc[js][0], ph[0], pl[0]);
        split(sc[js][2], ph[1], pl[1]);
        split(sc[js][1], ph[2], pl[2]);
        split(sc[js][3], ph[3], pl[3]);
#pragma unroll
        for (int cc = 0; cc < S::OG; ++cc) {
          const int o0 = chunk_at<W>(8 * js + 2 * tq, NT / 4 * gr + c0 + cc);
          const int o1 = chunk_at<W>(8 * js + 2 * tq + 1,
                                     NT / 4 * gr + c0 + cc);
          const float4 v0 = load4(xh + o0), v1 = load4(xh + o1);
          const float a0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t h0, l0, h1, l1;
            split(a0[u], h0, l0);
            split(a1[u], h1, l1);
            mma3(ot[4 * cc + u], ph, pl, __uint_as_float(h0),
                 __uint_as_float(h1), __uint_as_float(l0),
                 __uint_as_float(l1));
          }
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < 4 * S::OG; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * c0 + n2][e] = fmaf(acc[4 * c0 + n2][e], e < 2 ? al0 : al1,
                                     ot[n2][e]);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int64_t r = e ? r1 : r0;
    const float den = e ? den1 : den0;
    if (r < Sq) {
      float* const dst = o + ((b * Sq + r) * H + h) * hd + z0 + cw * W;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int cc = 0; cc < NT / 4; ++cc) {
          const int col = NT * (2 * tq + c) + 4 * cc;
          if (z0 + cw * W + col < hd)
            *reinterpret_cast<float4*>(dst + col) = make_float4(
                acc[4 * cc][2 * e + c] / den, acc[4 * cc + 1][2 * e + c] / den,
                acc[4 * cc + 2][2 * e + c] / den,
                acc[4 * cc + 3][2 * e + c] / den);
        }
    }
  }
}

template <class S>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
                int64_t hd, float scale, int causal, int64_t window,
                cudaStream_t stream) {
  const int64_t nq = (Sq + S::BQ - 1) / S::BQ;
  const int64_t ns = (hd + S::HDP - 1) / S::HDP;
  if (B * H > 0x7fffffffLL || nq > 65535 || ns > 65535 || hd % 8 != 0)
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
  flash_wide_kernel<S><<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
      H, KV, hd, (int)ns, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); float32, contiguous,
// 16-byte aligned.  window <= 0: no window.  hd 64, 80, 128 and 256 are
// built.
int lag_flash_attention_f32(const void* q, const void* k, const void* v,
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

// head_dim above 256: q, o (B, Sq, H, hd), k, v (B, Skv, KV, hd), float32,
// contiguous, 16-byte aligned, hd a multiple of 8
int lag_flash_attention_wide_f32(const void* q, const void* k, const void* v,
                                 void* o, int64_t B, int64_t Sq, int64_t Skv,
                                 int64_t H, int64_t KV, int64_t hd,
                                 float scale, int causal, int64_t window,
                                 void* stream) {
  if (KV <= 0 || H % KV != 0 || hd <= Hd256::HD || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= Wide384::HDP)
    return launch_wide<Wide384>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale,
                                causal, window, s);
  return launch_wide<Wide512>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale,
                              causal, window, s);
}

}  // extern "C"
