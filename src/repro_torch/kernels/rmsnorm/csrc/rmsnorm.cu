// Fused RMSNorm for Hopper (sm_90a).
//
// Hand-written CUDA replacement of the Pallas kernel rmsnorm_2d
// (_rmsnorm_kernel) of src/repro/kernels/rmsnorm/rmsnorm.py:
//
//   y = (x * rsqrt(mean(x^2) + eps)).astype(out) * scale.astype(out)
//
// row by row over x (rows, d), float32.  The reference's order of
// operations is kept: the row is multiplied by the rsqrt first, then by the
// scale, two separate roundings.
//
// Bound: bytes.  Each element is read once and written once with three
// flops between, so at prefill (8192 rows x 2048) the kernel moves 134 MB:
// 0.040 ms at the H100's 3.35 TB/s, far above its 0.3 us of arithmetic.
// The design reads every byte of x exactly once from device memory:
//
//   * ONE WARP PER ROW.  Lane l holds the float4s l, l+32, l+64, ... of its
//     row in registers (VPL of them: d <= 128*VPL), so the second pass (the
//     write) never re-reads x.  Each step of the warp loads 512 contiguous
//     bytes.
//   * The sum of squares runs in a fixed order: each lane folds its values
//     in sequence, then a fixed xor butterfly of shuffles; no atomics, no
//     shared memory, nothing crosses a row, so the same row gives the same
//     bits on every launch, whatever the number of rows.
//   * Any number of rows: the last block's surplus warps leave.  Widths are
//     multiples of 4 (the wrapper checks it, and 16-byte alignment), so a
//     row is whole float4s; up to 4096 a row fits 32 of them per lane.
//   * Wider rows (up to 8192: command-r-35b's d) take ONE BLOCK PER ROW:
//     thread i of the block's 256 holds the float4s i, i + 256, ... (8 at
//     d 8192) in registers, so x is still read once.  The sum of squares
//     is each warp's butterfly, then the 8 warp sums added in warp order
//     by every thread from shared memory: a fixed order again.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARP * WARPS_PER_BLOCK;
constexpr int MAX_ROW_VPL = 8;       // float4s a thread of a row's block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sq4(float acc, float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

// d = 4 * d4 with d4 <= 32 * VPL; x, scale, y 16-byte aligned
template <int VPL>
__global__ void __launch_bounds__(THREADS)
rmsnorm_reg_kernel(const float4* __restrict__ x,
                   const float4* __restrict__ scale, float4* __restrict__ y,
                   int64_t rows, int d4, float d, float eps) {
  const int64_t row = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (row >= rows) return;                   // the whole warp leaves
  const int lane = threadIdx.x % WARP;
  const float4* xr = x + row * d4;
  float4 v[VPL];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + j * WARP;
    v[j] = c < d4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc = sq4(acc, v[j]);
  }
  acc = warp_sum(acc);
  const float r = rsqrtf(acc / d + eps);
  float4* yr = y + row * d4;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + j * WARP;
    if (c < d4) {
      const float4 s = scale[c];
      yr[c] = make_float4(__fmul_rn(__fmul_rn(v[j].x, r), s.x),
                          __fmul_rn(__fmul_rn(v[j].y, r), s.y),
                          __fmul_rn(__fmul_rn(v[j].z, r), s.z),
                          __fmul_rn(__fmul_rn(v[j].w, r), s.w));
    }
  }
}

// one block per row: d = 4 * d4 with d4 <= THREADS * VPL
template <int VPL>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_kernel(const float4* __restrict__ x,
                   const float4* __restrict__ scale, float4* __restrict__ y,
                   int d4, float d, float eps) {
  __shared__ float part[WARPS_PER_BLOCK];
  const int64_t row = blockIdx.x;
  const float4* xr = x + row * d4;
  float4 v[VPL];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + j * THREADS;
    v[j] = c < d4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc = sq4(acc, v[j]);
  }
  acc = warp_sum(acc);
  if (threadIdx.x % WARP == 0) part[threadIdx.x / WARP] = acc;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS_PER_BLOCK; ++w) tot += part[w];
  const float r = rsqrtf(tot / d + eps);
  float4* yr = y + row * d4;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c < d4) {
      const float4 s = scale[c];
      yr[c] = make_float4(__fmul_rn(__fmul_rn(v[j].x, r), s.x),
                          __fmul_rn(__fmul_rn(v[j].y, r), s.y),
                          __fmul_rn(__fmul_rn(v[j].z, r), s.z),
                          __fmul_rn(__fmul_rn(v[j].w, r), s.w));
    }
  }
}

template <int VPL>
void launch_reg(const void* x, const void* scale, void* y, int64_t rows,
                int64_t d, float eps, cudaStream_t s, unsigned blocks) {
  rmsnorm_reg_kernel<VPL><<<blocks, THREADS, 0, s>>>(
      (const float4*)x, (const float4*)scale, (float4*)y, rows, (int)(d / 4),
      (float)d, eps);
}

}  // namespace

extern "C" {

// x, y: (rows, d) float32, contiguous; scale: (d,) float32; all three
// 16-byte aligned; d a multiple of 4, at most 8192.
int lag_rmsnorm_f32(const void* x, const void* scale, void* y, int64_t rows,
                    int64_t d, float eps, void* stream) {
  if (d % 4 != 0 || d > 4 * MAX_ROW_VPL * THREADS)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return 0;
  if (d > 4 * 32 * WARP) {                   // one block per row
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_row_kernel<MAX_ROW_VPL><<<(unsigned)rows, THREADS, 0,
                                      (cudaStream_t)stream>>>(
        (const float4*)x, (const float4*)scale, (float4*)y, (int)(d / 4),
        (float)d, eps);
    return (int)cudaGetLastError();
  }
  const int64_t blocks64 = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks64 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)blocks64;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t d4 = d / 4;
  if (d4 <= WARP)
    launch_reg<1>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 2 * WARP)
    launch_reg<2>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 4 * WARP)
    launch_reg<4>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 8 * WARP)
    launch_reg<8>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 16 * WARP)
    launch_reg<16>(x, scale, y, rows, d, eps, s, blocks);
  else
    launch_reg<32>(x, scale, y, rows, d, eps, s, blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
