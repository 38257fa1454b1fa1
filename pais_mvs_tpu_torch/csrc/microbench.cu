// Microbench of the fitness kernel's inner loop (M) for Hopper (sm_90a).
//
// Replaces: `run_grid` in tools/microbench_kernel.py:46-62 (the
// `pl.pallas_call` at :52) with its body A, "the current design" (:69-92):
// per grid cell, 30 particles each bilinear-sample a box of the mip-atlas
// into 1024 window pixels and sum. Plain twin:
// pais_mvs_tpu_torch/tools/microbench_kernel.py::run_grid_plain.
//
// The function, for cell i < cells, pixel t < 1024 and particle p < 30,
// with X = bf16(box[i mod nbox]) ([80, 256]):
//   u = 30 + 0.03 t + p,  v = 40 + 0.01 t  (f32, in that order);
//   x-weights bf16(max(1 - |u - k|, 0)) for k < 64 (the 64-column hat
//   matrix; the column read is (k + p mod 17) mod 256, body A's roll);
//   y-weights max(1 - |v - y|, 0) in f32;
//   out[i, t] = sum_p sum_y wy(y) * sum_k wx(k) * X[y, col(k)].
// The hats are zero outside two rows and two columns, so each (t, p) reads
// four taps, as the fitness kernel's bilinear sample does.
//
// Two variants of the same function:
//   (a) taps read straight from global memory (L2 holds the 655 KB of
//       boxes), as csrc/fitness.cu reads the atlas;
//   (b) the cell's box staged once into shared memory with cp.async
//       (80 KB, dynamic shared memory), then taps read from there: the
//       Hopper form of the Pallas kernel's VMEM box.
//
// What bounds it on this card: operations. Each (cell, t, p) does ~23 FP32
// operations on four taps; the output write (21 MB at 5120 cells) is the
// only large memory traffic.
//
// Design: one block of 256 threads per cell, four pixels per thread, the
// particle loop in registers, coalesced stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kY = 80, kX = 256, kS = 64, kT = 1024, kP = 30;
constexpr int kThreads = 256;
constexpr int kBoxBytes = kY * kX * 4;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out[t] for the 4 pixels t = tid + 256 j of one cell; `X` is the cell's
// box (global or shared), rounded to bf16 at each read.
__device__ __forceinline__ void cell_body(const float* __restrict__ X,
                                          float* __restrict__ out) {
  for (int j = 0; j < kT / kThreads; ++j) {
    const int t = threadIdx.x + kThreads * j;
    const float tf = (float)t;
    const float v = 40.f + 0.01f * tf;
    const int y0 = (int)floorf(v);
    const float wy0 = fmaxf(1.f - fabsf(v - (float)y0), 0.f);
    const float wy1 = fmaxf(1.f - fabsf(v - (float)(y0 + 1)), 0.f);
    const float* r0 = X + y0 * kX;
    const float* r1 = r0 + kX;
    float acc = 0.f;
    for (int p = 0; p < kP; ++p) {
      const float u = 30.f + 0.03f * tf + (float)p;
      const int k0 = (int)floorf(u);
      const float wx0 =
          k0 < kS ? bf16r(fmaxf(1.f - fabsf(u - (float)k0), 0.f)) : 0.f;
      const float wx1 =
          k0 + 1 < kS ? bf16r(fmaxf(1.f - fabsf(u - (float)(k0 + 1)), 0.f))
                      : 0.f;
      const int c0 = (k0 + p % 17) & (kX - 1);
      const int c1 = (k0 + 1 + p % 17) & (kX - 1);
      const float tmp0 = bf16r(r0[c0]) * wx0 + bf16r(r0[c1]) * wx1;
      const float tmp1 = bf16r(r1[c0]) * wx0 + bf16r(r1[c1]) * wx1;
      acc += tmp0 * wy0 + tmp1 * wy1;
    }
    out[t] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) microbench_a_kernel(
    const float* __restrict__ box, int nbox, float* __restrict__ out) {
  const int i = blockIdx.x;
  cell_body(box + (long)(i % nbox) * kY * kX, out + (long)i * kT);
}

__global__ void __launch_bounds__(kThreads) microbench_b_kernel(
    const float* __restrict__ box, int nbox, float* __restrict__ out) {
  extern __shared__ __align__(16) float sbox[];
  const int i = blockIdx.x;
  const float* src = box + (long)(i % nbox) * kY * kX;
  // 16-byte cp.async chunks, neighbouring threads on neighbouring chunks
  for (int q = threadIdx.x; q < kBoxBytes / 16; q += kThreads) {
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(sbox + q * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + q * 4));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  cell_body(sbox, out + (long)i * kT);
}

}  // namespace

// C entries, bound with ctypes. box [nbox, 80, 256] f32, out [cells, 1024]
// f32. Each returns cudaGetLastError() after its launch.
extern "C" int pais_microbench_a(const float* box, int nbox, int cells,
                                 float* out, void* stream) {
  if (cells == 0) return 0;
  microbench_a_kernel<<<cells, kThreads, 0, (cudaStream_t)stream>>>(
      box, nbox, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_microbench_b(const float* box, int nbox, int cells,
                                 float* out, void* stream) {
  if (cells == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      microbench_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBoxBytes);
  if (e != cudaSuccess) return (int)e;
  microbench_b_kernel<<<cells, kThreads, kBoxBytes, (cudaStream_t)stream>>>(
      box, nbox, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_microbench_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
