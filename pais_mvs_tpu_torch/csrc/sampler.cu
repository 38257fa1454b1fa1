// Warped-window sampler (K2) for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_sample_kernel` (+ `_cell_body`) in
// pais_mvs_tpu/ops/pallas_fitness.py:67/:344, launched by
// `_run_sampler_raw` (:421) via `_run_sampler` (:410) from
// `warped_patch_vectors_pallas` (:867) with one particle per patch and the
// NCC path's margins (0, 1). Contract: the sampling half of the jnp
// reference pais_mvs_tpu/ops/fitness.py::warped_patch_vectors (:248-298);
// its plain PyTorch twin is pais_mvs_tpu_torch/ops/fitness.py::
// warped_samples.
//
// For every (patch b, camera c, window pixel k): warp the reference window
// pixel through H[b,c], bilinear-sample camera c's LOD band of the bf16
// mip-atlas, and write the f32 sample, or INVALID (-1e9) where the warp
// leaves [0, dim-1), where the homography's w is 0, or for a camera not in
// the patch's mask. The L2 normalisation and the [C, C] NCC table stay in
// PyTorch (ncc_from_vectors), as the JAX package also leaves them outside
// Pallas.
//
// What bounds it on this card: the output write. It writes B*C*W2 floats
// (19.7 MB at B=1024, C=5, r=15) once and reads four 2-byte taps per
// sample from an atlas that L2 holds, so HBM bytes (the output) set the
// roofline bound.
//
// Design: one block per (b, c); threads stride over the window pixels, so
// a warp's stores are contiguous and coalesced. A masked camera's block
// writes INVALID without touching the atlas. Built with --fmad=false so
// each sample rounds as the plain version does on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalid = -1e9f;
constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ a,
                                     long i) {
  return __bfloat162float(a[i]);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) sampler_kernel(
    const __nv_bfloat16* __restrict__ images, const int* __restrict__ dims,
    const int* __restrict__ yoff, int C, int L, int Ha, int Wa,
    const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ lod, const uint8_t* __restrict__ cam_mask,
    int radius, float* __restrict__ out) {
  const long bc = blockIdx.x;  // b * C + c
  const int b = (int)(bc / C);
  const int c = (int)(bc % C);
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  float* row = out + bc * W2;
  if (!cam_mask[bc]) {
    for (int k = threadIdx.x; k < W2; k += blockDim.x) row[k] = kInvalid;
    return;
  }
  const float* h = H + bc * 9;
  const float h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4],
              h5 = h[5], h6 = h[6], h7 = h[7], h8 = h[8];
  const int l = lod[b];
  const float hgt = (float)dims[(c * L + l) * 2 + 0];
  const float wid = (float)dims[(c * L + l) * 2 + 1];
  const int yo = yoff[l];
  const float px = pt[b * 2 + 0];
  const float py = pt[b * 2 + 1];
  const long cam_base = (long)c * Ha * Wa;

  for (int k = threadIdx.x; k < W2; k += blockDim.x) {
    const float x = px + (float)(k / W - radius);
    const float y = py + (float)(k % W - radius);
    const float hw = h6 * x + h7 * y + h8;
    const float sw = hw == 0.f ? 1.f : hw;
    const float u = (h0 * x + h1 * y + h2) / sw;
    const float v = (h3 * x + h4 * y + h5) / sw;
    const bool ok = (u >= 0.f) & (u < wid - 1.f) & (v >= 0.f) &
                    (v < hgt - 1.f) & isfinite(u) & isfinite(v) &
                    (hw != 0.f);
    float val = kInvalid;
    if (ok) {
      const float x0 = floorf(u), y0 = floorf(v);
      const float fx = u - x0, fy = v - y0;
      const int x0i = clampi((int)x0, 0, Wa - 2);
      const int y0i = clampi((int)y0 + yo, 0, Ha - 2);
      const long i00 = cam_base + (long)y0i * Wa + x0i;
      val = tap(images, i00) * (1.f - fx) * (1.f - fy) +
            tap(images, i00 + 1) * fx * (1.f - fy) +
            tap(images, i00 + Wa) * (1.f - fx) * fy +
            tap(images, i00 + Wa + 1) * fx * fy;
    }
    row[k] = val;
  }
}

}  // namespace

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch.
extern "C" int pais_sampler(const void* images, const int* dims,
                            const int* yoff, int C, int L, int Ha, int Wa,
                            const float* H, const float* pt, const int* lod,
                            const uint8_t* cam_mask, int B, int radius,
                            float* out, void* stream) {
  if (B * C == 0) return 0;
  sampler_kernel<<<(unsigned)((long)B * C), kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)images, dims, yoff, C, L, Ha, Wa, H, pt, lod,
      cam_mask, radius, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_sampler_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
