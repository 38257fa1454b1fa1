// Warped-window sampler (K2) for Hopper (sm_90a), in its three uses.
//
// Replaces: the Pallas kernel `_sample_kernel` (+ `_cell_body`) in
// pais_mvs_tpu/ops/pallas_fitness.py:67/:344, launched by
// `_run_sampler_raw` (:421). Its three contracts are three entries here:
//
//   * NCC mode (`pais_sampler`): one particle per patch and the NCC path's
//     margins (0, 1), as `warped_patch_vectors_pallas` (:867) and
//     `warped_vectors_view` (pais_mvs_tpu/ops/view_fitness.py:399) call it.
//     Contract: the sampling half of the jnp reference
//     pais_mvs_tpu/ops/fitness.py::warped_patch_vectors (:248-298); plain
//     twin pais_mvs_tpu_torch/ops/fitness.py::warped_samples. Output
//     [B, C, W2].
//   * view mode (`pais_sampler_view`): every particle of every patch, the
//     fitness margins (2, 3), an `act [B, C]` and a `pvalid [B, P]` mask,
//     as `fitness_view_pallas` (view_fitness.py:283) calls it. Contract: the
//     sampling stage of the jnp reference `fitness_view_jnp`
//     (view_fitness.py:145-160), with the window centre of each particle;
//     plain twin pais_mvs_tpu_torch/ops/fitness.py::warped_samples_view.
//     Output [B, C, P, W2].
//   * reference windows (`pais_ref_window`): the view mode's reads of the
//     reference camera itself, which `_ref_window_rows` (view_fitness.py:
//     198) makes with the same Pallas kernel at an identity homography: the
//     intensity (foreground mask) and edge weight at the nearest pixel of
//     every window pixel of every particle, on the rank that holds the
//     reference camera, 0 on the others (so a psum replicates them).
//     Contract: fitness_view_jnp's per-pixel round(pt + offset) lookups
//     (view_fitness.py:135-143, :185-187), not the Pallas rounded-centre
//     rows; plain twin pais_mvs_tpu_torch/ops/fitness.py::reference_windows.
//     Output [n, B, P, W2] (n = 1, or 2 with the edge weights).
//
// For every sample of the first two modes: warp the reference window pixel
// through H, bilinear-sample the camera's LOD band of the bf16 mip-atlas,
// and write the f32 sample, or INVALID (-1e9) where the warp leaves
// [lo, dim-hi), where the homography's w is 0, or where the mask switches
// the (patch, camera) or (patch, particle) off. The L2 normalisation, the
// NCC table and the fitness epilogue stay in PyTorch, as the JAX package
// also leaves them outside Pallas.
//
// What bounds it on this card: the output write. Every mode writes one f32
// per sample (19.7 MB per NCC launch at B=1024, C=5, r=15; 590 MB per view
// launch at P=30; 118 MB per reference plane) and reads at most four
// 2-byte taps per sample from an atlas that L2 holds, so HBM bytes (the
// output) set the roofline bound.
//
// Design: NCC mode runs one block per (b, c); view mode one block per
// (b, c, block of kViewParticles particles). In both, threads stride over
// the window pixels, so a warp's stores are contiguous and coalesced, and a
// row that a mask switches off is written INVALID without touching the
// atlas. Built with --fmad=false so each sample rounds as the plain version
// does on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalid = -1e9f;
constexpr int kThreads = 256;
constexpr int kViewParticles = 8;

__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ a,
                                     long i) {
  return __bfloat162float(a[i]);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Band {
  float hgt, wid;  // the camera's LOD level, (h, w)
  int yo;          // the level's atlas row offset
  long cam_base;   // the camera's first atlas element
};

__device__ __forceinline__ Band band_of(const int* __restrict__ dims,
                                        const int* __restrict__ yoff, int c,
                                        int L, int l, int Ha, int Wa) {
  Band bd;
  bd.hgt = (float)dims[(c * L + l) * 2 + 0];
  bd.wid = (float)dims[(c * L + l) * 2 + 1];
  bd.yo = yoff[l];
  bd.cam_base = (long)c * Ha * Wa;
  return bd;
}

__device__ __forceinline__ void fill_invalid(float* __restrict__ row,
                                             int W2) {
  for (int k = threadIdx.x; k < W2; k += blockDim.x) row[k] = kInvalid;
}

// One window (2r+1)^2 around (px, py), warped through h, into `row`; the
// block's threads stride over its pixels. Valid iff lo <= u < wid - hi and
// lo <= v < hgt - hi (the order of bilinear_gather's comparisons).
__device__ __forceinline__ void sample_window(
    const __nv_bfloat16* __restrict__ images, const Band& bd, int Ha,
    int Wa, const float* __restrict__ h, float px, float py, int radius,
    float lo, float hi, float* __restrict__ row) {
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  const float h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4],
              h5 = h[5], h6 = h[6], h7 = h[7], h8 = h[8];
  for (int k = threadIdx.x; k < W2; k += blockDim.x) {
    const float x = px + (float)(k / W - radius);
    const float y = py + (float)(k % W - radius);
    const float hw = h6 * x + h7 * y + h8;
    const float sw = hw == 0.f ? 1.f : hw;
    const float u = (h0 * x + h1 * y + h2) / sw;
    const float v = (h3 * x + h4 * y + h5) / sw;
    const bool ok = (u >= lo) & (u < bd.wid - hi) & (v >= lo) &
                    (v < bd.hgt - hi) & isfinite(u) & isfinite(v) &
                    (hw != 0.f);
    float val = kInvalid;
    if (ok) {
      const float x0 = floorf(u), y0 = floorf(v);
      const float fx = u - x0, fy = v - y0;
      const int x0i = clampi((int)x0, 0, Wa - 2);
      const int y0i = clampi((int)y0 + bd.yo, 0, Ha - 2);
      const long i00 = bd.cam_base + (long)y0i * Wa + x0i;
      val = tap(images, i00) * (1.f - fx) * (1.f - fy) +
            tap(images, i00 + 1) * fx * (1.f - fy) +
            tap(images, i00 + Wa) * (1.f - fx) * fy +
            tap(images, i00 + Wa + 1) * fx * fy;
    }
    row[k] = val;
  }
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
  const int W2 = (2 * radius + 1) * (2 * radius + 1);
  float* row = out + bc * W2;
  if (!cam_mask[bc]) {
    fill_invalid(row, W2);
    return;
  }
  const Band bd = band_of(dims, yoff, c, L, lod[b], Ha, Wa);
  sample_window(images, bd, Ha, Wa, H + bc * 9, pt[b * 2 + 0],
                pt[b * 2 + 1], radius, 0.f, 1.f, row);
}

__global__ void __launch_bounds__(kThreads) sampler_view_kernel(
    const __nv_bfloat16* __restrict__ images, const int* __restrict__ dims,
    const int* __restrict__ yoff, int C, int L, int Ha, int Wa,
    const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ lod, const uint8_t* __restrict__ act,
    const uint8_t* __restrict__ pvalid, int P, int radius, float lo,
    float hi, float* __restrict__ out) {
  const int nblk = (P + kViewParticles - 1) / kViewParticles;
  const long bc = blockIdx.x / nblk;  // b * C + c
  const int p0 = (int)(blockIdx.x % nblk) * kViewParticles;
  const int p1 = min(p0 + kViewParticles, P);
  const int b = (int)(bc / C);
  const int c = (int)(bc % C);
  const int W2 = (2 * radius + 1) * (2 * radius + 1);
  const bool on = act[bc] != 0;
  const Band bd = band_of(dims, yoff, c, L, lod[b], Ha, Wa);
  for (int p = p0; p < p1; ++p) {
    float* row = out + (bc * P + p) * (long)W2;
    const long bp = (long)b * P + p;
    if (!on || !pvalid[bp]) {
      fill_invalid(row, W2);
      continue;
    }
    sample_window(images, bd, Ha, Wa, H + (bp * C + c) * 9, pt[bp * 2 + 0],
                  pt[bp * 2 + 1], radius, lo, hi, row);
  }
}

// One block per (b, p); threads stride over the window pixels. The pixel is
// round-half-even(pt + offset) (rintf, as torch.round), clamped into the
// atlas as nearest_gather clamps it; in-bounds is the caller's invariant.
__global__ void __launch_bounds__(kThreads) ref_window_kernel(
    const __nv_bfloat16* __restrict__ images,
    const __nv_bfloat16* __restrict__ edges, const int* __restrict__ yoff,
    int Ha, int Wa, const float* __restrict__ pt,
    const int* __restrict__ ref_cam, const uint8_t* __restrict__ own,
    const int* __restrict__ lod, long BP, int P, int radius,
    float* __restrict__ out) {
  const long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  float* ri = out + bp * W2;
  float* re = edges ? out + (BP + bp) * W2 : nullptr;
  if (!own[b]) {
    for (int k = threadIdx.x; k < W2; k += blockDim.x) {
      ri[k] = 0.f;
      if (re) re[k] = 0.f;
    }
    return;
  }
  const float px = pt[bp * 2 + 0], py = pt[bp * 2 + 1];
  const int yo = yoff[lod[b]];
  const long base = (long)ref_cam[b] * Ha * Wa;
  for (int k = threadIdx.x; k < W2; k += blockDim.x) {
    const float x = px + (float)(k / W - radius);
    const float y = py + (float)(k % W - radius);
    const int xi = clampi((int)rintf(x), 0, Wa - 1);
    const int yi = clampi((int)rintf(y) + yo, 0, Ha - 1);
    const long i = base + (long)yi * Wa + xi;
    ri[k] = tap(images, i);
    if (re) re[k] = tap(edges, i);
  }
}

}  // namespace

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch.
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

extern "C" int pais_sampler_view(const void* images, const int* dims,
                                 const int* yoff, int C, int L, int Ha,
                                 int Wa, const float* H, const float* pt,
                                 const int* lod, const uint8_t* act,
                                 const uint8_t* pvalid, int B, int P,
                                 int radius, float lo, float hi, float* out,
                                 void* stream) {
  if ((long)B * C * P == 0) return 0;
  const long blocks =
      (long)B * C * ((P + kViewParticles - 1) / kViewParticles);
  sampler_view_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)images, dims, yoff, C, L, Ha, Wa, H, pt, lod,
      act, pvalid, P, radius, lo, hi, out);
  return (int)cudaGetLastError();
}

// edges may be null: then only the intensity plane of `out` is written.
extern "C" int pais_ref_window(const void* images, const void* edges,
                               const int* yoff, int Ha, int Wa,
                               const float* pt, const int* ref_cam,
                               const uint8_t* own, const int* lod, int B,
                               int P, int radius, float* out, void* stream) {
  const long BP = (long)B * P;
  if (BP == 0) return 0;
  ref_window_kernel<<<(unsigned)BP, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)images, (const __nv_bfloat16*)edges, yoff, Ha,
      Wa, pt, ref_cam, own, lod, BP, P, radius, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_sampler_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
