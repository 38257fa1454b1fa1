// Fused photoconsistency fitness (K1) for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_fused_kernel` (+ `_fused_body`) in
// pais_mvs_tpu/ops/pallas_fitness.py:552/:680, launched by `_run_fused`
// (:987) from `patch_fitness_pallas` (:907). Contract: the jnp reference
// pais_mvs_tpu/ops/fitness.py::patch_fitness (:145-244); its plain PyTorch
// twin is pais_mvs_tpu_torch/ops/fitness.py::score_windows.
//
// For every (patch b, particle p): warp the (2r+1)^2 reference window
// through the plane homography H[b,p,c] into every visible camera c,
// bilinear-sample that camera's LOD band of the bf16 mip-atlas with margins
// [2, dim-3), take the per-pixel mean and mean |c_i - mean| (SAD) over the
// visible cameras, weight each pixel by foreground x Gaussian table x
// exp(-SAD^2/diffW) x exp(-1/(edge*gradW)) (each factor gated by its flag)
// and return sum(w*SAD)/sum(w), or BIG when a foreground sample of a
// visible camera is out of bounds, the particle is invalid (facing away,
// window outside the reference frame, degenerate homography: `pvalid`,
// computed by the wrapper), the swarm is inactive, or sum(w) = 0.
//
// What bounds it on this card: neither HBM nor the FP32 pipes at the
// bench shape. The inputs (two bf16 atlases of a few MB each, H at
// B*P*C*9 floats) are read once from HBM and then live in the 50 MB L2;
// the work is ~C*4 dependent 2-byte gathers per window pixel, so the
// kernel is bound by L1/L2 gather latency and load throughput. Its
// roofline bound (computed in chip_smoke.py) is the FP32 operation count.
//
// Design, right first and simple: one block per (b, p); threads stride
// over the window pixels; the camera loop runs in registers (the per-camera
// samples stay in a register array of kMaxCams = 8, which every rig this
// port drives fits; a larger rig is refused, not truncated); taps are read
// straight from global memory, which
// L1/L2 serve (no TPU-style box staging, so no coverage limit and no
// radius ceiling). One block reduction gives sum(w), sum(w*SAD) and the
// kill flag. Inactive swarms and invalid particles exit before any load.
//
// Arithmetic is written in the jnp reference's operation order and built
// with --fmad=false, so every per-pixel value rounds as the plain version
// does on the card; only the window sum's order differs (~1e-6 relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 256;
constexpr int kMaxCams = 8;

__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ a,
                                     long i) {
  return __bfloat162float(a[i]);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) fitness_kernel(
    const __nv_bfloat16* __restrict__ images,
    const __nv_bfloat16* __restrict__ edges, const int* __restrict__ dims,
    const int* __restrict__ yoff, int C, int L, int Ha, int Wa,
    const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ ref_cam, const int* __restrict__ lod,
    const uint8_t* __restrict__ cam_mask, const uint8_t* __restrict__ pvalid,
    const uint8_t* __restrict__ active, const float* __restrict__ wtable,
    int P, int radius, int use_dist, int use_diff, float diff_w,
    int use_grad, float grad_w, float* __restrict__ out) {
  const long bp = blockIdx.x;  // b * P + p
  const int b = (int)(bp / P);
  if (!pvalid[bp] || (active != nullptr && !active[b])) {
    if (threadIdx.x == 0) out[bp] = kBig;
    return;
  }

  __shared__ float sH[kMaxCams * 9];
  __shared__ float s_h[kMaxCams], s_w[kMaxCams];
  __shared__ int s_m[kMaxCams];
  __shared__ float red_w[kThreads / 32], red_ws[kThreads / 32];

  const int l = lod[b];
  for (int i = threadIdx.x; i < C * 9; i += blockDim.x)
    sH[i] = H[bp * C * 9 + i];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_h[c] = (float)dims[(c * L + l) * 2 + 0];
    s_w[c] = (float)dims[(c * L + l) * 2 + 1];
    s_m[c] = cam_mask[(long)b * C + c] != 0;
  }
  __syncthreads();

  int ncam = 0;
  for (int c = 0; c < C; ++c) ncam += s_m[c];
  const float cn = (float)ncam;

  const int W = 2 * radius + 1;
  const int W2 = W * W;
  const float px = pt[bp * 2 + 0];
  const float py = pt[bp * 2 + 1];
  const int yo = yoff[l];
  const long plane = (long)Ha * Wa;
  const long ref_base = (long)ref_cam[b] * plane;

  float acc_w = 0.f, acc_ws = 0.f;
  int bad = 0;
  for (int k = threadIdx.x; k < W2; k += blockDim.x) {
    // offset k is (dx, dy) = (k / W - r, k % W - r): x-major, as
    // window_offsets orders the table
    const float x = px + (float)(k / W - radius);
    const float y = py + (float)(k % W - radius);

    // nearest reference pixel: background test and edge strength
    const int xi = clampi((int)rintf(x), 0, Wa - 1);
    const int yi = clampi((int)rintf(y) + yo, 0, Ha - 1);
    const long ridx = ref_base + (long)yi * Wa + xi;
    const bool fg = tap(images, ridx) != 0.f;

    float vals[kMaxCams];
    float sum = 0.f;
    bool pix_ok = true;
#pragma unroll
    for (int c = 0; c < kMaxCams; ++c) {
      vals[c] = 0.f;
      if (c < C && s_m[c]) {
        const float* h = sH + c * 9;
        const float hw = h[6] * x + h[7] * y + h[8];
        const float sw = hw == 0.f ? 1.f : hw;
        const float u = (h[0] * x + h[1] * y + h[2]) / sw;
        const float v = (h[3] * x + h[4] * y + h[5]) / sw;
        const bool ok = (u >= 2.f) & (u < s_w[c] - 3.f) & (v >= 2.f) &
                        (v < s_h[c] - 3.f) & isfinite(u) & isfinite(v) &
                        (hw != 0.f);
        const float x0 = floorf(u), y0 = floorf(v);
        const float fx = u - x0, fy = v - y0;
        const int x0i = clampi((int)x0, 0, Wa - 2);
        const int y0i = clampi((int)y0 + yo, 0, Ha - 2);
        const long i00 = c * plane + (long)y0i * Wa + x0i;
        const float val = tap(images, i00) * (1.f - fx) * (1.f - fy) +
                          tap(images, i00 + 1) * fx * (1.f - fy) +
                          tap(images, i00 + Wa) * (1.f - fx) * fy +
                          tap(images, i00 + Wa + 1) * fx * fy;
        vals[c] = val;
        sum += val;
        pix_ok &= ok;
      }
    }
    const float mean = sum / cn;
    float sad = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCams; ++c)
      if (c < C && s_m[c]) sad += fabsf(vals[c] - mean);
    sad = sad / cn;

    float wgt = use_dist ? wtable[k] : 1.f;
    if (use_diff) wgt = wgt * expf(-sad * sad / diff_w);
    if (use_grad) {
      const float e = fmaxf(tap(edges, ridx) * grad_w, 1e-20f);
      wgt = wgt * expf(-1.f / e);
    }
    const float wfg = wgt * (fg ? 1.f : 0.f);
    acc_w += wfg;
    acc_ws += wfg * sad;
    bad |= (fg && !pix_ok);
  }

  bad = __syncthreads_or(bad);
  acc_w = warp_sum(acc_w);
  acc_ws = warp_sum(acc_ws);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_w[warp] = acc_w;
    red_ws[warp] = acc_ws;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sw = 0.f, sws = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      sw += red_w[i];
      sws += red_ws[i];
    }
    out[bp] = (!bad && sw > 0.f) ? sws / sw : kBig;
  }
}

}  // namespace

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported camera count).
extern "C" int pais_fitness(const void* images, const void* edges,
                            const int* dims, const int* yoff, int C, int L,
                            int Ha, int Wa, const float* H, const float* pt,
                            const int* ref_cam, const int* lod,
                            const uint8_t* cam_mask, const uint8_t* pvalid,
                            const uint8_t* active, const float* wtable, int B,
                            int P, int radius, int use_dist, int use_diff,
                            float diff_w, int use_grad, float grad_w,
                            float* out, void* stream) {
  if (B * P == 0) return 0;
  if (C > kMaxCams) return (int)cudaErrorInvalidValue;
  fitness_kernel<<<(unsigned)((long)B * P), kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)images, (const __nv_bfloat16*)edges, dims, yoff,
      C, L, Ha, Wa, H, pt, ref_cam, lod, cam_mask, pvalid, active, wtable, P,
      radius, use_dist, use_diff, diff_w, use_grad, grad_w, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_fitness_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
