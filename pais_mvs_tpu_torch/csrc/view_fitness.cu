// The view path's photoconsistency fitness for Hopper (sm_90a): its
// sampling and its cross-camera reductions, in two kernels around the view
// psums.
//
// Replaces: the Pallas kernel `_sample_kernel` (+ `_cell_body`) in
// pais_mvs_tpu/ops/pallas_fitness.py:67/:344, launched by
// `_run_sampler_raw` (:421), in its view mode as `fitness_view_pallas`
// (pais_mvs_tpu/ops/view_fitness.py:283) and `_ref_window_rows` (:198)
// call it, together with the per-pixel camera sums that
// `fitness_view_jnp` (view_fitness.py:162-172) takes of its samples.
// Contract: the stages of `fitness_view_jnp` between its collectives, with
// each particle's own window centre. A rank holds one camera block (c
// local cameras); the caller psums each output over the view axis.
//
//   * `pais_view_moments` (A), before the first psum. For every window
//     pixel of every (patch b, particle p), over the local cameras:
//       plane 0: the valid bilinear samples, summed in camera order;
//       plane 1: the number of cameras in `cam_mask` whose sample is
//                invalid (outside [2, dim-3), w = 0, or `act` or `pvalid`
//                off), in f32;
//       plane 2: the reference camera's intensity at round-half-even(pt +
//                offset) where this rank owns that camera (`own`), else 0;
//       plane 3: (with the gradient weight) its edge weight, the same way.
//     Output [n, B, P, W2], n = 3 or 4. Plain twin:
//     pais_mvs_tpu_torch/ops/fitness.py::view_moments.
//   * `pais_view_deviation` (B), between the two psums: for every window
//     pixel, the sum over the local cameras, in camera order, of |sample -
//     mean| for the valid samples, `mean` [B, P, W2] being the psummed
//     plane 0 over the global camera count, as the caller computed it (no
//     division here, so both sides read the same bits). Rows whose
//     particle is invalid or whose swarm is inactive are 0 without any
//     atlas read. Output [B, P, W2]. Plain twin:
//     pais_mvs_tpu_torch/ops/fitness.py::view_deviation.
//
// The adaptive weights and the weighted window mean stay in PyTorch
// (ops/view_fitness.py::_weigh), as the JAX package also computes them
// outside any Pallas kernel. These two kernels take the place of the
// sampler's view mode (which wrote one f32 per (patch, camera, particle,
// pixel): 590 MB per evaluation at the bench shape) and of the eight
// torch passes over that tensor that followed it.
//
// What bounds them on this card: at the bench shape (B=1024, P=30, r=15,
// c=5) A writes 3 x 118 MB and B reads 118 MB and writes 118 MB, a byte
// bound of ~0.1 ms each; each valid sample costs a homography, two IEEE
// divisions, four 2-byte gathers from an atlas that L2 holds and the
// blend, as in K1 (csrc/fitness.cu). chip_smoke.py computes both bounds
// from each run's inputs. On the H100 at the bench shape A takes 0.46 ms
// and B 0.37 ms on the round's first evaluation, 4.3x and 6.6x their byte
// bounds; ptxas -v: 43 and 47 registers, no spills (PERF.md).
//
// Design (what K1 and the NCC sampler taught, applied here):
//  * one block per (patch, particle) window; its threads cover the window
//    pixels and each loops over the local cameras, so no camera's samples
//    are ever stored and there is no camera ceiling (the shared memory
//    holds one 48-byte record per camera: the wrapper refuses only a rig
//    whose records and output tile exceed one block's 227 KB);
//  * a preamble in warp 0 compacts the (patch, particle)'s active cameras
//    in camera order into records (h[9], u and v limits, camera and its
//    cam_mask flag) read back with three float4 broadcasts per camera; a
//    row whose particle is invalid or whose swarm is inactive has no
//    active camera and reads no bilinear tap;
//  * lanes take the window's x offsets, which is the image's x axis (32
//    lanes at r >= 8, W > 32 looping over chunks of 32; 16 or 8 lanes for
//    smaller windows), and the rows of the block step over its y offsets,
//    so a warp's four taps of a camera fall on neighbouring atlas
//    elements of two image rows. A thread takes kRowBatch = 2 y offsets
//    at once and issues all their taps before any of the blends (4 took
//    over 60 registers and was slower, 1 no faster);
//  * the results go to a shared tile in the window's x-major order and
//    leave in coalesced stores; B stages its mean window the same way
//    (coalesced load, conflict-free strided reads: W is odd);
//  * invalid particles need no compaction: their blocks read no taps and
//    finish at once, and the block scheduler refills their SMs.
//
// Exactness: each sample keeps the jnp operation order of
// `bilinear_gather` and its two IEEE divisions, and the build uses
// --fmad=false, so every sample rounds as the plain twin's; the camera
// sums run in camera order, as the twins add them, so the outputs equal
// the twins' to the bit. The `isfinite` tests of the plain version are
// implied by the bounds comparisons (NaN and +-inf fail them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRec = 12;                 // floats per camera record
constexpr int kRowBatch = 2;             // y offsets a thread takes at once

__device__ __forceinline__ float tap(const uint16_t* __restrict__ a,
                                     long long i) {
  // bf16 -> f32 is the bits shifted into the high half
  return __uint_as_float((unsigned)__ldg(a + i) << 16);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Warp 0 compacts the active cameras of (b, p) in camera order into the
// records `rec` ([C][kRec]) and returns, in lane 0, their number; `nbad`
// gets the number of cameras in cam_mask that are not active (cam_mask may
// be null: then 0). A camera is active iff act[b, c] and `live`.
__device__ __forceinline__ void compact_cameras(
    const float* __restrict__ H, const int* __restrict__ dims,
    const uint8_t* __restrict__ act, const uint8_t* __restrict__ cam_mask,
    bool live, int b, long long bp, int C, int L, int l, float* rec,
    int* s_nact, int* s_nbad) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int n = 0, nbad = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < C;
    const bool a = in && live && act[(long long)b * C + c] != 0;
    const bool m = in && cam_mask != nullptr &&
                   cam_mask[(long long)b * C + c] != 0;
    const unsigned ba = __ballot_sync(0xffffffffu, a);
    nbad += __popc(__ballot_sync(0xffffffffu, m && !a));
    if (a) {
      float* r = rec + (n + __popc(ba & below)) * kRec;
      const float* h = H + (bp * C + c) * 9;
#pragma unroll
      for (int f = 0; f < 9; ++f) r[f] = h[f];
      // valid iff 2 <= u < wid - 3 and 2 <= v < hgt - 3
      r[9] = (float)dims[(c * L + l) * 2 + 1] - 3.f;
      r[10] = (float)dims[(c * L + l) * 2 + 0] - 3.f;
      r[11] = __int_as_float((c << 1) | (m ? 1 : 0));
    }
    n += __popc(ba);
  }
  if (lane == 0) {
    *s_nact = n;
    *s_nbad = nbad;
  }
}

// The kRowBatch samples of window column x, rows y[q], in one camera
// (records ra, rb, rc): ok[q] and the bilinear value val[q] (to be read
// only where ok). All taps are issued before any blend.
__device__ __forceinline__ void sample_rows(
    const uint16_t* __restrict__ images, const float4 ra, const float4 rb,
    const float4 rc, float x, const float* y, const bool* in, int yo,
    int Ha, int Wa, long long plane, bool* ok, float* val) {
  const long long cbase = (long long)(__float_as_int(rc.w) >> 1) * plane;
  float fx[kRowBatch], fy[kRowBatch];
  long long i00[kRowBatch];
#pragma unroll
  for (int q = 0; q < kRowBatch; ++q) {
    const float hw = rb.z * x + rb.w * y[q] + rc.x;
    const float sw = hw == 0.f ? 1.f : hw;
    const float u = (ra.x * x + ra.y * y[q] + ra.z) / sw;
    const float v = (ra.w * x + rb.x * y[q] + rb.y) / sw;
    // (NaN and +-inf fail the bounds: no isfinite test needed)
    ok[q] = in[q] & (u >= 2.f) & (u < rc.y) & (v >= 2.f) & (v < rc.z) &
            (hw != 0.f);
    const float x0 = floorf(u), y0 = floorf(v);
    fx[q] = u - x0;
    fy[q] = v - y0;
    const int x0i = clampi((int)x0, 0, Wa - 2);
    const int y0i = clampi((int)y0 + yo, 0, Ha - 2);
    i00[q] = cbase + (long long)y0i * Wa + x0i;
  }
  float t00[kRowBatch], t01[kRowBatch], t10[kRowBatch], t11[kRowBatch];
#pragma unroll
  for (int q = 0; q < kRowBatch; ++q) {
    t00[q] = t01[q] = t10[q] = t11[q] = 0.f;
    if (ok[q]) {
      t00[q] = tap(images, i00[q]);
      t01[q] = tap(images, i00[q] + 1);
      t10[q] = tap(images, i00[q] + Wa);
      t11[q] = tap(images, i00[q] + Wa + 1);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowBatch; ++q)
    val[q] = t00[q] * (1.f - fx[q]) * (1.f - fy[q]) +
             t01[q] * fx[q] * (1.f - fy[q]) +
             t10[q] * (1.f - fx[q]) * fy[q] + t11[q] * fx[q] * fy[q];
}

// A: one block per (b, p). Shared: records [C][kRec] | tile [n][W2].
__global__ void __launch_bounds__(kMaxThreads) view_moments_kernel(
    const uint16_t* __restrict__ images, const uint16_t* __restrict__ edges,
    const int* __restrict__ dims, const int* __restrict__ yoff, int C, int L,
    int Ha, int Wa, const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ lod, const uint8_t* __restrict__ act,
    const uint8_t* __restrict__ cam_mask, const uint8_t* __restrict__ pvalid,
    const int* __restrict__ ref_cam, const uint8_t* __restrict__ own,
    long long BP, int P, int radius, int lpr_shift,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);
  float* s_out = s_rec + C * kRec;
  __shared__ int s_nact, s_nbad;

  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int l = lod[b];
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  if (threadIdx.x < 32)
    compact_cameras(H, dims, act, cam_mask, pvalid[bp] != 0, b, bp, C, L, l,
                    s_rec, &s_nact, &s_nbad);
  __syncthreads();

  const int nact = s_nact;
  const float nbad0 = (float)s_nbad;
  const float px = pt[bp * 2 + 0], py = pt[bp * 2 + 1];
  const int yo = yoff[l];
  const long long plane = (long long)Ha * Wa;
  const bool owned = own[b] != 0;
  const long long ref_base = (long long)ref_cam[b] * plane;
  const int lpr = 1 << lpr_shift;
  const int col = threadIdx.x & (lpr - 1);
  const int sub = threadIdx.x >> lpr_shift;
  const int rps = blockDim.x >> lpr_shift;     // y offsets per step
  const float4* rec4 = reinterpret_cast<const float4*>(s_rec);

  for (int i0 = 0; i0 < W; i0 += lpr) {
    // window offset (dx, dy) = (i - r, j - r), stored at i * W + j
    const int i = i0 + col;
    const float x = px + (float)(i - radius);
    for (int j0 = 0; j0 < W; j0 += kRowBatch * rps) {
      float y[kRowBatch], sum[kRowBatch], bad[kRowBatch];
      bool in[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int j = j0 + q * rps + sub;
        in[q] = (i < W) & (j < W);
        y[q] = py + (float)(j - radius);
        sum[q] = 0.f;
        bad[q] = nbad0;
      }
#pragma unroll 1
      for (int k = 0; k < nact; ++k) {
        const float4 rc = rec4[k * 3 + 2];     // h8 umax vmax cam|mask
        bool ok[kRowBatch];
        float val[kRowBatch];
        sample_rows(images, rec4[k * 3 + 0], rec4[k * 3 + 1], rc, x, y, in,
                    yo, Ha, Wa, plane, ok, val);
        const float m = (float)(__float_as_int(rc.w) & 1);
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) {
          if (ok[q]) sum[q] += val[q];
          else bad[q] += m;
        }
      }
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        if (!in[q]) continue;
        const int kk = i * W + j0 + q * rps + sub;
        s_out[kk] = sum[q];
        s_out[W2 + kk] = bad[q];
        float ri = 0.f, re = 0.f;
        if (owned) {
          // the nearest reference pixel, clamped into the atlas as
          // nearest_gather clamps it (in-bounds is the caller's invariant)
          const int xi = clampi((int)rintf(x), 0, Wa - 1);
          const int yi = clampi((int)rintf(y[q]) + yo, 0, Ha - 1);
          const long long ridx = ref_base + (long long)yi * Wa + xi;
          ri = tap(images, ridx);
          if (edges != nullptr) re = tap(edges, ridx);
        }
        s_out[2 * W2 + kk] = ri;
        if (edges != nullptr) s_out[3 * W2 + kk] = re;
      }
    }
  }
  __syncthreads();
  const int nplanes = edges != nullptr ? 4 : 3;
  for (int pl = 0; pl < nplanes; ++pl) {
    float* dst = out + ((long long)pl * BP + bp) * W2;
    for (int kk = threadIdx.x; kk < W2; kk += blockDim.x)
      dst[kk] = s_out[pl * W2 + kk];
  }
}

// B: one block per (b, p). Shared: records [C][kRec] | window [W2] (the
// mean, overwritten pixel by pixel by the deviation its thread computed).
__global__ void __launch_bounds__(kMaxThreads) view_deviation_kernel(
    const uint16_t* __restrict__ images, const int* __restrict__ dims,
    const int* __restrict__ yoff, int C, int L, int Ha, int Wa,
    const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ lod, const uint8_t* __restrict__ act,
    const uint8_t* __restrict__ pvalid, const float* __restrict__ mean,
    int P, int radius, int lpr_shift, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);
  float* s_win = s_rec + C * kRec;
  __shared__ int s_nact, s_nbad;

  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int l = lod[b];
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  float* dst = out + bp * W2;
  if (threadIdx.x < 32)
    compact_cameras(H, dims, act, nullptr, pvalid[bp] != 0, b, bp, C, L, l,
                    s_rec, &s_nact, &s_nbad);
  __syncthreads();
  const int nact = s_nact;
  if (nact == 0) {                   // invalid particle or inactive swarm
    for (int kk = threadIdx.x; kk < W2; kk += blockDim.x) dst[kk] = 0.f;
    return;
  }
  for (int kk = threadIdx.x; kk < W2; kk += blockDim.x)
    s_win[kk] = mean[bp * W2 + kk];
  __syncthreads();

  const float px = pt[bp * 2 + 0], py = pt[bp * 2 + 1];
  const int yo = yoff[l];
  const long long plane = (long long)Ha * Wa;
  const int lpr = 1 << lpr_shift;
  const int col = threadIdx.x & (lpr - 1);
  const int sub = threadIdx.x >> lpr_shift;
  const int rps = blockDim.x >> lpr_shift;
  const float4* rec4 = reinterpret_cast<const float4*>(s_rec);

  for (int i0 = 0; i0 < W; i0 += lpr) {
    const int i = i0 + col;
    const float x = px + (float)(i - radius);
    for (int j0 = 0; j0 < W; j0 += kRowBatch * rps) {
      float y[kRowBatch], mu[kRowBatch], dev[kRowBatch];
      bool in[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int j = j0 + q * rps + sub;
        in[q] = (i < W) & (j < W);
        y[q] = py + (float)(j - radius);
        mu[q] = in[q] ? s_win[i * W + j] : 0.f;
        dev[q] = 0.f;
      }
#pragma unroll 1
      for (int k = 0; k < nact; ++k) {
        bool ok[kRowBatch];
        float val[kRowBatch];
        sample_rows(images, rec4[k * 3 + 0], rec4[k * 3 + 1],
                    rec4[k * 3 + 2], x, y, in, yo, Ha, Wa, plane, ok, val);
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q)
          if (ok[q]) dev[q] += fabsf(val[q] - mu[q]);
      }
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q)
        if (in[q]) s_win[i * W + j0 + q * rps + sub] = dev[q];
    }
  }
  __syncthreads();
  for (int kk = threadIdx.x; kk < W2; kk += blockDim.x) dst[kk] = s_win[kk];
}

// The launch shape of both kernels for a window of side W: lanes per x
// chunk (as a shift) and threads per block: enough rows of lanes that one
// step of kRowBatch y offsets covers the window where that fits in
// kMaxThreads threads, in whole warps.
void launch_shape(int W, int* lpr_shift, int* threads) {
  *lpr_shift = W <= 8 ? 3 : (W <= 16 ? 4 : 5);
  const int want = (1 << *lpr_shift) * ((W + kRowBatch - 1) / kRowBatch);
  *threads = want >= kMaxThreads ? kMaxThreads : ((want + 31) / 32) * 32;
}

// Dynamic shared memory of one block of either kernel: C camera records
// and `planes` window tiles (ops/cuda_fitness.py::view_smem_bytes
// computes the same to refuse a rig before the launch).
long long view_smem_bytes(int C, int radius, int planes) {
  const long long W = 2 * radius + 1;
  return 4LL * kRec * C + 4LL * planes * W * W;
}

template <typename K>
int prepare(K kernel, long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch, or the error of raising the block's shared-memory limit.
// edges may be null: then the output has 3 planes, else 4.
extern "C" int pais_view_moments(
    const void* images, const void* edges, const int* dims, const int* yoff,
    int C, int L, int Ha, int Wa, const float* H, const float* pt,
    const int* lod, const uint8_t* act, const uint8_t* cam_mask,
    const uint8_t* pvalid, const int* ref_cam, const uint8_t* own, int B,
    int P, int radius, float* out, void* stream) {
  const long long BP = (long long)B * P;
  if (BP == 0) return 0;
  const long long smem =
      view_smem_bytes(C, radius, edges != nullptr ? 4 : 3);
  const int rc = prepare(view_moments_kernel, smem);
  if (rc != 0) return rc;
  int lpr_shift, threads;
  launch_shape(2 * radius + 1, &lpr_shift, &threads);
  view_moments_kernel<<<(unsigned)BP, threads, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const uint16_t*)images, (const uint16_t*)edges, dims, yoff, C, L, Ha,
      Wa, H, pt, lod, act, cam_mask, pvalid, ref_cam, own, BP, P, radius,
      lpr_shift, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_view_deviation(
    const void* images, const int* dims, const int* yoff, int C, int L,
    int Ha, int Wa, const float* H, const float* pt, const int* lod,
    const uint8_t* act, const uint8_t* pvalid, const float* mean, int B,
    int P, int radius, float* out, void* stream) {
  const long long BP = (long long)B * P;
  if (BP == 0) return 0;
  const long long smem = view_smem_bytes(C, radius, 1);
  const int rc = prepare(view_deviation_kernel, smem);
  if (rc != 0) return rc;
  int lpr_shift, threads;
  launch_shape(2 * radius + 1, &lpr_shift, &threads);
  view_deviation_kernel<<<(unsigned)BP, threads, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const uint16_t*)images, dims, yoff, C, L, Ha, Wa, H, pt, lod, act,
      pvalid, mean, P, radius, lpr_shift, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_view_fitness_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
