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
// bench shape. The atlases (a few MB of bf16) are read once from HBM and
// then live in the 50 MB L2; each window pixel costs, per visible camera,
// a homography, two IEEE divisions, four 2-byte gathers and the blend:
// some 90 instructions a sample, counted from the source. So the kernel
// is bound by instruction issue and the latency of the gathers behind it;
// its roofline bound (computed in chip_smoke.py) is the FP32 operation
// count. On the H100 at the bench shape it takes 0.44 ms on the round's
// first evaluation, 11x that bound, against 1.44 ms for the first form of
// this kernel (one 256-thread block per particle, threads along the
// window's y axis, 145 registers); PERF.md has the measurements.
//
// Design, occupancy first:
//  * one warp per particle, kWarps = 8 particles of one patch per block
//    (grid B x ceil(P/8)); block t scores the patch's valid particles of
//    rank 8t .. 8t+7 (compacted in the preamble), so invalid particles
//    leave no warp idle, and writes BIG for the invalid ones of its index
//    range; a block whose swarm is inactive writes BIG before any load;
//  * a preamble loads the patch-level data once into shared memory: the
//    visible cameras compacted in camera order (index and LOD-band
//    limits), the valid particles' ranks and the Gaussian table; then one
//    block barrier, the only one. Each warp then packs its particle's
//    homographies of the visible cameras into 48-byte records (h[9], u and
//    v limits, camera), read back with three broadcast 16-byte loads per
//    camera and pixel;
//  * the samples of one pixel's visible cameras go to shared memory,
//    laid out [camera][thread] (bank-conflict free), not to a register
//    array (launch bound: 4 blocks of 8 warps, 32 warps resident per SM);
//  * the block holds the records and samples of a tile of kTile = 32
//    cameras, not of the rig: its shared memory is fitness_smem_bytes of
//    min(C, kTile) cameras (49,284 bytes at r = 15 for any rig of 32
//    cameras or more), so 4 blocks stay resident however wide the rig,
//    and there is no camera ceiling. A rig of at most kTile cameras runs
//    the one-pass loop alone (fitness_kernel<false>, the kernel as it
//    always was). On a wider rig (fitness_kernel<true>) a row loops over
//    its compacted cameras in tiles of kTile: each warp
//    packs a tile's records itself (a ballot scan of the row's camera
//    mask, one camera a lane); pass 1 samples every tile and adds to the
//    pixel's sum and out-of-bounds kill in camera order, keeping the last
//    tile's samples; pass 2 samples the earlier tiles again (the same
//    arithmetic, so the same bits) and adds |c_i - mean| in camera order,
//    the last tile from shared memory. Both sums round as in one pass.
//    The only limit left is the window: the wrapper refuses a radius
//    whose table and one tile exceed one block's shared memory
//    (r > 107 on a rig of 32 cameras or more);
//  * lanes take the window's x offsets and each warp steps over its y
//    offsets: 32 lanes at r >= 8 (W > 32 loops over chunks of 32), 16 or
//    8 lanes and 2 or 4 y offsets a step for smaller windows, so there is
//    no per-pixel integer division, and a warp's four taps of a camera
//    fall on neighbouring atlas elements of two image rows (a few 32-byte
//    sectors per load; lanes along y, the table's contiguous axis, touch
//    32 image rows, which cost the first form most of its time);
//  * the camera loop is not unrolled: unrolling it by two measured slower;
//  * no block reduction: each warp sums sum(w) and sum(w*SAD) with
//    shuffles, and stops as soon as __any_sync sees a killed pixel;
//  * taps read through the read-only path (__ldg) from L1/L2: no box
//    staging, so no coverage limit and no radius ceiling.
//
// Arithmetic is written in the jnp reference's operation order and built
// with --fmad=false; the per-camera sums run in camera order, so every
// per-pixel value rounds as the plain version does on the card; only the
// window sum's order differs (~1e-6 relative).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kWarps = 8;                // particles per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRec = 12;                 // floats per camera record
constexpr int kTile = 32;                // cameras a block holds at once

__device__ __forceinline__ float tap(const uint16_t* __restrict__ a,
                                     long long i) {
  // bf16 -> f32 is the bits shifted into the high half
  return __uint_as_float((unsigned)__ldg(a + i) << 16);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One bilinear sample of the camera of record r (h[9], u and v limits,
// camera) at reference pixel (x, y); ok is whether it lies inside the
// margins. Pass 1 and pass 2 call this one body, so a sample taken twice
// has the same bits.
__device__ __forceinline__ float sample(const float4* __restrict__ r,
                                        float x, float y,
                                        const uint16_t* __restrict__ images,
                                        long long plane, int Ha, int Wa,
                                        int yo, bool& ok) {
  const float4 ra = r[0];   // h0 h1 h2 h3
  const float4 rb = r[1];   // h4 h5 h6 h7
  const float4 rc = r[2];   // h8 umax vmax cam
  const float hw = rb.z * x + rb.w * y + rc.x;
  const float sw = hw == 0.f ? 1.f : hw;
  const float u = (ra.x * x + ra.y * y + ra.z) / sw;
  const float v = (ra.w * x + rb.x * y + rb.y) / sw;
  // (NaN and +-inf fail the bounds: no isfinite test needed)
  ok = (u >= 2.f) & (u < rc.y) & (v >= 2.f) & (v < rc.z) & (hw != 0.f);
  const float x0 = floorf(u), y0 = floorf(v);
  const float fx = u - x0, fy = v - y0;
  const int x0i = clampi((int)x0, 0, Wa - 2);
  const int y0i = clampi((int)y0 + yo, 0, Ha - 2);
  const long long i00 = (long long)__float_as_int(rc.w) * plane +
                        (long long)y0i * Wa + x0i;
  const float t00 = tap(images, i00);
  const float t01 = tap(images, i00 + 1);
  const float t10 = tap(images, i00 + Wa);
  const float t11 = tap(images, i00 + Wa + 1);
  return t00 * (1.f - fx) * (1.f - fy) + t01 * fx * (1.f - fy) +
         t10 * (1.f - fx) * fy + t11 * fx * fy;
}

// Pack the records of the row's visible cameras of rank k0 .. k0 + kTile
// - 1 into rec4: a ballot scan of the row's camera mask, each lane writing
// the record of the visible camera it holds when its rank falls in the
// tile. Called by the whole warp.
__device__ __forceinline__ void pack_tile(
    float4* __restrict__ rec4, const uint8_t* __restrict__ mask_row, int C,
    int k0, const float* __restrict__ Hp, const int* __restrict__ dims,
    int L, int l, int lane) {
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();
  int n = 0;
  for (int c0 = 0; c0 < C && n < k0 + kTile; c0 += 32) {
    const int c = c0 + lane;
    const bool vis = c < C && mask_row[c] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, vis);
    const int k = n + __popc(m & below) - k0;
    if (vis && k >= 0 && k < kTile) {
      const float* h = Hp + (long long)c * 9;
      rec4[k * 3 + 0] = make_float4(h[0], h[1], h[2], h[3]);
      rec4[k * 3 + 1] = make_float4(h[4], h[5], h[6], h[7]);
      rec4[k * 3 + 2] = make_float4(
          h[8], (float)dims[(c * L + l) * 2 + 1] - 3.f,
          (float)dims[(c * L + l) * 2 + 0] - 3.f, __int_as_float(c));
    }
    n += __popc(m);
  }
  __syncwarp();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The weight of one window pixel and its share of the particle's sums.
__device__ __forceinline__ void add_pixel(
    float sad, bool fg, long long ridx, int ij, const float* __restrict__ s_tab,
    int use_dist, int use_diff, float diff_w, int use_grad, float grad_w,
    const uint16_t* __restrict__ edges, float& acc_w, float& acc_ws) {
  float wgt = use_dist ? s_tab[ij] : 1.f;
  if (use_diff) wgt = wgt * expf(-sad * sad / diff_w);
  if (use_grad) {
    const float e = fmaxf(tap(edges, ridx) * grad_w, 1e-20f);
    wgt = wgt * expf(-1.f / e);
  }
  const float wfg = wgt * (fg ? 1.f : 0.f);
  acc_w += wfg;
  acc_ws += wfg * sad;
}

// kTiled: the rig has more cameras than one tile, so a row may see more
// (the launch picks it by C). A row that sees at most a tile takes the
// one-pass loop either way.
template <bool kTiled>
__global__ void __launch_bounds__(kThreads, 4) fitness_kernel(
    const uint16_t* __restrict__ images, const uint16_t* __restrict__ edges,
    const int* __restrict__ dims, const int* __restrict__ yoff, int C, int L,
    int Ha, int Wa, const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ ref_cam, const int* __restrict__ lod,
    const uint8_t* __restrict__ cam_mask, const uint8_t* __restrict__ pvalid,
    const uint8_t* __restrict__ active, const float* __restrict__ wtable,
    int P, int radius, int lpr_shift, int use_dist, int use_diff,
    float diff_w, int use_grad, float grad_w, float* __restrict__ out) {
  // shared, for T = min(C, kTile) cameras: records [kWarps][T][kRec] |
  // samples [T][kThreads] | limits [T][2] | cameras [T] | table [W2]
  const int T = C < kTile ? C : kTile;
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);
  float* s_val = s_rec + kWarps * T * kRec;
  float* s_lim = s_val + T * kThreads;
  int* s_cam = reinterpret_cast<int*>(s_lim + 2 * T);
  float* s_tab = reinterpret_cast<float*>(s_cam + T);
  __shared__ int s_nvis, s_npart, s_part[kWarps];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * kWarps;          // this block's tile of P
  if (active != nullptr && !active[b]) {       // the same for the block
    if (lane == 0 && t0 + warp < P) out[(long long)b * P + t0 + warp] = kBig;
    return;
  }
  const int l = lod[b];
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  const unsigned below = (1u << lane) - 1u;

  // preamble: warp 0 counts the visible cameras and compacts the first
  // tile of them in camera order, warp 1
  // the patch's valid particles in particle order; this block scores the
  // valid particles of rank t0 .. t0 + 7, one per warp, so a tile's warps
  // are not left idle by invalid particles
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool vis = c < C && cam_mask[(long long)b * C + c] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, vis);
      const int k = n + __popc(m & below);
      if (vis && k < kTile) {
        s_cam[k] = c;
        // valid iff 2 <= u < wid - 3 and 2 <= v < hgt - 3
        s_lim[2 * k + 0] = (float)dims[(c * L + l) * 2 + 1] - 3.f;
        s_lim[2 * k + 1] = (float)dims[(c * L + l) * 2 + 0] - 3.f;
      }
      n += __popc(m);
    }
    if (lane == 0) s_nvis = n;
  } else if (warp == 1) {
    int n = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int pp = p0 + lane;
      const bool v = pp < P && pvalid[(long long)b * P + pp] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      const int rank = n + __popc(m & below) - t0;
      if (v && rank >= 0 && rank < kWarps) s_part[rank] = pp;
      n += __popc(m);
    }
    if (lane == 0) s_npart = min(max(n - t0, 0), kWarps);
  }
  if (use_dist)
    for (int k = threadIdx.x; k < W2; k += kThreads) s_tab[k] = wtable[k];
  __syncthreads();

  // BIG for the invalid particles of this block's tile
  if (lane == 0 && t0 + warp < P &&
      !pvalid[(long long)b * P + t0 + warp])
    out[(long long)b * P + t0 + warp] = kBig;
  if (warp >= s_npart) return;
  const int p = s_part[warp];
  const long long bp = (long long)b * P + p;
  const int nvis = s_nvis;
  // the camera tiles: all but the last hold kTile cameras
  const int ntile = (nvis + kTile - 1) / kTile;
  const int last = ntile ? nvis - (ntile - 1) * kTile : 0;
  // this particle's records of the first tile: h[0..8], u limit, v limit,
  // camera
  float* rec = s_rec + warp * T * kRec;
  for (int e = lane; e < min(nvis, kTile) * kRec; e += 32) {
    const int k = e / kRec, f = e - k * kRec;
    const int c = s_cam[k];
    rec[e] = f < 9 ? H[(bp * C + c) * 9 + f]
                   : (f < 11 ? s_lim[2 * k + f - 9] : __int_as_float(c));
  }
  __syncwarp();

  const float cn = (float)nvis;
  const float px = pt[bp * 2 + 0];
  const float py = pt[bp * 2 + 1];
  const int yo = yoff[l];
  const long long plane = (long long)Ha * Wa;
  const long long ref_base = (long long)ref_cam[b] * plane;
  const int lpr = 1 << lpr_shift;              // lanes per x chunk
  const int col = lane & (lpr - 1);
  const int sub = lane >> lpr_shift;           // y offset within a step
  const int rps = 32 >> lpr_shift;             // y offsets per step
  float* my_val = s_val + threadIdx.x;         // my_val[k * kThreads]
  float4* rec4 = reinterpret_cast<float4*>(rec);
  const float* Hp = H + bp * C * 9;
  const uint8_t* mask_row = cam_mask + (long long)b * C;
  int held = 0;                                // the tile in rec

  float acc_w = 0.f, acc_ws = 0.f;
  bool bad = false;
  for (int i0 = 0; i0 < W; i0 += lpr) {
    // window offset (dx, dy) = (i - r, j - r), table index i * W + j
    // (x-major, as window_offsets orders it); lanes along x, so a warp's
    // taps fall on neighbouring atlas elements of one image row
    const int i = i0 + col;
    const float x = px + (float)(i - radius);
    for (int j0 = 0; j0 < W; j0 += rps) {
      const int j = j0 + sub;
      if (!kTiled || ntile <= 1) {
        if (i < W && j < W) {
          const float y = py + (float)(j - radius);

          // nearest reference pixel: background test and edge strength
          const int xi = clampi((int)rintf(x), 0, Wa - 1);
          const int yi = clampi((int)rintf(y) + yo, 0, Ha - 1);
          const long long ridx = ref_base + (long long)yi * Wa + xi;
          const bool fg = tap(images, ridx) != 0.f;

          float sum = 0.f;
          bool pix_ok = true;
#pragma unroll 1
          for (int k = 0; k < nvis; ++k) {
            bool ok;
            const float val = sample(rec4 + k * 3, x, y, images, plane, Ha,
                                     Wa, yo, ok);
            my_val[k * kThreads] = val;
            sum += val;
            pix_ok &= ok;
          }
          const float mean = sum / cn;
          float sad = 0.f;
          for (int k = 0; k < nvis; ++k)
            sad += fabsf(my_val[k * kThreads] - mean);
          sad = sad / cn;
          add_pixel(sad, fg, ridx, i * W + j, s_tab, use_dist, use_diff,
                    diff_w, use_grad, grad_w, edges, acc_w, acc_ws);
          bad |= (fg && !pix_ok);
        }
      } else {
        const bool in = i < W && j < W;
        const float y = py + (float)(j - radius);
        long long ridx = 0;
        bool fg = false;
        if (in) {
          const int xi = clampi((int)rintf(x), 0, Wa - 1);
          const int yi = clampi((int)rintf(y) + yo, 0, Ha - 1);
          ridx = ref_base + (long long)yi * Wa + xi;
          fg = tap(images, ridx) != 0.f;
        }
        // pass 1: every tile's samples into the sum, in camera order; the
        // last tile's samples stay in shared memory
        float sum = 0.f;
        bool pix_ok = true;
        for (int t = 0; t < ntile; ++t) {
          if (t != held) {                     // the same for the warp
            pack_tile(rec4, mask_row, C, t * kTile, Hp, dims, L, l, lane);
            held = t;
          }
          const int kn = t + 1 < ntile ? kTile : last;
          if (in) {
#pragma unroll 1
            for (int k = 0; k < kn; ++k) {
              bool ok;
              const float val = sample(rec4 + k * 3, x, y, images, plane,
                                       Ha, Wa, yo, ok);
              my_val[k * kThreads] = val;
              sum += val;
              pix_ok &= ok;
            }
          }
        }
        const float mean = sum / cn;
        // pass 2: |c_i - mean| in camera order, the tiles before the last
        // sampled again
        float sad = 0.f;
        for (int t = 0; t + 1 < ntile; ++t) {
          if (t != held) {
            pack_tile(rec4, mask_row, C, t * kTile, Hp, dims, L, l, lane);
            held = t;
          }
          if (in) {
#pragma unroll 1
            for (int k = 0; k < kTile; ++k) {
              bool ok;
              sad += fabsf(sample(rec4 + k * 3, x, y, images, plane, Ha, Wa,
                                  yo, ok) - mean);
            }
          }
        }
        if (in) {
          for (int k = 0; k < last; ++k)
            sad += fabsf(my_val[k * kThreads] - mean);
          sad = sad / cn;
          add_pixel(sad, fg, ridx, i * W + j, s_tab, use_dist, use_diff,
                    diff_w, use_grad, grad_w, edges, acc_w, acc_ws);
          bad |= (fg && !pix_ok);
        }
      }
      // a killed foreground pixel makes the particle BIG: stop early
      if (__any_sync(0xffffffffu, bad)) {
        if (lane == 0) out[bp] = kBig;
        return;
      }
    }
  }
  acc_w = warp_sum(acc_w);
  acc_ws = warp_sum(acc_ws);
  if (lane == 0) out[bp] = acc_w > 0.f ? acc_ws / acc_w : kBig;
}

// Dynamic shared memory of one block: the records and samples of one
// tile, min(C, kTile) cameras, and the W2-entry table
// (ops/cuda_fitness.py::fitness_smem_bytes computes the same to refuse a
// window before the launch).
long long fitness_smem_bytes(int C, int radius) {
  const long long W = 2 * radius + 1;
  const long long T = C < kTile ? C : kTile;
  return ((long long)kWarps * kRec + kThreads + 3) * 4 * T + 4 * W * W;
}

}  // namespace

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch,
// or the error of raising the block's shared-memory limit.
extern "C" int pais_fitness(const void* images, const void* edges,
                            const int* dims, const int* yoff, int C, int L,
                            int Ha, int Wa, const float* H, const float* pt,
                            const int* ref_cam, const int* lod,
                            const uint8_t* cam_mask, const uint8_t* pvalid,
                            const uint8_t* active, const float* wtable, int B,
                            int P, int radius, int use_dist, int use_diff,
                            float diff_w, int use_grad, float grad_w,
                            float* out, void* stream) {
  if ((long long)B * P == 0) return 0;
  const long long smem = fitness_smem_bytes(C, radius);
  const auto kernel =
      C > kTile ? fitness_kernel<true> : fitness_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int W = 2 * radius + 1;
  const int lpr_shift = W <= 8 ? 3 : (W <= 16 ? 4 : 5);
  const dim3 grid((unsigned)B, (unsigned)((P + kWarps - 1) / kWarps));
  kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint16_t*)images, (const uint16_t*)edges, dims, yoff, C, L, Ha,
      Wa, H, pt, ref_cam, lod, cam_mask, pvalid, active, wtable, P, radius,
      lpr_shift, use_dist, use_diff, diff_w, use_grad, grad_w, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_fitness_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
