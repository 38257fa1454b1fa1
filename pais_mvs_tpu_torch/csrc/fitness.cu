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
//  * one warp per particle, kW particles of one patch per block (kWarps
//    = 8, or kWideWarps = 4 on a rig wider than kTile; grid B x
//    ceil(P/kW)); block t scores the patch's valid particles of rank kW t
//    .. kW t + kW - 1 (compacted in the preamble), so invalid particles
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
//    laid out [camera][thread] (bank-conflict free; the wide path
//    [camera][lane] after the warp's records), not to a register array
//    (launch bound: 4 blocks of 8 warps, 32 warps resident per SM);
//  * a rig of at most kTile = 32 cameras runs the one-pass loop
//    (fitness_kernel<false>, the kernel as it always was): a block holds
//    the records and samples of every camera of the rig (fitness_smem_bytes
//    of C cameras: 15,204 bytes at C = 8, r = 15), 4 blocks an SM;
//  * a wider rig runs fitness_kernel<true>, whose blocks of kWideWarps = 4
//    particles give each warp (kRec + 32) floats for each of kSpan = 72
//    cameras (55,396 bytes a block at r = 15, so 4 blocks, 16 warps an SM,
//    up to 128 registers a thread; kWideBlocks). A row that sees at most
//    kSpan cameras takes each (pixel, camera) sample once: its records are
//    packed once per particle, and every sample of a pixel stays in shared
//    memory until the pixel's mean is known. A wider row keeps all its
//    records (packed once per particle) and the samples of as many of its
//    last cameras as fit beside them; pass 1 adds every sample to the
//    pixel's sum and out-of-bounds kill in camera order, pass 2 samples
//    the cameras before the kept ones again (the same bodies, so the same
//    bits) and adds |c_i - mean| in camera order, the kept ones from
//    shared memory. Up to 261 cameras a row the records fit (a row of 114
//    samples 58 twice); a wider row takes its cameras in tiles of kSpan
//    records aligned to its end (the first tile holds the rest), keeps the
//    last tile's samples, and a warp packs a tile's records (a ballot scan
//    of the row's camera mask) when it moves to another tile. Both sums
//    round as in one pass. With 16 warps an SM and not 32, a warp hides
//    part of its own latency: the samples of kUnroll = 4 cameras are
//    fetched (records, homographies, divisions, their 16 gathers issued)
//    before the first is blended, the taps kept as raw bf16 bits until
//    then (a tap shifted into a float as it arrives makes its sample wait
//    on the gather, and no unroll helps). What bounds it is the warps
//    an SM: each camera held costs a warp 176 bytes, and a span of 96 (12
//    warps an SM, 8 cameras a fetch) or 128 (8 warps) ran slower than 72
//    up to 64 cameras a row (PERF.md). The only limit left is the window:
//    the wrapper refuses a radius whose table and cameras exceed one
//    block's shared memory (r > 107 on a rig of 32 cameras, r > 105 on one
//    of kSpan or more; past r = 18 only 3 wide blocks fit an SM), and
//    there is no camera ceiling;
//  * lanes take the window's x offsets and each warp steps over its y
//    offsets: 32 lanes at r >= 8 (W > 32 loops over chunks of 32), 16 or
//    8 lanes and 2 or 4 y offsets a step for smaller windows, so there is
//    no per-pixel integer division, and a warp's four taps of a camera
//    fall on neighbouring atlas elements of two image rows (a few 32-byte
//    sectors per load; lanes along y, the table's contiguous axis, touch
//    32 image rows, which cost the first form most of its time);
//  * the one-pass loop's camera loop is not unrolled: unrolling it by two
//    measured slower there (each tap is used as it arrives);
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
constexpr int kWarps = 8;                // particles per block (one-pass)
constexpr int kThreads = 32 * kWarps;
constexpr int kRec = 12;                 // floats per camera record
constexpr int kTile = 32;                // the widest rig of the one-pass
constexpr int kSpan = 72;                // cameras a wide block holds
constexpr int kWideWarps = 4;            // particles per wide block
constexpr int kWideBlocks = 4;           // wide blocks resident per SM
constexpr int kUnroll = 4;               // samples a wide warp issues at once

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
// margins. The one-pass loop's; the wide path takes the same operations in
// the same order through fetch() and blend(), so the same bits.
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

// The four taps of one bilinear sample, fetched (their bf16 bits: nothing
// waits on a gather until blend() reads it), with the fractions that
// blend them and whether the sample lies inside the margins.
struct Taps {
  unsigned t00, t01, t10, t11;
  float fx, fy;
  bool ok;
};

// The wide path's sample(), cut in two: fetch the taps of the camera of
// record (ra, rb, rc) at (x, y), and blend() them later. The operations
// and their order are sample()'s, so the bits are too; every sample of the
// wide path, taken once or twice, goes through these two bodies.
__device__ __forceinline__ Taps fetch(const float4 ra, const float4 rb,
                                      const float4 rc, float x, float y,
                                      const uint16_t* __restrict__ images,
                                      long long plane, int Ha, int Wa,
                                      int yo) {
  // ra = h0 h1 h2 h3, rb = h4 h5 h6 h7, rc = h8 umax vmax cam
  const float hw = rb.z * x + rb.w * y + rc.x;
  const float sw = hw == 0.f ? 1.f : hw;
  const float u = (ra.x * x + ra.y * y + ra.z) / sw;
  const float v = (ra.w * x + rb.x * y + rb.y) / sw;
  Taps t;
  // (NaN and +-inf fail the bounds: no isfinite test needed)
  t.ok = (u >= 2.f) & (u < rc.y) & (v >= 2.f) & (v < rc.z) & (hw != 0.f);
  const float x0 = floorf(u), y0 = floorf(v);
  t.fx = u - x0;
  t.fy = v - y0;
  const int x0i = clampi((int)x0, 0, Wa - 2);
  const int y0i = clampi((int)y0 + yo, 0, Ha - 2);
  const long long i00 = (long long)__float_as_int(rc.w) * plane +
                        (long long)y0i * Wa + x0i;
  t.t00 = __ldg(images + i00);
  t.t01 = __ldg(images + i00 + 1);
  t.t10 = __ldg(images + i00 + Wa);
  t.t11 = __ldg(images + i00 + Wa + 1);
  return t;
}

__device__ __forceinline__ float blend(const Taps& t) {
  // bf16 -> f32 is the bits shifted into the high half
  const float t00 = __uint_as_float(t.t00 << 16);
  const float t01 = __uint_as_float(t.t01 << 16);
  const float t10 = __uint_as_float(t.t10 << 16);
  const float t11 = __uint_as_float(t.t11 << 16);
  return t00 * (1.f - t.fx) * (1.f - t.fy) + t01 * t.fx * (1.f - t.fy) +
         t10 * (1.f - t.fx) * t.fy + t11 * t.fx * t.fy;
}

// Pack the records of the row's visible cameras of rank k0 .. k0 + kn - 1
// into rec4: a ballot scan of the row's camera mask, each lane writing the
// record of the visible camera it holds when its rank falls in the tile.
// Called by the whole warp.
__device__ __forceinline__ void pack_tile(
    float4* __restrict__ rec4, const uint8_t* __restrict__ mask_row, int C,
    int k0, int kn, const float* __restrict__ Hp,
    const int* __restrict__ dims, int L, int l, int lane) {
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();
  int n = 0;
  for (int c0 = 0; c0 < C && n < k0 + kn; c0 += 32) {
    const int c = c0 + lane;
    const bool vis = c < C && mask_row[c] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, vis);
    const int k = n + __popc(m & below) - k0;
    if (vis && k >= 0 && k < kn) {
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

// The taps of the kUnroll cameras of rec4 from camera k at (x, y): their
// records read first, then every gather issued before any is used, so the
// kUnroll cameras' gathers are in flight together.
__device__ __forceinline__ void fetch_group(
    Taps (&t)[kUnroll], const float4* __restrict__ rec4, int k, float x,
    float y, const uint16_t* __restrict__ images, long long plane, int Ha,
    int Wa, int yo) {
  float4 r[kUnroll][3];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int q = 0; q < 3; ++q) r[u][q] = rec4[(k + u) * 3 + q];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    t[u] = fetch(r[u][0], r[u][1], r[u][2], x, y, images, plane, Ha, Wa, yo);
}

// The samples of the kn cameras of rec4 at (x, y), in camera order: each
// added to sum, and from camera `from` on kept in val[(k - from) * 32]; ok
// gathers the bounds. Groups of kUnroll cameras are fetched before they
// are blended and added; the adds run in camera order all the same.
__device__ __forceinline__ void sample_tile(
    const float4* __restrict__ rec4, int kn, float x, float y,
    const uint16_t* __restrict__ images, long long plane, int Ha, int Wa,
    int yo, float* __restrict__ val, int from, float& sum, bool& ok) {
  int k = 0;
  for (; k + kUnroll <= kn; k += kUnroll) {
    Taps t[kUnroll];
    fetch_group(t, rec4, k, x, y, images, plane, Ha, Wa, yo);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float v = blend(t[u]);
      if (k + u >= from) val[(k + u - from) * 32] = v;
      sum += v;
      ok &= t[u].ok;
    }
  }
  for (; k < kn; ++k) {
    const Taps t = fetch(rec4[k * 3], rec4[k * 3 + 1], rec4[k * 3 + 2], x, y,
                         images, plane, Ha, Wa, yo);
    const float v = blend(t);
    if (k >= from) val[(k - from) * 32] = v;
    sum += v;
    ok &= t.ok;
  }
}

// sad += |sample - mean| over the kn cameras of rec4, in camera order (the
// samples taken again: the same bodies, so the same bits).
__device__ __forceinline__ void deviate_tile(
    const float4* __restrict__ rec4, int kn, float x, float y,
    const uint16_t* __restrict__ images, long long plane, int Ha, int Wa,
    int yo, float mean, float& sad) {
  int k = 0;
  for (; k + kUnroll <= kn; k += kUnroll) {
    Taps t[kUnroll];
    fetch_group(t, rec4, k, x, y, images, plane, Ha, Wa, yo);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sad += fabsf(blend(t[u]) - mean);
  }
  for (; k < kn; ++k)
    sad += fabsf(blend(fetch(rec4[k * 3], rec4[k * 3 + 1], rec4[k * 3 + 2],
                             x, y, images, plane, Ha, Wa, yo)) -
                 mean);
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

// kTiled: the rig has more cameras than kTile (the launch picks it by C).
// Its blocks hold the records and samples of kSpan cameras for kWideWarps
// particles: a row that sees at most kSpan cameras takes one pass, a wider
// row two passes over tiles of kSpan.
template <bool kTiled>
__global__ void __launch_bounds__(kTiled ? 32 * kWideWarps : kThreads,
                                  kTiled ? kWideBlocks : 4) fitness_kernel(
    const uint16_t* __restrict__ images, const uint16_t* __restrict__ edges,
    const int* __restrict__ dims, const int* __restrict__ yoff, int C, int L,
    int Ha, int Wa, const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ ref_cam, const int* __restrict__ lod,
    const uint8_t* __restrict__ cam_mask, const uint8_t* __restrict__ pvalid,
    const uint8_t* __restrict__ active, const float* __restrict__ wtable,
    int P, int radius, int lpr_shift, int use_dist, int use_diff,
    float diff_w, int use_grad, float grad_w, float* __restrict__ out) {
  constexpr int kW = kTiled ? kWideWarps : kWarps;   // particles a block
  constexpr int kT = 32 * kW;
  constexpr int kHold = kTiled ? kSpan : kTile;      // cameras a block holds
  // shared, for T = min(C, kHold) cameras: records [kW][T][kRec] |
  // samples [T][kT] | limits [T][2] | cameras [T] | table [W2]
  const int T = C < kHold ? C : kHold;
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);
  float* s_val = s_rec + kW * T * kRec;
  float* s_lim = s_val + T * kT;
  int* s_cam = reinterpret_cast<int*>(s_lim + 2 * T);
  float* s_tab = reinterpret_cast<float*>(s_cam + T);
  __shared__ int s_nvis, s_npart, s_part[kW];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * kW;              // this block's tile of P
  if (active != nullptr && !active[b]) {       // the same for the block
    if (lane == 0 && t0 + warp < P) out[(long long)b * P + t0 + warp] = kBig;
    return;
  }
  const int l = lod[b];
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  const unsigned below = (1u << lane) - 1u;

  // preamble: warp 0 counts the visible cameras and compacts the first
  // kHold of them in camera order, warp 1
  // the patch's valid particles in particle order; this block scores the
  // valid particles of rank t0 .. t0 + kW - 1, one per warp, so a tile's
  // warps are not left idle by invalid particles
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool vis = c < C && cam_mask[(long long)b * C + c] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, vis);
      const int k = n + __popc(m & below);
      if (vis && k < kHold) {
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
      if (v && rank >= 0 && rank < kW) s_part[rank] = pp;
      n += __popc(m);
    }
    if (lane == 0) s_npart = min(max(n - t0, 0), kW);
  }
  if (use_dist)
    for (int k = threadIdx.x; k < W2; k += kT) s_tab[k] = wtable[k];
  __syncthreads();

  // BIG for the invalid particles of this block's tile
  if (lane == 0 && t0 + warp < P &&
      !pvalid[(long long)b * P + t0 + warp])
    out[(long long)b * P + t0 + warp] = kBig;
  if (warp >= s_npart) return;
  const int p = s_part[warp];
  const long long bp = (long long)b * P + p;
  const int nvis = s_nvis;
  // The wide path (kTiled) gives each warp (kRec + 32) floats for each of
  // T cameras: nrec records, then one sample a lane of each of the last
  // keep cameras. A row within the span holds all its records and
  // samples (one pass); a wider row holds all its records while they fit
  // beside the samples of at least one camera, and samples its first
  // nvis - keep cameras twice; a row wider still takes its cameras in
  // tiles of T records aligned to its end (the first tile holds the rest)
  // and keeps the last tile's samples.
  const int nrec = nvis <= T || kRec * nvis + 32 <= (kRec + 32) * T
                       ? nvis : T;
  const int keep = nvis <= T ? nvis
                   : (nrec == nvis ? ((kRec + 32) * T - kRec * nvis) / 32
                                   : T);
  const int kfrom = nvis - keep;               // the first kept camera
  const int ntile = nvis > nrec ? (nvis + nrec - 1) / nrec : 1;
  const int head = nvis - (ntile - 1) * nrec;  // the first tile's cameras
  // this particle's records of the first kHold cameras (tile 0 among
  // them; the rest of a row whose records all fit below): h[0..8], u
  // limit, v limit, camera
  float* rec = s_rec + warp * T * (kTiled ? kRec + 32 : kRec);
  for (int e = lane; e < min(nvis, kHold) * kRec; e += 32) {
    const int k = e / kRec, f = e - k * kRec;
    const int c = s_cam[k];
    rec[e] = f < 9 ? H[(bp * C + c) * 9 + f]
                   : (f < 11 ? s_lim[2 * k + f - 9] : __int_as_float(c));
  }
  __syncwarp();
  float4* rec4 = reinterpret_cast<float4*>(rec);
  const float* Hp = H + bp * C * 9;
  const uint8_t* mask_row = cam_mask + (long long)b * C;
  if (kTiled && nrec > kHold)
    pack_tile(rec4 + kHold * 3, mask_row, C, kHold, nrec - kHold, Hp, dims,
              L, l, lane);

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
  // my_val[k * kT] (the wide path: [k * 32], after the records)
  float* my_val = kTiled ? rec + kRec * nrec + lane : s_val + threadIdx.x;
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
      if (!kTiled) {
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
            my_val[k * kT] = val;
            sum += val;
            pix_ok &= ok;
          }
          const float mean = sum / cn;
          float sad = 0.f;
          for (int k = 0; k < nvis; ++k)
            sad += fabsf(my_val[k * kT] - mean);
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
        // pass 1: every tile's samples into the sum, in camera order,
        // those of the kept cameras into shared memory
        float sum = 0.f;
        bool pix_ok = true;
        for (int t = 0; t < ntile; ++t) {
          const int k0 = t ? head + (t - 1) * nrec : 0;
          const int kn = t ? nrec : head;
          if (t != held) {                     // the same for the warp
            pack_tile(rec4, mask_row, C, k0, kn, Hp, dims, L, l, lane);
            held = t;
          }
          if (in)
            sample_tile(rec4, kn, x, y, images, plane, Ha, Wa, yo, my_val,
                        kfrom - k0, sum, pix_ok);
        }
        const float mean = sum / cn;
        // pass 2: |c_i - mean| in camera order, the cameras before the
        // kept ones sampled again
        float sad = 0.f;
        for (int t = 0; t < ntile; ++t) {
          const int k0 = t ? head + (t - 1) * nrec : 0;
          if (k0 >= kfrom) break;              // the same for the warp
          const int kn = t ? nrec : head;
          if (t != held) {
            pack_tile(rec4, mask_row, C, k0, kn, Hp, dims, L, l, lane);
            held = t;
          }
          if (in)
            deviate_tile(rec4, min(kn, kfrom - k0), x, y, images, plane, Ha,
                         Wa, yo, mean, sad);
        }
        if (in) {
#pragma unroll 4
          for (int k = 0; k < keep; ++k) sad += fabsf(my_val[k * 32] - mean);
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

// Dynamic shared memory of one block: for each of min(C, kSpan) cameras
// (a rig of at most kTile holds them all), every particle's record (kRec
// floats) and every thread's sample (a rig of at most kTile runs kWarps
// particles a block, a wider one kWideWarps), the camera's limits and
// index; and the W2-entry table (ops/cuda_fitness.py::fitness_smem_bytes
// computes the same to refuse a window before the launch).
long long fitness_smem_bytes(int C, int radius) {
  const long long W = 2 * radius + 1;
  const long long warps = C > kTile ? kWideWarps : kWarps;
  const long long T = C < kSpan ? C : kSpan;
  return (warps * (kRec + 32) + 3) * 4 * T + 4 * W * W;
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
  const bool wide = C > kTile;
  const auto kernel = wide ? fitness_kernel<true> : fitness_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int W = 2 * radius + 1;
  const int lpr_shift = W <= 8 ? 3 : (W <= 16 ? 4 : 5);
  const int warps = wide ? kWideWarps : kWarps;
  const dim3 grid((unsigned)B, (unsigned)((P + warps - 1) / warps));
  kernel<<<grid, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint16_t*)images, (const uint16_t*)edges, dims, yoff, C, L, Ha,
      Wa, H, pt, ref_cam, lod, cam_mask, pvalid, active, wtable, P, radius,
      lpr_shift, use_dist, use_diff, diff_w, use_grad, grad_w, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_fitness_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ---------------------------------------------------------------------------
// The refine's per-particle geometry: patch_geometry_kernel
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the geometry stage of the jnp reference
// pais_mvs_tpu/ops/fitness.py::patch_fitness (:166-186), which XLA fuses
// under jit. Its plain PyTorch twin, pais_mvs_tpu_torch/ops/fitness.py::
// fitness_geometry, runs some 112 ops a PSO step; this is one launch that
// writes what the twin returns and K1 reads: H [B, P, C, 3, 3] for every
// camera of the rig (exact identity at the reference camera), pt [B, P, 2]
// (the reference-window centres at the LOD) and pvalid [B, P] (the normal
// faces the reference camera, the window lies inside the reference frame,
// and the plane does not pass through the reference camera's centre
// unless no other camera is visible).
//
// What bounds it: the store of H, 36 bytes a (particle, camera), 172 MB at
// B = 1024, P = 15, C = 312; the arithmetic a (particle, camera) is some
// 60 operations and 9 divisions. So: one block for each (row, tile of
// kGeoCams cameras); the block computes the row's relative poses R_rel,
// t_rel and the target intrinsics at the row's LOD once a camera (they
// depend on the reference camera, not the particle), and each particle's
// n_r and plane distance once (shared memory); then its threads take the
// (particle, camera) pairs, stage each pair's nine entries in shared
// memory and store them in address order, so the stores coalesce. Tiles
// of 32 cameras and 128 threads measured best of six shapes (tiles of 32
// to 128 cameras, 128 to 512 threads): 0.160 ms at B = 1024, P = 15, C =
// 312 against 0.186 for 64 x 256, 6.9 us against 9.2 at C = 5 (PERF.md).
//
// Bit-equal to the twin on the card: the same operations on the same
// operands in the twin's order, built with --fmad=false. torch's CUDA sum
// over a contiguous axis of 3 runs on two lanes (ATen's Reduce.cuh: a block
// width of last_pow2(3) = 2): lane 0 adds elements 0 and 2 into
// accumulators that start at +0, lane 1 holds element 1, and one shuffle
// adds the two, so torch_sum3 is ((x0 + x2) + 0) + (x1 + 0). 1 / x is
// torch's reciprocal, sin, cos and pow are sinf, cosf and powf.

namespace {

constexpr int kGeoThreads = 128;
constexpr int kGeoCams = 32;             // cameras of one block's tile
constexpr int kGeoCam = 16;              // floats of a camera's record

__device__ __forceinline__ float torch_sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + 0.f) + (x1 + 0.f);
}

// M @ v for a row-major 3x3 M, each component a torch_sum3 of products
__device__ __forceinline__ void mv3(const float* M, const float* v,
                                    float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = torch_sum3(M[3 * i] * v[0], M[3 * i + 1] * v[1],
                        M[3 * i + 2] * v[2]);
}

__global__ void __launch_bounds__(kGeoThreads) patch_geometry_kernel(
    const float* __restrict__ pos, const float* __restrict__ ray,
    const int* __restrict__ ref_cam, const int* __restrict__ lod,
    const uint8_t* __restrict__ cam_mask, const float* __restrict__ Rg,
    const float* __restrict__ Tg, const float* __restrict__ focal,
    const float* __restrict__ principal, const float* __restrict__ center,
    const float* __restrict__ optical, const int* __restrict__ dims, int C,
    int L, int P, float lod_ratio, float radius, float* __restrict__ H,
    float* __restrict__ pt, uint8_t* __restrict__ pvalid) {
  __shared__ float s_cam[kGeoCams * kGeoCam];   // R_rel, t_rel, intrinsics
  __shared__ float s_out[kGeoThreads * 9];      // staged entries of H
  extern __shared__ float4 s_part[];            // n_r, where(ok, d_r, 1)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kGeoCams;
  const int nc = min(kGeoCams, C - c0);
  const int ref = ref_cam[b];
  const int l = lod[b];
  const float s = powf(lod_ratio, (float)l);
  float Rr[9], Tr[3];
  for (int k = 0; k < 9; ++k) Rr[k] = Rg[ref * 9 + k];
  for (int k = 0; k < 3; ++k) Tr[k] = Tg[ref * 3 + k];

  // the cameras of the tile: the relative pose and the target's
  // intrinsics at the LOD (plane_homography's R_rel, t_rel, fx_t .. cy_t)
  for (int i = tid; i < nc; i += kGeoThreads) {
    const int c = c0 + i;
    float* rec = s_cam + i * kGeoCam;
    const float* Rt = Rg + c * 9;
    for (int r = 0; r < 3; ++r)
      for (int j = 0; j < 3; ++j)
        rec[3 * r + j] = torch_sum3(Rt[3 * r] * Rr[3 * j],
                                    Rt[3 * r + 1] * Rr[3 * j + 1],
                                    Rt[3 * r + 2] * Rr[3 * j + 2]);
    float RT[3];
    mv3(rec, Tr, RT);
    for (int r = 0; r < 3; ++r) rec[9 + r] = Tg[c * 3 + r] - RT[r];
    rec[12] = s * focal[c * 2];
    rec[13] = s * focal[c * 2 + 1];
    rec[14] = s * principal[c * 2];
    rec[15] = s * principal[c * 2 + 1];
  }

  // whether a camera other than the reference is visible: if none is, a
  // degenerate plane leaves the particle valid (every visible camera's
  // homography is the reference's identity)
  bool others = false;
  if (blockIdx.y == 0)
    for (int c = tid; c < C; c += kGeoThreads)
      others |= c != ref && cam_mask[(long long)b * C + c] != 0;
  others = __syncthreads_or(others);

  // the particles: normal, centre, n_r, X_r and d_r; the first camera
  // tile's block also writes pt and pvalid
  for (int p = tid; p < P; p += kGeoThreads) {
    const long long bp = (long long)b * P + p;
    const float th = pos[bp * 3], ph = pos[bp * 3 + 1],
                depth = pos[bp * 3 + 2];
    const float st = sinf(th);
    const float n[3] = {st * cosf(ph), st * sinf(ph), cosf(th)};
    float X[3];
    for (int k = 0; k < 3; ++k) X[k] = ray[b * 3 + k] * depth +
                                       center[ref * 3 + k];
    float nr[3], Xr[3];
    mv3(Rr, n, nr);
    mv3(Rr, X, Xr);
    for (int k = 0; k < 3; ++k) Xr[k] = Xr[k] + Tr[k];
    const float dr = torch_sum3(nr[0] * Xr[0], nr[1] * Xr[1], nr[2] * Xr[2]);
    const bool ok = fabsf(dr) > (float)1e-12;
    s_part[p] = make_float4(nr[0], nr[1], nr[2], ok ? dr : 1.f);
    if (blockIdx.y == 0) {
      const float* o = optical + ref * 3;
      const bool facing_bad = torch_sum3(n[0] * o[0], n[1] * o[1],
                                         n[2] * o[2]) > 0.f;
      // the projection into the reference camera at the LOD (X_r is its
      // camera-frame point)
      const float z = Xr[2];
      const float sz = z == 0.f ? 1.f : z;
      const float xn = Xr[0] / sz, yn = Xr[1] / sz;
      const float u = (focal[ref * 2] * xn + principal[ref * 2]) * s;
      const float v = (focal[ref * 2 + 1] * yn + principal[ref * 2 + 1]) * s;
      pt[bp * 2] = u;
      pt[bp * 2 + 1] = v;
      const float h = (float)dims[(ref * L + l) * 2];
      const float w = (float)dims[(ref * L + l) * 2 + 1];
      const bool in_ref = (u - radius >= 2.f) && (u + radius < w - 3.f) &&
                          (v - radius >= 2.f) && (v + radius < h - 3.f);
      pvalid[bp] = !facing_bad && in_ref && (ok || !others);
    }
  }
  __syncthreads();

  // the row's reference intrinsics at the LOD: the inverse of L K_ref
  const float inv_fx = 1.f / (s * focal[ref * 2]);
  const float inv_fy = 1.f / (s * focal[ref * 2 + 1]);
  const float ox = -principal[ref * 2] / focal[ref * 2];
  const float oy = -principal[ref * 2 + 1] / focal[ref * 2 + 1];

  const int pairs = P * nc;
  for (int base = 0; base < pairs; base += kGeoThreads) {
    const int i = base + tid;
    if (i < pairs) {
      const int p = i / nc, k = i - p * nc;
      float* out = s_out + tid * 9;
      if (c0 + k == ref) {
        for (int e = 0; e < 9; ++e) out[e] = (e % 4 == 0) ? 1.f : 0.f;
      } else {
        const float* rec = s_cam + k * kGeoCam;
        const float4 q = s_part[p];
        const float nr[3] = {q.x, q.y, q.z};
        float M[9];
        for (int r = 0; r < 3; ++r)
          for (int j = 0; j < 3; ++j)
            M[3 * r + j] = rec[3 * r + j] + (rec[9 + r] * nr[j]) / q.w;
        float KM[9];
        for (int j = 0; j < 3; ++j) {
          KM[j] = rec[12] * M[j] + rec[14] * M[6 + j];
          KM[3 + j] = rec[13] * M[3 + j] + rec[15] * M[6 + j];
          KM[6 + j] = M[6 + j];
        }
        for (int r = 0; r < 3; ++r) {
          out[3 * r] = KM[3 * r] * inv_fx;
          out[3 * r + 1] = KM[3 * r + 1] * inv_fy;
          out[3 * r + 2] = (KM[3 * r] * ox + KM[3 * r + 1] * oy) +
                           KM[3 * r + 2];
        }
      }
    }
    __syncthreads();
    // the staged pairs' entries in address order: a particle's run of the
    // tile's cameras is contiguous in H
    const int n9 = min(kGeoThreads, pairs - base) * 9;
    for (int e = tid; e < n9; e += kGeoThreads) {
      const int i = base + e / 9;
      const int p = i / nc, k = i - p * nc;
      H[(((long long)b * P + p) * C + c0 + k) * 9 + e % 9] = s_out[e];
    }
    __syncthreads();
  }
}

}  // namespace

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch,
// or the error of raising the block's shared-memory limit.
extern "C" int pais_geometry(const float* pos, const float* ray,
                             const int* ref_cam, const int* lod,
                             const uint8_t* cam_mask, const float* R,
                             const float* T, const float* focal,
                             const float* principal, const float* center,
                             const float* optical, const int* dims, int C,
                             int L, int B, int P, float lod_ratio,
                             int radius, float* H, float* pt,
                             uint8_t* pvalid, void* stream) {
  if ((long long)B * P == 0) return 0;
  const size_t smem = sizeof(float4) * (size_t)P;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        patch_geometry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)B, (unsigned)((C + kGeoCams - 1) / kGeoCams));
  patch_geometry_kernel<<<grid, kGeoThreads, smem, (cudaStream_t)stream>>>(
      pos, ray, ref_cam, lod, cam_mask, R, T, focal, principal, center,
      optical, dims, C, L, P, lod_ratio, (float)radius, H, pt, pvalid);
  return (int)cudaGetLastError();
}
