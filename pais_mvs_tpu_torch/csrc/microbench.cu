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
// What bounds it on this card: instruction issue. Each (cell, t, p) does
// ~23 FP32 operations on four taps (the roofline bound counts these
// operations); the output write (21 MB at 5120 cells) is the only large
// memory traffic, and the taps come from L2 or shared memory. Every
// instruction a step spends besides those operations (loads, address
// arithmetic, bf16 conversions, the loop) is issue time.
//
// Four variants of the same function, one block of 256 threads per cell
// (four pixels per thread, coalesced stores) unless said otherwise:
//   (a) taps read straight from global memory (L2 holds the 655 KB of
//       boxes), each rounded to bf16 at its read, as csrc/fitness.cu reads
//       the atlas; the particle loop not unrolled;
//   (b) the cell's whole box staged into shared memory with cp.async
//       (80 KB, dynamic shared memory), then (a)'s loop on it: the Hopper
//       form of the Pallas kernel's VMEM box;
//   (c) only the cell's tap footprint staged, by Hopper's bulk copy: the
//       rows and columns the taps read (rows 40-51, columns 30-102 here,
//       computed by tap_footprint() in the tool and passed in as ints),
//       widened to 16-byte column bounds (28-103: 12 rows of 304 B, 3.6 KB
//       against (b)'s 80 KB). One thread arms an mbarrier with the byte
//       count and issues one cp.async.bulk per row; the block waits on the
//       barrier's parity. One pass then builds the quad layout
//       Q[y][c] = (X[y][c], X[y][c+1], X[y+1][c], X[y+1][c+1]), each tap
//       rounded to bf16 once per cell (11 x 72 float4, 12.4 KB), so a
//       bilinear sample is one 16-byte shared load and no conversion. The
//       particle loop is unrolled (p mod 17 folds to constants, the column
//       offset to the load's immediate). The footprint does not wrap past
//       column 255 (tap_footprint checks it), so c1 = c0 + 1 and no wrap
//       mask is needed. The hat weights stay per (pixel, particle), as in
//       the fitness kernel. About 16 KB of shared memory per block leaves
//       registers, not shared memory, to set the blocks per SM;
//   (d) (c) with persistent blocks: a grid of (resident blocks per SM) x
//       SMs, from the occupancy calculator, each block walking cells
//       blockIdx.x + k gridDim.x through a two-stage ring (a footprint
//       buffer and an mbarrier per stage, the parity flipping every second
//       cell; one quad buffer). One thread issues the next cell's bulk
//       copies into the other stage before the block builds and reads the
//       current cell's quads, so the staging overlaps the tap loop inside
//       the block. A second quad buffer would save one block barrier per
//       cell but take the block to 32.7 KB of shared memory and the SM
//       from 8 resident blocks to 6 (measured slower); with one, 20.0 KB.
// Neither (c) nor (d) reuses a staged footprint across cells or skips the
// (pixel, particle) pairs whose x-weights are zero: every cell stages its
// own footprint and every step loads its quad and does its arithmetic.
//
// The arithmetic is (a)'s in (a)'s order (tmp0, tmp1, then
// acc += tmp0 * wy0 + tmp1 * wy1), built with --fmad=false, so all four
// variants give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kY = 80, kX = 256, kS = 64, kT = 1024, kP = 30;
constexpr int kThreads = 256;
constexpr int kBoxBytes = kY * kX * 4;
constexpr int kBarBytes = 16;            // two mbarriers, 8 bytes each
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory w/o opt-in

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

// ---- (c) and (d): the tap footprint, bulk-copied, as bf16 quads ----

// The footprint (rows y_lo..y_hi, columns c_lo..c_hi, inclusive) and the
// shared-memory layout of one stage: the staged rows S [rows][sw] f32,
// columns cw.. (16-byte bounds), then the quads Q [qh][qw] float4, the
// quad of (y0, c0) at Q[(y0 - y_lo) qw + c0 - c_lo].
struct Layout {
  int y_lo, c_lo, cw, rows, sw, qh, qw;
  __host__ __device__ Layout(int y_lo_, int y_hi, int c_lo_, int c_hi)
      : y_lo(y_lo_), c_lo(c_lo_), cw(c_lo_ & ~3), rows(y_hi - y_lo_ + 1),
        sw(((c_hi + 4) & ~3) - (c_lo_ & ~3)), qh(y_hi - y_lo_),
        qw(c_hi - c_lo_) {}
  __host__ __device__ int s_bytes() const { return rows * sw * 4; }
  __host__ __device__ int q_bytes() const { return qh * qw * 16; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One thread: arm `bar` with the footprint's bytes and issue one bulk copy
// per footprint row of the cell's box into S.
__device__ __forceinline__ void stage_footprint(const float* __restrict__ src,
                                                float* S, uint64_t* bar,
                                                const Layout& L) {
  const unsigned row_bytes = (unsigned)L.sw * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(row_bytes * L.rows)
               : "memory");
  const float* g = src + L.y_lo * kX + L.cw;
  for (int r = 0; r < L.rows; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(S + r * L.sw)),
        "l"(g + r * kX), "r"(row_bytes), "r"(smem_addr(bar))
        : "memory");
}

// All threads: the quads of the staged rows, each tap rounded once.
__device__ __forceinline__ void build_quads(const float* S,
                                            float4* __restrict__ Q,
                                            const Layout& L) {
  const int off = L.c_lo - L.cw;
  for (int q = threadIdx.x; q < L.qh * L.qw; q += kThreads) {
    const int y = q / L.qw;
    const float* s = S + y * L.sw + off + (q - y * L.qw);
    Q[q] = make_float4(bf16r(s[0]), bf16r(s[1]), bf16r(s[L.sw]),
                       bf16r(s[L.sw + 1]));
  }
}

// (a)'s loop on the quads: one 16-byte shared load a (pixel, particle),
// particles unrolled.
__device__ __forceinline__ void quad_body(const float4* __restrict__ Q,
                                          const Layout& L,
                                          float* __restrict__ out) {
  for (int j = 0; j < kT / kThreads; ++j) {
    const int t = threadIdx.x + kThreads * j;
    const float tf = (float)t;
    const float v = 40.f + 0.01f * tf;
    const int y0 = (int)floorf(v);
    const float wy0 = fmaxf(1.f - fabsf(v - (float)y0), 0.f);
    const float wy1 = fmaxf(1.f - fabsf(v - (float)(y0 + 1)), 0.f);
    const float4* row = Q + (y0 - L.y_lo) * L.qw;
    const float ut = 30.f + 0.03f * tf;
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float u = ut + (float)p;
      const int k0 = (int)floorf(u);
      const float wx0 =
          k0 < kS ? bf16r(fmaxf(1.f - fabsf(u - (float)k0), 0.f)) : 0.f;
      const float wx1 =
          k0 + 1 < kS ? bf16r(fmaxf(1.f - fabsf(u - (float)(k0 + 1)), 0.f))
                      : 0.f;
      const float4 q = row[k0 + p % 17 - L.c_lo];
      const float tmp0 = q.x * wx0 + q.y * wx1;
      const float tmp1 = q.z * wx0 + q.w * wx1;
      acc += tmp0 * wy0 + tmp1 * wy1;
    }
    out[t] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) microbench_c_kernel(
    const float* __restrict__ box, int nbox, int y_lo, int y_hi, int c_lo,
    int c_hi, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(y_lo, y_hi, c_lo, c_hi);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* S = reinterpret_cast<float*>(smem + kBarBytes);
  float4* Q = reinterpret_cast<float4*>(smem + kBarBytes + L.s_bytes());
  const int i = blockIdx.x;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    stage_footprint(box + (long)(i % nbox) * kY * kX, S, bar, L);
  mbar_wait(bar, 0);
  build_quads(S, Q, L);
  __syncthreads();
  quad_body(Q, L, out + (long)i * kT);
}

__global__ void __launch_bounds__(kThreads) microbench_d_kernel(
    const float* __restrict__ box, int nbox, int cells, int y_lo, int y_hi,
    int c_lo, int c_hi, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(y_lo, y_hi, c_lo, c_hi);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  // the ring: stage s's footprint rows at S(s); one quad buffer Q
  auto S = [&](int s) {
    return reinterpret_cast<float*>(smem + kBarBytes + s * L.s_bytes());
  };
  float4* Q = reinterpret_cast<float4*>(smem + kBarBytes + 2 * L.s_bytes());
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int i = blockIdx.x;                     // the grid is at most `cells`
  if (threadIdx.x == 0)
    stage_footprint(box + (long)(i % nbox) * kY * kX, S(0), bar, L);
  for (int k = 0; i < cells; ++k, i += gridDim.x) {
    const int s = k & 1;
    const int next = i + gridDim.x;
    // stage s ^ 1 was last read by the quad build of cell k - 1, which
    // every thread finished before that cell's second block barrier
    if (threadIdx.x == 0 && next < cells) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_footprint(box + (long)(next % nbox) * kY * kX, S(s ^ 1),
                      bar + (s ^ 1), L);
    }
    mbar_wait(bar + s, (k >> 1) & 1);
    if (k > 0) __syncthreads();           // the tap loop of cell k - 1 is done
    build_quads(S(s), Q, L);
    __syncthreads();
    quad_body(Q, L, out + (long)i * kT);
  }
}

// The dynamic shared memory of (c) (stages = 1) or (d) (stages = 2) for a
// footprint: the barriers, `stages` footprint buffers and one quad buffer,
// after checking that the footprint lies in the box; opts the kernel in
// above 48 KB. Returns a cudaError_t.
int footprint_smem(const void* kernel, int y_lo, int y_hi, int c_lo,
                   int c_hi, int stages, int* bytes) {
  if (y_lo < 0 || y_hi >= kY || y_hi <= y_lo || c_lo < 0 || c_hi >= kX ||
      c_hi <= c_lo)
    return (int)cudaErrorInvalidValue;
  const Layout L(y_lo, y_hi, c_lo, c_hi);
  *bytes = kBarBytes + stages * L.s_bytes() + L.q_bytes();
  if (*bytes <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

}  // namespace

// C entries, bound with ctypes. box [nbox, 80, 256] f32 (16-byte aligned
// for (c) and (d)), out [cells, 1024] f32; (c) and (d) take the tap
// footprint (rows y_lo..y_hi, columns c_lo..c_hi) and (d) its grid (at
// most `cells`). Each returns cudaGetLastError() after its launch.
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

extern "C" int pais_microbench_c(const float* box, int nbox, int cells,
                                 int y_lo, int y_hi, int c_lo, int c_hi,
                                 float* out, void* stream) {
  if (cells == 0) return 0;
  int smem = 0;
  const int e = footprint_smem((const void*)microbench_c_kernel, y_lo, y_hi,
                               c_lo, c_hi, 1, &smem);
  if (e != 0) return e;
  microbench_c_kernel<<<cells, kThreads, smem, (cudaStream_t)stream>>>(
      box, nbox, y_lo, y_hi, c_lo, c_hi, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_microbench_d(const float* box, int nbox, int cells,
                                 int y_lo, int y_hi, int c_lo, int c_hi,
                                 int grid, float* out, void* stream) {
  if (cells == 0) return 0;
  if (grid < 1 || grid > cells) return (int)cudaErrorInvalidValue;
  int smem = 0;
  const int e = footprint_smem((const void*)microbench_d_kernel, y_lo, y_hi,
                               c_lo, c_hi, 2, &smem);
  if (e != 0) return e;
  microbench_d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      box, nbox, cells, y_lo, y_hi, c_lo, c_hi, out);
  return (int)cudaGetLastError();
}

// (d)'s persistent grid for a footprint: the blocks of (d) one SM holds at
// once (occupancy calculator, at (d)'s shared memory) times the SMs of the
// current device, into *grid. Returns a cudaError_t.
extern "C" int pais_microbench_d_grid(int y_lo, int y_hi, int c_lo, int c_hi,
                                      int* grid) {
  int smem = 0, per_sm = 0, dev = 0, sms = 0;
  int e = footprint_smem((const void*)microbench_d_kernel, y_lo, y_hi, c_lo,
                         c_hi, 2, &smem);
  if (e != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, microbench_d_kernel, kThreads, smem);
  if (e != 0) return e;
  e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return 0;
}

extern "C" const char* pais_microbench_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
