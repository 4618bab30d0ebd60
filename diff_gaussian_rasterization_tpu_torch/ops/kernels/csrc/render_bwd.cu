// Backward tile blend of the Gaussian rasterizer, and the per-Gaussian
// reduction of its gradient rows, for NVIDIA Hopper (sm_90a).
//
// render_bwd replaces the TPU kernel `_bwd_kernel` of the JAX package
// (diff_gaussian_rasterization_tpu/ops/kernels/render_pallas.py:717, driven
// by `core_bwd` there); segment_sum_rows replaces `_kernel` of
// diff_gaussian_rasterization_tpu/ops/kernels/segment_sum.py:43.
//
// What render_bwd computes.  The closed-form VJP of the forward blend
// (blend.blend_chunk_bwd of the JAX package, in the direct form).  One
// thread block per tile, as in the forward.  Each pixel walks its tile's
// segment of the sorted table feat[cap, 11] in the forward order, with the
// forward's own test (blend_common.cuh) so it ends at the same instance,
// carrying its transmittance T and pre, the running sum of w * s.  Per
// pixel, constants pix[t, 10, q] (blend.bwd_pixel_inputs): pixcot[6]
// (the cotangents that the features [r, g, b, d, d^2, 1] are dotted with),
// dL_dd, gt, tot_all, dL_dmed.  For each contributing (instance, pixel):
//   w = alpha T,  s = <[r, g, b, d, d^2, 1], pixcot>,  pre += w s
//   d_alpha = T s - (tot_all - pre) / (1 - alpha),   e = d_alpha G
// (the alpha cap is ignored in the gradient: dalpha/dpower = op G), and
// the instance sums over the tile's pixels
//   e, e dx, e dy, e dx^2, e dy^2, e dx dy        (dx = x - px)
//   w dL_dc[3], w dL_dd, w (d - gt) dL_dvar, cross dL_dmed
// finish into one row rows[i, 12] = d(x, y, A, B, C, opacity, r, g, b,
// depth, depth_var, depth_med):
//   d_xy = -op (A S_dx + B S_dy, C S_dy + B S_dx)
//   d_conic = (-op S_dxx / 2, -op S_dxy, -op S_dyy / 2),  d_opacity = S_e
//   d_depth_var = 2 S_var
// The depth-variance and median rows go to the pose-stopped depth copy
// (the caller adds them into column 10 of the feature gradient).
// want_med / want_var = 0 skip those sums and leave their columns zero.
//
// What bounds it on an H100.  The least work is the pair test and ~58 FP32
// operations per contributing pair, ~1.9 G at the bench scale, ~29 us at
// 67 TFLOP/s; the bytes (table, pixel constants, rows) are ~53 MB, ~16 us.
// So operations bound it: the pairs a kernel tests beyond the
// contributions, and the per-instance reductions, are its overhead.
//
// The design for this card:
// - Pixels.  256 threads a block, up to four pixels a thread (PPT).  Each
//   warp owns PPT compact 8x4 sub-patches (a 16x8 region of a 32x32 tile),
//   lane l pixel l of each; a tile that does not divide into 8x4 patches
//   falls back to pixel threadIdx.x + k * 256.  That map is
//   blend_common.cuh's patch_pixel, which the forward shares; render.py's
//   bwd_pixel_map mirrors it and render_bwd_pixel_map exports it for the
//   checks.
// - Exact culling.  A pair with alpha < alpha_min adds nothing to any row,
//   so skipping it leaves every row as it was.  Each staged instance's
//   blend_common.cuh cull_box is computed once a round; each warp takes
//   the round 32 instances at a time: every lane tests one instance's box
//   against the warp's PPT sub-patch boxes (the live pixels' bounding
//   boxes), one ballot picks the instances that meet any, and for those
//   only the sub-patches they meet run the per-pair test.
// - Stop at the last contributor.  The forward's n_contrib (segment-local,
//   1-based) is each pixel's walk limit: nothing after a pixel's last
//   contributor adds to any row.  A sub-patch drops out past its pixels'
//   largest limit, the block past the tile's.
// - Reduction.  For each instance that any lane of the warp touched (a
//   warp vote), the warp reduces its lanes' 12 sums with a reduce-scatter
//   butterfly (13 shuffles: 12 -> 6 -> 3 -> 2 -> 1 values a lane, then a
//   last exchange), and 12 lanes put the warp's partial row in shared
//   memory; a bit per (warp, instance) says which partials exist.  After
//   the round, one thread per instance adds the warps' partials in warp
//   order and writes the row.  The order is fixed, so the rows are
//   bit-reproducible without atomics; each instance lies in one tile, so
//   each row has one writer.  The wrapper zero-fills rows, so the
//   instances never reached (past the tile's walk, culled by the binning,
//   the budget's unused tail) keep zero rows.
// - Fused multiply-adds in the twelve per-instance sums only.  The walk's
//   decisions and T keep the forward's expressions, so the backward ends
//   every pixel where the forward did; w, s, the prefix and d_alpha keep
//   the rounding of the plain version's expressions, so that the suffix
//   tot_all - pre cancels as it does there (fused, the prefix drifts from
//   the forward's totals, and the card's gradients left the CPU path's
//   tolerance on a small scene).
// - Staging.  Rounds of kBatch instances through a two-stage ring with
//   cp.async: round r + 1 loads while round r is reduced; a feature row is
//   padded to 12 floats so the blend reads it as three 16-byte vectors.
// - Occupancy.  __launch_bounds__(kThreads, kMinBlocks): two blocks an SM
//   at 117 registers, no spill (the -Xptxas -v report, which
//   chip_smoke.py prints); three blocks spill and ran no faster.
// - pairs (optional, null on the main path): a variant of the kernel adds
//   the (instance, pixel) pairs it tested, for the report beside the bound.
//
// Numerics.  Built without --use_fast_math and with --fmad=false, like the
// forward; the plain version (core_bwd_reference) sums over pixels and
// prefixes in other orders, so the two agree to float32 rounding, and
// where the plain version's chunked cumprod crosses a threshold at another
// instance than the kernel's sequential product, on the rows of that tile.
//
// segment_sum_rows: out[p, c] = sum of rows[inv[j], c] over the pre-sort
// run j in [gauss_start[p], gauss_stop[p]), in order of j.  Bit-equal to
// the plain version's index_add_ on the CPU, which adds in the same order.
// Bound by bytes: each row, inv[j] and each run's bounds read once, each
// output row written once (17.8 MB at the bench scene, 5.3 us at
// 3.35 TB/s).  A loop of dependent loads (inv[j], then the row) per
// Gaussian is bound by latency instead, a warp of such loops by its
// longest run (48 entries at the bench scene, 2.3 on average), and its
// scattered reads of inv waste most of each sector.  So one warp takes
// 32 consecutive Gaussians, reads their bounds once, and walks the span of
// their (consecutive) runs 32 entries at a time with coalesced reads of
// inv: the loads of a chunk are all in flight together, and the next
// chunk's load while this one is summed; each lane then adds its own
// run's rows, parked in shared memory, in run order.  A run of length L
// costs ~L / 32 round trips.  A 12-float row is 48 bytes, so with a
// 16-byte aligned buffer every row is read, and every output row written,
// as three 16-byte vectors (F = 2, the per-Gaussian uncertainty sums, as
// one 8-byte vector); any other F, or unaligned buffers, take the plain
// loop of one thread per (Gaussian, column).

#include <climits>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kFeatPad;
using blend::kThreads;
using blend::Params;
using blend::pixels_per_thread;

constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;     // instances staged (and reduced) per round
constexpr int kPix = 10;       // per-pixel constant rows
constexpr int kRow = 12;       // gradient columns
constexpr int kMinBlocks = 2;  // resident blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// The warp's sums acc[12] reduced over its 32 lanes by a reduce-scatter
// butterfly: lane l ends with the warp's total of column bwd_column(l)
// (or of a zero pad when that is -1).
__device__ __forceinline__ int bwd_column(int lane) {
  const int idx = ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  if (idx == 3) return -1;
  return ((lane >> 4) & 1) * 6 + ((lane >> 3) & 1) * 3 + idx;
}

__device__ __forceinline__ float reduce_scatter12(const float (&acc)[kRow],
                                                  int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float a6[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float send = h16 ? acc[c] : acc[c + 6];
    const float keep = h16 ? acc[c + 6] : acc[c];
    a6[c] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float a3[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float send = h8 ? a6[c] : a6[c + 3];
    const float keep = h8 ? a6[c + 3] : a6[c];
    a3[c] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  // three values and a zero pad: the low half keeps {0, 1}, the high half
  // {2, pad}
  const float s0 = h4 ? a3[0] : a3[2];
  const float s1 = h4 ? a3[1] : 0.f;
  const float k0 = h4 ? a3[2] : a3[0];
  const float k1 = h4 ? 0.f : a3[1];
  const float a2_0 = k0 + __shfl_xor_sync(kFull, s0, 4);
  const float a2_1 = k1 + __shfl_xor_sync(kFull, s1, 4);
  const float send = h2 ? a2_0 : a2_1;
  const float keep = h2 ? a2_1 : a2_0;
  const float a1 = keep + __shfl_xor_sync(kFull, send, 2);
  return a1 + __shfl_xor_sync(kFull, a1, 1);
}

template <int PPT, bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_bwd_kernel(const float* __restrict__ feat,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ pix,
                  const int* __restrict__ n_contrib, long long ncon_stride,
                  float* __restrict__ rows, Params prm, int want_med,
                  int want_var, unsigned long long* __restrict__ pairs) {
  __shared__ __align__(16) float s_feat[2][kBatch * kFeatPad];
  __shared__ float4 s_box[kBatch];
  __shared__ float s_part[kWarps][kBatch][kRow];
  __shared__ unsigned s_touch[kWarps][kBatch / 32];
  __shared__ float4 s_pbox[kWarps][PPT];  // live pixels' box of a sub-patch
  __shared__ int s_plim[kWarps][PPT];     // largest walk limit there
  __shared__ int s_wlim[kWarps];

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int seg = tile_stop[t] - start;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tg = prm.tile0 + t;  // the tile's index in the image
  const int tx0 = (tg % prm.tiles_x) * prm.tile_w;
  const int ty0 = (tg / prm.tiles_x) * prm.tile_h;

  // per pixel: its walk limit (segment-local; 0: no pixel, or the pixel
  // has ended), position, transmittance, prefix and constants
  int lim[PPT];
  float px[PPT], py[PPT], T[PPT], pre[PPT];
  float pc0[PPT], pc1[PPT], pc2[PPT], pc3[PPT], pc4[PPT], pc5[PPT];
  float dLdd[PPT], gt[PPT], tot[PPT], dLdmed[PPT];
  int wlim = 0;
  unsigned long long tested = 0;

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int qi = blend::patch_pixel<PPT>(prm.tile_w, prm.tile_h, warp,
                                           lane, k);
    const int pxi = tx0 + qi % prm.tile_w;
    const int pyi = ty0 + qi / prm.tile_w;
    const bool live = qi < q && pxi < prm.width && pyi < prm.height;
    lim[k] = 0;
    if (live) {
      lim[k] = min(n_contrib[(size_t)t * ncon_stride + qi], seg);
    }
    px[k] = (float)pxi;
    py[k] = (float)pyi;
    T[k] = 1.f;
    pre[k] = 0.f;
    const float* pp = pix + (size_t)t * kPix * q + (qi < q ? qi : 0);
    pc0[k] = pp[0 * q];
    pc1[k] = pp[1 * q];
    pc2[k] = pp[2 * q];
    pc3[k] = pp[3 * q];
    pc4[k] = pp[4 * q];
    pc5[k] = pp[5 * q];
    dLdd[k] = pp[6 * q];
    gt[k] = pp[7 * q];
    tot[k] = pp[8 * q];
    dLdmed[k] = pp[9 * q];
    // the sub-patch's box over the pixels that walk at all
    const bool walks = lim[k] > 0;
    const int x0 = __reduce_min_sync(kFull, walks ? pxi : INT_MAX);
    const int x1 = __reduce_max_sync(kFull, walks ? pxi : INT_MIN);
    const int y0 = __reduce_min_sync(kFull, walks ? pyi : INT_MAX);
    const int y1 = __reduce_max_sync(kFull, walks ? pyi : INT_MIN);
    const int plim = __reduce_max_sync(kFull, lim[k]);
    if (lane == 0) {
      s_pbox[warp][k] = make_float4((float)x0, (float)x1, (float)y0,
                                    (float)y1);
      s_plim[warp][k] = plim;
    }
    wlim = max(wlim, plim);
  }
  if (lane == 0) s_wlim[warp] = wlim;
  __syncthreads();
  int tile_lim = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_lim = max(tile_lim, s_wlim[w]);
  const int end = start + tile_lim;  // the block walks [start, end)

  if (start < end) {
    blend::stage_features(s_feat[0], feat, start, min(kBatch, end - start));
  }
  int stage = 0;
  for (int b0 = start; b0 < end; b0 += kBatch, stage ^= 1) {
    // this round's copies have landed (for this thread's part of them);
    // the barrier makes all parts visible and orders the last round's
    // reads of the other stage, s_box, s_part and s_touch before the
    // writes below
    __pipeline_wait_prior(0);
    __syncthreads();
    const int n = min(kBatch, end - b0);
    if (b0 + kBatch < end) {
      blend::stage_features(s_feat[stage ^ 1], feat, b0 + kBatch,
                            min(kBatch, end - b0 - kBatch));
    }
    const float* sf = s_feat[stage];
    if (threadIdx.x < n) {
      s_box[threadIdx.x] = blend::cull_box(sf + threadIdx.x * kFeatPad,
                                           prm.alpha_min);
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += 32) {
      // which of the warp's sub-patches instance j0 + lane meets, among
      // those that still walk at its position
      unsigned meets = 0;
      if (j0 + lane < n) {
        const float4 b = s_box[j0 + lane];
        const int loc = b0 - start + j0 + lane;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float4 pb = s_pbox[warp][k];
          if (loc < s_plim[warp][k] && blend::box_meets(b, pb.x, pb.y, pb.z,
                                                        pb.w)) {
            meets |= 1u << k;
          }
        }
      }
      unsigned todo = __ballot_sync(kFull, meets != 0);
      unsigned touched_bits = 0;
      while (todo) {
        const int jj = __ffs(todo) - 1;
        todo &= todo - 1;
        const unsigned mj = __shfl_sync(kFull, meets, jj);
        const int j = j0 + jj;
        const int loc = b0 - start + j;
        const float4* f4 = reinterpret_cast<const float4*>(sf + j * kFeatPad);
        const float4 fa = f4[0];  // x, y, A, B
        const float4 fb = f4[1];  // C, opacity, r, g
        const float4 fc = f4[2];  // b, depth, depth_sgview, (pad)
        const blend::Splat g{fa.x, fa.y, fa.z, fa.w, fb.x, fb.y};
        const float cr = fb.z, cg = fb.w, cb = fc.x, d = fc.y;
        const float d2 = d * d;
        float acc[kRow];
#pragma unroll
        for (int c = 0; c < kRow; ++c) acc[c] = 0.f;
        int touched = 0;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!((mj >> k) & 1u)) continue;  // the same for the whole warp
          if (loc >= lim[k]) continue;
          if constexpr (kCount) ++tested;
          const float dx = g.x - px[k];
          const float dy = g.y - py[k];
          const float power = blend::splat_power(g, dx, dy);
          if (power > 0.f) continue;
          const float G = expf(power);
          const float alpha = blend::splat_alpha(g, G, prm);
          if (alpha < prm.alpha_min) continue;
          const float test_T = T[k] * (1.f - alpha);
          if (test_T < prm.t_terminate) {
            lim[k] = 0;
            continue;
          }
          // w, s, the prefix and d_alpha in the forward's rounding (the
          // suffix tot_all - pre then cancels as the forward's totals do);
          // only the twelve per-instance terms in fused multiply-adds
          // (__fmaf_rn stays an FFMA under --fmad=false)
          const float w = alpha * T[k];
          const float s = cr * pc0[k] + cg * pc1[k] + cb * pc2[k] +
                          d * pc3[k] + d2 * pc4[k] + pc5[k];
          pre[k] += w * s;
          const float d_alpha =
              T[k] * s - (tot[k] - pre[k]) * (1.f / (1.f - alpha));
          const float e = d_alpha * G;
          const float edx = e * dx, edy = e * dy;
          acc[0] += e;
          acc[1] += edx;
          acc[2] += edy;
          acc[3] = __fmaf_rn(edx, dx, acc[3]);
          acc[4] = __fmaf_rn(edy, dy, acc[4]);
          acc[5] = __fmaf_rn(edx, dy, acc[5]);
          acc[6] = __fmaf_rn(w, pc0[k], acc[6]);
          acc[7] = __fmaf_rn(w, pc1[k], acc[7]);
          acc[8] = __fmaf_rn(w, pc2[k], acc[8]);
          acc[9] = __fmaf_rn(w, dLdd[k], acc[9]);
          if (want_var) acc[10] = __fmaf_rn(w * (d - gt[k]), pc4[k], acc[10]);
          if (want_med && T[k] > 0.5f && test_T < 0.5f) acc[11] += dLdmed[k];
          T[k] = test_T;
          touched = 1;
        }
        // a warp none of whose pixels contributed has all-zero partials
        // and leaves no partial row
        if (__any_sync(kFull, touched)) {
          const float v = reduce_scatter12(acc, lane);
          const int c = bwd_column(lane);
          if (c >= 0 && (lane & 1) == 0) s_part[warp][j][c] = v;
          touched_bits |= 1u << jj;
        }
      }
      if (lane == 0) s_touch[warp][j0 >> 5] = touched_bits;
    }
    __syncthreads();

    if (threadIdx.x < n) {
      const int j = threadIdx.x;
      float sum[kRow];
#pragma unroll
      for (int c = 0; c < kRow; ++c) sum[c] = 0.f;
      for (int w = 0; w < kWarps; ++w) {  // in warp order
        if (!((s_touch[w][j >> 5] >> (j & 31)) & 1u)) continue;
#pragma unroll
        for (int c = 0; c < kRow; ++c) sum[c] += s_part[w][j][c];
      }
      const float* f = sf + j * kFeatPad;
      const float A = f[2], B = f[3], C = f[4], op = f[5];
      float4* r = reinterpret_cast<float4*>(rows + (size_t)(b0 + j) * kRow);
      r[0] = make_float4(-op * (A * sum[1] + B * sum[2]),
                         -op * (C * sum[2] + B * sum[1]), -0.5f * op * sum[3],
                         -op * sum[5]);
      r[1] = make_float4(-0.5f * op * sum[4], sum[0], sum[6], sum[7]);
      r[2] = make_float4(sum[8], sum[9], 2.f * sum[10], sum[11]);
    }
  }

  if constexpr (kCount) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tested += __shfl_down_sync(kFull, tested, off);
    if (lane == 0 && tested != 0) atomicAdd(pairs, tested);
  }
}

template <int PPT>
cudaError_t launch_bwd(int n_tiles, cudaStream_t s, const float* feat,
                       const int* tile_start, const int* tile_stop,
                       const float* pix, const int* n_contrib,
                       long long ncon_stride, float* rows, const Params& prm,
                       int want_med, int want_var,
                       unsigned long long* pairs) {
  if (pairs != nullptr) {
    render_bwd_kernel<PPT, true><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, pix, n_contrib, ncon_stride, rows, prm,
        want_med, want_var, pairs);
  } else {
    render_bwd_kernel<PPT, false><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, pix, n_contrib, ncon_stride, rows, prm,
        want_med, want_var, pairs);
  }
  return cudaGetLastError();
}

template <int PPT>
__global__ void pixel_map_kernel(int tile_w, int tile_h, int* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    out[threadIdx.x * PPT + k] =
        blend::patch_pixel<PPT>(tile_w, tile_h, warp, lane, k);
}

constexpr int kSumWarps = 8;  // warps a block, 32 Gaussians each

// Row i of a [*, F] buffer (zeros for i < 0) into registers: 16-byte loads
// when F is a multiple of 4, else 8-byte ones (the caller checked the
// alignment).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ rows,
                                         int i, float (&v)[F]) {
  static_assert(F % 2 == 0, "rows of an even number of floats");
  if (i < 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = 0.f;
    return;
  }
  const float* r = rows + (size_t)i * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int c = 0; c < F; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(r + c));
      v[c] = x.x;
      v[c + 1] = x.y;
      v[c + 2] = x.z;
      v[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < F; c += 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(r + c));
      v[c] = x.x;
      v[c + 1] = x.y;
    }
  }
}

// Store F floats at dst (aligned as load_row's source), as vectors.
template <int F>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int c = 0; c < F; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < F; c += 2)
      *reinterpret_cast<float2*>(dst + c) = make_float2(v[c], v[c + 1]);
  }
}

// One warp per 32 consecutive Gaussians.  Their runs are consecutive in
// the pre-sort order, so the warp walks the span [lo, hi) of its lanes'
// runs 32 entries at a time: each lane loads one inv[j] and that row into
// registers, parks the row in the warp's slice of shared memory, and every
// lane adds, in order, the parked rows that belong to its own run.  The
// next chunk's rows (and the chunk after's indices) load while the
// current one is summed.
template <int F>
__global__ void __launch_bounds__(kSumWarps * 32)
segment_sum_rows_kernel(const float* __restrict__ rows,
                        const int* __restrict__ inv,
                        const int* __restrict__ gauss_start,
                        const int* __restrict__ gauss_stop,
                        float* __restrict__ out, int p) {
  __shared__ __align__(16) float s_rows[kSumWarps][32 * F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = (blockIdx.x * kSumWarps + warp) * 32 + lane;
  int start = 0, stop = 0;
  if (g < p) {
    start = gauss_start[g];
    stop = gauss_stop[g];
  }
  const bool some = start < stop;
  const int lo = __reduce_min_sync(kFull, some ? start : INT_MAX);
  const int hi = __reduce_max_sync(kFull, some ? stop : INT_MIN);
  float* parked = s_rows[warp];
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.f;
  if (lo < hi) {
    float v[F];
    load_row<F>(rows, lo + lane < hi ? __ldg(inv + lo + lane) : -1, v);
    int next = lo + 32 + lane < hi ? __ldg(inv + lo + 32 + lane) : -1;
    for (int j0 = lo; j0 < hi; j0 += 32) {
      store_row<F>(parked + lane * F, v);
      __syncwarp();
      if (j0 + 32 < hi) {
        load_row<F>(rows, next, v);
        next = j0 + 64 + lane < hi ? __ldg(inv + j0 + 64 + lane) : -1;
      }
      const int u1 = min(stop - j0, 32);
      for (int u = max(start - j0, 0); u < u1; ++u) {
#pragma unroll
        for (int c = 0; c < F; ++c) acc[c] += parked[u * F + c];
      }
      __syncwarp();
    }
  }
  if (g < p) store_row<F>(out + (size_t)g * F, acc);
}

// Any other F: one thread per (Gaussian, column), in run order.
__global__ void segment_sum_rows_any_kernel(const float* __restrict__ rows,
                                            const int* __restrict__ inv,
                                            const int* __restrict__ gauss_start,
                                            const int* __restrict__ gauss_stop,
                                            float* __restrict__ out, int p,
                                            int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p * f) return;
  const int g = (int)(i / f);
  const int c = (int)(i % f);
  float acc = 0.f;
  for (int j = gauss_start[g]; j < gauss_stop[g]; ++j)
    acc += rows[(size_t)inv[j] * f + c];
  out[i] = acc;
}

template <int F>
void launch_rows(const float* rows, const int* inv, const int* gauss_start,
                 const int* gauss_stop, float* out, int p, cudaStream_t s) {
  constexpr int per_block = kSumWarps * 32;
  segment_sum_rows_kernel<F><<<(p + per_block - 1) / per_block, per_block,
                               0, s>>>(rows, inv, gauss_start, gauss_stop,
                                       out, p);
}

}  // namespace

// rows [cap, 12] (zero-filled by the caller, 16-byte aligned) of the
// backward blend.  n_contrib, each pixel's walk limit, is the forward's
// [T, *] int32 with tile stride ncon_stride and pixel stride 1; pairs may
// be null.
extern "C" int render_bwd(const float* feat, const int* tile_start,
                          const int* tile_stop, const float* pix,
                          const int* n_contrib, long long ncon_stride,
                          float* rows, int n_tiles, int tiles_x, int tile0,
                          int tile_w, int tile_h, int width, int height,
                          float alpha_cap,
                          float alpha_min, float t_terminate, int want_med,
                          int want_var, unsigned long long* pairs,
                          void* stream) {
  const Params prm{tiles_x, tile_w, tile_h, width, height,
                   alpha_cap, alpha_min, t_terminate, tile0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return 0;
  switch (pixels_per_thread(tile_w * tile_h)) {
    case 1:
      return static_cast<int>(launch_bwd<1>(
          n_tiles, s, feat, tile_start, tile_stop, pix, n_contrib,
          ncon_stride, rows, prm, want_med, want_var, pairs));
    case 2:
      return static_cast<int>(launch_bwd<2>(
          n_tiles, s, feat, tile_start, tile_stop, pix, n_contrib,
          ncon_stride, rows, prm, want_med, want_var, pairs));
    case 4:
      return static_cast<int>(launch_bwd<4>(
          n_tiles, s, feat, tile_start, tile_stop, pix, n_contrib,
          ncon_stride, rows, prm, want_med, want_var, pairs));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[thread * ppt + k] = the tile pixel k of each of the kThreads threads
// of render_bwd and render_fwd (blend_common.cuh's patch_pixel; tile_w *
// tile_h where it has none); ppt is 1, 2 or 4 as the tile's size gives it.
extern "C" int render_bwd_pixel_map(int tile_w, int tile_h, int* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pixels_per_thread(tile_w * tile_h)) {
    case 1: pixel_map_kernel<1><<<1, kThreads, 0, s>>>(tile_w, tile_h, out);
      break;
    case 2: pixel_map_kernel<2><<<1, kThreads, 0, s>>>(tile_w, tile_h, out);
      break;
    case 4: pixel_map_kernel<4><<<1, kThreads, 0, s>>>(tile_w, tile_h, out);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum_rows(const float* rows, const int* inv,
                                const int* gauss_start, const int* gauss_stop,
                                float* out, int p, int f, void* stream) {
  if (p <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  if (f == 12 && (at & 15) == 0) {
    launch_rows<12>(rows, inv, gauss_start, gauss_stop, out, p, s);
  } else if (f == 2 && (at & 7) == 0) {
    launch_rows<2>(rows, inv, gauss_start, gauss_stop, out, p, s);
  } else {
    const int threads = 256;
    const long long total = (long long)p * f;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    segment_sum_rows_any_kernel<<<blocks, threads, 0, s>>>(
        rows, inv, gauss_start, gauss_stop, out, p, f);
  }
  return static_cast<int>(cudaGetLastError());
}
