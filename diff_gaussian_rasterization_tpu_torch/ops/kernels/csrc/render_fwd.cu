// Forward tile blend of the Gaussian rasterizer, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (diff_gaussian_rasterization_tpu/ops/kernels/render_pallas.py:157, driven
// by `core_fwd` there), and, in `tile_scatter_sum` below, the scatter of the
// per-pixel median-crossing statistics that follows it (render_pallas.py:390).
//
// What render_fwd computes.  One thread block per image tile.  The tile's
// instances are a contiguous, depth-sorted segment [tile_start, tile_stop)
// of the sorted feature table feat[cap, 11] = (x, y, A, B, C, opacity, r,
// g, b, depth, depth_sgview).  Each pixel walks the segment front to back:
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy;    skip if power > 0
//   alpha = min(alpha_cap, opacity * exp(power)); skip if alpha < alpha_min
//   stop before accumulating once T * (1 - alpha) < t_terminate
// and accumulates color, depth, weight, the raw depth moments of the
// variance, the median depth and moments at the T = 0.5 crossing.  Outputs
// per pixel: out_f[t, 9, q] = color[3], depth, weight, median, var,
// t_final, ucross and out_i[t, 3, q] = n_contrib (segment-local, 1-based),
// n_valid, midx (global position in the sorted stream, or -1).  Pixels past
// the image edge keep the initial state.
//
// What bounds it on an H100.  The least work is the pairs that contribute
// (a pair below alpha_min changes nothing, and an exact test can skip it):
// the pair test (~24 FP32 operations, the expf counted as 8) and ~20 for
// the sums, ~1.0 G operations for the bench scene's 23.6 M contributions
// (1200x680, 100k Gaussians, ~234k instances), ~16 us at 67 TFLOP/s; the
// features, ground truth and outputs are ~53.5 MB, ~16 us at 3.35 TB/s.
// A walk without culling tests every pair up to each pixel's termination,
// 93.0 M there, four times the contributions: those tests, and the shared
// memory reads that feed them, are the kernel's overhead.
//
// The design for this card:
// - Pixels.  256 threads a block, up to four pixels a thread (PPT) in
//   registers, on blend_common.cuh's patch_pixel, the map render_bwd uses:
//   a warp owns PPT compact 8x4 sub-patches (a 16x8 region of a 32x32
//   tile), lane l pixel l of each; a tile that does not divide into 8x4
//   patches falls back to pixel threadIdx.x + k * 256.  Each staged
//   instance read from shared memory serves a thread's PPT pixels.
// - Exact culling per sub-patch.  After a round lands, each instance's
//   cull_box (blend_common.cuh) is computed once, and each warp rebuilds
//   its sub-patches' boxes from their live pixels: a pixel that has
//   terminated, or lies past the image, pulls in no instance, and a
//   sub-patch with no live pixel meets none.  The warp takes the round 32
//   instances at a time: each lane tests one instance's box against the
//   sub-patch boxes, one ballot picks the instances that meet any, and for
//   those only the sub-patches they meet run the per-pair test, in segment
//   order.  A pair outside the box has alpha < alpha_min, which the blend
//   skips too, so every output is what the whole walk gives, n_contrib
//   included.
// - Staging.  Rounds of kBatch instances through a two-stage ring with
//   cp.async: round r + 1 loads while round r blends; a feature row is
//   padded to 12 floats and read as three 16-byte vectors.  One block-wide
//   vote a round (__syncthreads_count) ends the tile once every pixel has
//   terminated; that barrier also orders the last round's shared reads
//   before the copies into that stage.
// - Occupancy.  __launch_bounds__(kThreads, kMinBlocks): three blocks an
//   SM at 78 registers, no spill (the -Xptxas -v report, which
//   chip_smoke.py prints).  To fit, a pixel keeps in registers only what
//   the blend updates: the median crossing, which happens at most once a
//   pixel (T only falls), leaves its instance and weight in shared memory,
//   and the median depth and the crossing's moments are read back from
//   that instance's row at the end, with the blend's own expressions.
// - pairs (optional, null on the main path): a variant of the kernel adds
//   the (instance, pixel) pairs it tested, for the report beside the bound.
// - The basis form of the exponent (cfg.splat_basis_power; the TPU kernel's
//   `basis` path, render_pallas.py:193-200): a compile-time variant
//   (kBasis).  A warp makes an instance's six coefficients about the
//   tile's corner once, when it takes the instance (one per jj of its
//   `todo` loop); each pixel's five basis terms (tile-local coordinates,
//   exact integers in float32, and their products) are made once and held
//   in registers in place of its position, so a pair's exponent is five
//   products and five sums; the culling boxes are the basis form's,
//   widened for its rounding (blend_common.cuh).  The default
//   instantiation (kBasis false) is the direct form, unchanged.
//
// The per-pair test's expressions live in blend_common.cuh, shared with
// render_bwd and render_jvp, so every pass makes the same decisions bit for
// bit; render_jvp's primal takes the same sums in the same order (the
// crossing's inside its loop: sums of one term), so its primal outputs are
// bit-equal to these.
//
// Numerics.  Built without --use_fast_math and with --fmad=false, so each
// operation rounds as the plain PyTorch version's elementwise ops do; the
// sequential T *= (1 - alpha) still rounds differently from the plain
// version's chunked cumprod, so pixels exactly on the t_terminate or 0.5
// thresholds may flip.
//
// tile_scatter_sum: the per-instance median-crossing statistics,
//   u_inst[i] = sum of ucross over the pixels whose midx is i,
//   npix_inst[i] = the number of those pixels,
// each sum taken in ascending pixel order (the order of index_add_ on the
// CPU, so the two are bit-equal), and 0 for every instance no pixel names.
// midx is global in the sorted stream but always lies in the pixel's own
// tile segment [tile_start[t], tile_stop[t]) (a midx outside it is
// dropped; the forward never writes one), so each tile reduces on its own,
// with no global sort, one block per tile (256 threads, four pixels each,
// for a 32x32 tile).  A tile's median crossings mostly belong to a few
// large front splats (5,980 named instances for the bench scene's 816,000
// crossing pixels in 836 tiles), so a block sums them in passes of up to
// kFew = 32 instances: a pass takes out the next distinct instances its
// pixels name in increasing order, one block-wide minimum a round, then a
// counting sort puts those pixels' values into one bucket per instance, in
// pixel order within each (warp-level ranks by __match_any_sync, a block
// scan of the per-chunk counts), and one thread per instance sums its
// bucket.  A run of L pixels costs L dependent adds, from loads that do
// not wait on one another.  No float atomics.  A tile naming D distinct
// instances takes D + ceil(D / 32) rounds (one barrier each) and
// ceil(D / 32) counting sorts of its pixels, D <= the tile's pixels; at
// the bench scene and the 500k mapping step no tile names more than 24
// (one pass).  Bound by bytes: midx and ucross read once, the two outputs
// written once (~8.9 MB at the bench scene, ~2.7 us at 3.35 TB/s); the
// rounds, the counting sort and the longest run's chain of adds are the
// kernel's overhead.  The caller zero-fills the outputs; a block writes
// only the instances its pixels name.

#include <climits>

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kFeatPad;
using blend::kThreads;
using blend::Params;
using blend::pixels_per_thread;

constexpr unsigned kAll = 0xffffffffu;
// instances staged per round, one culling box per thread (on an H100, 128
// took 3% longer at the bench scene and 1% less at the 500k map step's
// render, 64 9% and 2% longer)
constexpr int kBatch = 256;
static_assert(kBatch <= kThreads, "a thread computes a staged row's box");
constexpr int kWarps = kThreads / 32;
// resident blocks an SM: 78 registers a thread, no spill (two blocks, at
// 112 registers, took 18% longer at the bench scene on an H100)
// The basis instantiation keeps three blocks: at 80 registers it spills
// (56 bytes of stores).  Before its basis terms were held per pixel it
// spilled 88 and still took 7-8% less time than a copy bounded to two
// blocks (117 registers, no spill; ab_render_fwd.py --basis, at the bench
// scene and the 500k map step's render, on an H100).
constexpr int kMinBlocks = 3;

template <int PPT, bool kCount, bool kBasis>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_fwd_kernel(const float* __restrict__ feat,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ gt,
                  float* __restrict__ out_f, int* __restrict__ out_i,
                  Params prm, unsigned long long* __restrict__ pairs) {
  __shared__ __align__(16) float s_feat[2][kBatch * kFeatPad];
  __shared__ float4 s_box[kBatch];
  __shared__ float4 s_pbox[kWarps][PPT];  // live pixels' box of a sub-patch
  // per pixel, the instance and weight w of its median crossing, set at
  // most once (T only falls): kept out of the registers the blend needs
  __shared__ int s_midx[PPT][kThreads];
  __shared__ float s_wx[PPT][kThreads];

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tg = prm.tile0 + t;  // the tile's index in the image
  const int tx0 = (tg % prm.tiles_x) * prm.tile_w;
  const int ty0 = (tg / prm.tiles_x) * prm.tile_h;
  // the basis form's origin: the tile's corner
  const float ox = (float)tx0, oy = (float)ty0;

  // per pixel its position and blend state; bit k of `live`: pixel k lies
  // in the tile and the image and has not terminated.  dep is also the
  // variance's first moment (the sum of d w, the same sum).  The median
  // depth and the crossing's moments are read back from the crossing
  // instance's row at the end.  The basis form keeps the pixel's basis
  // terms in place of its position (px = ox + qx exactly).
  float px[PPT], py[PPT], T[PPT];
  [[maybe_unused]] blend::PixelBasis pq[PPT];
  float c0[PPT], c1[PPT], c2[PPT], dep[PPT], wgt[PPT], vdd[PPT];
  int ncon[PPT], nval[PPT];
  unsigned live = 0;
  unsigned tested = 0;

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int qi = blend::patch_pixel<PPT>(prm.tile_w, prm.tile_h, warp,
                                           lane, k);
    const int pxi = tx0 + qi % prm.tile_w;
    const int pyi = ty0 + qi / prm.tile_w;
    if (qi < q && pxi < prm.width && pyi < prm.height) live |= 1u << k;
    if constexpr (kBasis) {
      pq[k] = blend::pixel_basis((float)pxi, (float)pyi, ox, oy);
    } else {
      px[k] = (float)pxi;
      py[k] = (float)pyi;
    }
    T[k] = 1.f;
    c0[k] = c1[k] = c2[k] = dep[k] = wgt[k] = vdd[k] = 0.f;
    ncon[k] = nval[k] = 0;
    s_midx[k][threadIdx.x] = -1;
    s_wx[k][threadIdx.x] = 0.f;
  }

  if (start < stop) {
    blend::stage_features(s_feat[0], feat, start, min(kBatch, stop - start));
  }
  int stage = 0;
  for (int b0 = start; b0 < stop; b0 += kBatch, stage ^= 1) {
    // this round's copies have landed (for this thread's part of them);
    // the barrier makes all parts visible, orders every warp's reads of the
    // other stage, s_box and s_pbox in the last round before the writes
    // below, and ends the tile once no pixel is live
    __pipeline_wait_prior(0);
    if (__syncthreads_count(live != 0) == 0) break;
    const int n = min(kBatch, stop - b0);
    if (b0 + kBatch < stop) {
      blend::stage_features(s_feat[stage ^ 1], feat, b0 + kBatch,
                            min(kBatch, stop - b0 - kBatch));
    }
    const float* sf = s_feat[stage];
    if (threadIdx.x < n) {
      if constexpr (kBasis) {
        s_box[threadIdx.x] = blend::cull_box_of<true>(
            sf + threadIdx.x * kFeatPad, prm.alpha_min, ox, oy,
            (float)(prm.tile_w - 1), (float)(prm.tile_h - 1));
      } else {
        s_box[threadIdx.x] = blend::cull_box(sf + threadIdx.x * kFeatPad,
                                             prm.alpha_min);
      }
    }
    // the warp's sub-patch boxes over their live pixels; bit k of wlive
    // (the same on every lane): sub-patch k has one
    unsigned wlive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const bool on = (live >> k) & 1u;
      int xi, yi;
      if constexpr (kBasis) {
        xi = tx0 + (int)pq[k].qx;
        yi = ty0 + (int)pq[k].qy;
      } else {
        xi = (int)px[k];
        yi = (int)py[k];
      }
      const int x0 = __reduce_min_sync(kAll, on ? xi : INT_MAX);
      const int x1 = __reduce_max_sync(kAll, on ? xi : INT_MIN);
      const int y0 = __reduce_min_sync(kAll, on ? yi : INT_MAX);
      const int y1 = __reduce_max_sync(kAll, on ? yi : INT_MIN);
      if (x0 <= x1) wlive |= 1u << k;
      if (lane == 0) {
        s_pbox[warp][k] = make_float4((float)x0, (float)x1, (float)y0,
                                      (float)y1);
      }
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += 32) {
      if (!__any_sync(kAll, live != 0)) break;
      // which of the warp's live sub-patches instance j0 + lane meets
      unsigned meets = 0;
      if (j0 + lane < n) {
        const float4 b = s_box[j0 + lane];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!((wlive >> k) & 1u)) continue;
          const float4 pb = s_pbox[warp][k];
          if (blend::box_meets(b, pb.x, pb.y, pb.z, pb.w)) meets |= 1u << k;
        }
      }
      unsigned todo = __ballot_sync(kAll, meets != 0);
      while (todo) {
        const int jj = __ffs(todo) - 1;
        todo &= todo - 1;
        const unsigned mj = __shfl_sync(kAll, meets, jj);
        const int j = j0 + jj;
        const float4* f4 = reinterpret_cast<const float4*>(sf + j * kFeatPad);
        const float4 fa = f4[0];  // x, y, A, B
        const float4 fb = f4[1];  // C, opacity, r, g
        const blend::Splat g{fa.x, fa.y, fa.z, fa.w, fb.x, fb.y};
        [[maybe_unused]] blend::Basis cb{};
        if constexpr (kBasis) cb = blend::splat_basis(g, ox, oy);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!((mj >> k) & 1u)) continue;  // the same for the whole warp
          if constexpr (kCount) tested += (live >> k) & 1u;
          if (!((live >> k) & 1u)) continue;
          float power;
          if constexpr (kBasis) {
            power = blend::splat_power_basis(cb, pq[k]);
          } else {
            const float dx = g.x - px[k];
            const float dy = g.y - py[k];
            power = blend::splat_power(g, dx, dy);
          }
          if (power > 0.f) continue;
          const float G = expf(power);
          const float alpha = blend::splat_alpha(g, G, prm);
          if (alpha < prm.alpha_min) continue;
          const float test_T = T[k] * (1.f - alpha);
          if (test_T < prm.t_terminate) {
            live &= ~(1u << k);
            continue;
          }
          const float4 fc = f4[2];  // b, depth, depth_sgview, (pad)
          const float w = alpha * T[k];
          const float d = fc.y;
          const float d2 = d * d;
          c0[k] += fb.z * w;
          c1[k] += fb.w * w;
          c2[k] += fc.x * w;
          dep[k] += d * w;
          wgt[k] += w;
          vdd[k] += d2 * w;
          if (T[k] > 0.5f && test_T < 0.5f) {
            s_midx[k][threadIdx.x] = b0 + j;
            s_wx[k][threadIdx.x] = w;
          }
          T[k] = test_T;
          ncon[k] = b0 - start + j + 1;
          nval[k] += 1;
        }
      }
    }
  }

  if constexpr (kCount) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tested += __shfl_down_sync(kAll, tested, off);
    if (lane == 0 && tested != 0) {
      atomicAdd(pairs, (unsigned long long)tested);
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int qi = blend::patch_pixel<PPT>(prm.tile_w, prm.tile_h, warp,
                                           lane, k);
    if (qi >= q) continue;
    // the crossing's sums, one term each, as the blend would take them
    const int mi = s_midx[k][threadIdx.x];
    float med = 0.f, udd = 0.f, ud = 0.f, uw = 0.f;
    if (mi >= 0) {
      const float* f = feat + (size_t)mi * kFeat;
      const float d = f[9], w = s_wx[k][threadIdx.x];
      const float d2 = d * d;
      med = f[10];
      udd += d2 * w;
      ud += d * w;
      uw += w;
    }
    const float g = gt[(size_t)t * q + qi];
    float* of = out_f + (size_t)t * 9 * q + qi;
    int* oi = out_i + (size_t)t * 3 * q + qi;
    of[0 * q] = c0[k];
    of[1 * q] = c1[k];
    of[2 * q] = c2[k];
    of[3 * q] = dep[k];
    of[4 * q] = wgt[k];
    of[5 * q] = med;
    of[6 * q] = vdd[k] - 2.f * g * dep[k] + g * g * wgt[k];
    of[7 * q] = T[k];
    of[8 * q] = udd - 2.f * g * ud + g * g * uw;
    oi[0 * q] = ncon[k];
    oi[1 * q] = nval[k];
    oi[2 * q] = mi;
  }
}

template <int PPT, bool kBasis>
cudaError_t launch_fwd_form(int n_tiles, cudaStream_t s, const float* feat,
                            const int* tile_start, const int* tile_stop,
                            const float* gt, float* out_f, int* out_i,
                            const Params& prm, unsigned long long* pairs) {
  if (pairs != nullptr) {
    render_fwd_kernel<PPT, true, kBasis><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, gt, out_f, out_i, prm, pairs);
  } else {
    render_fwd_kernel<PPT, false, kBasis><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, gt, out_f, out_i, prm, pairs);
  }
  return cudaGetLastError();
}

template <int PPT>
cudaError_t launch_fwd(int n_tiles, cudaStream_t s, const float* feat,
                       const int* tile_start, const int* tile_stop,
                       const float* gt, float* out_f, int* out_i,
                       const Params& prm, int basis,
                       unsigned long long* pairs) {
  if (basis) {
    return launch_fwd_form<PPT, true>(n_tiles, s, feat, tile_start,
                                      tile_stop, gt, out_f, out_i, prm,
                                      pairs);
  }
  return launch_fwd_form<PPT, false>(n_tiles, s, feat, tile_start, tile_stop,
                                     gt, out_f, out_i, prm, pairs);
}

constexpr int kFew = 32;  // distinct instances a pass sums
constexpr int E = 4;      // pixels a thread

// One block per tile, T threads: element e = threadIdx.x + m * T of the
// n = E * T pixels is this thread's m-th.  __launch_bounds__(256, 8):
// 32 registers (12 bytes spill), eight blocks an SM, so that a
// 32x32-tiled frame's 836 tiles are resident at once (unbounded, fewer
// blocks an SM ran slower).
__global__ void __launch_bounds__(256, 8)
tile_scatter_sum_kernel(const int* __restrict__ midx, long long midx_stride,
                        const float* __restrict__ ucross,
                        long long ucross_stride,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_stop, int q,
                        float* __restrict__ u_inst,
                        int* __restrict__ npix_inst) {
  extern __shared__ float smem[];
  __shared__ int s_wmin[2][256 / 32];
  __shared__ int s_few[kFew];
  __shared__ int s_wsum[256 / 32];
  const int T = blockDim.x;
  const int n = E * T;  // a power of two >= q, at least 128
  float* s_val = smem;          // [n], by pixel
  float* s_sorted = s_val + n;  // [n], by bucket, in pixel order in each
  // per-(bucket, chunk) counts, then their offsets: kFew x n / 32 = n
  int* s_cnt = reinterpret_cast<int*>(s_sorted + n);
  static_assert(kFew == 32, "kFew x (n / 32) counts, E a thread");
  const int nch = n / 32;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int stop = tile_stop[t];

  // each pixel's instance, local to the segment (-1: none)
  int loc[E];
  int named = 0;
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = i + m * T;
    loc[m] = -1;
    if (e < q) {
      const int mi = midx[(size_t)t * midx_stride + e];
      if (mi >= start && mi < stop) {
        loc[m] = mi - start;
        s_val[e] = ucross[(size_t)t * ucross_stride + e];
        named = 1;
      }
    }
  }
  if (__syncthreads_count(named) == 0) return;

  // passes over the instances past `done`, up to kFew each; a pass's
  // first round is a barrier, so the counts it zeroes are zero before the
  // counting sort writes them, and the last pass's reads are over
  for (int done = -1;;) {
    for (int k = i; k < n; k += T) s_cnt[k] = 0;
    // take out the next instances in increasing order, one block-wide
    // minimum a round
    int n_few = 0, prev = done;
    for (; n_few < kFew; ++n_few) {
      int mine = INT_MAX;
#pragma unroll
      for (int m = 0; m < E; ++m)
        if (loc[m] > prev) mine = min(mine, loc[m]);
      const int wmin = __reduce_min_sync(kAll, mine);
      if (lane == 0) s_wmin[n_few & 1][warp] = wmin;
      // one barrier a round: the two halves of s_wmin alternate
      __syncthreads();
      const int next = __reduce_min_sync(
          kAll, lane < T / 32 ? s_wmin[n_few & 1][lane] : INT_MAX);
      if (next == INT_MAX) break;
      if (i == 0) s_few[n_few] = next;
      prev = next;
    }
    __syncthreads();  // s_few is whole
    // a counting sort of the pass's pixels into its n_few buckets, in
    // pixel order within each: count each bucket's pixels per 32-pixel
    // chunk, scan the kFew x nch counts in (bucket, chunk) order (E a
    // thread), and place every value at its bucket's offset plus its rank
    // in the chunk
    int f[E], rank[E];
#pragma unroll
    for (int m = 0; m < E; ++m) {
      f[m] = -1;
      if (loc[m] > done && loc[m] <= prev) {
        int a = 0, b = n_few;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (s_few[mid] < loc[m]) {
            a = mid + 1;
          } else {
            b = mid;
          }
        }
        f[m] = a;
      }
      const unsigned same = __match_any_sync(kAll, f[m]);
      rank[m] = __popc(same & ((1u << lane) - 1u));
      // the chunk of element i + m * T is warp + m * (T / 32)
      if (f[m] >= 0 && rank[m] == 0) {
        s_cnt[f[m] * nch + warp + m * (T / 32)] = __popc(same);
      }
    }
    __syncthreads();
    int cnt[E], run = 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      cnt[r] = s_cnt[i * E + r];
      run += cnt[r];
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int base = incl - run, total = 0;
    for (int w = 0; w < T / 32; ++w) {
      if (w < warp) base += s_wsum[w];
      total += s_wsum[w];
    }
#pragma unroll
    for (int r = 0; r < E; ++r) {
      s_cnt[i * E + r] = base;
      base += cnt[r];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < E; ++m) {
      if (f[m] >= 0) {
        s_sorted[s_cnt[f[m] * nch + warp + m * (T / 32)] + rank[m]] =
            s_val[i + m * T];
      }
    }
    __syncthreads();
    // each bucket summed in pixel order by one thread (the buckets past
    // n_few are empty, so the next bucket's offset ends this one)
    if (i < n_few) {
      const int begin = s_cnt[i * nch];
      const int end = i + 1 < kFew ? s_cnt[(i + 1) * nch] : total;
      float acc = 0.f;
#pragma unroll 8
      for (int r = begin; r < end; ++r) acc += s_sorted[r];
      u_inst[start + s_few[i]] = acc;
      npix_inst[start + s_few[i]] = end - begin;
    }
    done = prev;
    int more = 0;
#pragma unroll
    for (int m = 0; m < E; ++m) more |= loc[m] > done;
    if (__syncthreads_or(more) == 0) return;
  }
}

}  // namespace

// out_f [n_tiles, 9, q] and out_i [n_tiles, 3, q] of the forward blend;
// basis != 0 takes the exponent's basis form; pairs may be null.
extern "C" int render_fwd(const float* feat, const int* tile_start,
                          const int* tile_stop, const float* gt, float* out_f,
                          int* out_i, int n_tiles, int tiles_x, int tile0,
                          int tile_w, int tile_h, int width, int height,
                          float alpha_cap,
                          float alpha_min, float t_terminate, int basis,
                          unsigned long long* pairs, void* stream) {
  const Params prm{tiles_x, tile_w, tile_h, width, height,
                   alpha_cap, alpha_min, t_terminate, tile0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return 0;
  switch (pixels_per_thread(tile_w * tile_h)) {
    case 1:
      return static_cast<int>(launch_fwd<1>(n_tiles, s, feat, tile_start,
                                            tile_stop, gt, out_f, out_i, prm,
                                            basis, pairs));
    case 2:
      return static_cast<int>(launch_fwd<2>(n_tiles, s, feat, tile_start,
                                            tile_stop, gt, out_f, out_i, prm,
                                            basis, pairs));
    case 4:
      return static_cast<int>(launch_fwd<4>(n_tiles, s, feat, tile_start,
                                            tile_stop, gt, out_f, out_i, prm,
                                            basis, pairs));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// u_inst, npix_inst (zero-filled by the caller) from the forward's
// per-pixel midx and ucross, [n_tiles, *] with tile strides midx_stride
// and ucross_stride and pixel stride 1 (views of out_i and out_f, read in
// place).
extern "C" int tile_scatter_sum(const int* midx, long long midx_stride,
                                const float* ucross, long long ucross_stride,
                                const int* tile_start, const int* tile_stop,
                                int n_tiles, int q, float* u_inst,
                                int* npix_inst, void* stream) {
  if (n_tiles <= 0) return 0;
  if (q <= 0 || q > 4 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // four pixels a thread, at least a warp: 256 threads for a 32x32 tile,
  // so that a frame's tiles are resident together
  int n = 128;
  while (n < q) n <<= 1;
  tile_scatter_sum_kernel<<<n_tiles, n / E, n * 3 * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      midx, midx_stride, ucross, ucross_stride, tile_start, tile_stop, q,
      u_inst, npix_inst);
  return static_cast<int>(cudaGetLastError());
}
