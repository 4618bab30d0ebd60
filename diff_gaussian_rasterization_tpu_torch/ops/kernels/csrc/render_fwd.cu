// Forward tile blend of the Gaussian rasterizer, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (diff_gaussian_rasterization_tpu/ops/kernels/render_pallas.py:157, driven
// by `core_fwd` there), and, in `segment_sum` below, the scatter of the
// per-pixel median-crossing statistics that follows it (render_pallas.py:390).
//
// What it computes.  One thread block per image tile.  The tile's instances
// are a contiguous, depth-sorted segment [tile_start, tile_stop) of the
// sorted feature table feat[cap, 11] = (x, y, A, B, C, opacity, r, g, b,
// depth, depth_sgview).  Each pixel walks the segment front to back:
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
// about 36 FP32 operations and one expf each, ~1.0 G operations at the
// bench scale (1200x680, 100k Gaussians, ~234k instances), about 16 us at
// 67 TFLOP/s of FP32; the features, ground-truth depth and outputs are
// about 55 MB, also about 16 us at 3.35 TB/s.  This design tests every
// pair a pixel walks before it terminates, about four times the
// contributions, so those pair tests bound it.
//
// What this simple design does about that.  256 threads per block, each
// owning up to four pixels of the tile in registers (a 32x32 tile is 1024
// pixels).  The segment is staged through shared memory in batches of 256
// instances (11 KB), read with coalesced loads, and every thread reads each
// staged instance from shared memory by broadcast.  A block-wide vote
// (__syncthreads_count) ends the tile as soon as every pixel has
// terminated.  Register blocking, cp.async double buffering and a
// persistent tile loop are left for later.
//
// The per-pair test's expressions live in blend_common.cuh, shared with
// the backward kernel (render_bwd.cu), so both passes make the same
// decisions bit for bit.
//
// Numerics.  Built without --use_fast_math and with --fmad=false, so each
// operation rounds as the plain PyTorch version's elementwise ops do; the
// sequential T *= (1 - alpha) still rounds differently from the plain
// version's chunked cumprod, so pixels exactly on the t_terminate or 0.5
// thresholds may flip.
//
// segment_sum: out[p] = sum of vals[j] (and of ivals[j]) over
// j in [bounds[p], bounds[p+1]), one thread per segment, summed in order.
// The caller sorts by key stably first, so the sum order is the input
// order: bit-reproducible from run to run, unlike a scatter with atomics.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kThreads;
using blend::Params;

constexpr int kBatch = 256;  // instances staged in shared memory per round

template <int PPT>  // pixels per thread
__global__ void __launch_bounds__(kThreads)
render_fwd_kernel(const float* __restrict__ feat,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ gt,
                  float* __restrict__ out_f, int* __restrict__ out_i,
                  Params prm) {
  __shared__ float s_feat[kBatch * kFeat];

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int stop = tile_stop[t];

  float px[PPT], py[PPT], T[PPT];
  float c0[PPT], c1[PPT], c2[PPT], dep[PPT], wgt[PPT], med[PPT];
  float vdd[PPT], vd[PPT], udd[PPT], ud[PPT], uw[PPT];
  int ncon[PPT], nval[PPT], midx[PPT];
  bool done[PPT];

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    done[k] = !blend::pixel_of(prm, t, k, px[k], py[k]);
    T[k] = 1.f;
    c0[k] = c1[k] = c2[k] = dep[k] = wgt[k] = med[k] = 0.f;
    vdd[k] = vd[k] = udd[k] = ud[k] = uw[k] = 0.f;
    ncon[k] = nval[k] = 0;
    midx[k] = -1;
  }

  for (int b0 = start; b0 < stop; b0 += kBatch) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // barrier + vote: also orders the previous round's shared reads
    // before this round's writes
    if (__syncthreads_count(live) == 0) break;

    const int n = min(kBatch, stop - b0);
    const float* src = feat + (size_t)b0 * kFeat;
    for (int i = threadIdx.x; i < n * kFeat; i += kThreads) s_feat[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* f = s_feat + j * kFeat;
      const blend::Splat g = blend::load_splat(f);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        const float dx = g.x - px[k];
        const float dy = g.y - py[k];
        const float power = blend::splat_power(g, dx, dy);
        if (power > 0.f) continue;
        const float G = expf(power);
        const float alpha = blend::splat_alpha(g, G, prm);
        if (alpha < prm.alpha_min) continue;
        const float test_T = T[k] * (1.f - alpha);
        if (test_T < prm.t_terminate) {
          done[k] = true;
          continue;
        }
        const float w = alpha * T[k];
        const float d = f[9];
        const float d2 = d * d;
        c0[k] += f[6] * w;
        c1[k] += f[7] * w;
        c2[k] += f[8] * w;
        dep[k] += d * w;
        wgt[k] += w;
        vdd[k] += d2 * w;
        vd[k] += d * w;
        if (T[k] > 0.5f && test_T < 0.5f) {
          med[k] = f[10];
          midx[k] = b0 + j;
          udd[k] += d2 * w;
          ud[k] += d * w;
          uw[k] += w;
        }
        T[k] = test_T;
        ncon[k] = b0 - start + j + 1;
        nval[k] += 1;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int qi = threadIdx.x + k * kThreads;
    if (qi >= q) continue;
    const float g = gt[(size_t)t * q + qi];
    float* of = out_f + (size_t)t * 9 * q + qi;
    int* oi = out_i + (size_t)t * 3 * q + qi;
    of[0 * q] = c0[k];
    of[1 * q] = c1[k];
    of[2 * q] = c2[k];
    of[3 * q] = dep[k];
    of[4 * q] = wgt[k];
    of[5 * q] = med[k];
    of[6 * q] = vdd[k] - 2.f * g * vd[k] + g * g * wgt[k];
    of[7 * q] = T[k];
    of[8 * q] = udd[k] - 2.f * g * ud[k] + g * g * uw[k];
    oi[0 * q] = ncon[k];
    oi[1 * q] = nval[k];
    oi[2 * q] = midx[k];
  }
}

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ ivals,
                                   const int* __restrict__ bounds,
                                   float* __restrict__ out,
                                   int* __restrict__ out_i, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float acc = 0.f;
  int iacc = 0;
  for (int j = bounds[p]; j < bounds[p + 1]; ++j) {
    acc += vals[j];
    iacc += ivals[j];
  }
  out[p] = acc;
  out_i[p] = iacc;
}

}  // namespace

extern "C" int render_fwd(const float* feat, const int* tile_start,
                          const int* tile_stop, const float* gt, float* out_f,
                          int* out_i, int n_tiles, int tiles_x, int tile_w,
                          int tile_h, int width, int height, float alpha_cap,
                          float alpha_min, float t_terminate, void* stream) {
  const Params prm{tiles_x, tile_w, tile_h, width, height,
                   alpha_cap, alpha_min, t_terminate};
  const int q = tile_w * tile_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return 0;
  if (q <= kThreads) {
    render_fwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, gt, out_f, out_i, prm);
  } else if (q <= 2 * kThreads) {
    render_fwd_kernel<2><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, gt, out_f, out_i, prm);
  } else if (q <= 4 * kThreads) {
    render_fwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, gt, out_f, out_i, prm);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum(const float* vals, const int* ivals,
                           const int* bounds, float* out, int* out_i, int n,
                           void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  segment_sum_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, ivals, bounds, out, out_i, n);
  return static_cast<int>(cudaGetLastError());
}
