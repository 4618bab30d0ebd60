// Forward tile blend of the Gaussian rasterizer, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (diff_gaussian_rasterization_tpu/ops/kernels/render_pallas.py:157, driven
// by `core_fwd` there), and, in `tile_scatter_sum` below, the scatter of the
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
//
// segment_sum: out[p] = sum of vals[j] (and of ivals[j]) over
// j in [bounds[p], bounds[p+1]), one thread per segment, summed in order.
// The caller sorts by key stably first, so the sum order is the input
// order: bit-reproducible from run to run, unlike a scatter with atomics.
// Left for the dense oracle's per-Gaussian sums, whose keys are not
// tile-local.

#include <climits>

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

constexpr unsigned kAll = 0xffffffffu;
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
