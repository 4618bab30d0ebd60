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
//
// Determinism without atomics.  The tile's segment is staged in batches of
// kBatch instances.  For each instance, every thread sums its own pixels'
// 12 terms, each warp reduces with a fixed __shfl_down_sync tree, lane 0
// puts the warp's 12 partials in shared memory, and after one barrier one
// thread per instance adds the 8 warp partials in warp order and writes
// the row.  Each instance lies in exactly one tile, so each row has one
// writer.  A block-wide vote ends the tile once every pixel has
// terminated; the wrapper zero-fills rows, so the instances never reached
// (and culled instances, and the budget's unused tail) keep zero rows.
// want_med / want_var = 0 skip those sums and leave their columns zero.
//
// What bounds it on an H100.  The least work is the pair test and ~58 FP32
// operations per contributing pair, ~1.9 G at the bench scale, ~29 us at
// 67 TFLOP/s; the bytes (table, pixel constants, rows) are ~53 MB, ~16 us.
// So operations bound it.  This simple design tests every pair of the
// forward's walk, and adds the per-instance warp reductions (60 shuffles
// per warp, skipped by a warp vote when no lane's pixel touched the
// instance), and leaves register blocking and cp.async staging for later.
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

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kThreads;
using blend::Params;

constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;  // instances staged (and reduced) per round
constexpr int kPix = 10;    // per-pixel constant rows
constexpr int kRow = 12;    // gradient columns
constexpr unsigned kFull = 0xffffffffu;

template <int PPT>  // pixels per thread
__global__ void __launch_bounds__(kThreads)
render_bwd_kernel(const float* __restrict__ feat,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ pix, float* __restrict__ rows,
                  Params prm, int want_med, int want_var) {
  __shared__ float s_feat[kBatch * kFeat];
  __shared__ float s_part[kWarps][kBatch][kRow];

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[PPT], py[PPT], T[PPT], pre[PPT];
  float pc0[PPT], pc1[PPT], pc2[PPT], pc3[PPT], pc4[PPT], pc5[PPT];
  float dLdd[PPT], gt[PPT], tot[PPT], dLdmed[PPT];
  bool done[PPT];

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    done[k] = !blend::pixel_of(prm, t, k, px[k], py[k]);
    T[k] = 1.f;
    pre[k] = 0.f;
    const int qi = threadIdx.x + k * kThreads;
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
      const float cr = f[6], cg = f[7], cb = f[8], d = f[9];
      const float d2 = d * d;
      float acc[kRow];
#pragma unroll
      for (int c = 0; c < kRow; ++c) acc[c] = 0.f;
      int touched = 0;
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
        const float s = cr * pc0[k] + cg * pc1[k] + cb * pc2[k] +
                        d * pc3[k] + d2 * pc4[k] + pc5[k];
        pre[k] += w * s;
        const float d_alpha =
            T[k] * s - (tot[k] - pre[k]) * (1.f / (1.f - alpha));
        const float e = d_alpha * G;
        acc[0] += e;
        acc[1] += e * dx;
        acc[2] += e * dy;
        acc[3] += e * dx * dx;
        acc[4] += e * dy * dy;
        acc[5] += e * dx * dy;
        acc[6] += w * pc0[k];
        acc[7] += w * pc1[k];
        acc[8] += w * pc2[k];
        acc[9] += w * dLdd[k];
        if (want_var) acc[10] += w * (d - gt[k]) * pc4[k];
        if (want_med && T[k] > 0.5f && test_T < 0.5f) acc[11] += dLdmed[k];
        T[k] = test_T;
        touched = 1;
      }
      // fixed-order warp reduction; a warp none of whose pixels reached
      // the instance has all-zero partials and skips it
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int c = 0; c < kRow; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[c] += __shfl_down_sync(kFull, acc[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kRow; ++c) s_part[warp][j][c] = acc[c];
      }
    }
    __syncthreads();

    if (threadIdx.x < n) {
      const int j = threadIdx.x;
      float sum[kRow];
#pragma unroll
      for (int c = 0; c < kRow; ++c) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += s_part[w][j][c];
        sum[c] = v;
      }
      const float* f = s_feat + j * kFeat;
      const float A = f[2], B = f[3], C = f[4], op = f[5];
      float* r = rows + (size_t)(b0 + j) * kRow;
      r[0] = -op * (A * sum[1] + B * sum[2]);
      r[1] = -op * (C * sum[2] + B * sum[1]);
      r[2] = -0.5f * op * sum[3];
      r[3] = -op * sum[5];
      r[4] = -0.5f * op * sum[4];
      r[5] = sum[0];
      r[6] = sum[6];
      r[7] = sum[7];
      r[8] = sum[8];
      r[9] = sum[9];
      r[10] = 2.f * sum[10];
      r[11] = sum[11];
    }
  }
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

extern "C" int render_bwd(const float* feat, const int* tile_start,
                          const int* tile_stop, const float* pix, float* rows,
                          int n_tiles, int tiles_x, int tile_w, int tile_h,
                          int width, int height, float alpha_cap,
                          float alpha_min, float t_terminate, int want_med,
                          int want_var, void* stream) {
  const Params prm{tiles_x, tile_w, tile_h, width, height,
                   alpha_cap, alpha_min, t_terminate};
  const int q = tile_w * tile_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return 0;
  if (q <= kThreads) {
    render_bwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, pix, rows, prm, want_med, want_var);
  } else if (q <= 2 * kThreads) {
    render_bwd_kernel<2><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, pix, rows, prm, want_med, want_var);
  } else if (q <= 4 * kThreads) {
    render_bwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(
        feat, tile_start, tile_stop, pix, rows, prm, want_med, want_var);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
