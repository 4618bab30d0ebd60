// Dual forward tile blend (the render plus K pose tangents), for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_jvp_kernel` of the JAX package
// (diff_gaussian_rasterization_tpu/ops/kernels/render_pallas.py:440, driven
// by `core_fwd_jvp` there).
//
// What it computes.  Everything render_fwd.cu computes, into out_f[t, 9, q]
// and out_i[t, 3, q] exactly as render_fwd writes them, plus, for each of
// K pose directions, the exact directional derivative of five per-pixel
// outputs: out_t[t, k, 6, q] = dcolor[3], ddepth, dweight, dt_final.  The
// tangents enter through a sorted tangent table tan[cap, PER_K * K] read
// by the same rows as the features: per direction dx, dy, ddepth of the
// splat and, in the full variant (PER_K = 6), dA, dB, dC of its conic.
// Per contributing (instance, pixel) pair, with the selection masks frozen:
//   gx = A dx + B dy,  gy = C dy + B dx           (shared by all tangents)
//   dpow_k = -(gx tx_k + gy ty_k)
//            [- (0.5 tA_k dx + tB_k dy) dx - 0.5 tC_k dy^2]
//   rate = alpha / (1 - alpha), 0 where alpha is capped
//   dw_k = w ((capped ? 0 : dpow_k) - S_k),  then S_k += rate dpow_k
//   dcolor_k += color dw_k, ddepth_k += depth dw_k + tdepth_k w,
//   dweight_k += dw_k,  and at the end dt_final_k = -T_final S_k.
// The median's tangent is structurally zero (the median reads the
// pose-detached depth copy); the kernel does not write it.
//
// What bounds it on an H100.  The forward's pairs (about 24 FP32
// operations each, the expf counted as 8) plus, per contribution, the
// forward's ~20 and ~130 more for six tangents (the division counted as
// 8).  At the tracking frame (100k Gaussians, 1200x680) that is a few
// G operations, ~0.1 ms at 67 TFLOP/s; the bytes (features, tangents,
// outputs: the tangent output alone is 836 x 6 x 6 x 1024 floats) are
// ~0.06 ms at 3.35 TB/s.  So it is bound by operations.
//
// What this simple design does about that.  The forward kernel keeps four
// pixels in each of 256 threads; with 6 K = 36 more accumulators per pixel
// that would spill.  Here a block is 256 threads with one pixel each, and
// a tile is a column of blocks (grid (T, ceil(Q / 256))): each block walks
// its tile's whole segment for its 256 pixels and votes its own early
// exit, so the segment is read once per block from L2.  Instances are
// staged in shared memory with their tangent rows: 256 a round in the
// light variant (29.7 KB at K = 6), 128 in the full one (24 KB), under the
// 48 KB of static shared memory.  The kernel is templated on K and PER_K;
// the entry point instantiates K = 1 and K = 6 and refuses any other.
//
// Numerics.  The per-pair test comes from blend_common.cuh, and the
// primal sums are the forward kernel's expressions in its order; with
// --fmad=false and no fast math every primal output is bit-equal to
// render_fwd's.  The tangent sums are sequential per pixel; the plain
// version takes them by a chunked cumsum, so they agree to a tolerance.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kThreads;
using blend::Params;

template <int K, int PER_K>
__global__ void __launch_bounds__(kThreads)
render_jvp_kernel(const float* __restrict__ feat,
                  const float* __restrict__ tan,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ gt,
                  float* __restrict__ out_f, int* __restrict__ out_i,
                  float* __restrict__ out_t, Params prm) {
  constexpr int kTan = K * PER_K;                   // tangent floats a row
  constexpr int kBatch = PER_K == 6 ? 128 : 256;    // instances a round
  __shared__ float s_feat[kBatch * kFeat];
  __shared__ float s_tan[kBatch * kTan];

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int stop = tile_stop[t];

  float px, py;
  bool done = !blend::pixel_of(prm, t, blockIdx.y, px, py);
  float T = 1.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f, wgt = 0.f, med = 0.f;
  float vdd = 0.f, vd = 0.f, udd = 0.f, ud = 0.f, uw = 0.f;
  int ncon = 0, nval = 0, midx = -1;
  float S[K], tc0[K], tc1[K], tc2[K], tdep[K], twgt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    S[k] = tc0[k] = tc1[k] = tc2[k] = tdep[k] = twgt[k] = 0.f;
  }

  for (int b0 = start; b0 < stop; b0 += kBatch) {
    // barrier + vote: also orders the previous round's shared reads
    // before this round's writes
    if (__syncthreads_count(!done) == 0) break;

    const int n = min(kBatch, stop - b0);
    const float* src = feat + (size_t)b0 * kFeat;
    for (int i = threadIdx.x; i < n * kFeat; i += kThreads) s_feat[i] = src[i];
    const float* tsrc = tan + (size_t)b0 * kTan;
    for (int i = threadIdx.x; i < n * kTan; i += kThreads) s_tan[i] = tsrc[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (done) break;
      const float* f = s_feat + j * kFeat;
      const blend::Splat g = blend::load_splat(f);
      const float dx = g.x - px;
      const float dy = g.y - py;
      const float power = blend::splat_power(g, dx, dy);
      if (power > 0.f) continue;
      const float G = expf(power);
      const float alpha = blend::splat_alpha(g, G, prm);
      if (alpha < prm.alpha_min) continue;
      const float test_T = T * (1.f - alpha);
      if (test_T < prm.t_terminate) {
        done = true;
        continue;
      }
      // the primal: render_fwd's expressions, in its order
      const float w = alpha * T;
      const float d = f[9];
      const float d2 = d * d;
      c0 += f[6] * w;
      c1 += f[7] * w;
      c2 += f[8] * w;
      dep += d * w;
      wgt += w;
      vdd += d2 * w;
      vd += d * w;
      if (T > 0.5f && test_T < 0.5f) {
        med = f[10];
        midx = b0 + j;
        udd += d2 * w;
        ud += d * w;
        uw += w;
      }
      // the tangents
      const bool capped = alpha >= prm.alpha_cap;
      const float rate = capped ? 0.f : alpha / (1.f - alpha);
      const float gx = g.A * dx + g.B * dy;
      const float gy = g.C * dy + g.B * dx;
      const float* tk = s_tan + j * kTan;
#pragma unroll
      for (int k = 0; k < K; ++k, tk += PER_K) {
        float dpow = -(gx * tk[0] + gy * tk[1]);
        if constexpr (PER_K == 6) {
          dpow = dpow - (0.5f * tk[3] * dx + tk[4] * dy) * dx
                 - 0.5f * tk[5] * dy * dy;
        }
        const float dw = w * ((capped ? 0.f : dpow) - S[k]);
        S[k] += rate * dpow;
        tc0[k] += f[6] * dw;
        tc1[k] += f[7] * dw;
        tc2[k] += f[8] * dw;
        tdep[k] += d * dw;
        tdep[k] += tk[2] * w;
        twgt[k] += dw;
      }
      T = test_T;
      ncon = b0 - start + j + 1;
      nval += 1;
    }
  }

  const int qi = threadIdx.x + blockIdx.y * kThreads;
  if (qi >= q) return;
  const float gv = gt[(size_t)t * q + qi];
  float* of = out_f + (size_t)t * 9 * q + qi;
  int* oi = out_i + (size_t)t * 3 * q + qi;
  of[0 * q] = c0;
  of[1 * q] = c1;
  of[2 * q] = c2;
  of[3 * q] = dep;
  of[4 * q] = wgt;
  of[5 * q] = med;
  of[6 * q] = vdd - 2.f * gv * vd + gv * gv * wgt;
  of[7 * q] = T;
  of[8 * q] = udd - 2.f * gv * ud + gv * gv * uw;
  oi[0 * q] = ncon;
  oi[1 * q] = nval;
  oi[2 * q] = midx;
  float* ot = out_t + (size_t)t * K * 6 * q + qi;
#pragma unroll
  for (int k = 0; k < K; ++k, ot += 6 * q) {
    ot[0 * q] = tc0[k];
    ot[1 * q] = tc1[k];
    ot[2 * q] = tc2[k];
    ot[3 * q] = tdep[k];
    ot[4 * q] = twgt[k];
    ot[5 * q] = -T * S[k];
  }
}

template <int K, int PER_K>
void launch(dim3 grid, cudaStream_t s, const float* feat, const float* tan,
            const int* tile_start, const int* tile_stop, const float* gt,
            float* out_f, int* out_i, float* out_t, const Params& prm) {
  render_jvp_kernel<K, PER_K><<<grid, kThreads, 0, s>>>(
      feat, tan, tile_start, tile_stop, gt, out_f, out_i, out_t, prm);
}

}  // namespace

extern "C" int render_jvp(const float* feat, const float* tan,
                          const int* tile_start, const int* tile_stop,
                          const float* gt, float* out_f, int* out_i,
                          float* out_t, int n_tiles, int tiles_x, int tile_w,
                          int tile_h, int width, int height, float alpha_cap,
                          float alpha_min, float t_terminate, int k,
                          int per_k, void* stream) {
  const Params prm{tiles_x, tile_w, tile_h, width, height,
                   alpha_cap, alpha_min, t_terminate};
  const int q = tile_w * tile_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return 0;
  if (q <= 0 || q > 4 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_tiles, (q + kThreads - 1) / kThreads);
  const auto args = [&](auto fn) {
    fn(grid, s, feat, tan, tile_start, tile_stop, gt, out_f, out_i, out_t,
       prm);
  };
  if (k == 6 && per_k == 3) {
    args(launch<6, 3>);
  } else if (k == 6 && per_k == 6) {
    args(launch<6, 6>);
  } else if (k == 1 && per_k == 3) {
    args(launch<1, 3>);
  } else if (k == 1 && per_k == 6) {
    args(launch<1, 6>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
