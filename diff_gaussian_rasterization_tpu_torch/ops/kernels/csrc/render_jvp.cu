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
// splat, in the full variant (PER_K = 6) dA, dB, dC of its conic, and with
// the SH colour branch (PER_K = 9) dr, dg, db of its colour after them.
// Per contributing (instance, pixel) pair, with the selection masks frozen:
//   gx = A dx + B dy,  gy = C dy + B dx           (shared by all tangents)
//   dpow_k = -(gx tx_k + gy ty_k)
//            [- (0.5 tA_k dx + tB_k dy) dx - 0.5 tC_k dy^2]
//   rate = alpha / (1 - alpha), 0 where alpha is capped
//   dw_k = w ((capped ? 0 : dpow_k) - S_k),  then S_k += rate dpow_k
//   dcolor_k += color dw_k [+ tcolor_k w], ddepth_k += depth dw_k
//   + tdepth_k w,
//   dweight_k += dw_k,  and at the end dt_final_k = -T_final S_k.
// The median's tangent is structurally zero (the median reads the
// pose-detached depth copy); the kernel does not write it.
//
// What bounds it on an H100.  Per contributing pair (a pair below
// alpha_min needs no work: culling skips it) the pair test (about 24 FP32
// operations, the expf counted as 8), the forward's ~20 and ~136 more for
// six tangents.  At the tracking frame (100k Gaussians, 1200x680, ~23.5 M
// contributions) that is ~4.2 G operations, ~0.063 ms at 67 TFLOP/s; the
// bytes (features, tangents, outputs) ~0.06 ms at 3.35 TB/s.  So the
// operations bound it, closely followed by the bytes; the kernel itself is
// held back by the latency of the loads and by the pairs it tests beyond
// the contributions.
//
// The design for this card:
// - Pixels.  One pixel per thread (36 tangent accumulators at K = 6 leave
//   no room for more), 256 threads a block, a tile is a column of
//   ceil(Q / 256) blocks.  Each warp owns an 8x4 pixel patch (when the
//   tile's width is a multiple of 8 and its height of 4; else 32
//   consecutive tile pixels), so a warp's pixels are compact.
// - Staging.  The segment is staged in rounds of kBatch instances through
//   a two-stage ring in dynamic shared memory, with cp.async: round r + 1's
//   features and tangents load while round r blends.  In shared memory a
//   feature row is padded to 12 floats and each tangent's columns to a
//   multiple of 4, so the blend reads them as 16-byte vectors.  One
//   block-wide vote per round ends the tile once every pixel has
//   terminated.
// - Exact culling.  A pair with alpha < alpha_min changes no output, so
//   skipping it keeps every output bit-equal as long as no contributing
//   pair is skipped.  After a round lands, each instance's box is computed
//   once (blend_common.cuh's cull_box: outside it opacity * exp(power) <
//   alpha_min, with a margin for float32 rounding; empty when opacity <
//   alpha_min), and each warp takes the round 32 instances at a time: one
//   ballot of "the box meets my patch's bounding box", then only the set
//   bits, in order.
// - Fused multiply-adds in the tangent arithmetic only (__fmaf_rn stays an
//   FFMA under --fmad=false), on negated terms so that each tangent costs
//   one FFMA a sum, and one reciprocal for rate; the primal's expressions
//   and order stay render_fwd's.
// - Occupancy.  __launch_bounds__(256, 3): three resident blocks an SM
//   (24 warps) at 80 registers a thread; the -Xptxas -v report shows
//   registers and spills.
// - The colour branch (PER_K = 9) adds three fused multiply-adds a tangent
//   and three floats a tangent's row; it runs one more 16-byte read a
//   tangent, and its two staged rounds take 86 KB of shared memory (62 KB
//   at PER_K = 6), so two blocks, not three, fit an SM.
// - Any K.  Templated on K = 1..6 and PER_K; a table with more tangents is
//   rendered in groups of at most kMaxK columns, one launch per group
//   (k0, k_total): each launch walks the same pairs, and only the first
//   writes the primal (write_primal).
// - pairs (optional, null on the main path): a variant of the kernel adds
//   the (instance, pixel) pairs its warps tested, for the report beside
//   the bound.
//
// Numerics.  The per-pair test comes from blend_common.cuh, and the primal
// sums are the forward kernel's expressions in its order; with
// --fmad=false and no fast math every primal output is bit-equal to
// render_fwd's.  The tangent sums are sequential per pixel; the plain
// version takes them by a chunked cumsum, so they agree to a tolerance.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

#include "blend_common.cuh"

namespace {

using blend::kFeat;
using blend::kThreads;
using blend::Params;

constexpr int kBatch = 128;  // instances a round
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 6;     // tangents a launch carries
// resident blocks an SM: 80 registers a thread (2 blocks, at 117-121
// registers, took 9-13% longer on an H100)
constexpr int kMinBlocks = 3;
constexpr unsigned kFull = 0xffffffffu;
// Where a launch's tangent group sits in the whole table and output.
struct Group {
  int tan_stride;    // floats per row of the whole tangent table
  int k0, k_total;   // first tangent of this group; tangents in out_t
  int write_primal;  // 1 for the first group
};

// This thread's tile pixel (q when it has none): the warp's 8x4 patch, or
// 32 consecutive pixels when the tile does not divide into patches.
__device__ __forceinline__ int tile_pixel(const Params& prm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((prm.tile_w & 7) == 0 && (prm.tile_h & 3) == 0) {
    const int patch = blockIdx.y * kWarps + warp;
    const int across = prm.tile_w >> 3;
    const int ly = (patch / across) * 4 + (lane >> 3);
    const int lx = (patch % across) * 8 + (lane & 7);
    return ly < prm.tile_h ? ly * prm.tile_w + lx : prm.tile_w * prm.tile_h;
  }
  return threadIdx.x + blockIdx.y * kThreads;
}

// Shared-memory layout of a staged instance: the 11 features padded to
// kFeatPad floats, and each tangent's PER_K floats padded to a multiple of
// 4, so the blend reads them as 16-byte vectors.
constexpr int kFeatPad = 12;
template <int PER_K>
__host__ __device__ constexpr int tan_pad() {
  return (PER_K + 3) / 4 * 4;
}
template <int K, int PER_K>
__host__ __device__ constexpr int stage_floats() {
  return kBatch * (kFeatPad + K * tan_pad<PER_K>());
}
template <int K, int PER_K>
__host__ __device__ constexpr int smem_bytes() {
  return (2 * stage_floats<K, PER_K>() + 4 * kBatch) * (int)sizeof(float);
}

// Start one round's copies (features, then this group's tangent columns)
// into a stage of the ring, 4 bytes each, and commit them as one group.
template <int K, int PER_K>
__device__ __forceinline__ void stage_round(float* dst,
                                            const float* __restrict__ feat,
                                            const float* __restrict__ tan,
                                            int tan_stride, int b0, int n) {
  constexpr int kTan = K * PER_K, kPad = tan_pad<PER_K>();
  const float* src = feat + (size_t)b0 * kFeat;
  for (int i = threadIdx.x; i < n * kFeat; i += kThreads) {
    const int r = i / kFeat;
    __pipeline_memcpy_async(dst + r * kFeatPad + (i - r * kFeat), src + i,
                            sizeof(float));
  }
  float* dt = dst + kBatch * kFeatPad;
  for (int i = threadIdx.x; i < n * kTan; i += kThreads) {
    const int r = i / kTan, c = i - r * kTan;
    const int k = c / PER_K, e = c - k * PER_K;
    __pipeline_memcpy_async(dt + (r * K + k) * kPad + e,
                            tan + (size_t)(b0 + r) * tan_stride + c,
                            sizeof(float));
  }
  __pipeline_commit();
}

template <int K, int PER_K, bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_jvp_kernel(const float* __restrict__ feat,
                  const float* __restrict__ tan,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_stop,
                  const float* __restrict__ gt,
                  float* __restrict__ out_f, int* __restrict__ out_i,
                  float* __restrict__ out_t, Params prm, Group grp,
                  unsigned long long* __restrict__ pairs) {
  constexpr int kPad = tan_pad<PER_K>();
  constexpr int kStage = stage_floats<K, PER_K>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* s_box = reinterpret_cast<float4*>(smem + 2 * kStage);

  const int t = blockIdx.x;
  const int q = prm.tile_w * prm.tile_h;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int lane = threadIdx.x & 31;
  const float* tan_g = tan + grp.k0 * PER_K;

  const int qi = tile_pixel(prm);
  const int tg = prm.tile0 + t;  // the tile's index in the image
  const int pxi = (tg % prm.tiles_x) * prm.tile_w + qi % prm.tile_w;
  const int pyi = (tg / prm.tiles_x) * prm.tile_h + qi / prm.tile_w;
  bool done = !(qi < q && pxi < prm.width && pyi < prm.height);
  const float px = (float)pxi;
  const float py = (float)pyi;
  // the bounding box of the warp's pixels in the image
  const float wx0 = (float)__reduce_min_sync(kFull, done ? INT_MAX : pxi);
  const float wx1 = (float)__reduce_max_sync(kFull, done ? INT_MIN : pxi);
  const float wy0 = (float)__reduce_min_sync(kFull, done ? INT_MAX : pyi);
  const float wy1 = (float)__reduce_max_sync(kFull, done ? INT_MIN : pyi);

  float T = 1.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f, wgt = 0.f, med = 0.f;
  float vdd = 0.f, vd = 0.f, udd = 0.f, ud = 0.f, uw = 0.f;
  int ncon = 0, nval = 0, midx = -1;
  unsigned tested = 0;
  float S[K], tc0[K], tc1[K], tc2[K], tdep[K], twgt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    S[k] = tc0[k] = tc1[k] = tc2[k] = tdep[k] = twgt[k] = 0.f;
  }

  if (start < stop) {
    stage_round<K, PER_K>(smem, feat, tan_g, grp.tan_stride, start,
                          min(kBatch, stop - start));
  }
  int stage = 0;
  for (int b0 = start; b0 < stop; b0 += kBatch, stage ^= 1) {
    // this round's copies have landed (for this thread's part of them);
    // the barrier makes all parts visible and orders every warp's reads of
    // the other stage (and of s_box) in the last round before the writes
    // below
    __pipeline_wait_prior(0);
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, stop - b0);
    if (b0 + kBatch < stop) {
      stage_round<K, PER_K>(smem + (stage ^ 1) * kStage, feat, tan_g,
                            grp.tan_stride, b0 + kBatch,
                            min(kBatch, stop - b0 - kBatch));
    }
    const float* s_feat = smem + stage * kStage;
    const float4* s_tan =
        reinterpret_cast<const float4*>(s_feat + kBatch * kFeatPad);
    if (threadIdx.x < n) {
      s_box[threadIdx.x] = blend::cull_box(s_feat + threadIdx.x * kFeatPad,
                                           prm.alpha_min);
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += 32) {
      if (!__any_sync(kFull, !done)) break;
      bool meets = false;
      if (j0 + lane < n) {
        const float4 b = s_box[j0 + lane];
        meets = blend::box_meets(b, wx0, wx1, wy0, wy1);
      }
      unsigned todo = __ballot_sync(kFull, meets);
      while (todo) {
        const int j = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        if constexpr (kCount) tested += !done;
        if (done) continue;
        const float4* f4 = reinterpret_cast<const float4*>(
            s_feat + j * kFeatPad);
        const float4 fa = f4[0];  // x, y, A, B
        const float4 fb = f4[1];  // C, opacity, r, g
        const blend::Splat g{fa.x, fa.y, fa.z, fa.w, fb.x, fb.y};
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
        const float4 fc = f4[2];  // b, depth, depth_sgview, (pad)
        // the primal: render_fwd's expressions, in its order
        const float w = alpha * T;
        const float d = fc.y;
        const float d2 = d * d;
        c0 += fb.z * w;
        c1 += fb.w * w;
        c2 += fc.x * w;
        dep += d * w;
        wgt += w;
        vdd += d2 * w;
        vd += d * w;
        if (T > 0.5f && test_T < 0.5f) {
          med = fc.z;
          midx = b0 + j;
          udd += d2 * w;
          ud += d * w;
          uw += w;
        }
        // the tangents, in fused multiply-adds on negated terms:
        //   ndp = -dpow,  ndw = -dw = cw ndp + w S  (cw = 0 where capped),
        //   S += rate dpow = S - rate ndp
        const bool capped = alpha >= prm.alpha_cap;
        const float nrate = capped ? 0.f : -alpha * __frcp_rn(1.f - alpha);
        const float cw = capped ? 0.f : w;
        const float gx = __fmaf_rn(g.A, dx, g.B * dy);
        const float gy = __fmaf_rn(g.C, dy, g.B * dx);
        // the conic tangents' terms: ndp += 0.5 dx^2 dA + dx dy dB
        //                                    + 0.5 dy^2 dC
        const float hxx = 0.5f * dx * dx, hxy = dx * dy, hyy = 0.5f * dy * dy;
        const float4* tk = s_tan + j * K * (kPad / 4);
#pragma unroll
        for (int k = 0; k < K; ++k, tk += kPad / 4) {
          const float4 ta = tk[0];  // dx, dy, ddepth, [dA]
          float ndp = __fmaf_rn(gx, ta.x, gy * ta.y);
          if constexpr (PER_K >= 6) {
            const float4 tb = tk[1];  // dB, dC, [dr, dg]
            ndp = __fmaf_rn(tb.y, hyy,
                            __fmaf_rn(tb.x, hxy, __fmaf_rn(ta.w, hxx, ndp)));
          }
          const float ndw = __fmaf_rn(cw, ndp, w * S[k]);
          S[k] = __fmaf_rn(nrate, ndp, S[k]);
          if constexpr (PER_K == 9) {
            // the colour's own tangent: dcolor += tcolor w
            const float4 tb = tk[1], tc = tk[2];  // dr, dg in tb; db in tc
            tc0[k] = __fmaf_rn(tb.z, w, __fmaf_rn(-fb.z, ndw, tc0[k]));
            tc1[k] = __fmaf_rn(tb.w, w, __fmaf_rn(-fb.w, ndw, tc1[k]));
            tc2[k] = __fmaf_rn(tc.x, w, __fmaf_rn(-fc.x, ndw, tc2[k]));
          } else {
            tc0[k] = __fmaf_rn(-fb.z, ndw, tc0[k]);
            tc1[k] = __fmaf_rn(-fb.w, ndw, tc1[k]);
            tc2[k] = __fmaf_rn(-fc.x, ndw, tc2[k]);
          }
          tdep[k] = __fmaf_rn(ta.z, w, __fmaf_rn(-d, ndw, tdep[k]));
          twgt[k] -= ndw;
        }
        T = test_T;
        ncon = b0 - start + j + 1;
        nval += 1;
      }
    }
  }

  if constexpr (kCount) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tested += __shfl_down_sync(kFull, tested, off);
    if (lane == 0 && tested != 0) atomicAdd(pairs, (unsigned long long)tested);
  }
  if (qi >= q) return;
  if (grp.write_primal) {
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
  }
  float* ot = out_t + ((size_t)t * grp.k_total + grp.k0) * 6 * q + qi;
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

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const float *feat, *tan;
  const int *tile_start, *tile_stop;
  const float* gt;
  float* out_f;
  int* out_i;
  float* out_t;
  Params prm;
  Group grp;
  unsigned long long* pairs;
};

template <int K, int PER_K, bool kCount>
cudaError_t launch(const Launch& a) {
  constexpr int bytes = smem_bytes<K, PER_K>();
  const auto kernel = render_jvp_kernel<K, PER_K, kCount>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<a.grid, kThreads, bytes, a.stream>>>(
      a.feat, a.tan, a.tile_start, a.tile_stop, a.gt, a.out_f, a.out_i,
      a.out_t, a.prm, a.grp, a.pairs);
  return cudaGetLastError();
}

template <int K, int PER_K>
cudaError_t launch_counted(const Launch& a) {
  return a.pairs != nullptr ? launch<K, PER_K, true>(a)
                            : launch<K, PER_K, false>(a);
}

// cull_box of each feature row, as the blend computes it: the checks hold
// these boxes to the pixels a splat contributes to and to render.py's
// mirror.
__global__ void cull_boxes_kernel(const float* __restrict__ feat, int n,
                                  float alpha_min, float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = blend::cull_box(feat + (size_t)i * kFeat, alpha_min);
}

template <int PER_K>
cudaError_t launch_k(int k, const Launch& a) {
  switch (k) {
    case 1: return launch_counted<1, PER_K>(a);
    case 2: return launch_counted<2, PER_K>(a);
    case 3: return launch_counted<3, PER_K>(a);
    case 4: return launch_counted<4, PER_K>(a);
    case 5: return launch_counted<5, PER_K>(a);
    case 6: return launch_counted<6, PER_K>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch for the tangent columns [k0, k0 + k) of a table with k_total
// tangents (tan_stride = per_k * k_total floats a row); write_primal = 1
// writes out_f and out_i.  pairs may be null.
extern "C" int render_jvp(const float* feat, const float* tan,
                          const int* tile_start, const int* tile_stop,
                          const float* gt, float* out_f, int* out_i,
                          float* out_t, int n_tiles, int tiles_x, int tile0,
                          int tile_w, int tile_h, int width, int height,
                          float alpha_cap,
                          float alpha_min, float t_terminate, int k,
                          int per_k, int k0, int k_total, int write_primal,
                          unsigned long long* pairs, void* stream) {
  const int q = tile_w * tile_h;
  if (n_tiles <= 0) return 0;
  if (q <= 0 || q > 4 * kThreads || k < 1 || k > kMaxK || k0 < 0
      || k0 + k > k_total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch a{dim3(n_tiles, (q + kThreads - 1) / kThreads),
                 static_cast<cudaStream_t>(stream), feat, tan, tile_start,
                 tile_stop, gt, out_f, out_i, out_t,
                 Params{tiles_x, tile_w, tile_h, width, height, alpha_cap,
                        alpha_min, t_terminate, tile0},
                 Group{per_k * k_total, k0, k_total, write_primal}, pairs};
  if (per_k == 3) return static_cast<int>(launch_k<3>(k, a));
  if (per_k == 6) return static_cast<int>(launch_k<6>(k, a));
  if (per_k == 9) return static_cast<int>(launch_k<9>(k, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// boxes[i] = (x0, x1, y0, y1), the blend's culling box of feature row i of
// feat [n, 11]; boxes is 16-byte aligned.
extern "C" int render_jvp_cull_boxes(const float* feat, int n,
                                     float alpha_min, float* boxes,
                                     void* stream) {
  if (n <= 0) return 0;
  cull_boxes_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      feat, n, alpha_min, reinterpret_cast<float4*>(boxes));
  return static_cast<int>(cudaGetLastError());
}
