// Tracking's Gauss-Newton step outside the dual render, for NVIDIA Hopper
// (sm_90a): the twist basis of the view matrix, the normal equations and
// the Levenberg-Marquardt update.
//
// It replaces no TPU kernel: the JAX package's tracker
// (diff_gaussian_rasterization_tpu/models/slam.py::_track_gn_jit) leaves
// the twist basis (jax.jacfwd of lie.apply_twist), the residuals and the
// normal equations to XLA's fusion.  The port ran the same glue as ~300
// ATen calls a Gauss-Newton iteration (a torch.func.jacfwd of the twist,
// the mask, residuals, Jacobian and Huber weights, an N x 6 GEMM, a 6 x 6
// solve, the accept bookkeeping) and a host wait in every lie.exp_se3;
// on the card the host spent ~30% of a tracked frame there while the
// device idled.
//
// twist_tangents_kernel.  One thread: V0 exp(xi)^T and, with tangents,
// its derivative along each of the six twist directions (v, w), in double
// inside: the Rodrigues coefficients of lie._rot_coeffs with its Taylor
// branch at |w|^2 < 1e-12, and their derivatives by |w|^2.  Rounded to
// float once, at the end.
//
// gn_reduce_kernel<FULL>.  One pass over the pixels of the render, each
// thread a strided run of pixels.  A pixel counts where the silhouette
// exceeds sil_threshold and the target depth is valid (elsewhere every
// residual and Jacobian entry is zero: the pixel is skipped, and its
// tangents are never read).  Its four residuals (sqc x colour, sqd x the
// depth over the silhouette clamped at 1e-6), their Jacobian rows (the
// depth's by the quotient rule, dsil zeroed where the silhouette is at
// most 1e-6) and the Huber IRLS weights are float, in the plain version's
// operations and order (ops/kernels/gauss_newton.py::
// gn_reduce_reference); the 21 + 6 + 1 sums of H, g and the cost are
// double.  Cost only (FULL false): the cost's sum alone, from the primal
// images.  Each block reduces its threads' sums in a fixed order (warp
// shuffles, then the warps in order) into part[block]; the last block to
// finish (an integer ticket, no float atomics) adds the blocks' partials
// in a fixed order, writes H, g and the cost as float and, when given a
// state, runs the LM stage on them.  Two calls give the same bits.
//
// The LM stage (one thread).  From H, g and the cost as float: the
// deferred-accept update, the line search's proposal, its decision or its
// final comparison (modes below), on a float state vector whose layout
// ops/kernels/gauss_newton.py names.  The damped matrix h + lam diag(h) +
// 1e-9 I is formed in float as the plain version forms it, then solved in
// double (Gaussian elimination, partial pivoting); a non-finite step is a
// failed factorisation, as torch.linalg.solve_ex's is.
//
// What bounds it on an H100.  Bytes: gn_reduce reads at most 39 floats a
// pixel (9 primal and target, 30 of the six tangent images), ~127 MB at
// 1200 x 680, ~38 us at 3.35 TB/s; ~230 double operations a counted
// pixel, ~5 us at the card's FP64 rate.  kMaxBlocks blocks of 256 threads
// keep ~10 MB of loads in flight.  twist_tangents and the final stage are
// a few microseconds of one thread each: what they save is the host's
// ATen calls and waits, not device time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of gn_reduce at most; a constant, so the order of the sums (and
// so the bits) depends on the image size alone
constexpr int kMaxBlocks = 264;
constexpr int kFull = 28;  // H's upper triangle (21), g (6), the cost

// the state vector (ops/kernels/gauss_newton.py)
constexpr int kXi = 0, kAnchor = 6, kDx = 12, kBestXi = 18, kTrial = 24;
constexpr int kRefCost = 30, kBestCost = 31, kLam = 32;
constexpr int kNone = -1, kDeferred = 0, kPropose = 1, kDecide = 2,
              kFinal = 3;

struct Images {
  const float *color, *depth, *sil, *rgb, *gtd, *dcolor, *ddepth, *dsil;
  // element strides (the last axis is contiguous): colour and target
  // [3, H, W] by channel and row, the maps [H, W] by row, the tangents
  // [6, 3, H, W] and [6, H, W] by direction, channel and row
  long long color_c, color_y, depth_y, sil_y, rgb_c, rgb_y, gtd_y;
  long long dcolor_k, dcolor_c, dcolor_y, ddepth_k, ddepth_y, dsil_k, dsil_y;
  int height, width;
  float sil_threshold, sqc, sqd, huber;
};

struct Lm {
  float* state;
  float* costs;
  bool* accept;
  int mode, slot;
};

// ---------------------------------------------------------------------------
// the twist basis
// ---------------------------------------------------------------------------

__device__ void hat(const double* w, double k[3][3]) {
  k[0][0] = 0.0;   k[0][1] = -w[2]; k[0][2] = w[1];
  k[1][0] = w[2];  k[1][1] = 0.0;   k[1][2] = -w[0];
  k[2][0] = -w[1]; k[2][1] = w[0];  k[2][2] = 0.0;
}

__device__ void mul3(const double a[3][3], const double b[3][3],
                     double c[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

// out = V0 e^T for the 4 x 4 transform e = [[m, t], [0, last]]
__device__ void times_transposed(const double v0[4][4], const double m[3][3],
                                 const double* t, double last, float* out) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j)
      out[i * 4 + j] = static_cast<float>(
          v0[i][0] * m[j][0] + v0[i][1] * m[j][1] + v0[i][2] * m[j][2]
          + v0[i][3] * t[j]);
    out[i * 4 + 3] = static_cast<float>(v0[i][3] * last);
  }
}

__global__ void twist_tangents_kernel(const float* __restrict__ view0,
                                      const float* __restrict__ xi,
                                      float* __restrict__ view,
                                      float* __restrict__ tangents) {
  double v0[4][4], v[3], w[3];
  for (int i = 0; i < 16; ++i) v0[i / 4][i % 4] = view0[i];
  for (int i = 0; i < 3; ++i) {
    v[i] = xi[i];
    w[i] = xi[3 + i];
  }
  // lie._rot_coeffs: a = sin t / t, b = (1 - cos t) / t^2,
  // c = (t - sin t) / t^3, and their derivatives by t2 = t^2
  const double t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double a, b, c, da, db, dc;
  if (t2 < 1e-12) {
    a = 1.0 - t2 / 6.0;
    b = 0.5 - t2 / 24.0;
    c = 1.0 / 6.0 - t2 / 120.0;
    da = -1.0 / 6.0;
    db = -1.0 / 24.0;
    dc = -1.0 / 120.0;
  } else {
    const double th = sqrt(t2), sn = sin(th), cs = cos(th);
    a = sn / th;
    b = (1.0 - cs) / t2;
    c = (th - sn) / (t2 * th);
    da = (cs - a) / (2.0 * t2);
    db = (0.5 * a - b) / t2;
    dc = (b - 3.0 * c) / (2.0 * t2);
  }
  double k[3][3], k2[3][3], rot[3][3], vm[3][3], tr[3];
  hat(w, k);
  mul3(k, k, k2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      rot[i][j] = eye + a * k[i][j] + b * k2[i][j];
      vm[i][j] = eye + b * k[i][j] + c * k2[i][j];
    }
  for (int i = 0; i < 3; ++i)
    tr[i] = vm[i][0] * v[0] + vm[i][1] * v[1] + vm[i][2] * v[2];
  times_transposed(v0, rot, tr, 1.0, view);
  if (tangents == nullptr) return;

  const double zero[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0},
                             {0.0, 0.0, 0.0}};
  for (int d = 0; d < 3; ++d) {  // along v_d: the translation moves by Vm e_d
    const double col[3] = {vm[0][d], vm[1][d], vm[2][d]};
    times_transposed(v0, zero, col, 0.0, tangents + d * 16);
  }
  for (int d = 0; d < 3; ++d) {  // along w_d
    double e[3] = {0.0, 0.0, 0.0}, dk[3][3], dkk[3][3], kdk[3][3];
    e[d] = 1.0;
    hat(e, dk);
    mul3(dk, k, dkk);
    mul3(k, dk, kdk);
    const double dt2 = 2.0 * w[d];
    double drot[3][3], dvm[3][3], dtr[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const double dk2 = dkk[i][j] + kdk[i][j];
        drot[i][j] = da * dt2 * k[i][j] + a * dk[i][j] + db * dt2 * k2[i][j]
                     + b * dk2;
        dvm[i][j] = db * dt2 * k[i][j] + b * dk[i][j] + dc * dt2 * k2[i][j]
                    + c * dk2;
      }
    for (int i = 0; i < 3; ++i)
      dtr[i] = dvm[i][0] * v[0] + dvm[i][1] * v[1] + dvm[i][2] * v[2];
    times_transposed(v0, drot, dtr, 0.0, tangents + (3 + d) * 16);
  }
}

// ---------------------------------------------------------------------------
// the LM stage
// ---------------------------------------------------------------------------

// the step of the damped normal equations; false when it is not finite
__device__ bool lm_solve(const float* h, const float* g, float lam,
                         float* dx) {
  double m[6][7];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      float aij = h[i * 6 + j] + lam * (i == j ? h[i * 6 + j] : 0.0f);
      m[i][j] = aij + (i == j ? 1e-9f : 0.0f);
    }
    m[i][6] = -static_cast<double>(g[i]);
  }
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    for (int i = col + 1; i < 6; ++i)
      if (fabs(m[i][col]) > fabs(m[piv][col])) piv = i;
    if (piv != col)
      for (int j = col; j < 7; ++j) {
        const double t = m[col][j];
        m[col][j] = m[piv][j];
        m[piv][j] = t;
      }
    for (int i = col + 1; i < 6; ++i) {
      const double f = m[i][col] / m[col][col];
      for (int j = col; j < 7; ++j) m[i][j] -= f * m[col][j];
    }
  }
  bool ok = true;
  double x[6];
  for (int i = 5; i >= 0; --i) {
    double s = m[i][6];
    for (int j = i + 1; j < 6; ++j) s -= m[i][j] * x[j];
    x[i] = s / m[i][i];
    dx[i] = static_cast<float>(x[i]);
    ok = ok && isfinite(dx[i]);
  }
  return ok;
}

__device__ float damped(bool accept, float lam) {
  return accept ? fmaxf(lam / 3.0f, 1e-7f) : fminf(lam * 5.0f, 1e3f);
}

__device__ void lm_stage(const float* h, const float* g, float cost,
                         const Lm& lm) {
  float* s = lm.state;
  if (lm.mode == kDeferred || lm.mode == kPropose || lm.mode == kFinal) {
    if (cost < s[kBestCost]) {
      for (int i = 0; i < 6; ++i) s[kBestXi + i] = s[kXi + i];
      s[kBestCost] = cost;
    }
  }
  if (lm.mode == kDeferred || lm.mode == kPropose) lm.costs[lm.slot] = cost;
  if (lm.mode == kDeferred) {
    // the trial at xi = anchor + dx: accepted when below the anchor's cost;
    // a rejected trial keeps the anchor and retries half the step
    const bool accept = cost < s[kRefCost];
    const float lam = damped(accept, s[kLam]);
    s[kLam] = lam;
    float dx[6];
    const bool ok = accept && lm_solve(h, g, lam, dx);
    for (int i = 0; i < 6; ++i) {
      s[kDx + i] = ok ? dx[i] : 0.5f * s[kDx + i];
      if (accept) s[kAnchor + i] = s[kXi + i];
      s[kXi + i] = s[kAnchor + i] + s[kDx + i];
    }
    if (accept) s[kRefCost] = cost;
    *lm.accept = accept;
  } else if (lm.mode == kPropose) {
    float dx[6];
    lm_solve(h, g, s[kLam], dx);
    for (int i = 0; i < 6; ++i) {
      s[kDx + i] = dx[i];
      s[kTrial + i] = s[kXi + i] + dx[i];
    }
    s[kRefCost] = cost;
  } else if (lm.mode == kDecide) {
    // the cost at the trial decides; a non-finite step never moves
    bool accept = cost < s[kRefCost];
    for (int i = 0; i < 6; ++i) accept = accept && isfinite(s[kDx + i]);
    if (accept)
      for (int i = 0; i < 6; ++i) s[kXi + i] = s[kTrial + i];
    s[kLam] = damped(accept, s[kLam]);
    *lm.accept = accept;
  }
}

// ---------------------------------------------------------------------------
// the reduction
// ---------------------------------------------------------------------------

// one residual row: its Jacobian j[6], residual r and weight w
__device__ __forceinline__ void add_row(const float* j, float r, float w,
                                        double* acc) {
  float jw[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) jw[a] = j[a] * w;
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b)
      acc[n++] += static_cast<double>(jw[a]) * static_cast<double>(j[b]);
#pragma unroll
  for (int a = 0; a < 6; ++a)
    acc[21 + a] += static_cast<double>(jw[a]) * static_cast<double>(r);
  acc[27] += static_cast<double>(w * r * r);
}

__device__ __forceinline__ float huber_weight(float r, float huber) {
  const float q = r / huber;
  return 1.0f / sqrtf(1.0f + q * q);
}

template <bool FULL>
__device__ __forceinline__ void add_pixel(const Images& im, long long y,
                                          int x, double* acc) {
  const float sil = im.sil[y * im.sil_y + x];
  const float gtd = im.gtd[y * im.gtd_y + x];
  if (!(sil > im.sil_threshold && gtd > 0.0f)) return;
  const float depth = im.depth[y * im.depth_y + x];
  const float silc = fmaxf(sil, 1e-6f);
  float r[4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    r[c] = im.sqc * (im.color[c * im.color_c + y * im.color_y + x]
                     - im.rgb[c * im.rgb_c + y * im.rgb_y + x]);
  r[3] = im.sqd * (depth / silc - gtd);
  if constexpr (!FULL) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = huber_weight(r[i], im.huber);
      acc[0] += static_cast<double>(w * r[i] * r[i]);
    }
    return;
  }
  float j[4][6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      j[c][k] = im.sqc * im.dcolor[k * im.dcolor_k + c * im.dcolor_c
                                   + y * im.dcolor_y + x];
    const float ds = sil > 1e-6f ? im.dsil[k * im.dsil_k + y * im.dsil_y + x]
                                 : 0.0f;
    const float dd = im.ddepth[k * im.ddepth_k + y * im.ddepth_y + x];
    j[3][k] = im.sqd * ((dd * silc - depth * ds) / (silc * silc));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) add_row(j[i], r[i], huber_weight(r[i], im.huber),
                                      acc);
}

template <bool FULL>
__global__ void __launch_bounds__(kThreads)
    gn_reduce_kernel(Images im, double* __restrict__ part,
                     unsigned int* __restrict__ ticket, float* h_out,
                     float* g_out, float* cost_out, Lm lm) {
  constexpr int NV = FULL ? kFull : 1;
  double acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0;
  const int npix = im.height * im.width;  // the wrapper checks < 2^31
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < npix;
       p += gridDim.x * kThreads) {
    const int y = p / im.width;
    add_pixel<FULL>(im, y, p - y * im.width, acc);
  }

  __shared__ double red[kWarps * NV];
  __shared__ double fin[kThreads];
  __shared__ double tot[NV];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    double s = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * NV + v] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w * NV + threadIdx.x];
    part[blockIdx.x * NV + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: value v's partials split over `per` threads, each
  // summing every per-th block from its own, then the `per` sums in order
  constexpr int per = kThreads / NV;
  const int v = threadIdx.x / per, q = threadIdx.x - v * per;
  double s = 0.0;
  if (v < NV)
    for (int b = q; b < static_cast<int>(gridDim.x); b += per)
      s += __ldcg(part + b * NV + v);
  fin[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < NV) {
    double t = 0.0;
    for (int i = 0; i < per; ++i) t += fin[threadIdx.x * per + i];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float h[36], g[6];
  const float cost = static_cast<float>(tot[NV - 1]) * 0.5f;
  if (FULL) {
    int n = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b, ++n)
        h[a * 6 + b] = h[b * 6 + a] = static_cast<float>(tot[n]);
    for (int a = 0; a < 6; ++a) g[a] = static_cast<float>(tot[21 + a]);
    for (int i = 0; i < 36; ++i) h_out[i] = h[i];
    for (int a = 0; a < 6; ++a) g_out[a] = g[a];
  }
  *cost_out = cost;
  if (lm.mode != kNone) lm_stage(h, g, cost, lm);
  *ticket = 0u;  // ready for the next call on this stream
}

}  // namespace

extern "C" int twist_tangents(const float* view0, const float* xi,
                              float* view, float* tangents, void* stream) {
  twist_tangents_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      view0, xi, view, tangents);
  return static_cast<int>(cudaGetLastError());
}


// ptrs: colour, depth, silhouette, target colour, target depth, and the
// tangents' colour, depth and silhouette (null: cost only); strides: the
// Images strides in their order; dims: height, width; fpar:
// sil_threshold, sqc, sqd, huber.  part holds kMaxBlocks x 28 doubles;
// ticket is zero between calls.
extern "C" int gn_reduce(const void* const* ptrs, const long long* strides,
                         const int* dims, const float* fpar, double* part,
                         unsigned int* ticket, float* h, float* g,
                         float* cost, float* state, float* costs,
                         bool* accept, int mode, int slot, void* stream) {
  Images im;
  const float** p[8] = {&im.color, &im.depth, &im.sil, &im.rgb, &im.gtd,
                        &im.dcolor, &im.ddepth, &im.dsil};
  for (int i = 0; i < 8; ++i) *p[i] = static_cast<const float*>(ptrs[i]);
  long long* st[14] = {&im.color_c, &im.color_y, &im.depth_y, &im.sil_y,
                       &im.rgb_c, &im.rgb_y, &im.gtd_y, &im.dcolor_k,
                       &im.dcolor_c, &im.dcolor_y, &im.ddepth_k, &im.ddepth_y,
                       &im.dsil_k, &im.dsil_y};
  for (int i = 0; i < 14; ++i) *st[i] = strides[i];
  im.height = dims[0];
  im.width = dims[1];
  im.sil_threshold = fpar[0];
  im.sqc = fpar[1];
  im.sqd = fpar[2];
  im.huber = fpar[3];
  const bool full = im.dcolor != nullptr;
  if (mode < kNone || mode > kFinal || (mode != kNone && state == nullptr)
      || (full && (mode == kDecide || mode == kFinal))
      || (!full && (mode == kDeferred || mode == kPropose))
      || (full && (h == nullptr || g == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Lm lm{state, costs, accept, mode, slot};
  const int npix = im.height * im.width;
  const long long want = (static_cast<long long>(npix) + kThreads - 1)
                         / kThreads;
  const int blocks = want < 1 ? 1 : (want < kMaxBlocks ? int(want)
                                                        : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (full)
    gn_reduce_kernel<true><<<blocks, kThreads, 0, s>>>(im, part, ticket, h, g,
                                                       cost, lm);
  else
    gn_reduce_kernel<false><<<blocks, kThreads, 0, s>>>(im, part, ticket, h,
                                                        g, cost, lm);
  return static_cast<int>(cudaGetLastError());
}
