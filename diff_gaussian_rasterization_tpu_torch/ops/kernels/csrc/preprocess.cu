// The render op's per-Gaussian preprocess, forward and closed-form backward,
// for NVIDIA Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package left the preprocess
// (diff_gaussian_rasterization_tpu/ops/projection.py::preprocess) to XLA's
// fusion.  The port ran the same composite as ~290 ATen calls a render,
// whose [P, 3] x [3, k] products went to cuBLAS (GEMV, GEMM with K = 3,
// gemmk1), and ~390 more in autograd's backward: ~44 of a 500k map step's
// 59 device ms.
//
// What preprocess_fwd computes.  ops/projection.py::preprocess, in its
// formulas and its order of operations, for one Gaussian a thread: view
// depth z = [m, 1] V[:, 2] and the near-plane test; the homogeneous divide
// [m, 1] (V P)[:, {0, 1}] / (w + w_eps) with w = z (P's column 3 is e_2)
// set to 1 behind the near plane; Sigma3D = M M^T, M = R(q) diag(s mod),
// q normalised or raw, or cov3D_precomp; the EWA Sigma2D = J W Sigma W^T
// J^T + lowpass with the view point clamped to fov_clamp tan(fov); det,
// conic, the eigenvalue radius (eig_clamp); the opacity_cull footprint
// and bin_margin_px; ndc2pix with the means2D offset; the tile rect and
// tiles_touched; the mask; SH colour (degree D = 0..3, +0.5, clamp at 0)
// or colors_precomp (D = -1).  It writes the render core's feature table
// feat[P, 11] (x, y, A, B, C, opacity, r, g, b, depth, depth_sgview), the
// footprint ints[P, 6] (radius, rect_min x, y, rect_max x, y,
// tiles_touched) and the mask.
//
// What preprocess_bwd computes.  From d feat[P, 11] it recomputes the
// forward's intermediates from the inputs (nothing is saved) and writes
// the closed-form gradients of the reference's preprocessCUDA,
// computeCov2DCUDA and computeCov3DCUDA backward: means3D, scales,
// rotations (through the normalisation when it is on), opacities, shs,
// cov3D_precomp, colors_precomp and the means2D offset, each where its
// pointer is given.  With WANT_VIEW it also sums the view matrix's
// gradient over the Gaussians, along the routes the composite gives it
// under the branch flags: the depth (POSE_DEPTH), the NDC position through
// V P (POSE_NDC), the 2D covariance (POSE_COV) and the camera position
// -V[:3, :3] V[3, :3] of the SH direction (POSE_SH); never from the depth
// copy in column 10.  Each block reduces its threads' [16] in a fixed
// order (warp shuffles, then the warps in order) into part[block, 16];
// preprocess_view_kernel, one block, adds the blocks' partials in a fixed
// order.  No float atomics: the gradients are bit-reproducible.
//
// What preprocess_tangents computes.  The forward mode of the same
// composite along K view-matrix tangents dV [K, 16]: the per-Gaussian
// columns of the dual render's tangent table (ops/rasterize.py::
// pose_jvp_tables), per tangent dx, dy, ddepth; dA, dB, dC of the conic
// (POSE_COV); dr, dg, db of the SH colour (POSE_SH, SH degree >= 1).  It
// replaces no TPU kernel either: the JAX package's rasterize_with_pose_jvp
// leaves the tangents to jax.linearize under XLA
// (diff_gaussian_rasterization_tpu/ops/rasterize.py:664).  The port ran
// them as torch.func.vmap of torch.func.jvp over the composite, whose
// batched 3x3 products went to cuBLAS gemvx: ~24 ms a pass at 500k, K = 6,
// SH 3.  Its bound is bytes too: 3 to 60 floats read a Gaussian (the
// means; scales, rotations and 48 SH coefficients for the full chain) and
// 3 K to 9 K written, 0.013 ms (light) to 0.067 ms (full, SH 3) at 500k,
// K = 6.  One thread a Gaussian: the primal intermediates recomputed in
// registers once, then a loop over the K tangents (read through the
// read-only cache, like the view) writing each Gaussian's row of
// per_k * K floats once.
//
// What bounds it on an H100.  Bytes: ~200 operations a Gaussian forward
// and ~400 backward against 25 and 39 floats moved (splatbench/work.py's
// counts), so 500k Gaussians take 15 us forward and 23 us backward at
// 3.35 TB/s, and 1.5 / 3 us at 67 TFLOP/s.  The design: one thread a
// Gaussian, every intermediate in registers, each input read once and each
// output written once; a thread's rows are 12 to 48 contiguous bytes, so
// a warp's loads and stores cover whole sectors.  The view matrix is read
// through the read-only cache (every thread reads the same 64 bytes).
// Built with --fmad=false and no fast math, like the other sources, so
// each operation rounds as the composite's elementwise ops do.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kView = 16;
// preprocess_tangent_kernel: threads a block, tangents a shared-memory chunk
constexpr int kTanThreads = 128, kTanChunk = 6;

// flag bits of Params::flags (ops/kernels/preprocess.py)
enum : int {
  kNormalizeQ = 1, kOpacityCull = 2, kCovPre = 4, kColPre = 8, kMeans2D = 16,
  kPoseDepth = 32, kPoseNdc = 64, kPoseCov = 128, kPoseSh = 256,
  kWantView = 512,
};

struct Params {
  // float parameters, in the wrapper's order
  float scale_mod, fx, fy, limx, limy, p00, p11, near, w_eps, lowpass,
      eig_clamp, radius_sigma, alpha_min, bin_margin;
  // integer parameters, in the wrapper's order
  int P, width, height, tile_w, tile_h, tiles_x, tiles_y, sh_coeffs,
      sh_degree, flags;
};
constexpr int kNF = 14, kNI = 10;

// sh.py's constants; T(kC...) rounds them to float32 as the composite's
// scalar products round them (each double rounds to the float32 nearest
// its decimal)
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC20 = 1.0925484305920792, kC21 = -1.0925484305920792,
                 kC22 = 0.31539156525252005, kC23 = -1.0925484305920792,
                 kC24 = 0.5462742152960396;
constexpr double kC30 = -0.5900435899266435, kC31 = 2.890611442640554,
                 kC32 = -0.4570457994644658, kC33 = 0.3731763325901154,
                 kC34 = -0.4570457994644658, kC35 = 1.445305721320277,
                 kC36 = -0.5900435899266435;

// torch.clamp / clamp_min / clamp_max: NaN passes through
template <typename T>
__device__ __forceinline__ T clampf(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// The helpers below run in float (the forward and backward, rounding as
// the composite's float32 ops) or in double (the tangents).
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double fma_t(double x, double y, double z) {
  return fma(x, y, z);
}

// packed symmetric index: (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ int sym(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}

// Sigma3D = M M^T with M = R(q) diag(s): the rotation and scales kept for
// the backward
template <typename T>
struct Cov3 {
  T q[4];   // the quaternion R is built from (normalised or raw)
  T qn;     // its norm before normalisation (1 when off)
  T R[9];
  T s[3];
};

template <typename T>
__device__ __forceinline__ void cov3d(const float* scales, const float* rots,
                                      int i, const Params& p, Cov3<T>& c,
                                      T S[6]) {
  T r = rots[4 * i], x = rots[4 * i + 1], y = rots[4 * i + 2],
    z = rots[4 * i + 3];
  c.qn = 1.f;
  if (p.flags & kNormalizeQ) {
    const T n = sqrt_t(((r * r + x * x) + y * y) + z * z);
    c.qn = n;
    r = r / n; x = x / n; y = y / n; z = z / n;
  }
  c.q[0] = r; c.q[1] = x; c.q[2] = y; c.q[3] = z;
  c.R[0] = 1.f - 2.f * (y * y + z * z);
  c.R[1] = 2.f * (x * y - r * z);
  c.R[2] = 2.f * (x * z + r * y);
  c.R[3] = 2.f * (x * y + r * z);
  c.R[4] = 1.f - 2.f * (x * x + z * z);
  c.R[5] = 2.f * (y * z - r * x);
  c.R[6] = 2.f * (x * z - r * y);
  c.R[7] = 2.f * (y * z + r * x);
  c.R[8] = 1.f - 2.f * (x * x + y * y);
  for (int j = 0; j < 3; ++j) c.s[j] = T(scales[3 * i + j]) * T(p.scale_mod);
  T M[9];
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 3; ++j) M[3 * a + j] = c.R[3 * a + j] * c.s[j];
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b)
      S[sym(a, b)] = (M[3 * a] * M[3 * b] + M[3 * a + 1] * M[3 * b + 1]) +
                     M[3 * a + 2] * M[3 * b + 2];
}

// A point's product with a column of the view matrix, as the composite's
// matrix products take it (fused multiply-adds in order): the view depth
// of a Gaussian near the camera is a small difference of larger terms, and
// rounding each product on its own loses ~3 ulps of it, which the 1 / w^2
// of the screen position's gradient then doubles.
template <typename T>
__device__ __forceinline__ T dot3(T x, T y, T z, T a, T b, T c) {
  return fma_t(z, c, fma_t(y, b, x * a));
}

// The projection's intermediates, shared by the forward and the backward.
template <typename T>
struct Proj {
  T m[3];
  T z;          // view depth (and the homogeneous w)
  bool vis;     // z > near
  T hx, hy;     // homogeneous x, y: [m, 1] (V P)[:, 0 / 1]
  T den;        // (vis ? z : 1) + w_eps
  T t0, t1, tz; // view point, tz = 1 behind the near plane
  T u0, u1, uc0, uc1, tx, ty, inv_tz, inv_tz2;
  T j00, j02, j11, j12;
  T m0[3], m1[3];   // J W rows
  T S[6];           // Sigma3D, packed
  T sm0[3], sm1[3]; // Sigma m0, Sigma m1
  T a, b, c;        // Sigma2D + lowpass
  T det, inv_det;
  bool det_ok;
};

// The view depth, the near-plane test and the homogeneous x, y, w + w_eps
// of the screen position (the fields of Proj up to den).
template <typename T>
__device__ __forceinline__ void center(const float* means, const T* V, int i,
                                       const Params& p, Proj<T>& g) {
  const T mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
  g.m[0] = mx; g.m[1] = my; g.m[2] = mz;
  // means3D @ V[:3, c] + V[3, c]
  g.z = dot3(mx, my, mz, V[2], V[6], V[10]) + V[14];
  g.vis = g.z > p.near;
  // (V P)[:, 0] = V[:, 0] p00, (V P)[:, 1] = V[:, 1] p11
  g.hx = dot3(mx, my, mz, V[0] * p.p00, V[4] * p.p00, V[8] * p.p00) +
         V[12] * p.p00;
  g.hy = dot3(mx, my, mz, V[1] * p.p11, V[5] * p.p11, V[9] * p.p11) +
         V[13] * p.p11;
  g.den = (g.vis ? g.z : 1.f) + p.w_eps;
}

template <typename T>
__device__ __forceinline__ void project(const float* means, const T* V, int i,
                                        const Params& p, Proj<T>& g) {
  center(means, V, i, p, g);
  const T mx = g.m[0], my = g.m[1], mz = g.m[2];

  // compute_cov2d
  g.t0 = dot3(mx, my, mz, V[0], V[4], V[8]) + V[12];
  g.t1 = dot3(mx, my, mz, V[1], V[5], V[9]) + V[13];
  g.tz = g.vis ? g.z : 1.f;
  g.u0 = g.t0 / g.tz;
  g.u1 = g.t1 / g.tz;
  g.uc0 = clampf(g.u0, T(-p.limx), T(p.limx));
  g.uc1 = clampf(g.u1, T(-p.limy), T(p.limy));
  g.tx = g.uc0 * g.tz;
  g.ty = g.uc1 * g.tz;
  g.inv_tz = 1.f / g.tz;
  g.inv_tz2 = g.inv_tz * g.inv_tz;
  g.j00 = p.fx * g.inv_tz;
  g.j02 = (-p.fx * g.tx) * g.inv_tz2;
  g.j11 = p.fy * g.inv_tz;
  g.j12 = (-p.fy * g.ty) * g.inv_tz2;
  // m0 = j0 @ W, W[a][b] = V[b][a]; j0[1] = j1[0] = 0
  for (int b = 0; b < 3; ++b) {
    g.m0[b] = g.j00 * V[4 * b] + g.j02 * V[4 * b + 2];
    g.m1[b] = g.j11 * V[4 * b + 1] + g.j12 * V[4 * b + 2];
  }
  for (int a = 0; a < 3; ++a) {
    g.sm0[a] = (g.S[sym(a, 0)] * g.m0[0] + g.S[sym(a, 1)] * g.m0[1]) +
               g.S[sym(a, 2)] * g.m0[2];
    g.sm1[a] = (g.S[sym(a, 0)] * g.m1[0] + g.S[sym(a, 1)] * g.m1[1]) +
               g.S[sym(a, 2)] * g.m1[2];
  }
  g.a = ((g.m0[0] * g.sm0[0] + g.m0[1] * g.sm0[1]) + g.m0[2] * g.sm0[2]) +
        p.lowpass;
  g.b = (g.m0[0] * g.sm1[0] + g.m0[1] * g.sm1[1]) + g.m0[2] * g.sm1[2];
  g.c = ((g.m1[0] * g.sm1[0] + g.m1[1] * g.sm1[1]) + g.m1[2] * g.sm1[2]) +
        p.lowpass;
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det != 0.f;
  g.inv_det = 1.f / (g.det_ok ? g.det : 1.f);
}

// The unit view direction of the SH colour: means3D - campos, campos =
// -V[:3, :3] V[3, :3]; returns the norm (0 if the direction is 0).
template <typename T>
__device__ __forceinline__ T sh_dir(const T m[3], const T* V, T d[3],
                                    T dirs[3]) {
  for (int a = 0; a < 3; ++a) {
    const T cp = -((V[4 * a] * V[12] + V[4 * a + 1] * V[13]) +
                   V[4 * a + 2] * V[14]);
    dirs[a] = m[a] - cp;
  }
  const T n =
      sqrt_t((dirs[0] * dirs[0] + dirs[1] * dirs[1]) + dirs[2] * dirs[2]);
  const T den = n > 0.f ? n : T(1.f);
  for (int a = 0; a < 3; ++a) d[a] = dirs[a] / den;
  return n;
}

// The SH basis of degree D at d: values b[k] and their derivatives by x,
// y, z (bx, by, bz), k < (D + 1)^2.
template <int D, typename T>
__device__ __forceinline__ void sh_basis(const T d[3], T b[16], T bx[16],
                                         T by[16], T bz[16]) {
  const T x = d[0], y = d[1], z = d[2];
  for (int k = 0; k < 16; ++k) b[k] = bx[k] = by[k] = bz[k] = 0.f;
  b[0] = T(kC0);
  if (D > 0) {
    b[1] = -T(kC1) * y; by[1] = -T(kC1);
    b[2] = T(kC1) * z;  bz[2] = T(kC1);
    b[3] = -T(kC1) * x; bx[3] = -T(kC1);
  }
  if (D > 1) {
    const T xx = x * x, yy = y * y, zz = z * z;
    const T xy = x * y, yz = y * z, xz = x * z;
    b[4] = T(kC20) * xy; bx[4] = T(kC20) * y; by[4] = T(kC20) * x;
    b[5] = T(kC21) * yz; by[5] = T(kC21) * z; bz[5] = T(kC21) * y;
    b[6] = T(kC22) * ((2.f * zz - xx) - yy);
    bx[6] = -2.f * T(kC22) * x; by[6] = -2.f * T(kC22) * y;
    bz[6] = 4.f * T(kC22) * z;
    b[7] = T(kC23) * xz; bx[7] = T(kC23) * z; bz[7] = T(kC23) * x;
    b[8] = T(kC24) * (xx - yy); bx[8] = 2.f * T(kC24) * x;
    by[8] = -2.f * T(kC24) * y;
    if (D > 2) {
      b[9] = (T(kC30) * y) * (3.f * xx - yy);
      bx[9] = 6.f * T(kC30) * xy; by[9] = 3.f * T(kC30) * (xx - yy);
      b[10] = (T(kC31) * xy) * z;
      bx[10] = T(kC31) * yz; by[10] = T(kC31) * xz; bz[10] = T(kC31) * xy;
      b[11] = (T(kC32) * y) * ((4.f * zz - xx) - yy);
      bx[11] = -2.f * T(kC32) * xy;
      by[11] = T(kC32) * ((4.f * zz - xx) - 3.f * yy);
      bz[11] = 8.f * T(kC32) * yz;
      b[12] = (T(kC33) * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      bx[12] = -6.f * T(kC33) * xz; by[12] = -6.f * T(kC33) * yz;
      bz[12] = T(kC33) * ((6.f * zz - 3.f * xx) - 3.f * yy);
      b[13] = (T(kC34) * x) * ((4.f * zz - xx) - yy);
      bx[13] = T(kC34) * ((4.f * zz - 3.f * xx) - yy);
      by[13] = -2.f * T(kC34) * xy; bz[13] = 8.f * T(kC34) * xz;
      b[14] = (T(kC35) * z) * (xx - yy);
      bx[14] = 2.f * T(kC35) * xz; by[14] = -2.f * T(kC35) * yz;
      bz[14] = T(kC35) * (xx - yy);
      b[15] = (T(kC36) * x) * (xx - 3.f * yy);
      bx[15] = 3.f * T(kC36) * (xx - yy); by[15] = -6.f * T(kC36) * xy;
    }
  }
}

// sh.eval_sh before its clamp, channel c, in its order of operations
template <int D, typename T>
__device__ __forceinline__ T sh_eval(const float* sh, const T d[3], int c) {
  const T x = d[0], y = d[1], z = d[2];
  auto k = [&](int i) { return T(sh[3 * i + c]); };
  T r = T(kC0) * k(0);
  if (D > 0)
    r = ((r - (T(kC1) * y) * k(1)) + (T(kC1) * z) * k(2)) -
        (T(kC1) * x) * k(3);
  if (D > 1) {
    const T xx = x * x, yy = y * y, zz = z * z;
    const T xy = x * y, yz = y * z, xz = x * z;
    r = ((((r + (T(kC20) * xy) * k(4)) + (T(kC21) * yz) * k(5)) +
          (T(kC22) * ((2.f * zz - xx) - yy)) * k(6)) +
         (T(kC23) * xz) * k(7)) +
        (T(kC24) * (xx - yy)) * k(8);
    if (D > 2) {
      r = ((((((r + ((T(kC30) * y) * (3.f * xx - yy)) * k(9)) +
               ((T(kC31) * xy) * z) * k(10)) +
              ((T(kC32) * y) * ((4.f * zz - xx) - yy)) * k(11)) +
             ((T(kC33) * z) * ((2.f * zz - 3.f * xx) - 3.f * yy)) * k(12)) +
            ((T(kC34) * x) * ((4.f * zz - xx) - yy)) * k(13)) +
           ((T(kC35) * z) * (xx - yy)) * k(14)) +
          ((T(kC36) * x) * (xx - 3.f * yy)) * k(15);
    }
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void load_view(const float* view, T V[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) V[k] = __ldg(view + k);
}

template <int D>
__global__ void __launch_bounds__(kThreads) preprocess_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ opac,
    const float* __restrict__ shs, const float* __restrict__ cov_pre,
    const float* __restrict__ col_pre, const float* __restrict__ m2d,
    const float* __restrict__ view, const Params p, float* __restrict__ feat,
    int* __restrict__ ints, bool* __restrict__ mask) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.P) return;
  float V[16];
  load_view(view, V);
  Proj<float> g;
  if (p.flags & kCovPre) {
    for (int k = 0; k < 6; ++k) g.S[k] = cov_pre[6 * i + k];
  } else {
    Cov3<float> c3;
    cov3d(scales, rots, i, p, c3, g.S);
  }
  project(means, V, i, p, g);

  const float a = g.a, b = g.b, c = g.c;
  const float mid = 0.5f * (a + c);
  const float lam = mid + sqrtf(clamp_min(mid * mid - g.det, p.eig_clamp));
  const float radius = ceilf(p.radius_sigma * sqrtf(lam));
  const float op = opac[i];
  float rx, ry;
  if (p.flags & kOpacityCull) {
    const float ratio = op / p.alpha_min;
    const float cut = clamp_max(sqrtf(2.f * logf(clamp_min(ratio, 1.f))),
                                p.radius_sigma);
    const bool live = ratio > 1.f;
    rx = live ? ceilf(cut * sqrtf(clamp_min(a, 0.f)) + 1e-3f) : 0.f;
    ry = live ? ceilf(cut * sqrtf(clamp_min(c, 0.f)) + 1e-3f) : 0.f;
  } else {
    rx = ry = radius;
  }
  if (p.bin_margin != 0.f) {
    rx = rx > 0.f ? rx + p.bin_margin : rx;
    ry = ry > 0.f ? ry + p.bin_margin : ry;
  }
  float vx = g.hx / g.den, vy = g.hy / g.den;
  if (p.flags & kMeans2D) {
    vx = vx + m2d[2 * i];
    vy = vy + m2d[2 * i + 1];
  }
  const float px = ((vx + 1.f) * static_cast<float>(p.width) - 1.f) * 0.5f;
  const float py = ((vy + 1.f) * static_cast<float>(p.height) - 1.f) * 0.5f;
  const float tw = static_cast<float>(p.tile_w);
  const float th = static_cast<float>(p.tile_h);
  const float ntx = static_cast<float>(p.tiles_x);
  const float nty = static_cast<float>(p.tiles_y);
  const int r0x = static_cast<int>(clampf(floorf((px - rx) / tw), 0.f, ntx));
  const int r0y = static_cast<int>(clampf(floorf((py - ry) / th), 0.f, nty));
  const int r1x =
      static_cast<int>(clampf(floorf((px + rx) / tw) + 1.f, 0.f, ntx));
  const int r1y =
      static_cast<int>(clampf(floorf((py + ry) / th) + 1.f, 0.f, nty));
  const int tt = (r1x - r0x) * (r1y - r0y);
  const bool live = g.vis && g.det_ok && tt > 0;

  float col[3];
  if constexpr (D < 0) {
    for (int k = 0; k < 3; ++k) col[k] = col_pre[3 * i + k];
  } else {
    float d[3], dirs[3];
    sh_dir(g.m, V, d, dirs);
    const float* sh = shs + static_cast<long long>(i) * p.sh_coeffs * 3;
    for (int k = 0; k < 3; ++k) col[k] = clamp_min(sh_eval<D>(sh, d, k) + 0.5f,
                                                   0.f);
  }

  float* f = feat + 11 * static_cast<long long>(i);
  f[0] = px; f[1] = py;
  f[2] = c * g.inv_det; f[3] = -b * g.inv_det; f[4] = a * g.inv_det;
  f[5] = op;
  f[6] = col[0]; f[7] = col[1]; f[8] = col[2];
  f[9] = g.z; f[10] = g.z;
  int* o = ints + 6 * static_cast<long long>(i);
  o[0] = live ? static_cast<int>(radius) : 0;
  o[1] = r0x; o[2] = r0y; o[3] = r1x; o[4] = r1y;
  o[5] = live ? tt : 0;
  mask[i] = live;
}

// Sum v[kView] over the block in a fixed order into part[blockIdx.x].
__device__ __forceinline__ void block_sum(float v[kView], float* part) {
  __shared__ float warp_sum[kThreads / 32][kView];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kView; ++k) {
    float x = v[k];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sum[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kView) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w][threadIdx.x];
    part[kView * blockIdx.x + threadIdx.x] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) preprocess_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ shs,
    const float* __restrict__ cov_pre, const float* __restrict__ view,
    const Params p, const float* __restrict__ dfeat,
    float* __restrict__ d_means, float* __restrict__ d_scales,
    float* __restrict__ d_rots, float* __restrict__ d_opac,
    float* __restrict__ d_shs, float* __restrict__ d_cov,
    float* __restrict__ d_col, float* __restrict__ d_m2d,
    float* __restrict__ part) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool want_view = p.flags & kWantView;
  float dV[kView];
#pragma unroll
  for (int k = 0; k < kView; ++k) dV[k] = 0.f;
  if (i < p.P) {
    float V[16];
    load_view(view, V);
    Proj<float> g;
    Cov3<float> c3;
    if (p.flags & kCovPre) {
      for (int k = 0; k < 6; ++k) g.S[k] = cov_pre[6 * i + k];
    } else {
      cov3d(scales, rots, i, p, c3, g.S);
    }
    project(means, V, i, p, g);
    const float* gf = dfeat + 11 * static_cast<long long>(i);
    float G[11];
    for (int k = 0; k < 11; ++k) G[k] = gf[k];
    const float* m = g.m;

    // depth and its pose-stopped copy
    float dm[3];
    const float gz = G[9] + G[10];
    for (int a = 0; a < 3; ++a) dm[a] = gz * V[4 * a + 2];
    if (want_view && (p.flags & kPoseDepth)) {
      for (int a = 0; a < 3; ++a) dV[4 * a + 2] += m[a] * G[9];
      dV[14] += G[9];
    }

    // xy = ndc2pix(h / den + means2D)
    const float dvx = G[0] * 0.5f * static_cast<float>(p.width);
    const float dvy = G[1] * 0.5f * static_cast<float>(p.height);
    if (d_m2d) {
      d_m2d[2 * i] = dvx;
      d_m2d[2 * i + 1] = dvy;
    }
    const float d_den = -(dvx * g.hx + dvy * g.hy) / (g.den * g.den);
    const float dhx = dvx / g.den, dhy = dvy / g.den;
    const float dhw = g.vis ? d_den : 0.f;
    // hom_c = [m, 1] (V P)[:, c]: (V P)[:, 0] = V[:, 0] p00,
    // (V P)[:, 1] = V[:, 1] p11, (V P)[:, 3] = V[:, 2]
    for (int a = 0; a < 3; ++a)
      dm[a] += (dhx * (V[4 * a] * p.p00) + dhy * (V[4 * a + 1] * p.p11)) +
               dhw * V[4 * a + 2];
    if (want_view && (p.flags & kPoseNdc)) {
      // d(V P) = [m, 1]^T d hom, then dV = d(V P) P^T
      for (int r = 0; r < 4; ++r) {
        const float mh = r < 3 ? m[r] : 1.f;
        dV[4 * r] += (mh * dhx) * p.p00;
        dV[4 * r + 1] += (mh * dhy) * p.p11;
        dV[4 * r + 2] += mh * dhw;
      }
    }

    // conic = (c, -b, a) / det
    const float d_inv = (G[2] * g.c - G[3] * g.b) + G[4] * g.a;
    const float d_det = g.det_ok ? -d_inv * g.inv_det * g.inv_det : 0.f;
    const float da = G[4] * g.inv_det + g.c * d_det;
    const float db = -G[3] * g.inv_det - 2.f * g.b * d_det;
    const float dc = G[2] * g.inv_det + g.a * d_det;

    // a = m0 S m0, b = m0 S m1, c = m1 S m1
    float dm0[3], dm1[3], dS[6];
    for (int k = 0; k < 3; ++k) {
      dm0[k] = 2.f * da * g.sm0[k] + db * g.sm1[k];
      dm1[k] = db * g.sm0[k] + 2.f * dc * g.sm1[k];
    }
    for (int r = 0; r < 3; ++r)
      for (int s = r; s < 3; ++s) {
        const float e = da * g.m0[r] * g.m0[s] + db * g.m0[r] * g.m1[s] +
                        dc * g.m1[r] * g.m1[s];
        const float et = da * g.m0[s] * g.m0[r] + db * g.m0[s] * g.m1[r] +
                         dc * g.m1[s] * g.m1[r];
        dS[sym(r, s)] = r == s ? e : e + et;
      }
    // m0 = j0 W, m1 = j1 W
    float dj00 = 0.f, dj02 = 0.f, dj11 = 0.f, dj12 = 0.f;
    for (int b = 0; b < 3; ++b) {
      dj00 += dm0[b] * V[4 * b];
      dj02 += dm0[b] * V[4 * b + 2];
      dj11 += dm1[b] * V[4 * b + 1];
      dj12 += dm1[b] * V[4 * b + 2];
    }
    const bool pose_cov = want_view && (p.flags & kPoseCov);
    if (pose_cov) {
      for (int b = 0; b < 3; ++b) {
        dV[4 * b] += dm0[b] * g.j00;
        dV[4 * b + 1] += dm1[b] * g.j11;
        dV[4 * b + 2] += dm0[b] * g.j02 + dm1[b] * g.j12;
      }
    }
    const float d_tx = -p.fx * g.inv_tz2 * dj02;
    const float d_ty = -p.fy * g.inv_tz2 * dj12;
    const float d_inv_tz =
        (p.fx * dj00 + p.fy * dj11) +
        2.f * g.inv_tz * (-p.fx * g.tx * dj02 - p.fy * g.ty * dj12);
    const float du0 =
        (g.u0 >= -p.limx && g.u0 <= p.limx) ? g.tz * d_tx : 0.f;
    const float du1 =
        (g.u1 >= -p.limy && g.u1 <= p.limy) ? g.tz * d_ty : 0.f;
    const float d_tz = ((-g.inv_tz * g.inv_tz * d_inv_tz + g.uc0 * d_tx) +
                        g.uc1 * d_ty) -
                       (du0 * g.t0 + du1 * g.t1) / (g.tz * g.tz);
    const float dt[3] = {du0 / g.tz, du1 / g.tz, g.vis ? d_tz : 0.f};
    for (int a = 0; a < 3; ++a)
      dm[a] += (dt[0] * V[4 * a] + dt[1] * V[4 * a + 1]) + dt[2] * V[4 * a + 2];
    if (pose_cov) {
      for (int a = 0; a < 3; ++a)
        for (int j = 0; j < 3; ++j) dV[4 * a + j] += m[a] * dt[j];
      for (int j = 0; j < 3; ++j) dV[12 + j] += dt[j];
    }

    // Sigma3D
    if (p.flags & kCovPre) {
      if (d_cov)
        for (int k = 0; k < 6; ++k) d_cov[6 * i + k] = dS[k];
    } else if (d_scales || d_rots) {
      // dM = (dS + dS^T) M over the upper triangle
      float Gs[9];
      for (int r = 0; r < 3; ++r)
        for (int s = 0; s < 3; ++s)
          Gs[3 * r + s] = r == s ? 2.f * dS[sym(r, s)] : dS[sym(r, s)];
      float M[9], dM[9];
      for (int r = 0; r < 3; ++r)
        for (int j = 0; j < 3; ++j) M[3 * r + j] = c3.R[3 * r + j] * c3.s[j];
      for (int r = 0; r < 3; ++r)
        for (int j = 0; j < 3; ++j)
          dM[3 * r + j] = (Gs[3 * r] * M[j] + Gs[3 * r + 1] * M[3 + j]) +
                          Gs[3 * r + 2] * M[6 + j];
      float ds[3], dR[9];
      for (int j = 0; j < 3; ++j) {
        ds[j] = (dM[j] * c3.R[j] + dM[3 + j] * c3.R[3 + j]) +
                dM[6 + j] * c3.R[6 + j];
        for (int r = 0; r < 3; ++r) dR[3 * r + j] = dM[3 * r + j] * c3.s[j];
      }
      if (d_scales)
        for (int j = 0; j < 3; ++j) d_scales[3 * i + j] = ds[j] * p.scale_mod;
      if (d_rots) {
        const float r = c3.q[0], x = c3.q[1], y = c3.q[2], z = c3.q[3];
        float dq[4] = {
            2.f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] -
                   y * dR[6] + x * dR[7]),
            2.f * (y * dR[1] + z * dR[2] + y * dR[3] - 2.f * x * dR[4] -
                   r * dR[5] + z * dR[6] + r * dR[7] - 2.f * x * dR[8]),
            2.f * (-2.f * y * dR[0] + x * dR[1] + r * dR[2] + x * dR[3] +
                   z * dR[5] - r * dR[6] + z * dR[7] - 2.f * y * dR[8]),
            2.f * (-2.f * z * dR[0] - r * dR[1] + x * dR[2] + r * dR[3] -
                   2.f * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7])};
        if (p.flags & kNormalizeQ) {
          const float qd = ((r * dq[0] + x * dq[1]) + y * dq[2]) + z * dq[3];
          for (int k = 0; k < 4; ++k)
            dq[k] = (dq[k] - c3.q[k] * qd) / c3.qn;
        }
        for (int k = 0; k < 4; ++k) d_rots[4 * i + k] = dq[k];
      }
    }

    // colour
    if constexpr (D < 0) {
      if (d_col)
        for (int k = 0; k < 3; ++k) d_col[3 * i + k] = G[6 + k];
    } else {
      float d[3], dirs[3];
      const float n = sh_dir(m, V, d, dirs);
      const float* sh = shs + static_cast<long long>(i) * p.sh_coeffs * 3;
      float gc[3];
      for (int c = 0; c < 3; ++c)
        gc[c] = sh_eval<D>(sh, d, c) + 0.5f >= 0.f ? G[6 + c] : 0.f;
      float b[16], bx[16], by[16], bz[16];
      sh_basis<D>(d, b, bx, by, bz);
      constexpr int kCoef = (D + 1) * (D + 1);
      float dd[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kCoef; ++k) {
        const float dbk =
            (sh[3 * k] * gc[0] + sh[3 * k + 1] * gc[1]) + sh[3 * k + 2] * gc[2];
        dd[0] += dbk * bx[k];
        dd[1] += dbk * by[k];
        dd[2] += dbk * bz[k];
      }
      if (d_shs) {
        float* o = d_shs + static_cast<long long>(i) * p.sh_coeffs * 3;
#pragma unroll
        for (int k = 0; k < kCoef; ++k)
          for (int c = 0; c < 3; ++c) o[3 * k + c] = b[k] * gc[c];
        for (int k = 3 * kCoef; k < 3 * p.sh_coeffs; ++k) o[k] = 0.f;
      }
      float ddirs[3];
      if (n > 0.f) {
        const float dot = (d[0] * dd[0] + d[1] * dd[1]) + d[2] * dd[2];
        for (int a = 0; a < 3; ++a) ddirs[a] = (dd[a] - d[a] * dot) / n;
      } else {
        for (int a = 0; a < 3; ++a) ddirs[a] = dd[a];
      }
      for (int a = 0; a < 3; ++a) dm[a] += ddirs[a];
      if (want_view && (p.flags & kPoseSh)) {
        // campos = -V[:3, :3] V[3, :3], d campos = -d dirs
        for (int a = 0; a < 3; ++a)
          for (int j = 0; j < 3; ++j) dV[4 * a + j] += ddirs[a] * V[12 + j];
        for (int j = 0; j < 3; ++j)
          dV[12 + j] += (ddirs[0] * V[j] + ddirs[1] * V[4 + j]) +
                        ddirs[2] * V[8 + j];
      }
    }

    if (d_means)
      for (int a = 0; a < 3; ++a) d_means[3 * i + a] = dm[a];
    if (d_opac) d_opac[i] = G[5];
  }
  if (want_view) block_sum(dV, part);
}

// The view matrix's gradient: the blocks' partials [nblocks, 16] added in a
// fixed order by one block (16 strided runs a component, then in order).
__global__ void __launch_bounds__(kThreads) preprocess_view_kernel(
    const float* __restrict__ part, int nblocks, float* __restrict__ out) {
  __shared__ float run[kThreads / kView][kView];
  const int k = threadIdx.x % kView, r = threadIdx.x / kView;
  float s = 0.f;
  for (int b = r; b < nblocks; b += kThreads / kView) s += part[kView * b + k];
  run[r][k] = s;
  __syncthreads();
  if (threadIdx.x < kView) {
    float t = 0.f;
    for (int j = 0; j < kThreads / kView; ++j) t += run[j][threadIdx.x];
    out[threadIdx.x] = t;
  }
}

// The forward mode of the preprocess along K view tangents dV [K, 16]: for
// Gaussian i, out[i, k * PER_K + j] is the derivative along dV[k] of, in
// order, x, y, depth (always); A, B, C of the conic (with COV, else zeros
// when the colour columns follow); r, g, b (with DEG >= 1, the SH colour
// branch).  PER_K = 3, 6 or 9.  Each branch differentiates what the
// composite lets the view reach under the flags: the depth (kPoseDepth);
// the screen position through V P, w = 1 behind the near plane
// (kPoseNdc); the EWA Sigma2D -> conic through the clamped view point, tz
// = 1 where not visible, the clamp passing the tangent only inside its
// range, det guarded (COV); the SH colour through the camera position
// -V[:3, :3] V[3, :3], the guarded normalisation and the clamp at 0 (DEG).
// Each product's tangent is taken in the composite's order, d(u v) =
// du v + u dv.  The primal intermediates are recomputed once a Gaussian
// and everything runs in double: the conic's tangent divides by det^2, so
// float32's rounding of a, b, c (the composite's) sets its error, and
// double leaves only the inputs' rounding (~0.1x the float32 composite's
// error against float64).  K is the loop bound, in chunks of kTanChunk
// tangents: their view tangents are read into shared memory once a block,
// as double, and the rows' values staged there, so that the block writes
// its rows' contiguous span (a row is per_k K floats; written from
// registers, each warp store would touch 32 sectors for 32 floats).
// Without COV and DEG it reads only the means.
template <bool COV, int DEG>
__global__ void __launch_bounds__(kTanThreads) preprocess_tangent_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ shs,
    const float* __restrict__ cov_pre, const float* __restrict__ view,
    const float* __restrict__ dview, const Params p, int k_t,
    float* __restrict__ out) {
  using T = double;
  constexpr int kPerK = DEG > 0 ? 9 : (COV ? 6 : 3);
  __shared__ float stage[kTanThreads * kPerK * kTanChunk];
  __shared__ T sdV[kTanChunk * 16];
  const int i0 = blockIdx.x * kTanThreads;
  const int rows = min(kTanThreads, p.P - i0);
  // a thread past the last row computes the last row again and stores
  // nothing: every thread reaches the block's barriers
  const int i = threadIdx.x < rows ? i0 + threadIdx.x : p.P - 1;
  T V[16];
  load_view(view, V);
  Proj<T> g;
  if constexpr (COV) {
    if (p.flags & kCovPre) {
      for (int k = 0; k < 6; ++k) g.S[k] = cov_pre[6 * i + k];
    } else {
      Cov3<T> c3;
      cov3d(scales, rots, i, p, c3, g.S);
    }
    project(means, V, i, p, g);
  } else {
    center(means, V, i, p, g);
  }
  const T* m = g.m;
  const bool pose_depth = p.flags & kPoseDepth, pose_ndc = p.flags & kPoseNdc;
  const T vx = g.hx / g.den, vy = g.hy / g.den;
  const T half_w = 0.5 * p.width, half_h = 0.5 * p.height;
  const T p00 = p.p00, p11 = p.p11;
  bool in0 = false, in1 = false;
  if constexpr (COV) {
    in0 = g.u0 >= -p.limx && g.u0 <= p.limx;
    in1 = g.u1 >= -p.limy && g.u1 <= p.limy;
  }

  // The colour's derivative by the unit direction, a channel (zero where
  // the clamp at 0 holds): dcol_c = gd[c] . d unit.
  T gd[3][3] = {}, d[3] = {}, n = 0.0;
  if constexpr (DEG > 0) {
    T dirs[3];
    n = sh_dir(m, V, d, dirs);
    const float* sh = shs + static_cast<long long>(i) * p.sh_coeffs * 3;
    T b[16], bx[16], by[16], bz[16];
    sh_basis<DEG>(d, b, bx, by, bz);
    constexpr int kCoef = (DEG + 1) * (DEG + 1);
    for (int c = 0; c < 3; ++c) {
      if (!(sh_eval<DEG>(sh, d, c) + 0.5 >= 0.0)) continue;
#pragma unroll
      for (int k = 0; k < kCoef; ++k) {
        const T s = sh[3 * k + c];
        gd[c][0] += bx[k] * s;
        gd[c][1] += by[k] * s;
        gd[c][2] += bz[k] * s;
      }
    }
  }

  for (int t0 = 0; t0 < k_t; t0 += kTanChunk) {
    const int nc = min(kTanChunk, k_t - t0);
    __syncthreads();
    if (threadIdx.x < 16 * nc) sdV[threadIdx.x] = dview[16 * t0 + threadIdx.x];
    __syncthreads();
    for (int t = 0; t < nc; ++t) {
      T dV[16];
      for (int k = 0; k < 16; ++k) dV[k] = sdV[16 * t + k];
      // [m, 1] dV[:, 2]: the depth's and the homogeneous w's tangent
      const T dz = dot3(m[0], m[1], m[2], dV[2], dV[6], dV[10]) + dV[14];
      T r[kPerK];
      r[2] = pose_depth ? dz : 0.0;
      if (pose_ndc) {
        // (V P)[:, 0] = V[:, 0] p00, (V P)[:, 1] = V[:, 1] p11
        const T dhx = dot3(m[0], m[1], m[2], dV[0] * p00, dV[4] * p00,
                           dV[8] * p00) + dV[12] * p00;
        const T dhy = dot3(m[0], m[1], m[2], dV[1] * p11, dV[5] * p11,
                           dV[9] * p11) + dV[13] * p11;
        const T dw = g.vis ? dz : 0.0;
        r[0] = (dhx - dw * vx) / g.den * half_w;
        r[1] = (dhy - dw * vy) / g.den * half_h;
      } else {
        r[0] = r[1] = 0.0;
      }

      if constexpr (COV) {
        // the view point's tangent: [m, 1] dV[:, :3]
        const T dt0 = dot3(m[0], m[1], m[2], dV[0], dV[4], dV[8]) + dV[12];
        const T dt1 = dot3(m[0], m[1], m[2], dV[1], dV[5], dV[9]) + dV[13];
        const T dtz = g.vis ? dz : 0.0;
        const T duc0 = in0 ? (dt0 - dtz * g.u0) / g.tz : 0.0;
        const T duc1 = in1 ? (dt1 - dtz * g.u1) / g.tz : 0.0;
        const T dtx = dtz * g.uc0 + duc0 * g.tz;
        const T dty = dtz * g.uc1 + duc1 * g.tz;
        // d(1 / u) = -du (1 / u)^2
        const T dinv = -dtz * g.inv_tz2;
        const T dinv2 = 2.0 * (g.inv_tz * dinv);
        const T dj00 = p.fx * dinv, dj11 = p.fy * dinv;
        const T dj02 = (-p.fx * dtx) * g.inv_tz2 + (-p.fx * g.tx) * dinv2;
        const T dj12 = (-p.fy * dty) * g.inv_tz2 + (-p.fy * g.ty) * dinv2;
        // m0[b] = j00 V[b][0] + j02 V[b][2], m1[b] = j11 V[b][1] + j12 V[b][2]
        T dm0[3], dm1[3];
        for (int b = 0; b < 3; ++b) {
          dm0[b] = (dj00 * V[4 * b] + dj02 * V[4 * b + 2]) +
                   (g.j00 * dV[4 * b] + g.j02 * dV[4 * b + 2]);
          dm1[b] = (dj11 * V[4 * b + 1] + dj12 * V[4 * b + 2]) +
                   (g.j11 * dV[4 * b + 1] + g.j12 * dV[4 * b + 2]);
        }
        // a = m0 . S m0, b = m0 . S m1, c = m1 . S m1
        T dsm0[3], dsm1[3];
        for (int a = 0; a < 3; ++a) {
          dsm0[a] = (g.S[sym(a, 0)] * dm0[0] + g.S[sym(a, 1)] * dm0[1]) +
                    g.S[sym(a, 2)] * dm0[2];
          dsm1[a] = (g.S[sym(a, 0)] * dm1[0] + g.S[sym(a, 1)] * dm1[1]) +
                    g.S[sym(a, 2)] * dm1[2];
        }
        auto dot = [](const T* u, const T* w) {
          return (u[0] * w[0] + u[1] * w[1]) + u[2] * w[2];
        };
        const T da = dot(dm0, g.sm0) + dot(g.m0, dsm0);
        const T db = dot(dm0, g.sm1) + dot(g.m0, dsm1);
        const T dc = dot(dm1, g.sm1) + dot(g.m1, dsm1);
        // conic = (c, -b, a) / det, det = a c - b^2 where non-zero
        const T ddet =
            g.det_ok ? (dc * g.a + da * g.c) - (db * g.b + db * g.b) : 0.0;
        const T dinv_det = -ddet * (g.inv_det * g.inv_det);
        r[3] = dinv_det * g.c + dc * g.inv_det;
        r[4] = -(dinv_det * g.b + db * g.inv_det);
        r[5] = dinv_det * g.a + da * g.inv_det;
      } else if constexpr (DEG > 0) {
        r[3] = r[4] = r[5] = 0.0;
      }

      if constexpr (DEG > 0) {
        // dirs = m + V[:3, :3] V[3, :3]: d dirs = dV[:3, :3] V[3, :3] +
        // V[:3, :3] dV[3, :3]; d unit = (d dirs - d (d . d dirs)) / n, or
        // d dirs where the direction is 0 (its norm's guard)
        T dd[3];
        for (int a = 0; a < 3; ++a)
          dd[a] = ((dV[4 * a] * V[12] + dV[4 * a + 1] * V[13]) +
                   dV[4 * a + 2] * V[14]) +
                  ((V[4 * a] * dV[12] + V[4 * a + 1] * dV[13]) +
                   V[4 * a + 2] * dV[14]);
        if (n > 0.0) {
          const T dn = (d[0] * dd[0] + d[1] * dd[1]) + d[2] * dd[2];
          for (int a = 0; a < 3; ++a) dd[a] = (dd[a] - dn * d[a]) / n;
        }
        for (int c = 0; c < 3; ++c)
          r[6 + c] = (gd[c][0] * dd[0] + gd[c][1] * dd[1]) + gd[c][2] * dd[2];
      }
      float* o = stage + (threadIdx.x * nc + t) * kPerK;
#pragma unroll
      for (int j = 0; j < kPerK; ++j) o[j] = static_cast<float>(r[j]);
    }
    // the chunk's columns of the block's rows
    __syncthreads();
    const int w = kPerK * nc;
    float* dst = out + static_cast<long long>(i0) * (kPerK * k_t) + kPerK * t0;
    for (int e = threadIdx.x; e < rows * w; e += kTanThreads)
      dst[static_cast<long long>(e / w) * (kPerK * k_t) + e % w] = stage[e];
  }
}

Params params_of(const float* fpar, const int* ipar) {
  static_assert(sizeof(Params) == (kNF + kNI) * 4, "Params is packed");
  Params p;
  std::memcpy(&p, fpar, kNF * 4);
  std::memcpy(reinterpret_cast<char*>(&p) + kNF * 4, ipar, kNI * 4);
  return p;
}

}  // namespace

// fpar[14], ipar[10]: host arrays in Params' order.  Null pointers for the
// inputs a call lacks (scales and rots with cov_pre, shs with col_pre,
// m2d without the offset).
extern "C" int preprocess_fwd(const float* means, const float* scales,
                              const float* rots, const float* opac,
                              const float* shs, const float* cov_pre,
                              const float* col_pre, const float* m2d,
                              const float* view, const float* fpar,
                              const int* ipar, float* feat, int* ints,
                              bool* mask, void* stream) {
  const Params p = params_of(fpar, ipar);
  if (p.P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p.P + kThreads - 1) / kThreads;
  const int deg = (p.flags & kColPre) ? -1 : p.sh_degree;
#define PREP_FWD(D)                                                         \
  preprocess_fwd_kernel<D><<<blocks, kThreads, 0, s>>>(                     \
      means, scales, rots, opac, shs, cov_pre, col_pre, m2d, view, p, feat, \
      ints, mask)
  switch (deg) {
    case -1: PREP_FWD(-1); break;
    case 0: PREP_FWD(0); break;
    case 1: PREP_FWD(1); break;
    case 2: PREP_FWD(2); break;
    case 3: PREP_FWD(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PREP_FWD
  return static_cast<int>(cudaGetLastError());
}

// The gradients whose pointers are given, each written whole; with
// kWantView in ipar's flags, part [nblocks, 16] is scratch and d_view [16]
// the view matrix's gradient.
extern "C" int preprocess_bwd(const float* means, const float* scales,
                              const float* rots, const float* shs,
                              const float* cov_pre, const float* view,
                              const float* fpar, const int* ipar,
                              const float* dfeat, float* d_means,
                              float* d_scales, float* d_rots, float* d_opac,
                              float* d_shs, float* d_cov, float* d_col,
                              float* d_m2d, float* part, float* d_view,
                              void* stream) {
  const Params p = params_of(fpar, ipar);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p.P + kThreads - 1) / kThreads;
  const bool want_view = p.flags & kWantView;
  if (want_view && (part == nullptr || d_view == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.P > 0) {
    const int deg = (p.flags & kColPre) ? -1 : p.sh_degree;
#define PREP_BWD(D)                                                          \
  preprocess_bwd_kernel<D><<<blocks, kThreads, 0, s>>>(                      \
      means, scales, rots, shs, cov_pre, view, p, dfeat, d_means, d_scales,  \
      d_rots, d_opac, d_shs, d_cov, d_col, d_m2d, part)
    switch (deg) {
      case -1: PREP_BWD(-1); break;
      case 0: PREP_BWD(0); break;
      case 1: PREP_BWD(1); break;
      case 2: PREP_BWD(2); break;
      case 3: PREP_BWD(3); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PREP_BWD
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (want_view)
    preprocess_view_kernel<<<1, kThreads, 0, s>>>(part, blocks, d_view);
  return static_cast<int>(cudaGetLastError());
}

// out [P, per_k * k_t]: the columns of k_t tangents dview [k_t, 16] (see
// preprocess_tangent_kernel).  The colour columns come with kPoseSh, SH
// (no kColPre) and sh_degree >= 1; per_k must be the columns that the
// flags give (3, 6 or 9), else nothing runs.
extern "C" int preprocess_tangents(const float* means, const float* scales,
                                   const float* rots, const float* shs,
                                   const float* cov_pre, const float* view,
                                   const float* dview, const float* fpar,
                                   const int* ipar, int k_t, int per_k,
                                   float* out, void* stream) {
  const Params p = params_of(fpar, ipar);
  const bool cov = p.flags & kPoseCov;
  const int deg = ((p.flags & kPoseSh) && !(p.flags & kColPre) && shs)
                      ? p.sh_degree : 0;
  if (per_k != (deg > 0 ? 9 : (cov ? 6 : 3)) || k_t < 1 || deg > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p.P + kTanThreads - 1) / kTanThreads;
#define PREP_TAN(C, D)                                                  \
  preprocess_tangent_kernel<C, D><<<blocks, kTanThreads, 0, s>>>(       \
      means, scales, rots, shs, cov_pre, view, dview, p, k_t, out)
  switch (deg * 2 + (cov ? 1 : 0)) {
    case 0: PREP_TAN(false, 0); break;
    case 1: PREP_TAN(true, 0); break;
    case 2: PREP_TAN(false, 1); break;
    case 3: PREP_TAN(true, 1); break;
    case 4: PREP_TAN(false, 2); break;
    case 5: PREP_TAN(true, 2); break;
    case 6: PREP_TAN(false, 3); break;
    case 7: PREP_TAN(true, 3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PREP_TAN
  return static_cast<int>(cudaGetLastError());
}
