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

// sh.py's constants, rounded to float32 as the composite's scalar products
// round them
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

// torch.clamp / clamp_min / clamp_max: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// packed symmetric index: (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ int sym(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}

// Sigma3D = M M^T with M = R(q) diag(s): the rotation and scales kept for
// the backward
struct Cov3 {
  float q[4];   // the quaternion R is built from (normalised or raw)
  float qn;     // its norm before normalisation (1 when off)
  float R[9];
  float s[3];
};

__device__ __forceinline__ void cov3d(const float* scales, const float* rots,
                                      int i, const Params& p, Cov3& c,
                                      float S[6]) {
  float r = rots[4 * i], x = rots[4 * i + 1], y = rots[4 * i + 2],
        z = rots[4 * i + 3];
  c.qn = 1.f;
  if (p.flags & kNormalizeQ) {
    const float n = sqrtf(((r * r + x * x) + y * y) + z * z);
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
  for (int j = 0; j < 3; ++j) c.s[j] = scales[3 * i + j] * p.scale_mod;
  float M[9];
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
__device__ __forceinline__ float dot3(float x, float y, float z, float a,
                                      float b, float c) {
  return fmaf(z, c, fmaf(y, b, x * a));
}

// The projection's intermediates, shared by the forward and the backward.
struct Proj {
  float m[3];
  float z;          // view depth (and the homogeneous w)
  bool vis;         // z > near
  float hx, hy;     // homogeneous x, y: [m, 1] (V P)[:, 0 / 1]
  float den;        // (vis ? z : 1) + w_eps
  float t0, t1, tz; // view point, tz = 1 behind the near plane
  float u0, u1, uc0, uc1, tx, ty, inv_tz, inv_tz2;
  float j00, j02, j11, j12;
  float m0[3], m1[3];   // J W rows
  float S[6];           // Sigma3D, packed
  float sm0[3], sm1[3]; // Sigma m0, Sigma m1
  float a, b, c;        // Sigma2D + lowpass
  float det, inv_det;
  bool det_ok;
};

__device__ __forceinline__ void project(const float* means, const float* V,
                                        int i, const Params& p, Proj& g) {
  const float mx = means[3 * i], my = means[3 * i + 1],
              mz = means[3 * i + 2];
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

  // compute_cov2d
  g.t0 = dot3(mx, my, mz, V[0], V[4], V[8]) + V[12];
  g.t1 = dot3(mx, my, mz, V[1], V[5], V[9]) + V[13];
  g.tz = g.vis ? g.z : 1.f;
  g.u0 = g.t0 / g.tz;
  g.u1 = g.t1 / g.tz;
  g.uc0 = clampf(g.u0, -p.limx, p.limx);
  g.uc1 = clampf(g.u1, -p.limy, p.limy);
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
__device__ __forceinline__ float sh_dir(const float m[3], const float* V,
                                        float d[3], float dirs[3]) {
  for (int a = 0; a < 3; ++a) {
    const float cp = -((V[4 * a] * V[12] + V[4 * a + 1] * V[13]) +
                       V[4 * a + 2] * V[14]);
    dirs[a] = m[a] - cp;
  }
  const float n =
      sqrtf((dirs[0] * dirs[0] + dirs[1] * dirs[1]) + dirs[2] * dirs[2]);
  const float den = n > 0.f ? n : 1.f;
  for (int a = 0; a < 3; ++a) d[a] = dirs[a] / den;
  return n;
}

// The SH basis of degree D at d: values b[k] and their derivatives by x,
// y, z (bx, by, bz), k < (D + 1)^2.
template <int D>
__device__ __forceinline__ void sh_basis(const float d[3], float b[16],
                                         float bx[16], float by[16],
                                         float bz[16]) {
  const float x = d[0], y = d[1], z = d[2];
  for (int k = 0; k < 16; ++k) b[k] = bx[k] = by[k] = bz[k] = 0.f;
  b[0] = kC0;
  if (D > 0) {
    b[1] = -kC1 * y; by[1] = -kC1;
    b[2] = kC1 * z;  bz[2] = kC1;
    b[3] = -kC1 * x; bx[3] = -kC1;
  }
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC20 * xy; bx[4] = kC20 * y; by[4] = kC20 * x;
    b[5] = kC21 * yz; by[5] = kC21 * z; bz[5] = kC21 * y;
    b[6] = kC22 * ((2.f * zz - xx) - yy);
    bx[6] = -2.f * kC22 * x; by[6] = -2.f * kC22 * y;
    bz[6] = 4.f * kC22 * z;
    b[7] = kC23 * xz; bx[7] = kC23 * z; bz[7] = kC23 * x;
    b[8] = kC24 * (xx - yy); bx[8] = 2.f * kC24 * x;
    by[8] = -2.f * kC24 * y;
    if (D > 2) {
      b[9] = (kC30 * y) * (3.f * xx - yy);
      bx[9] = 6.f * kC30 * xy; by[9] = 3.f * kC30 * (xx - yy);
      b[10] = (kC31 * xy) * z;
      bx[10] = kC31 * yz; by[10] = kC31 * xz; bz[10] = kC31 * xy;
      b[11] = (kC32 * y) * ((4.f * zz - xx) - yy);
      bx[11] = -2.f * kC32 * xy;
      by[11] = kC32 * ((4.f * zz - xx) - 3.f * yy);
      bz[11] = 8.f * kC32 * yz;
      b[12] = (kC33 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      bx[12] = -6.f * kC33 * xz; by[12] = -6.f * kC33 * yz;
      bz[12] = kC33 * ((6.f * zz - 3.f * xx) - 3.f * yy);
      b[13] = (kC34 * x) * ((4.f * zz - xx) - yy);
      bx[13] = kC34 * ((4.f * zz - 3.f * xx) - yy);
      by[13] = -2.f * kC34 * xy; bz[13] = 8.f * kC34 * xz;
      b[14] = (kC35 * z) * (xx - yy);
      bx[14] = 2.f * kC35 * xz; by[14] = -2.f * kC35 * yz;
      bz[14] = kC35 * (xx - yy);
      b[15] = (kC36 * x) * (xx - 3.f * yy);
      bx[15] = 3.f * kC36 * (xx - yy); by[15] = -6.f * kC36 * xy;
    }
  }
}

// sh.eval_sh before its clamp, channel c, in its order of operations
template <int D>
__device__ __forceinline__ float sh_eval(const float* sh, const float d[3],
                                         int c) {
  const float x = d[0], y = d[1], z = d[2];
  auto k = [&](int i) { return sh[3 * i + c]; };
  float r = kC0 * k(0);
  if (D > 0) r = ((r - (kC1 * y) * k(1)) + (kC1 * z) * k(2)) - (kC1 * x) * k(3);
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    r = ((((r + (kC20 * xy) * k(4)) + (kC21 * yz) * k(5)) +
          (kC22 * ((2.f * zz - xx) - yy)) * k(6)) +
         (kC23 * xz) * k(7)) +
        (kC24 * (xx - yy)) * k(8);
    if (D > 2) {
      r = ((((((r + ((kC30 * y) * (3.f * xx - yy)) * k(9)) +
               ((kC31 * xy) * z) * k(10)) +
              ((kC32 * y) * ((4.f * zz - xx) - yy)) * k(11)) +
             ((kC33 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy)) * k(12)) +
            ((kC34 * x) * ((4.f * zz - xx) - yy)) * k(13)) +
           ((kC35 * z) * (xx - yy)) * k(14)) +
          ((kC36 * x) * (xx - 3.f * yy)) * k(15);
    }
  }
  return r;
}

__device__ __forceinline__ void load_view(const float* view, float V[16]) {
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
  Proj g;
  if (p.flags & kCovPre) {
    for (int k = 0; k < 6; ++k) g.S[k] = cov_pre[6 * i + k];
  } else {
    Cov3 c3;
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
    Proj g;
    Cov3 c3;
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
