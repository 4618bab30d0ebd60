// What the tile kernels share: the launch parameters, the pixel map and
// the staging of a round that render_fwd and render_bwd both use, the
// expressions of the test that decides, for one (instance, pixel) pair,
// whether the instance is skipped, contributes, or ends the pixel, and the
// culling box outside which that test always skips.  Every kernel
// evaluates the test in this one expression order, so the backward walks
// exactly the pairs the forward blended: a pixel on a threshold terminates
// at the same instance in every pass.  The exponent has two forms, the
// direct one (splat_power) and the basis one (splat_power_basis, the JAX
// package's splat_basis_power); a kernel instantiated for one form takes
// it in every pass.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace blend {

constexpr int kThreads = 256;  // threads per tile block
constexpr int kFeat = 11;      // floats per instance row:
                               // x, y, A, B, C, opacity, r, g, b, depth,
                               // depth_sgview

struct Params {
  int tiles_x, tile_w, tile_h, width, height;
  float alpha_cap, alpha_min, t_terminate;
  int tile0;  // global index of the launch's first tile: block t renders
              // tile tile0 + t of the image (its pixel origin); every
              // tile-major array of the launch is indexed by t
};

constexpr int kFeatPad = 12;   // floats of a feature row staged in shared
                               // memory: three 16-byte vectors

// Pixels a thread for a tile of q pixels in a block of kThreads (0: the
// tile is too large).
__host__ __device__ inline int pixels_per_thread(int q) {
  if (q <= kThreads) return 1;
  if (q <= 2 * kThreads) return 2;
  if (q <= 4 * kThreads) return 4;
  return 0;
}

// Tile pixel k of lane `lane` of warp `warp` (q when it has none), for PPT
// pixels a thread: the map of render_fwd and render_bwd (render.py's
// bwd_pixel_map mirrors it, render_bwd_pixel_map exports it).  When the
// tile divides into 8x4 patches, lane l owns pixel (l % 8, l / 8) of each
// of its warp's PPT sub-patches: with four pixels a thread and an even
// number of patches across and down, the 2x2 block of patches
// (bx, by) = (warp % (across / 2), warp / (across / 2)), a 16x8 region;
// otherwise the PPT consecutive patches warp * PPT + k, row-major.  Any
// other tile takes pixel threadIdx.x + k * kThreads.
template <int PPT>
__host__ __device__ __forceinline__ int patch_pixel(int tile_w, int tile_h,
                                                    int warp, int lane,
                                                    int k) {
  const int q = tile_w * tile_h;
  if ((tile_w & 7) != 0 || (tile_h & 3) != 0) {
    const int qi = warp * 32 + lane + k * kThreads;
    return qi < q ? qi : q;
  }
  const int across = tile_w >> 3, down = tile_h >> 2;
  int pxp, pyp;
  if (PPT == 4 && (across & 1) == 0 && (down & 1) == 0) {
    const int half = across >> 1;
    pxp = 2 * (warp % half) + (k & 1);
    pyp = 2 * (warp / half) + (k >> 1);
  } else {
    const int patch = warp * PPT + k;
    pxp = patch % across;
    pyp = patch / across;
  }
  if (pyp >= down) return q;
  return (pyp * 4 + (lane >> 3)) * tile_w + pxp * 8 + (lane & 7);
}

// Start the copies of feature rows [b0, b0 + n) into a stage of a ring in
// shared memory, 4 bytes each into rows padded to kFeatPad floats, and
// commit them as one group (all kThreads threads take part).
__device__ __forceinline__ void stage_features(float* dst,
                                               const float* __restrict__ feat,
                                               int b0, int n) {
  const float* src = feat + (size_t)b0 * kFeat;
  for (int i = threadIdx.x; i < n * kFeat; i += kThreads) {
    const int r = i / kFeat;
    __pipeline_memcpy_async(dst + r * kFeatPad + (i - r * kFeat), src + i,
                            sizeof(float));
  }
  __pipeline_commit();
}

// The fields of one staged instance that the test reads, loaded into
// registers once per instance (not once per pixel).
struct Splat {
  float x, y, A, B, C, op;
};

__device__ __forceinline__ Splat load_splat(const float* f) {
  return Splat{f[0], f[1], f[2], f[3], f[4], f[5]};
}

// The per-pair test, in one expression order for both kernels:
//   dx = x - px, dy = y - py, power = splat_power(g, dx, dy)
//   skip if power > 0
//   G = expf(power), alpha = splat_alpha(g, G, prm); skip if alpha < alpha_min
//   test_T = T * (1 - alpha); the pixel ends, before accumulating, once
//   test_T < t_terminate.
// Each kernel writes the three tests out in its own loop, as `continue`s:
// an inlined helper that returned a step code instead made the forward
// kernel slower on an H100 (same outputs, other branch layout).
__device__ __forceinline__ float splat_power(const Splat& g, float dx,
                                             float dy) {
  return -0.5f * (g.A * dx * dx + g.C * dy * dy) - g.B * dx * dy;
}

__device__ __forceinline__ float splat_alpha(const Splat& g, float G,
                                             const Params& prm) {
  return fminf(prm.alpha_cap, g.op * G);
}

// The basis form of the exponent (cfg.splat_basis_power): the quadratic
// expanded about the tile's corner (ox, oy), six coefficients a splat
//   xg = x - ox, yg = y - oy
//   c0 = -0.5 A xg^2 - 0.5 C yg^2 - B xg yg,  c1 = A xg + B yg,
//   c2 = C yg + B xg,  c3 = -0.5 A,  c4 = -0.5 C,  c5 = -B
// (the JAX package's blend.splat_power, in its operand order) against the
// pixel basis [1, qx, qy, qx^2, qy^2, qx qy] of the tile-local integer
// coordinates (qx, qy) (exact in float32, and so are their products below
// 2^12 px), summed left to right: five products and five sums a pair.  The
// plain version (blend.splat_power with a basis) takes the same
// operations in the same order, so the two are bit-equal.  The corner is
// the image tile's, so a launch at any tile0 gives the same numbers.
struct Basis {
  float c0, c1, c2, c3, c4, c5;
};

__device__ __forceinline__ Basis splat_basis(const Splat& g, float ox,
                                             float oy) {
  const float xg = g.x - ox;
  const float yg = g.y - oy;
  return Basis{-0.5f * g.A * xg * xg - 0.5f * g.C * yg * yg - g.B * xg * yg,
               g.A * xg + g.B * yg,
               g.C * yg + g.B * xg,
               -0.5f * g.A,
               -0.5f * g.C,
               -g.B};
}

// A pixel's basis terms, made once a pixel and kept in registers: its
// tile-local coordinates qx = px - ox, qy = py - oy and their products.
struct PixelBasis {
  float qx, qy, qxx, qyy, qxy;
};

__device__ __forceinline__ PixelBasis pixel_basis(float px, float py,
                                                  float ox, float oy) {
  const float qx = px - ox;
  const float qy = py - oy;
  return PixelBasis{qx, qy, qx * qx, qy * qy, qx * qy};
}

__device__ __forceinline__ float splat_power_basis(const Basis& c,
                                                   const PixelBasis& q) {
  return c.c0 + c.c1 * q.qx + c.c2 * q.qy + c.c3 * q.qxx + c.c4 * q.qyy +
         c.c5 * q.qxy;
}

// Relative slack of cull_box against float32 rounding, and its absolute
// widening in pixels (render.py's cull_extent mirrors both).
constexpr float kCullRel = 2e-5f;
constexpr float kCullAbs = 1e-2f;
// The basis form's rounding, relative to S, the sum of the magnitudes of
// every term of its expansion over the tile's pixels:
//   S = 0.5 |A| X^2 + 0.5 |C| Y^2 + |B| X Y,
//   X = |x - ox| + tile_w - 1,  Y = |y - oy| + tile_h - 1.
// c0 is three rounded products summed, c1 and c2 two, and the power six
// rounded products summed: the computed power lies within about
// (gamma_5 + gamma_6) S ~ 11 u S of the exact quadratic about the rounded
// xg, yg (u = 2^-24; the rounding of xg, yg itself moves the centre by at
// most u |x - ox|, under 1e-3 px for images below 16,000 px, inside
// kCullAbs).  kBasisRel = 1e-6 (~17 u) covers that with room for the
// rounding of S.
constexpr float kBasisRel = 1e-6f;

// The box (x0, x1, y0, y1) outside which the splat's alpha is below
// alpha_min at every pixel.  alpha >= alpha_min needs
// power >= -tau, tau = ln(opacity / alpha_min), i.e. the quadratic form
// A dx^2 + 2 B dx dy + C dy^2 <= 2 tau, whose ellipse has the half-extents
// sqrt(2 tau C / det) and sqrt(2 tau A / det), det = A C - B^2.  The
// kernels' float32 power, expf and product each round; the box is taken
// for the form with A, C shrunk and |B| grown by kCullRel and tau grown by
// kCullRel, far more than that rounding, then widened by kCullRel and
// kCullAbs pixels.  Empty when opacity < alpha_min (then opacity * G <
// alpha_min for every G <= 1); unbounded when the conic is not positive
// definite.  Every comparison is written so that a NaN leaves the box
// unbounded, as the per-pair test would not skip such a pair either.  So a
// kernel may skip every pair whose pixel lies outside the box: the blend
// would skip it too.
//
// The basis form (kBasis) rounds more than the direct one: its box takes
// tau grown by kBasisRel S for the tile at (ox, oy) with qxm = tile_w - 1
// and qym = tile_h - 1, so a pair outside it has a basis power below
// -tau(opacity) as well.  It is the tile's box, made in each tile's block.
template <bool kBasis>
__device__ __forceinline__ float4 cull_box_of(const float* f, float alpha_min,
                                              float ox, float oy, float qxm,
                                              float qym) {
  const float x = f[0], y = f[1], op = f[5];
  const float inf = CUDART_INF_F;
  if (op < alpha_min) return make_float4(inf, -inf, inf, -inf);
  float tau2;
  if constexpr (kBasis) {
    const float X = fabsf(x - ox) + qxm;
    const float Y = fabsf(y - oy) + qym;
    const float s = 0.5f * fabsf(f[2]) * X * X + 0.5f * fabsf(f[4]) * Y * Y +
                    fabsf(f[3]) * X * Y;
    tau2 = 2.f * (logf(op / alpha_min) + kBasisRel * s) * (1.f + kCullRel) +
           kCullRel;
  } else {
    tau2 = 2.f * logf(op / alpha_min) * (1.f + kCullRel) + kCullRel;
  }
  const float a = f[2] * (1.f - kCullRel);
  const float c = f[4] * (1.f - kCullRel);
  const float b = fabsf(f[3]) * (1.f + kCullRel);
  const float det = a * c - b * b;
  if (!(a > 0.f && c > 0.f && det > 0.f)) {
    return make_float4(-inf, inf, -inf, inf);
  }
  const float rx = sqrtf(tau2 * c / det) * (1.f + kCullRel) + kCullAbs;
  const float ry = sqrtf(tau2 * a / det) * (1.f + kCullRel) + kCullAbs;
  return make_float4(x - rx, x + rx, y - ry, y + ry);
}

__device__ __forceinline__ float4 cull_box(const float* f, float alpha_min) {
  return cull_box_of<false>(f, alpha_min, 0.f, 0.f, 0.f, 0.f);
}

// Whether a culling box meets the pixel box [x0, x1] x [y0, y1] (an empty
// pixel box, x0 > x1, meets nothing).
__device__ __forceinline__ bool box_meets(const float4& b, float x0, float x1,
                                          float y0, float y1) {
  return !(b.x > x1 || b.y < x0 || b.z > y1 || b.w < y0);
}

}  // namespace blend
