// What the tile kernels share: the launch parameters, the forward's pixels
// per thread, the expressions of the test that decides, for one (instance,
// pixel) pair, whether the instance is skipped, contributes, or ends the
// pixel, and the culling box outside which that test always skips.  Every
// kernel evaluates the test in this one expression order, so the backward
// walks exactly the pairs the forward blended: a pixel on a threshold
// terminates at the same instance in every pass.

#pragma once

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
};

// Pixel k of this thread is tile pixel threadIdx.x + k * kThreads.
// Returns whether it lies in the tile and in the image.
__device__ __forceinline__ bool pixel_of(const Params& prm, int t, int k,
                                         float& px, float& py) {
  const int q = prm.tile_w * prm.tile_h;
  const int qi = threadIdx.x + k * kThreads;
  const int pxi = (t % prm.tiles_x) * prm.tile_w + qi % prm.tile_w;
  const int pyi = (t / prm.tiles_x) * prm.tile_h + qi / prm.tile_w;
  px = (float)pxi;
  py = (float)pyi;
  return qi < q && pxi < prm.width && pyi < prm.height;
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

// Relative slack of cull_box against float32 rounding, and its absolute
// widening in pixels (render.py's cull_extent mirrors both).
constexpr float kCullRel = 2e-5f;
constexpr float kCullAbs = 1e-2f;

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
__device__ __forceinline__ float4 cull_box(const float* f, float alpha_min) {
  const float x = f[0], y = f[1], op = f[5];
  const float inf = CUDART_INF_F;
  if (op < alpha_min) return make_float4(inf, -inf, inf, -inf);
  const float tau2 =
      2.f * logf(op / alpha_min) * (1.f + kCullRel) + kCullRel;
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

// Whether a culling box meets the pixel box [x0, x1] x [y0, y1] (an empty
// pixel box, x0 > x1, meets nothing).
__device__ __forceinline__ bool box_meets(const float4& b, float x0, float x1,
                                          float y0, float y1) {
  return !(b.x > x1 || b.y < x0 || b.z > y1 || b.w < y0);
}

}  // namespace blend
