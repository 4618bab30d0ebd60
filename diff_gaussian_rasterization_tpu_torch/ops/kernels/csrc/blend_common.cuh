// What the forward and backward tile kernels share: the launch parameters,
// each thread's pixels, and the expressions of the test that decides, for
// one (instance, pixel) pair, whether the instance is skipped, contributes,
// or ends the pixel.  Both kernels evaluate that test in this one
// expression order, so the backward walks exactly the pairs the forward
// blended: a pixel on a threshold terminates at the same instance in both
// passes.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace blend
