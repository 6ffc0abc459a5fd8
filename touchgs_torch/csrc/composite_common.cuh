// Shared layout constants and the per-(entry, pixel) alpha of the tile
// compositing kernels (composite_fwd.cu, composite_bwd.cu).
//
// Attribute row layout (16 floats per slot), as packed by
// touchgs_torch/ops/rasterize_cuda.py::_pack_attrs:
//   [mx, my, ca~, cb~, cc~, op, z, r, g, b, 0 x 6]
// with ca~ = ½·log2(e)·conic_a, cb~ = log2(e)·conic_b, cc~ = ½·log2(e)·conic_c,
// so σ̃ = ca~·dx² + cc~·dy² + cb~·dx·dy = log2(e)·σ and α = op·2^(−σ̃).
//
// Forward stack layout per tile (8 rows of npix floats):
//   [R, G, B, D, A, T, chunks_done, 0]
#pragma once

#include <cuda_runtime.h>

namespace touchgs {

constexpr int kA = 16;
constexpr int kMX = 0, kMY = 1, kCA = 2, kCB = 3, kCC = 4, kOP = 5, kZ = 6,
              kR = 7, kG = 8, kB = 9;
constexpr int kRowT = 5, kRowDone = 6, kRows = 8;
constexpr float kSatEps = 1e-4f;  // tile-wide saturation threshold
constexpr float kLn2 = 0.6931471805599453f;

// α for one (entry, pixel), exactly the JAX kernels' `_alpha_exact`:
// dx, dy are exact differences from the pixel centre; kept where σ̃ ≥ 0 and
// α ≥ alpha_thr, clipped at alpha_clip.  exp2f is the accurate CUDA math
// function (the build passes no fast-math flag).
//
// σ̃ and op·2^(−σ̃) are rounded after every operation (__fmul_rn and
// __fadd_rn are never contracted into FMAs), in the order the plain PyTorch
// version evaluates them.  α is then bit-identical between the two on the
// card, so a pair sitting on the 1/255 keep threshold cannot fall on
// different sides of it, and the tile-wide exit gate reads the same T.
// eval_sigma is its first half, σ̃ with dx and dy, which K5's noexp mode
// (anatomy_variants.cu) shares.
__device__ __forceinline__ float eval_sigma(const float* a, float px,
                                            float py, float ox, float oy,
                                            float& dx, float& dy) {
  const float mx = a[kMX] - ox;
  const float my = a[kMY] - oy;
  dx = px - mx;
  dy = py - my;
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a[kCA], dx), dx),
                             __fmul_rn(__fmul_rn(a[kCC], dy), dy)),
                   __fmul_rn(__fmul_rn(a[kCB], dx), dy));
}

__device__ __forceinline__ void eval_alpha(const float* a, float px, float py,
                                           float ox, float oy,
                                           float alpha_clip, float alpha_thr,
                                           float& alpha, float& opx,
                                           float& expns, float& dx,
                                           float& dy) {
  const float sigma = eval_sigma(a, px, py, ox, oy, dx, dy);
  expns = exp2f(-sigma);
  opx = __fmul_rn(a[kOP], expns);
  alpha = fminf(alpha_clip, opx);
  if (!(sigma >= 0.f && alpha >= alpha_thr)) alpha = 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace touchgs
