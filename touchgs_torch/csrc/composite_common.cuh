// Shared layout constants and the per-(entry, pixel) alpha of the tile
// compositing kernels (composite_fwd.cu, composite_bwd.cu) and of K5's
// ablations of the forward (anatomy_variants.cu).
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

// Pixels per thread of K2 and K3: 4 where npix / 4 threads make whole warps,
// else 2, else 1 (every multiple of 32 takes one of them).  Thread q of the
// npix / P threads owns pixels q, q + S, …, q + (P − 1)·S with S = npix / P,
// so each of its P loads of a per-pixel row is coalesced across the warp.
// rasterize_plain.pixels_per_thread is the same rule.
__host__ __device__ constexpr int pixels_per_thread(int npix) {
  return npix % 128 == 0 ? 4 : (npix % 64 == 0 ? 2 : 1);
}

// Let `kernel` use `smem` bytes of dynamic shared memory: above 48 KB it
// must ask.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch a K2 or K3 instance for npix-pixel tiles: one block per tile of
// npix / pixels_per_thread(npix) threads.  Returns the CUDA error.
inline int launch_tiles(const void* kernel, void** args, int n_tiles,
                        int npix, size_t smem, void* stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && n_tiles > 0)
    err = cudaLaunchKernel(kernel, dim3(n_tiles),
                           dim3(npix / pixels_per_thread(npix)), args, smem,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch shape of a K2 or K3 instance for npix-pixel tiles with `smem`
// dynamic shared bytes: out = [pixels per thread, threads, registers,
// resident blocks per SM, shared bytes].  Returns the CUDA error.
inline int launch_info(const void* kernel, int npix, size_t smem, int* out) {
  const int threads = npix / pixels_per_thread(npix);
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pixels_per_thread(npix);
  out[1] = threads;
  out[2] = attr.numRegs;
  out[3] = blocks;
  out[4] = static_cast<int>(smem);
  return 0;
}

// A staged attribute row, read as three 16-byte shared-memory loads.  mx and
// my are tile-local (mx − ox, my − oy), rounded once when the chunk is
// staged (stage_rows): the same subtraction eval_sigma does per pixel.
struct Row {
  float mx, my, ca, cb, cc, op, z, r, g, b;
};

__device__ __forceinline__ Row load_row(const float* s_row) {
  const float4* v = reinterpret_cast<const float4*>(s_row);
  const float4 a = v[0], c = v[1], d = v[2];
  return Row{a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, d.x, d.y};
}

// Copy n floats of attribute rows into shared memory with mx and my made
// tile-local, so the per-entry subtraction is done once per entry, not once
// per pixel.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n,
                                           int q, int n_threads, float ox,
                                           float oy) {
  for (int i = q; i < n; i += n_threads) {
    float v = src[i];
    const int col = i % kA;
    if (col == kMX) v -= ox;
    if (col == kMY) v -= oy;
    dst[i] = v;
  }
}

// α for one (entry, pixel) of a staged row: eval_alpha's operations in its
// order, from the tile-local mx, my, so α is bit-identical to eval_alpha's.
__device__ __forceinline__ float row_alpha(const Row& a, float px, float py,
                                           float alpha_clip, float alpha_thr,
                                           float& opx, float& expns,
                                           float& dx, float& dy) {
  dx = px - a.mx;
  dy = py - a.my;
  const float sigma =
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a.ca, dx), dx),
                          __fmul_rn(__fmul_rn(a.cc, dy), dy)),
                __fmul_rn(__fmul_rn(a.cb, dx), dy));
  expns = exp2f(-sigma);
  opx = __fmul_rn(a.op, expns);
  const float alpha = fminf(alpha_clip, opx);
  return sigma >= 0.f && alpha >= alpha_thr ? alpha : 0.f;
}

}  // namespace touchgs
