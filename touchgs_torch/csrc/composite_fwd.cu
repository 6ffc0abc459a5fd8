// K2: front-to-back tile compositing, forward.
//
// Replaces touchgs_tpu/ops/rasterize_pallas.py::_make_forward_kernel
// (:248-299), launched by _forward_tiles (:488-505, the pallas_call at :500).
//
// Per tile, chunks of k_chunk entries of the front-packed attribute list are
// composited in order: α = min(alpha_clip, op·2^(−σ̃)), kept where σ̃ ≥ 0
// and α ≥ alpha_thr; w = T·α; [R, G, B, D, A] += w·[r, g, b, z, 1]; T carried.
// The whole tile stops once the max of T over its pixels, measured TWO
// chunks stale (the decision for chunk c reads the max after chunk c − 2),
// is ≤ 1e-4 — exactly the JAX kernel's gate, because the backward replays
// the recorded count (row 6 of the output).  With early_exit = 0 (the JAX
// kernel's early_exit=False, :278-279) the gate never fires: every chunk up
// to min(n_chunks, k_tile/k_chunk) is composited and counted.  The flag is a
// template parameter, so the exiting kernel's code is the same as without it.
//
// Bound on an H100: operations.  Each scanned (entry, pixel) pair costs
// about 34 fp32 operations and one exp2; the bytes are the scanned attribute
// rows and the (n_tiles, 8, npix) output.
//
// Design: one block per tile, one thread per pixel (1024 threads for the
// 32x32 tiles).  Each chunk's rows are staged once in shared memory and
// every thread walks them in order with fp32 FMAs: the K=8 contractions the
// TPU ran on its matrix unit at HIGHEST precision are plain FMAs here, never
// TF32.  Within a chunk the transmittance is T·p with p the running product
// of (1 − α), as the JAX kernel's exclusive prefix product is.  After each
// chunk a warp-shuffle max and a 32-entry shared-memory max give the
// tile-wide max of T; every thread computes the same value, so the exit
// branch is uniform.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace touchgs;

template <bool kEarlyExit>
__global__ void __launch_bounds__(1024, 1)
composite_fwd_kernel(const int* __restrict__ n_chunks,
                     const int* __restrict__ tile_ids,
                     const float* __restrict__ attrs, float* __restrict__ out,
                     int th, int tw, int k_tile, int k_chunk, int n_tx,
                     float alpha_clip, float alpha_thr) {
  extern __shared__ float s_attr[];  // k_chunk rows of kA floats
  __shared__ float s_wmax[32];
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = q & 31, warp = q >> 5, n_warps = npix >> 5;

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const float px = static_cast<float>(q % tw) + 0.5f;
  const float py = static_cast<float>(q / tw) + 0.5f;
  const int nch = min(n_chunks[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;

  float T = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_a = 0.f;
  float m1 = 1.f, m2 = 1.f;  // max T after the last and the one before
  int done = 0;
  for (int c = 0; c < nch; ++c) {
    if (kEarlyExit && !(m2 > kSatEps)) break;
    const float* src = tile_attr + static_cast<size_t>(c) * k_chunk * kA;
    for (int i = q; i < k_chunk * kA; i += npix) s_attr[i] = src[i];
    __syncthreads();

    float p = 1.f;
    for (int e = 0; e < k_chunk; ++e) {
      const float* a = s_attr + e * kA;
      float alpha, opx, expns, dx, dy;
      eval_alpha(a, px, py, ox, oy, alpha_clip, alpha_thr, alpha, opx, expns,
                 dx, dy);
      const float w = __fmul_rn(__fmul_rn(T, p), alpha);
      acc_r += w * a[kR];
      acc_g += w * a[kG];
      acc_b += w * a[kB];
      acc_d += w * a[kZ];
      acc_a += w;
      p *= 1.f - alpha;
    }
    T *= p;
    ++done;

    // also without the exit: this barrier keeps the next chunk's staging
    // from overwriting rows that other warps still read
    const float wm = warp_max(T);
    if (lane == 0) s_wmax[warp] = wm;
    __syncthreads();
    float m = s_wmax[0];
    for (int i = 1; i < n_warps; ++i) m = fmaxf(m, s_wmax[i]);
    m2 = m1;
    m1 = m;
  }

  float* o = out + static_cast<size_t>(t) * kRows * npix + q;
  o[0 * npix] = acc_r;
  o[1 * npix] = acc_g;
  o[2 * npix] = acc_b;
  o[3 * npix] = acc_d;
  o[4 * npix] = acc_a;
  o[kRowT * npix] = T;
  o[kRowDone * npix] = static_cast<float>(done);
  o[7 * npix] = 0.f;
}

}  // namespace

extern "C" int composite_fwd_launch(const int* n_chunks, const int* tile_ids,
                                    const float* attrs, float* out,
                                    int n_tiles, int th, int tw, int k_tile,
                                    int k_chunk, int n_tx, float alpha_clip,
                                    float alpha_thr, int early_exit,
                                    void* stream) {
  const int npix = th * tw;
  const size_t smem = static_cast<size_t>(k_chunk) * kA * sizeof(float);
  auto kernel = early_exit ? composite_fwd_kernel<true>
                           : composite_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_tiles > 0) {
    kernel<<<n_tiles, npix, smem, static_cast<cudaStream_t>(stream)>>>(
        n_chunks, tile_ids, attrs, out, th, tw, k_tile, k_chunk, n_tx,
        alpha_clip, alpha_thr);
  }
  return static_cast<int>(cudaGetLastError());
}
