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
// rows and the (n_tiles, 8, npix) output.  The kernel is bound by
// instruction issue: the first design, one thread per pixel in 1024-thread
// blocks, issued about 33 counted SASS instructions a pair, two-thirds of
// them the α chain before exp2 (PERF.md, the anatomy).
//
// Design: K3's thread shape.  P pixels per thread (pixels_per_thread: 4 for
// 32x32 tiles), npix / P threads a block, so several tiles are resident per
// SM.  Each chunk's rows are staged once in shared memory with mx − ox and
// my − oy already taken (stage_rows), and every thread walks them in order:
// each row is read with three 16-byte loads and serves its P pixels.  α's
// own operations and their order are the plain version's (row_alpha, in
// composite_common.cuh), so α is bit-identical to the plain version's and so are T and the exit gate's
// decisions; the R, G, B, D sums are fp32 FMAs (the K=8 contractions the
// TPU ran on its matrix unit at HIGHEST precision, never TF32).  Within a
// chunk the transmittance is T·p with p the running product of (1 − α), as
// the JAX kernel's exclusive prefix product is.  After each chunk each
// thread's max of T over its pixels, a warp-shuffle max and a shared-memory
// max over the warps give the tile-wide max; every thread computes the same
// value, so the exit branch is uniform.
//
// Any other tile shape (over 1024 pixels, or not a multiple of 32) runs the
// group kernel, composite_fwd_groups_kernel: kGroupP pixels per thread in at
// most 256 threads, the tile walked in groups of pixels (composite_common.cuh).
// Each chunk's rows are staged once and serve every group in turn; between
// groups a pixel's T and its R, G, B, D, A sums wait in its own rows of the
// output, which only its thread reads and writes.  Per pixel the arithmetic
// and its order are the register kernels', so T, chunks_done and the exit
// decisions are the plain version's; pixels past the tile's last are masked.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace touchgs;

template <bool kEarlyExit, int P>
__global__ void __launch_bounds__(1024 / P, P == 4 ? 3 : 1)
composite_fwd_kernel(const int* __restrict__ n_chunks,
                     const int* __restrict__ tile_ids,
                     const float* __restrict__ attrs, float* __restrict__ out,
                     int th, int tw, int k_tile, int k_chunk, int n_tx,
                     float alpha_clip, float alpha_thr) {
  extern __shared__ __align__(16) float s_attr[];  // k_chunk rows of kA
  __shared__ float s_wmax[32];
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int S = blockDim.x;  // threads; pixel stride
  const int npix = S * P;
  const int lane = q & 31, warp = q >> 5, n_warps = S >> 5;

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const int nch = min(n_chunks[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;

  float px[P], py[P], T[P], acc_r[P], acc_g[P], acc_b[P], acc_d[P], acc_a[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pix = q + j * S;
    px[j] = static_cast<float>(pix % tw) + 0.5f;
    py[j] = static_cast<float>(pix / tw) + 0.5f;
    T[j] = 1.f;
    acc_r[j] = acc_g[j] = acc_b[j] = acc_d[j] = acc_a[j] = 0.f;
  }
  float m1 = 1.f, m2 = 1.f;  // max T after the last and the one before
  int done = 0;
  for (int c = 0; c < nch; ++c) {
    if (kEarlyExit && !(m2 > kSatEps)) break;
    stage_rows(s_attr, tile_attr + static_cast<size_t>(c) * k_chunk * kA,
               k_chunk * kA, q, S, ox, oy);
    __syncthreads();

    float p[P];
#pragma unroll
    for (int j = 0; j < P; ++j) p[j] = 1.f;
    for (int e = 0; e < k_chunk; ++e) {
      const Row a = load_row(s_attr + e * kA);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float opx, expns, dx, dy;
        const float alpha = row_alpha(a, px[j], py[j], alpha_clip, alpha_thr,
                                      opx, expns, dx, dy);
        const float w = __fmul_rn(__fmul_rn(T[j], p[j]), alpha);
        acc_r[j] += w * a.r;
        acc_g[j] += w * a.g;
        acc_b[j] += w * a.b;
        acc_d[j] += w * a.z;
        acc_a[j] += w;
        p[j] *= 1.f - alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) T[j] *= p[j];
    float tmax = T[0];
#pragma unroll
    for (int j = 1; j < P; ++j) tmax = fmaxf(tmax, T[j]);
    ++done;

    // also without the exit: this barrier keeps the next chunk's staging
    // from overwriting rows that other warps still read
    const float wm = warp_max(tmax);
    if (lane == 0) s_wmax[warp] = wm;
    __syncthreads();
    float m = s_wmax[0];
    for (int i = 1; i < n_warps; ++i) m = fmaxf(m, s_wmax[i]);
    m2 = m1;
    m1 = m;
  }

  float* o = out + static_cast<size_t>(t) * kRows * npix + q;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float* oj = o + j * S;
    oj[0 * npix] = acc_r[j];
    oj[1 * npix] = acc_g[j];
    oj[2 * npix] = acc_b[j];
    oj[3 * npix] = acc_d[j];
    oj[4 * npix] = acc_a[j];
    oj[kRowT * npix] = T[j];
    oj[kRowDone * npix] = static_cast<float>(done);
    oj[7 * npix] = 0.f;
  }
}

template <bool kEarlyExit, int P>
__global__ void __launch_bounds__(kGroupThreads, 3)
composite_fwd_groups_kernel(const int* __restrict__ n_chunks,
                            const int* __restrict__ tile_ids,
                            const float* __restrict__ attrs,
                            float* __restrict__ out, int th, int tw,
                            int k_tile, int k_chunk, int n_tx,
                            float alpha_clip, float alpha_thr) {
  extern __shared__ __align__(16) float s_attr[];  // k_chunk rows of kA
  __shared__ float s_wmax[32];
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int S = blockDim.x;  // threads; pixel stride within a group
  const int npix = th * tw;
  const int n_groups = (npix + P * S - 1) / (P * S);
  const int lane = q & 31, warp = q >> 5, n_warps = S >> 5;

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const int nch = min(n_chunks[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;
  float* o = out + static_cast<size_t>(t) * kRows * npix;

  // rows 0..4 (the sums) start at 0, row 5 (T) at 1
  for (int g = 0; g < n_groups; ++g)
    for (int j = 0; j < P; ++j) {
      const int pix = group_pixel(g, j, q, S);
      if (pix < npix) {
        for (int r = 0; r < kRowT; ++r) o[r * npix + pix] = 0.f;
        o[kRowT * npix + pix] = 1.f;
      }
    }
  float m1 = 1.f, m2 = 1.f;  // max T after the last and the one before
  int done = 0;
  for (int c = 0; c < nch; ++c) {
    if (kEarlyExit && !(m2 > kSatEps)) break;
    stage_rows(s_attr, tile_attr + static_cast<size_t>(c) * k_chunk * kA,
               k_chunk * kA, q, S, ox, oy);
    __syncthreads();

    float tmax = 0.f;  // over this thread's pixels in the tile
    for (int g = 0; g < n_groups; ++g) {
      int pix[P];
      float px[P], py[P], T[P], acc_r[P], acc_g[P], acc_b[P], acc_d[P],
          acc_a[P], p[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        pix[j] = group_pixel(g, j, q, S);
        const bool live = pix[j] < npix;
        px[j] = static_cast<float>(pix[j] % tw) + 0.5f;
        py[j] = static_cast<float>(pix[j] / tw) + 0.5f;
        // a masked pixel carries T = 0: it adds nothing and never holds the
        // tile open
        T[j] = live ? o[kRowT * npix + pix[j]] : 0.f;
        acc_r[j] = live ? o[0 * npix + pix[j]] : 0.f;
        acc_g[j] = live ? o[1 * npix + pix[j]] : 0.f;
        acc_b[j] = live ? o[2 * npix + pix[j]] : 0.f;
        acc_d[j] = live ? o[3 * npix + pix[j]] : 0.f;
        acc_a[j] = live ? o[4 * npix + pix[j]] : 0.f;
        p[j] = 1.f;
      }
      for (int e = 0; e < k_chunk; ++e) {
        const Row a = load_row(s_attr + e * kA);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float opx, expns, dx, dy;
          const float alpha = row_alpha(a, px[j], py[j], alpha_clip,
                                        alpha_thr, opx, expns, dx, dy);
          const float w = __fmul_rn(__fmul_rn(T[j], p[j]), alpha);
          acc_r[j] += w * a.r;
          acc_g[j] += w * a.g;
          acc_b[j] += w * a.b;
          acc_d[j] += w * a.z;
          acc_a[j] += w;
          p[j] *= 1.f - alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        T[j] *= p[j];
        tmax = fmaxf(tmax, T[j]);
        if (pix[j] < npix) {
          o[0 * npix + pix[j]] = acc_r[j];
          o[1 * npix + pix[j]] = acc_g[j];
          o[2 * npix + pix[j]] = acc_b[j];
          o[3 * npix + pix[j]] = acc_d[j];
          o[4 * npix + pix[j]] = acc_a[j];
          o[kRowT * npix + pix[j]] = T[j];
        }
      }
    }
    ++done;

    // also without the exit: this barrier keeps the next chunk's staging
    // from overwriting rows that other warps still read
    const float wm = warp_max(tmax);
    if (lane == 0) s_wmax[warp] = wm;
    __syncthreads();
    float m = s_wmax[0];
    for (int i = 1; i < n_warps; ++i) m = fmaxf(m, s_wmax[i]);
    m2 = m1;
    m1 = m;
  }

  for (int g = 0; g < n_groups; ++g)
    for (int j = 0; j < P; ++j) {
      const int pix = group_pixel(g, j, q, S);
      if (pix < npix) {
        o[kRowDone * npix + pix] = static_cast<float>(done);
        o[7 * npix + pix] = 0.f;
      }
    }
}

size_t smem_bytes(int k_chunk) {
  return static_cast<size_t>(k_chunk) * kA * sizeof(float);
}

template <bool kEarlyExit>
const void* instance(int npix) {
  if (!whole_warps(npix))
    return reinterpret_cast<const void*>(
        composite_fwd_groups_kernel<kEarlyExit, kGroupP>);
  const int P = pixels_per_thread(npix);
  return P == 4   ? reinterpret_cast<const void*>(
                      composite_fwd_kernel<kEarlyExit, 4>)
         : P == 2 ? reinterpret_cast<const void*>(
                      composite_fwd_kernel<kEarlyExit, 2>)
                  : reinterpret_cast<const void*>(
                      composite_fwd_kernel<kEarlyExit, 1>);
}

const void* instance(int npix, int early_exit) {
  return early_exit ? instance<true>(npix) : instance<false>(npix);
}

}  // namespace

extern "C" int composite_fwd_launch(const int* n_chunks, const int* tile_ids,
                                    const float* attrs, float* out,
                                    int n_tiles, int th, int tw, int k_tile,
                                    int k_chunk, int n_tx, float alpha_clip,
                                    float alpha_thr, int early_exit,
                                    void* stream) {
  void* args[] = {&n_chunks, &tile_ids, &attrs,  &out,        &th,
                  &tw,       &k_tile,   &k_chunk, &n_tx,      &alpha_clip,
                  &alpha_thr};
  const int npix = th * tw;
  return launch_tiles(instance(npix, early_exit), args, n_tiles, npix,
                      smem_bytes(k_chunk), stream);
}

// launch_info of the kernel for npix-pixel tiles, k_chunk-entry chunks and
// the exit flag (variant).
extern "C" int composite_fwd_info(int npix, int k_chunk, int variant,
                                  int* out) {
  return launch_info(instance(npix, variant), npix, smem_bytes(k_chunk), out);
}
