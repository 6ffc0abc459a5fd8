// K5: ablations of the forward compositing kernel (K2, composite_fwd.cu),
// for attributing its time to its pieces.
//
// Replaces tools/exp_kernel_anatomy.py::make_variant (:78-135, the
// pallas_call at :132).  Every mode scans each tile's full list, chunk by
// chunk up to min(n_chunks, k_tile/k_chunk), with no early exit, and writes
// two rows per tile, out = (n_tiles, 2, npix) = [Σ-row, T]:
//
//   full        Σ w, w = T·p·α, with the R, G, B and D accumulations of K2
//               kept alive (the TPU kernel computed all of Vᵀw on its matrix
//               unit and kept row A); T carried
//   no_mxu      Σ w only; T carried
//   alpha_only  Σ α; T stays 1
//   noexp       Σ α with exp2 replaced by 1 − 0.25·σ̃ under the same mask;
//               T stays 1
//
// The pixel centres, the pre-scaled conics, the thresholds and the rounding
// of σ̃ and α are K2's (eval_sigma/eval_alpha in composite_common.cuh), and
// the file is built with K2's flags, so the differences between the modes'
// times attribute K2's time.
//
// fp32 operations per (entry, pixel), counted from this source (each
// +, −, ×, unary −, min, compare, && and select is one, exp2f is one; an
// FMA counts two, as the card's 67 TFLOP/s peak counts it):
//   α (eval_alpha): mx, my 2; dx, dy 2; σ̃ 8; −σ̃ 1; exp2f 1; op·e 1; min 1;
//   mask 4 (σ̃ ≥ 0, α ≥ thr, &&, select)                           = 20
//   alpha_only: α + Σ                                              = 21
//   noexp: α with (−σ̃, exp2f) replaced by (0.25·σ̃, 1 −) + Σ         = 21
//   no_mxu: α + w = (T·p)·α 2 + Σ 1 + p ·= (1 − α) 2               = 25
//   full: no_mxu + R, G, B, D += w·v 8                             = 33
// (ops/anatomy.py OPS_PER_PAIR holds the same table.)
//
// Bound on an H100: operations, as K2's.
//
// Design: K2's.  One block per tile, one thread per pixel; each chunk's rows
// are staged once in shared memory and every thread walks them in order.
// The trap in `full`: it stores only ΣA, so the compiler would delete the R,
// G, B and D accumulations and `full` would time `no_mxu`.  They are stored
// into a scratch output (n_tiles, 4, npix) that the wrapper allocates and
// drops, so their FMAs stay in the code.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace touchgs;

enum Mode : int { kFull = 0, kNoMxu = 1, kAlphaOnly = 2, kNoExp = 3 };

template <int kMode>
__global__ void __launch_bounds__(1024, 1)
anatomy_kernel(const int* __restrict__ n_chunks,
               const int* __restrict__ tile_ids,
               const float* __restrict__ attrs, float* __restrict__ out,
               float* __restrict__ scratch, int th, int tw, int k_tile,
               int k_chunk, int n_tx, float alpha_clip, float alpha_thr) {
  extern __shared__ float s_attr[];  // k_chunk rows of kA floats
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int npix = blockDim.x;

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const float px = static_cast<float>(q % tw) + 0.5f;
  const float py = static_cast<float>(q / tw) + 0.5f;
  const int nch = min(n_chunks[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;

  float T = 1.f;
  float acc = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  for (int c = 0; c < nch; ++c) {
    const float* src = tile_attr + static_cast<size_t>(c) * k_chunk * kA;
    for (int i = q; i < k_chunk * kA; i += npix) s_attr[i] = src[i];
    __syncthreads();

    float p = 1.f;
    for (int e = 0; e < k_chunk; ++e) {
      const float* a = s_attr + e * kA;
      float alpha;
      if constexpr (kMode == kNoExp) {
        float dx, dy;
        const float sigma = eval_sigma(a, px, py, ox, oy, dx, dy);
        // the stand-in for exp2, rounded as its plain version rounds it
        const float expns = __fsub_rn(1.f, __fmul_rn(0.25f, sigma));
        alpha = fminf(alpha_clip, __fmul_rn(a[kOP], expns));
        if (!(sigma >= 0.f && alpha >= alpha_thr)) alpha = 0.f;
      } else {
        float opx, expns, dx, dy;
        eval_alpha(a, px, py, ox, oy, alpha_clip, alpha_thr, alpha, opx,
                   expns, dx, dy);
      }
      if constexpr (kMode == kAlphaOnly || kMode == kNoExp) {
        acc += alpha;
      } else {
        const float w = __fmul_rn(__fmul_rn(T, p), alpha);
        if constexpr (kMode == kFull) {
          acc_r += w * a[kR];
          acc_g += w * a[kG];
          acc_b += w * a[kB];
          acc_d += w * a[kZ];
        }
        acc += w;
        p *= 1.f - alpha;
      }
    }
    T *= p;  // p stays 1 in the α-only modes
    __syncthreads();  // every warp is done with the chunk before the next
  }

  float* o = out + static_cast<size_t>(t) * 2 * npix + q;
  o[0] = acc;
  o[npix] = T;
  if constexpr (kMode == kFull) {
    float* s = scratch + static_cast<size_t>(t) * 4 * npix + q;
    s[0 * npix] = acc_r;
    s[1 * npix] = acc_g;
    s[2 * npix] = acc_b;
    s[3 * npix] = acc_d;
  }
}

template <int kMode>
int launch(const int* n_chunks, const int* tile_ids, const float* attrs,
           float* out, float* scratch, int n_tiles, int th, int tw,
           int k_tile, int k_chunk, int n_tx, float alpha_clip,
           float alpha_thr, cudaStream_t stream) {
  const int npix = th * tw;
  const size_t smem = static_cast<size_t>(k_chunk) * kA * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        anatomy_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_tiles > 0) {
    anatomy_kernel<kMode><<<n_tiles, npix, smem, stream>>>(
        n_chunks, tile_ids, attrs, out, scratch, th, tw, k_tile, k_chunk,
        n_tx, alpha_clip, alpha_thr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 full, 1 no_mxu, 2 alpha_only, 3 noexp.  scratch, (n_tiles, 4,
// npix) f32, is written by `full` only and may be null for the others.
extern "C" int anatomy_variants_launch(const int* n_chunks,
                                       const int* tile_ids,
                                       const float* attrs, float* out,
                                       float* scratch, int mode, int n_tiles,
                                       int th, int tw, int k_tile,
                                       int k_chunk, int n_tx,
                                       float alpha_clip, float alpha_thr,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return launch<kFull>(n_chunks, tile_ids, attrs, out, scratch, n_tiles,
                           th, tw, k_tile, k_chunk, n_tx, alpha_clip,
                           alpha_thr, s);
    case kNoMxu:
      return launch<kNoMxu>(n_chunks, tile_ids, attrs, out, scratch, n_tiles,
                            th, tw, k_tile, k_chunk, n_tx, alpha_clip,
                            alpha_thr, s);
    case kAlphaOnly:
      return launch<kAlphaOnly>(n_chunks, tile_ids, attrs, out, scratch,
                                n_tiles, th, tw, k_tile, k_chunk, n_tx,
                                alpha_clip, alpha_thr, s);
    case kNoExp:
      return launch<kNoExp>(n_chunks, tile_ids, attrs, out, scratch, n_tiles,
                            th, tw, k_tile, k_chunk, n_tx, alpha_clip,
                            alpha_thr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
