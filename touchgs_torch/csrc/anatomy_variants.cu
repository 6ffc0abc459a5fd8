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
// The thread shape, the staging, the row loads, the rounding of σ̃ and α
// (row_sigma, row_alpha in composite_common.cuh) and the build flags are
// K2's, so the differences between the modes' times, and between `full`
// and K2 without its exit, attribute K2's time.
//
// fp32 operations per (entry, pixel), counted from this source (each
// +, −, ×, unary −, min, compare, && and select is one, exp2f is one; an
// FMA counts two, as the card's 67 TFLOP/s peak counts it; mx − ox and
// my − oy are taken once per entry in the staging):
//   α (row_alpha): dx, dy 2; σ̃ 8; −σ̃ 1; exp2f 1; op·e 1; min 1;
//   mask 4 (σ̃ ≥ 0, α ≥ thr, &&, select)                           = 18
//   alpha_only: α + Σ 1                                            = 19
//   noexp: α with (−σ̃, exp2f) replaced by (0.25·σ̃, 1 −) + Σ 1      = 19
//   no_mxu: α + w = (T·p)·α 2 + Σ 1 + p ·= (1 − α) 2               = 23
//   full: no_mxu + R, G, B, D += w·v 4 FMAs 8                      = 31
// (ops/anatomy.py OPS_PER_PAIR holds the same table; a test parses it.)
//
// Bound on an H100: operations, as K2's.  The α chain has no FMA (every
// product and sum is rounded on its own), so at one fp32 instruction per
// lane and clock a perfect kernel reaches about half the 67 TFLOP/s that
// the bound counts.
//
// Design: K2's.  P pixels per thread (pixels_per_thread: 4 for 32x32
// tiles), npix / P threads a block, several tiles resident per SM.  Each
// chunk's rows are staged once in shared memory with mx − ox and my − oy
// already taken (stage_rows), and every thread walks them in order: each row
// is read with three 16-byte loads and serves its P pixels.  The trap in
// `full`: it stores only ΣA, so the compiler would delete the R, G, B and D
// accumulations and `full` would time `no_mxu`.  They are stored into a
// scratch output (n_tiles, 4, npix) that the wrapper allocates and drops, so
// their FMAs stay in the code.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace touchgs;

enum Mode : int { kFull = 0, kNoMxu = 1, kAlphaOnly = 2, kNoExp = 3 };

template <int kMode, int P>
__global__ void __launch_bounds__(1024 / P, P == 4 ? 3 : 1)
anatomy_kernel(const int* __restrict__ n_chunks,
               const int* __restrict__ tile_ids,
               const float* __restrict__ attrs, float* __restrict__ out,
               float* __restrict__ scratch, int th, int tw, int k_tile,
               int k_chunk, int n_tx, float alpha_clip, float alpha_thr) {
  extern __shared__ __align__(16) float s_attr[];  // k_chunk rows of kA
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int S = blockDim.x;  // threads; pixel stride
  const int npix = S * P;

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const int nch = min(n_chunks[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;

  float px[P], py[P], T[P], acc[P], acc_r[P], acc_g[P], acc_b[P], acc_d[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pix = q + j * S;
    px[j] = static_cast<float>(pix % tw) + 0.5f;
    py[j] = static_cast<float>(pix / tw) + 0.5f;
    T[j] = 1.f;
    acc[j] = acc_r[j] = acc_g[j] = acc_b[j] = acc_d[j] = 0.f;
  }
  for (int c = 0; c < nch; ++c) {
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
        float alpha;
        if constexpr (kMode == kNoExp) {
          float dx, dy;
          const float sigma = row_sigma(a, px[j], py[j], dx, dy);
          // the stand-in for exp2, rounded as its plain version rounds it
          const float expns = __fsub_rn(1.f, __fmul_rn(0.25f, sigma));
          alpha = fminf(alpha_clip, __fmul_rn(a.op, expns));
          if (!(sigma >= 0.f && alpha >= alpha_thr)) alpha = 0.f;
        } else {
          float opx, expns, dx, dy;
          alpha = row_alpha(a, px[j], py[j], alpha_clip, alpha_thr, opx,
                            expns, dx, dy);
        }
        if constexpr (kMode == kAlphaOnly || kMode == kNoExp) {
          acc[j] += alpha;
        } else {
          const float w = __fmul_rn(__fmul_rn(T[j], p[j]), alpha);
          if constexpr (kMode == kFull) {
            acc_r[j] += w * a.r;
            acc_g[j] += w * a.g;
            acc_b[j] += w * a.b;
            acc_d[j] += w * a.z;
          }
          acc[j] += w;
          p[j] *= 1.f - alpha;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) T[j] *= p[j];  // p stays 1 in the α-only modes
    __syncthreads();  // every warp is done with the chunk before the next
  }

  float* o = out + static_cast<size_t>(t) * 2 * npix + q;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    o[j * S] = acc[j];
    o[npix + j * S] = T[j];
    if constexpr (kMode == kFull) {
      float* s = scratch + static_cast<size_t>(t) * 4 * npix + q + j * S;
      s[0 * npix] = acc_r[j];
      s[1 * npix] = acc_g[j];
      s[2 * npix] = acc_b[j];
      s[3 * npix] = acc_d[j];
    }
  }
}

size_t smem_bytes(int k_chunk) {
  return static_cast<size_t>(k_chunk) * kA * sizeof(float);
}

template <int kMode>
const void* instance(int npix) {
  const int P = pixels_per_thread(npix);
  return P == 4   ? reinterpret_cast<const void*>(anatomy_kernel<kMode, 4>)
         : P == 2 ? reinterpret_cast<const void*>(anatomy_kernel<kMode, 2>)
                  : reinterpret_cast<const void*>(anatomy_kernel<kMode, 1>);
}

// The kernel of `mode` for npix-pixel tiles, or null for an unknown mode.
const void* instance(int npix, int mode) {
  switch (mode) {
    case kFull:
      return instance<kFull>(npix);
    case kNoMxu:
      return instance<kNoMxu>(npix);
    case kAlphaOnly:
      return instance<kAlphaOnly>(npix);
    case kNoExp:
      return instance<kNoExp>(npix);
    default:
      return nullptr;
  }
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
  const int npix = th * tw;
  const void* kernel = instance(npix, mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&n_chunks, &tile_ids, &attrs,  &out,  &scratch,
                  &th,       &tw,       &k_tile, &k_chunk, &n_tx,
                  &alpha_clip, &alpha_thr};
  return launch_tiles(kernel, args, n_tiles, npix, smem_bytes(k_chunk),
                      stream);
}

// launch_info of the kernel of `mode` (variant) for npix-pixel tiles and
// k_chunk-entry chunks.
extern "C" int anatomy_variants_info(int npix, int k_chunk, int variant,
                                     int* out) {
  const void* kernel = instance(npix, variant);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_info(kernel, npix, smem_bytes(k_chunk), out);
}
