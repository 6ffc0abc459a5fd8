// K3: tile compositing, backward.
//
// Replaces touchgs_tpu/ops/rasterize_pallas.py::_make_backward_kernel
// (:302-394), launched by _backward_tiles (:508-525, the pallas_call at :520).
//
// Per tile it replays exactly the chunks_done chunks the forward composited,
// front to back, recomputing α.  One suffix accumulator carries
// S_u = Σ_j u_j, u_j = w_j·(gr·r_j + gg·g_j + gb·b_j + gd·z_j + ga), starting
// at Σ_rows G·F and shrinking as entries pass; the transmittance cotangent
// enters as −gT·T_out/(1 − α).  Gates: α > 0 and unclipped
// (op·2^(−σ̃) < alpha_clip).  Output per (tile, slot) row:
//   [dmx, dmy, dca~, dcb~, dcc~, dop, dz, dr, dg, db, 0 x 6];
// rows past the replay are zero.
//
// Bound on an H100: operations.  Each replayed (entry, pixel) pair costs
// about 76 fp32 operations and one exp2; the bytes are the replayed
// attribute rows, the forward and cotangent stacks and the output rows.
// Per entry, ten per-pixel quantities (s1, s2, dca, dcb, dcc, dop, dz, dr,
// dg, db) are summed over the tile's pixels.
//
// What held the first design back: one thread per pixel in 1024-thread
// blocks (one tile per SM), and each sum a 5-step shuffle butterfly in every
// warp: 50 SHFL and 50 FADD per pair beside the gradient's ~76 operations.
// At the flagship (203,136 replayed entries of 1024 pixels) that is 325M
// warp shuffles, ≈1.24 ms of the shuffle pipe alone at one warp shuffle a
// clock per SM on 132 SMs at 1980 MHz, and ≈190 instructions a pair in all;
// it ran 2.06 ms (NVIDIA H100 80GB HBM3, 700 W power limit; PERF.md).
//
// Design: P pixels per thread (pixels_per_thread: 4 for 32x32 and 16x16
// tiles), npix / P threads a block, so two tiles are resident per SM.  Each
// thread keeps its P pixels' state in registers and, per entry:
//   1. sums its P pixels' ten quantities in pixel order;
//   2. runs three reduce-scatter steps across the warp (lane_steps): at
//      shuffle offsets 16, 8 and 4 each lane keeps half of its values, sends
//      the other half to its partner and adds what it receives, 5 + 3 + 2 =
//      10 shuffles for the ten values (the butterfly took 50).  Each
//      quantity's sum over the 8 lanes that share lane bits 1..0 then sits
//      on one of those lanes;
//   3. stores those (at most two) values to shared memory: four partials a
//      quantity per warp.
// After each group of up to 32 entries one thread per (entry, quantity) adds
// its 4·n_warps partials in order (warp by warp, lanes 0..3 within a warp).
// No atomics: the result does not change from run to run.  dmx and dmy are
// formed from s1 and s2 through the packed conic coefficients.
//
// These sums cancel heavily (the cotangents take both signs), so a one-ulp
// change in a per-pixel term can move a sum by far more than its own
// rounding.  The file is therefore built with -fmad=false
// (touchgs_torch/ops/cuda_build.py): every operation is rounded on its own,
// in the order of the plain PyTorch version, which also sums in this
// kernel's order (rasterize_plain._block_sum: a thread's pixels, then the
// lane tree, then the partials in order).  The two then agree to the last
// bit on the card, and the comparison tests the kernel, not the summation
// order.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace touchgs;

constexpr int kQ = 10;         // reduced quantities per entry
constexpr int kMaxGroup = 32;  // entries per shared-memory group
constexpr int kSub = 4;        // partials per quantity and warp (lane bits 1..0)

// Three reduce-scatter steps over lane bits 4, 3 and 2.  On return o[j] is
// the sum of quantity slot_quantity(lane, j) over the 8 lanes that share this
// lane's bits 1..0, or 0 where the slot holds none.  Each step adds two
// partial sums of disjoint lane sets, so the tree is the butterfly's.
__device__ __forceinline__ void lane_steps(const float (&v)[kQ], int lane,
                                           float (&o)[2]) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float s[5];  // quantities 5·b4 + j
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float send = b4 ? v[j] : v[j + 5];
    const float keep = b4 ? v[j + 5] : v[j];
    s[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float r[3];  // s[3·b3 + j], the third empty where b3 is set
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float hi = j + 3 < 5 ? s[j + 3] : 0.f;
    const float send = b3 ? s[j] : hi;
    const float keep = b3 ? hi : s[j];
    r[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // r[2·b2 + j]
    const float hi = j + 2 < 3 ? r[j + 2] : 0.f;
    const float send = b2 ? r[j] : hi;
    const float keep = b2 ? hi : r[j];
    o[j] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

// The quantity lane_steps leaves in slot j of a lane, or −1 for none.
__device__ __forceinline__ int slot_quantity(int lane, int j) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  const int in_s = 3 * b3 + 2 * b2 + j;  // index into s
  const bool held = 2 * b2 + j < 3 && in_s < 5;
  return held ? 5 * b4 + in_s : -1;
}

template <int P>
__global__ void __launch_bounds__(1024 / P, P == 4 ? 2 : 1)
composite_bwd_kernel(const int* __restrict__ chunks_done,
                     const int* __restrict__ tile_ids,
                     const float* __restrict__ attrs,
                     const float* __restrict__ fwd,
                     const float* __restrict__ grad,
                     float* __restrict__ dattrs, int th, int tw, int k_tile,
                     int k_chunk, int n_tx, float alpha_clip,
                     float alpha_thr) {
  const int group = min(k_chunk, kMaxGroup);
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const int S = blockDim.x;  // threads; pixel stride
  const int npix = S * P;
  const int lane = q & 31, warp = q >> 5, n_warps = S >> 5;

  extern __shared__ __align__(16) float smem[];
  float* s_attr = smem;                                // group x kA
  float* s_part = s_attr + group * kA;                 // n_warps x group x kQ x kSub
  float* s_red = s_part + n_warps * group * kQ * kSub; // group x kQ

  const int tid = tile_ids[t];
  const float ox = static_cast<float>((tid % n_tx) * tw);
  const float oy = static_cast<float>((tid / n_tx) * th);
  const int done = min(chunks_done[t], k_tile / k_chunk);
  const float* tile_attr = attrs + static_cast<size_t>(t) * k_tile * kA;
  float* dout = dattrs + static_cast<size_t>(t) * k_tile * kA;
  const int quant0 = slot_quantity(lane, 0), quant1 = slot_quantity(lane, 1);
  const int sub = lane & (kSub - 1);

  // rows past the replay are never visited: zero them up front
  for (int i = done * k_chunk * kA + q; i < k_tile * kA; i += S) dout[i] = 0.f;

  const float* F = fwd + static_cast<size_t>(t) * kRows * npix + q;
  const float* Gg = grad + static_cast<size_t>(t) * kRows * npix + q;
  float px[P], py[P], gr[P], gg[P], gb[P], gd[P], ga[P], gT_term[P], S_u[P],
      T[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pix = q + j * S, o = j * S;
    px[j] = static_cast<float>(pix % tw) + 0.5f;
    py[j] = static_cast<float>(pix / tw) + 0.5f;
    gr[j] = Gg[0 * npix + o];
    gg[j] = Gg[1 * npix + o];
    gb[j] = Gg[2 * npix + o];
    gd[j] = Gg[3 * npix + o];
    ga[j] = Gg[4 * npix + o];
    // cotangent of the transmittance output, chained through
    // dT_out/dα_j = −T_out/(1 − α_j)
    gT_term[j] = Gg[kRowT * npix + o] * F[kRowT * npix + o];
    S_u[j] = gr[j] * F[0 * npix + o] + gg[j] * F[1 * npix + o] +
             gb[j] * F[2 * npix + o] + gd[j] * F[3 * npix + o] +
             ga[j] * F[4 * npix + o];
    T[j] = 1.f;
  }

  for (int c = 0; c < done; ++c) {
    float p[P], cu[P];  // running product of (1 − α); exclusive sum of u
#pragma unroll
    for (int j = 0; j < P; ++j) {
      p[j] = 1.f;
      cu[j] = 0.f;
    }
    for (int g0 = 0; g0 < k_chunk; g0 += group) {
      const int row0 = c * k_chunk + g0;
      stage_rows(s_attr, tile_attr + static_cast<size_t>(row0) * kA,
                 group * kA, q, S, ox, oy);
      __syncthreads();

      for (int e = 0; e < group; ++e) {
        const Row a = load_row(s_attr + e * kA);
        float v[kQ];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float opx, expns, dx, dy;
          const float alpha = row_alpha(a, px[j], py[j], alpha_clip,
                                        alpha_thr, opx, expns, dx, dy);
          const float T_i = T[j] * p[j];
          const float w = T_i * alpha;
          const float direct =
              a.r * gr[j] + a.g * gg[j] + a.b * gb[j] + a.z * gd[j] + ga[j];
          const float u = w * direct;
          const float U_i = S_u[j] - (cu[j] + u);  // suffix after entry i
          const float one_m = fmaxf(1.f - alpha, 1e-6f);
          const bool gate = alpha > 0.f && opx < alpha_clip;
          const float dalpha =
              gate ? T_i * direct - (U_i + gT_term[j]) / one_m : 0.f;
          // ∂α/∂σ̃ = −ln2·α
          const float dsigma = -kLn2 * dalpha * alpha;
          const float t1 = dsigma * dx;
          const float t2 = dsigma * dy;
          const float x[kQ] = {t1,      t2,        t1 * dx,   t1 * dy,
                               t2 * dy, dalpha * expns, w * gd[j], w * gr[j],
                               w * gg[j], w * gb[j]};
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            if (j == 0)
              v[k] = x[k];
            else
              v[k] += x[k];
          }
          cu[j] += u;
          p[j] *= 1.f - alpha;
        }
        float o[2];
        lane_steps(v, lane, o);
        float* dst = s_part + (warp * group + e) * kQ * kSub + sub;
        if (quant0 >= 0) dst[quant0 * kSub] = o[0];
        if (quant1 >= 0) dst[quant1 * kSub] = o[1];
      }
      __syncthreads();

      // the partials of (entry, quantity) i, warp by warp, lanes 0..3
      for (int i = q; i < group * kQ; i += S) {
        const float4* src = reinterpret_cast<const float4*>(s_part) + i;
        float4 x = src[0];
        float s = x.x;
        s += x.y;
        s += x.z;
        s += x.w;
        for (int w = 1; w < n_warps; ++w) {
          x = src[w * group * kQ];
          s += x.x;
          s += x.y;
          s += x.z;
          s += x.w;
        }
        s_red[i] = s;
      }
      __syncthreads();

      for (int i = q; i < group * kA; i += S) {
        const int e = i / kA, col = i % kA;
        const float* red = s_red + e * kQ;
        const float* a = s_attr + e * kA;
        float val = 0.f;
        if (col == 0) {
          // ∂σ̃/∂dx = 2·ca~·dx + cb~·dy
          val = -(2.f * a[kCA] * red[0] + a[kCB] * red[1]);
        } else if (col == 1) {
          val = -(a[kCB] * red[0] + 2.f * a[kCC] * red[1]);
        } else if (col < kQ) {
          val = red[col];  // dca~, dcb~, dcc~, dop, dz, dr, dg, db
        }
        dout[static_cast<size_t>(row0) * kA + i] = val;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T[j] *= p[j];
      S_u[j] -= cu[j];
    }
  }
}

// Shared memory of one block.
size_t smem_bytes(int npix, int k_chunk) {
  const int group = k_chunk < kMaxGroup ? k_chunk : kMaxGroup;
  const int n_warps = npix / pixels_per_thread(npix) / 32;
  return static_cast<size_t>(group) * (kA + n_warps * kQ * kSub + kQ) *
         sizeof(float);
}

const void* instance(int npix) {
  const int P = pixels_per_thread(npix);
  return P == 4   ? reinterpret_cast<const void*>(composite_bwd_kernel<4>)
         : P == 2 ? reinterpret_cast<const void*>(composite_bwd_kernel<2>)
                  : reinterpret_cast<const void*>(composite_bwd_kernel<1>);
}

}  // namespace

extern "C" int composite_bwd_launch(const int* chunks_done,
                                    const int* tile_ids, const float* attrs,
                                    const float* fwd, const float* grad,
                                    float* dattrs, int n_tiles, int th,
                                    int tw, int k_tile, int k_chunk, int n_tx,
                                    float alpha_clip, float alpha_thr,
                                    void* stream) {
  void* args[] = {&chunks_done, &tile_ids, &attrs,  &fwd,  &grad,
                  &dattrs,      &th,       &tw,     &k_tile, &k_chunk,
                  &n_tx,        &alpha_clip, &alpha_thr};
  const int npix = th * tw;
  return launch_tiles(instance(npix), args, n_tiles, npix,
                      smem_bytes(npix, k_chunk), stream);
}

// launch_info of the kernel for npix-pixel tiles and k_chunk-entry chunks;
// variant is unused (composite_fwd_info's early_exit).
extern "C" int composite_bwd_info(int npix, int k_chunk, int variant,
                                  int* out) {
  (void)variant;
  return launch_info(instance(npix), npix, smem_bytes(npix, k_chunk), out);
}
