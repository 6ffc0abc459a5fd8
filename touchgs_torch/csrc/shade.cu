// The per-Gaussian shade stage of a render and its gradient: two fused
// kernels.
//
// Replaces no Pallas kernel: the JAX package leaves projection, SH and the
// attribute packing (touchgs_tpu/ops/projection.py, ops/sh.py,
// ops/rasterize_pallas.py::_pack_attrs) to XLA, which fuses the elementwise
// chain into a few passes.  The port ran it as PyTorch ops, about a hundred
// (C,) elementwise kernels each way, and the 16 selects of the (C, 16, 3)
// SH table zero-filled and summed 16 buffers of that size in the backward.
// These kernels compute ops/shade.py's shade_fwd_plain (splatfacto.shade's
// projection, view directions, SH and colour clamp, then _attr_rows'
// packing) and shade_bwd_plain (its VJP, written out) in one pass each.
//
// Forward, one thread a Gaussian: exp of the log-scales, the sigmoid of the
// logit opacity, the EWA projection (the 1.3x-fov clamped Jacobian, eps2d,
// the det guard, the opacity-adaptive cull radius), the view direction, SH
// degrees 0-3 up to the active degree, +0.5 and the clamp at 0, the
// means2d offset; it writes the packed row [mx, my, ca~, cb~, cc~, op, z,
// r, g, b, 0...] (the conic columns carry log2(e)), the 512 dead rows as
// zeros where asked, and means2d, depths, radii, cull radii and validity
// for binning.  Every operation is PyTorch's in PyTorch's order, each
// rounded on its own (built with -fmad=false), with the same libm calls
// (expf, logf, sqrtf, ceilf, IEEE division), so the radii, cull radii and
// validity, and the pairs binning makes from them, are those of the op
// chain: a sum of squares over a row adds in the order of PyTorch's CUDA
// reduction of a short last axis ((x0 + x2) + (x1 + x3) for 4, (x0 + x2) +
// x1 for 3), a division of a tensor by a Python number multiplies by the
// number's reciprocal taken in double and rounded to float (the launcher's
// argument), as PyTorch's CUDA division by a CPU scalar does, and a Python
// number divided by a tensor is the tensor's reciprocal times it.
//
// Backward, one thread a Gaussian: the (C + dead, 16) table's gradient in,
// the forward's intermediates recomputed in registers (nothing saved), and
// each parameter group's gradient and the means2d offset's written once,
// with autograd's masks: torch.where on the near plane and the det guard,
// the clamps of the Jacobian's tx, ty and of the colours inclusive at their
// limits, zero for bands above the active degree.  A row whose incoming
// gradient is zero (a dead, culled or unlisted Gaussian) gets zero
// gradients without being computed.
//
// Bound on an H100: bytes.  A Gaussian's parameters are 240 bytes (sh_rest
// 180 of them); the forward writes 85 (the 64-byte row, means2d, depth,
// radii, validity), the backward reads the parameters and 40 bytes of the
// row's gradient and writes 244.  At 3.35 TB/s that is 0.10 ms forward and
// 0.16 ms backward for 1,048,576 Gaussians.  sh_rest's 180-byte rows are
// not 16-byte aligned row by row, so each block stages its rows through
// shared memory with coalesced float4 loads (and the backward its gradient
// rows with float4 stores) instead of 45 scattered loads a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // Gaussians a block, one a thread
constexpr int kMaxRest = 15;      // SH bases past the DC band at degree 3
constexpr int kCols = 16;         // the packed table's columns

// Python's float constants as PyTorch rounds a scalar: double to float
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kNegC1 = static_cast<float>(-0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);
constexpr float kHalfLog2e = static_cast<float>(0.5 * 1.4426950408889634);
constexpr float kLog2e = static_cast<float>(1.4426950408889634);
constexpr float kTiny = static_cast<float>(1e-12);
constexpr float kDiscFloor = static_cast<float>(0.01);
constexpr float kFov = static_cast<float>(1.3);

struct Params {   // a Gaussian's parameter groups (C rows each)
  const float* means;
  const float* quats;
  const float* log_scales;
  const float* logit_opacities;
  const float* sh_dc;
  const float* sh_rest;
};

struct CamPtrs {  // the camera's device tensors
  const float* w2c;
  const float* c2w;
  const float *fx, *fy, *cx, *cy;
};

struct Cam {
  float W[9], t[3], o[3];  // w2c's rotation (row-major) and translation;
                           // the camera's origin c2w[:3, 3]
  float fx, fy, cx, cy, lim_x, lim_y;
};

struct Consts {
  int n, dead, n_rest, active, width, height;
  float near, eps2d, sigma_cutoff, inv_alpha_threshold;
};

__device__ __forceinline__ Cam load_cam(const CamPtrs& p, int width,
                                        int height) {
  Cam k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) k.W[3 * i + j] = __ldg(p.w2c + 4 * i + j);
    k.t[i] = __ldg(p.w2c + 4 * i + 3);
    k.o[i] = __ldg(p.c2w + 4 * i + 3);
  }
  k.fx = __ldg(p.fx);
  k.fy = __ldg(p.fy);
  k.cx = __ldg(p.cx);
  k.cy = __ldg(p.cy);
  // 1.3 * (0.5 * width / fx): the Python number over the tensor is the
  // tensor's reciprocal times the number
  k.lim_x = ((1.0f / k.fx) * static_cast<float>(0.5 * width)) * kFov;
  k.lim_y = ((1.0f / k.fy) * static_cast<float>(0.5 * height)) * kFov;
  return k;
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// What the projection computes of a Gaussian, as project_gaussians writes
// it: scales, the normalised quaternion, W R, A = W R diag(s), the camera
// covariance, the clamped Jacobian and the 2D covariance.
struct Geo {
  float s[3], q[4], qn[4], nq, den;
  float M[3][3], A[3][3];
  float c00, c01, c02, c11, c12, c22;
  float x, y, z, zs, u, v, ucl, vcl, tx, ty, iz, iz2;
  float j00, j02, j11, j12, a, b, c, det, ds;
};

__device__ __forceinline__ void geometry(const Params& p, int i,
                                         const Cam& k, const Consts& cs,
                                         Geo& g) {
  const float m0 = __ldg(p.means + 3 * i), m1 = __ldg(p.means + 3 * i + 1),
              m2 = __ldg(p.means + 3 * i + 2);
  const float4 q4 = __ldg(reinterpret_cast<const float4*>(p.quats) + i);
  g.q[0] = q4.x;
  g.q[1] = q4.y;
  g.q[2] = q4.z;
  g.q[3] = q4.w;
#pragma unroll
  for (int j = 0; j < 3; ++j) g.s[j] = expf(__ldg(p.log_scales + 3 * i + j));

  g.x = ((k.W[0] * m0 + k.W[1] * m1) + k.W[2] * m2) + k.t[0];
  g.y = ((k.W[3] * m0 + k.W[4] * m1) + k.W[5] * m2) + k.t[1];
  g.z = ((k.W[6] * m0 + k.W[7] * m1) + k.W[8] * m2) + k.t[2];
  g.zs = g.z > cs.near ? g.z : cs.near;

  // q / (sqrt(Σq²) + 1e-12)
  g.nq = sqrtf((g.q[0] * g.q[0] + g.q[2] * g.q[2]) +
               (g.q[1] * g.q[1] + g.q[3] * g.q[3]));
  g.den = g.nq + kTiny;
#pragma unroll
  for (int j = 0; j < 4; ++j) g.qn[j] = g.q[j] / g.den;
  const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  float R[9];
  R[0] = 1.0f - (y * y + z * z) * 2.0f;
  R[1] = (x * y - w * z) * 2.0f;
  R[2] = (x * z + w * y) * 2.0f;
  R[3] = (x * y + w * z) * 2.0f;
  R[4] = 1.0f - (x * x + z * z) * 2.0f;
  R[5] = (y * z - w * x) * 2.0f;
  R[6] = (x * z - w * y) * 2.0f;
  R[7] = (y * z + w * x) * 2.0f;
  R[8] = 1.0f - (x * x + y * y) * 2.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g.M[r][j] = (k.W[3 * r] * R[j] + k.W[3 * r + 1] * R[3 + j]) +
                  k.W[3 * r + 2] * R[6 + j];
      g.A[r][j] = g.M[r][j] * g.s[j];
    }
  }
  auto dot = [&](int r, int t) {
    return (g.A[r][0] * g.A[t][0] + g.A[r][1] * g.A[t][1]) +
           g.A[r][2] * g.A[t][2];
  };
  g.c00 = dot(0, 0);
  g.c01 = dot(0, 1);
  g.c02 = dot(0, 2);
  g.c11 = dot(1, 1);
  g.c12 = dot(1, 2);
  g.c22 = dot(2, 2);

  g.u = g.x / g.zs;
  g.v = g.y / g.zs;
  g.ucl = clampf(g.u, -k.lim_x, k.lim_x);
  g.vcl = clampf(g.v, -k.lim_y, k.lim_y);
  g.tx = g.ucl * g.zs;
  g.ty = g.vcl * g.zs;
  g.iz = 1.0f / g.zs;
  g.iz2 = g.iz * g.iz;
  g.j00 = k.fx * g.iz;
  g.j02 = (-k.fx * g.tx) * g.iz2;
  g.j11 = k.fy * g.iz;
  g.j12 = (-k.fy * g.ty) * g.iz2;

  g.a = (((g.j00 * g.j00) * g.c00 + ((g.j00 * 2.0f) * g.j02) * g.c02) +
         (g.j02 * g.j02) * g.c22) + cs.eps2d;
  g.b = g.j00 * (g.c01 * g.j11 + g.c02 * g.j12) +
        g.j02 * (g.c12 * g.j11 + g.c22 * g.j12);
  g.c = (((g.j11 * g.j11) * g.c11 + ((g.j11 * 2.0f) * g.j12) * g.c12) +
         (g.j12 * g.j12) * g.c22) + cs.eps2d;
  g.det = g.a * g.c - g.b * g.b;
  g.ds = g.det > kTiny ? g.det : kTiny;
}

// The unit view direction of the Gaussian from the camera's origin:
// d / (sqrt(Σd²) + 1e-12); also d, the norm and the divisor
struct Dir {
  float d[3], nd, dd, v[3];
};

__device__ __forceinline__ Dir direction(const Params& p, int i,
                                         const Cam& k) {
  Dir r;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.d[j] = __ldg(p.means + 3 * i + j) - k.o[j];
  r.nd = sqrtf((r.d[0] * r.d[0] + r.d[2] * r.d[2]) + r.d[1] * r.d[1]);
  r.dd = r.nd + kTiny;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.v[j] = r.d[j] / r.dd;
  return r;
}

// eval_sh's sum for one channel up to the active degree (the bands above
// it add exactly zero), before the +0.5; ``rest`` is the Gaussian's
// (n_rest, 3) row in shared memory
__device__ __forceinline__ float eval_sh(float dc, const float* rest, int c,
                                         int active, const float* v) {
  const float x = v[0], y = v[1], z = v[2];
  float r = dc * kC0;
  if (active >= 1) {
    const float b1 = ((kNegC1 * y) * rest[c] + (kC1 * z) * rest[3 + c]) -
                     (kC1 * x) * rest[6 + c];
    r = r + b1;
  }
  if (active >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    const float b2 = (((kC20 * xy) * rest[9 + c] + (kC21 * yz) * rest[12 + c]) +
                      (kC22 * ((zz * 2.0f - xx) - yy)) * rest[15 + c] +
                      (kC23 * xz) * rest[18 + c]) +
                     (kC24 * (xx - yy)) * rest[21 + c];
    r = r + b2;
    if (active >= 3) {
      const float b3 =
          (((((((kC30 * y) * (xx * 3.0f - yy)) * rest[24 + c] +
               ((kC31 * xy) * z) * rest[27 + c]) +
              ((kC32 * y) * ((zz * 4.0f - xx) - yy)) * rest[30 + c]) +
             ((kC33 * z) * ((zz * 2.0f - xx * 3.0f) - yy * 3.0f)) *
                 rest[33 + c]) +
            ((kC34 * x) * ((zz * 4.0f - xx) - yy)) * rest[36 + c]) +
           ((kC35 * z) * (xx - yy)) * rest[39 + c]) +
          ((kC36 * x) * (xx - yy * 3.0f)) * rest[42 + c];
      r = r + b3;
    }
  }
  return r;
}

// copy ``count`` floats between device and shared memory by the whole
// block, as float4 where the device side is 16-byte aligned
template <bool kToShared>
__device__ __forceinline__ void stage(float* dev, float* shared, int count) {
  if ((reinterpret_cast<uintptr_t>(dev) & 15) == 0) {
    const int n4 = count >> 2;
    float4* d4 = reinterpret_cast<float4*>(dev);
    float4* s4 = reinterpret_cast<float4*>(shared);
    for (int k = threadIdx.x; k < n4; k += kThreads) {
      if (kToShared) {
        s4[k] = __ldg(d4 + k);
      } else {
        d4[k] = s4[k];
      }
    }
    for (int k = 4 * n4 + threadIdx.x; k < count; k += kThreads) {
      if (kToShared) {
        shared[k] = __ldg(dev + k);
      } else {
        dev[k] = shared[k];
      }
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kThreads) {
      if (kToShared) {
        shared[k] = __ldg(dev + k);
      } else {
        dev[k] = shared[k];
      }
    }
  }
}

struct FwdOut {
  float* table;
  float* means2d;
  float* depths;
  float* radii;
  float* cull_radii;
  unsigned char* valid;
};

__global__ void __launch_bounds__(kThreads)
    shade_fwd_kernel(Params p, const unsigned char* alive,
                     const float* offset, CamPtrs cp, Consts cs, FwdOut o) {
  __shared__ __align__(16) float s_rest[kThreads * 3 * kMaxRest];
  const int row0 = blockIdx.x * kThreads;
  const int i = row0 + threadIdx.x;
  const int nr = 3 * cs.n_rest;
  const int rows = max(0, min(kThreads, cs.n - row0));
  stage<true>(const_cast<float*>(p.sh_rest) + static_cast<long long>(row0) * nr,
              s_rest, rows * nr);
  __syncthreads();
  float4* row = reinterpret_cast<float4*>(o.table) +
                static_cast<long long>(i) * (kCols / 4);
  if (i >= cs.n) {  // the dead rows past the table
    if (i < cs.n + cs.dead) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kCols / 4; ++k) row[k] = zero;
    }
    return;
  }
  const Cam k = load_cam(cp, cs.width, cs.height);
  Geo g;
  geometry(p, i, k, cs, g);
  const float op = 1.0f / (1.0f + expf(-__ldg(p.logit_opacities + i)));

  const float conic_a = g.c / g.ds, conic_b = -g.b / g.ds,
              conic_c = g.a / g.ds;
  const float mx = (k.fx * g.x) / g.zs + k.cx;
  const float my = (k.fy * g.y) / g.zs + k.cy;

  // radius at sigma_cutoff and the opacity-adaptive cull radius
  const float mid = (g.a + g.c) * 0.5f;
  const float disc = sqrtf(clamp_min(mid * mid - g.det, kDiscFloor));
  const float sigma_max = sqrtf(mid + disc);
  const float radius = ceilf(sigma_max * cs.sigma_cutoff);
  const float cutoff = clampf(
      sqrtf(logf(clamp_min(op, kTiny) * cs.inv_alpha_threshold) * 2.0f),
      0.0f, cs.sigma_cutoff);
  const float cull = ceilf(cutoff * sigma_max);

  bool valid = (g.z > cs.near) & (g.det > kTiny);
  valid &= mx + cull > 0.0f;
  valid &= mx - cull < static_cast<float>(cs.width);
  valid &= my + cull > 0.0f;
  valid &= my - cull < static_cast<float>(cs.height);
  valid &= cull > 0.0f;
  valid &= alive[i] != 0;

  const Dir dir = direction(p, i, k);
  const float* rest = s_rest + threadIdx.x * nr;
  float col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r = eval_sh(__ldg(p.sh_dc + 3 * i + c), rest, c, cs.active,
                            dir.v);
    col[c] = clamp_min(r + 0.5f, 0.0f);
  }

  float ox = 0.0f, oy = 0.0f;
  if (offset != nullptr) {
    const float2 off = __ldg(reinterpret_cast<const float2*>(offset) + i);
    ox = off.x;
    oy = off.y;
  }
  const float px = offset != nullptr ? mx + ox : mx;
  const float py = offset != nullptr ? my + oy : my;
  row[0] = make_float4(px, py, conic_a * kHalfLog2e, conic_b * kLog2e);
  row[1] = make_float4(conic_c * kHalfLog2e, op, g.z, col[0]);
  row[2] = make_float4(col[1], col[2], 0.0f, 0.0f);
  row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<float2*>(o.means2d)[i] = make_float2(px, py);
  o.depths[i] = g.z;
  o.radii[i] = valid ? radius : 0.0f;
  o.cull_radii[i] = valid ? cull : 0.0f;
  o.valid[i] = valid;
}

struct BwdOut {
  float* means;
  float* quats;
  float* log_scales;
  float* logit_opacities;
  float* sh_dc;
  float* sh_rest;
  float* offset;
};

__device__ __forceinline__ void zero_grads(const BwdOut& o, int i) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.means[3 * i + j] = 0.0f;
    o.log_scales[3 * i + j] = 0.0f;
    o.sh_dc[3 * i + j] = 0.0f;
  }
  reinterpret_cast<float4*>(o.quats)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  o.logit_opacities[i] = 0.0f;
  reinterpret_cast<float2*>(o.offset)[i] = make_float2(0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads)
    shade_bwd_kernel(const float* grad_table, Params p, CamPtrs cp,
                     Consts cs, BwdOut o) {
  __shared__ __align__(16) float s_rest[kThreads * 3 * kMaxRest];
  const int row0 = blockIdx.x * kThreads;
  const int i = row0 + threadIdx.x;
  const int nr = 3 * cs.n_rest;
  const int rows = max(0, min(kThreads, cs.n - row0));
  stage<true>(const_cast<float*>(p.sh_rest) + static_cast<long long>(row0) * nr,
              s_rest, rows * nr);
  __syncthreads();
  float* rest = s_rest + threadIdx.x * nr;
  if (i < cs.n) {
    const float4* gr4 = reinterpret_cast<const float4*>(grad_table) +
                        static_cast<long long>(i) * (kCols / 4);
    const float4 r0 = __ldg(gr4), r1 = __ldg(gr4 + 1), r2 = __ldg(gr4 + 2);
    const float G[10] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                         r1.y, r1.z, r1.w, r2.x, r2.y};
    bool any = false;
#pragma unroll
    for (int j = 0; j < 10; ++j) any |= G[j] != 0.0f;
    if (!any) {
      zero_grads(o, i);
      for (int j = 0; j < nr; ++j) rest[j] = 0.0f;
    } else {
      const Cam k = load_cam(cp, cs.width, cs.height);
      Geo g;
      geometry(p, i, k, cs, g);
      const float op = 1.0f / (1.0f + expf(-__ldg(p.logit_opacities + i)));
      const Dir dir = direction(p, i, k);
      const int active = cs.active;

      // colours: the clamp at 0 passes the gradient where r + 0.5 >= 0
      float gcol[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float r = eval_sh(__ldg(p.sh_dc + 3 * i + c), rest, c, active,
                                dir.v);
        gcol[c] = r + 0.5f >= 0.0f ? G[7 + c] : 0.0f;
      }
      // each basis function's value and its derivative along x, y, z, for
      // the active bands; the gradient into sh_rest replaces the row in
      // shared memory once its coefficients are read
      const float x = dir.v[0], y = dir.v[1], z = dir.v[2];
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      float basis[kMaxRest], dbx[kMaxRest], dby[kMaxRest], dbz[kMaxRest];
      basis[0] = kNegC1 * y;  dbx[0] = 0.0f;  dby[0] = kNegC1;  dbz[0] = 0.0f;
      basis[1] = kC1 * z;     dbx[1] = 0.0f;  dby[1] = 0.0f;    dbz[1] = kC1;
      basis[2] = -kC1 * x;    dbx[2] = -kC1;  dby[2] = 0.0f;    dbz[2] = 0.0f;
      basis[3] = kC20 * xy;   dbx[3] = kC20 * y;  dby[3] = kC20 * x;
      dbz[3] = 0.0f;
      basis[4] = kC21 * yz;   dbx[4] = 0.0f;  dby[4] = kC21 * z;
      dbz[4] = kC21 * y;
      basis[5] = kC22 * (2.0f * zz - xx - yy);
      dbx[5] = -2.0f * kC22 * x;  dby[5] = -2.0f * kC22 * y;
      dbz[5] = 4.0f * kC22 * z;
      basis[6] = kC23 * xz;   dbx[6] = kC23 * z;  dby[6] = 0.0f;
      dbz[6] = kC23 * x;
      basis[7] = kC24 * (xx - yy);
      dbx[7] = 2.0f * kC24 * x;  dby[7] = -2.0f * kC24 * y;  dbz[7] = 0.0f;
      basis[8] = kC30 * y * (3.0f * xx - yy);
      dbx[8] = kC30 * 6.0f * xy;  dby[8] = kC30 * (3.0f * xx - 3.0f * yy);
      dbz[8] = 0.0f;
      basis[9] = kC31 * xy * z;
      dbx[9] = kC31 * yz;  dby[9] = kC31 * xz;  dbz[9] = kC31 * xy;
      basis[10] = kC32 * y * (4.0f * zz - xx - yy);
      dbx[10] = kC32 * -2.0f * xy;
      dby[10] = kC32 * (4.0f * zz - xx - 3.0f * yy);
      dbz[10] = kC32 * 8.0f * yz;
      basis[11] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      dbx[11] = kC33 * -6.0f * xz;  dby[11] = kC33 * -6.0f * yz;
      dbz[11] = kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      basis[12] = kC34 * x * (4.0f * zz - xx - yy);
      dbx[12] = kC34 * (4.0f * zz - 3.0f * xx - yy);
      dby[12] = kC34 * -2.0f * xy;  dbz[12] = kC34 * 8.0f * xz;
      basis[13] = kC35 * z * (xx - yy);
      dbx[13] = kC35 * 2.0f * xz;  dby[13] = kC35 * -2.0f * yz;
      dbz[13] = kC35 * (xx - yy);
      basis[14] = kC36 * x * (xx - 3.0f * yy);
      dbx[14] = kC36 * (3.0f * xx - 3.0f * yy);  dby[14] = kC36 * -6.0f * xy;
      dbz[14] = 0.0f;
      const int n_active = (active + 1) * (active + 1) - 1;
      float gdir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int b = 0; b < kMaxRest; ++b) {
        if (b < cs.n_rest) {
          if (b < n_active) {
            const float dot = (gcol[0] * rest[3 * b] +
                               gcol[1] * rest[3 * b + 1]) +
                              gcol[2] * rest[3 * b + 2];
            gdir[0] += dbx[b] * dot;
            gdir[1] += dby[b] * dot;
            gdir[2] += dbz[b] * dot;
#pragma unroll
            for (int c = 0; c < 3; ++c) rest[3 * b + c] = basis[b] * gcol[c];
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) rest[3 * b + c] = 0.0f;
          }
        }
      }
      // the direction's divisor d / (|d| + 1e-12)
      const float gdot = (gdir[0] * dir.d[0] + gdir[1] * dir.d[1]) +
                         gdir[2] * dir.d[2];
      const float gdd = -gdot / (dir.dd * dir.dd);
      float gm[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gm[j] = gdir[j] / dir.dd + dir.d[j] * (gdd / dir.nd);

      // the conic (c, -b, a) / det_safe and the det guard
      const float gA = G[2] * kHalfLog2e, gB = G[3] * kLog2e,
                  gC = G[4] * kHalfLog2e;
      float ga = gC / g.ds, gb = -gB / g.ds, gc = gA / g.ds;
      if (g.det > kTiny) {
        const float gdet =
            -((gA * g.c - gB * g.b) + gC * g.a) / (g.ds * g.ds);
        ga += gdet * g.c;
        gc += gdet * g.a;
        gb -= 2.0f * g.b * gdet;
      }
      // 2D covariance = J Σ Jᵀ (+ eps2d)
      const float gj00 = ga * (2.0f * g.j00 * g.c00 + 2.0f * g.j02 * g.c02) +
                         gb * (g.c01 * g.j11 + g.c02 * g.j12);
      const float gj02 = ga * (2.0f * g.j00 * g.c02 + 2.0f * g.j02 * g.c22) +
                         gb * (g.c12 * g.j11 + g.c22 * g.j12);
      const float gj11 = gc * (2.0f * g.j11 * g.c11 + 2.0f * g.j12 * g.c12) +
                         gb * (g.j00 * g.c01 + g.j02 * g.c12);
      const float gj12 = gc * (2.0f * g.j11 * g.c12 + 2.0f * g.j12 * g.c22) +
                         gb * (g.j00 * g.c02 + g.j02 * g.c22);
      const float gc00 = ga * g.j00 * g.j00;
      const float gc01 = gb * g.j00 * g.j11;
      const float gc02 = ga * 2.0f * g.j00 * g.j02 + gb * g.j00 * g.j12;
      const float gc11 = gc * g.j11 * g.j11;
      const float gc12 = gb * g.j02 * g.j11 + gc * 2.0f * g.j11 * g.j12;
      const float gc22 = ga * g.j02 * g.j02 + gb * g.j02 * g.j12 +
                         gc * g.j12 * g.j12;
      // the Jacobian's entries from 1/z and the clamped tx, ty
      const float giz2 = gj02 * (-k.fx * g.tx) + gj12 * (-k.fy * g.ty);
      const float giz = gj00 * k.fx + gj11 * k.fy + giz2 * 2.0f * g.iz;
      const float gtx = gj02 * -k.fx * g.iz2;
      const float gty = gj12 * -k.fy * g.iz2;
      float gzs = -giz * (g.iz * g.iz) + gtx * g.ucl + gty * g.vcl;
      const float gu = (g.u >= -k.lim_x && g.u <= k.lim_x) ? gtx * g.zs : 0.0f;
      const float gv = (g.v >= -k.lim_y && g.v <= k.lim_y) ? gty * g.zs : 0.0f;
      // u = x / z, and the mean fx x / z + cx
      const float gmx = G[0], gmy = G[1];
      const float gx = gu / g.zs + k.fx * (gmx / g.zs);
      const float gy = gv / g.zs + k.fy * (gmy / g.zs);
      gzs -= (gu * g.x + gmx * (k.fx * g.x)) / (g.zs * g.zs) +
             (gv * g.y + gmy * (k.fy * g.y)) / (g.zs * g.zs);
      const float gz = G[6] + (g.z > cs.near ? gzs : 0.0f);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gm[j] += (k.W[j] * gx + k.W[3 + j] * gy) + k.W[6 + j] * gz;

      // covariance = A Aᵀ: the rows of A
      const float gcv[3][3] = {{gc00, gc01, gc02},
                               {gc01, gc11, gc12},
                               {gc02, gc12, gc22}};
      float gs[3] = {0.0f, 0.0f, 0.0f}, gR[9];
      float gM[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float gAr = 0.0f;
#pragma unroll
          for (int t = 0; t < 3; ++t)
            gAr += (t == r ? 2.0f : 1.0f) * gcv[r][t] * g.A[t][j];
          gs[j] += gAr * g.M[r][j];
          gM[r][j] = gAr * g.s[j];
        }
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          gR[3 * t + j] = (k.W[t] * gM[0][j] + k.W[3 + t] * gM[1][j]) +
                          k.W[6 + t] * gM[2][j];
      }
      // the rotation of the normalised quaternion (w, x, y, z)
      const float qw = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
      float gqn[4];
      gqn[0] = 2.0f * (-qz * gR[1] + qy * gR[2] + qz * gR[3] - qx * gR[5] -
                       qy * gR[6] + qx * gR[7]);
      gqn[1] = 2.0f * (qy * gR[1] + qz * gR[2] + qy * gR[3] -
                       2.0f * qx * gR[4] - qw * gR[5] + qz * gR[6] +
                       qw * gR[7] - 2.0f * qx * gR[8]);
      gqn[2] = 2.0f * (-2.0f * qy * gR[0] + qx * gR[1] + qw * gR[2] +
                       qx * gR[3] + qz * gR[5] - qw * gR[6] + qz * gR[7] -
                       2.0f * qy * gR[8]);
      gqn[3] = 2.0f * (-2.0f * qz * gR[0] - qw * gR[1] + qx * gR[2] +
                       qw * gR[3] - 2.0f * qz * gR[4] + qy * gR[5] +
                       qx * gR[6] + qy * gR[7]);
      // q / (|q| + 1e-12)
      const float qdot = (gqn[0] * g.q[0] + gqn[1] * g.q[1]) +
                         (gqn[2] * g.q[2] + gqn[3] * g.q[3]);
      const float gden = -qdot / (g.den * g.den);
      float gq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gq[j] = gqn[j] / g.den + g.q[j] * (gden / g.nq);

#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o.means[3 * i + j] = gm[j];
        o.log_scales[3 * i + j] = gs[j] * g.s[j];
        o.sh_dc[3 * i + j] = gcol[j] * kC0;
      }
      reinterpret_cast<float4*>(o.quats)[i] =
          make_float4(gq[0], gq[1], gq[2], gq[3]);
      o.logit_opacities[i] = G[5] * (1.0f - op) * op;
      reinterpret_cast<float2*>(o.offset)[i] = make_float2(G[0], G[1]);
    }
  }
  __syncthreads();
  stage<false>(o.sh_rest + static_cast<long long>(row0) * nr, s_rest,
               rows * nr);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The forward: the (n + dead, 16) packed table (its last ``dead`` rows
// zero), means2d (n, 2), depths, radii and cull radii (n), validity (n,
// bool).  ``offset`` (n, 2) may be null; quats and the table 16-byte
// aligned, means2d and offset 8-byte aligned.  ``inv_alpha_threshold`` is
// 1 / alpha_threshold in double, rounded to float.
extern "C" int shade_fwd_launch(
    const float* means, const float* quats, const float* log_scales,
    const float* logit_opacities, const float* sh_dc, const float* sh_rest,
    const unsigned char* alive, const float* offset, const float* w2c,
    const float* c2w, const float* fx, const float* fy, const float* cx,
    const float* cy, float* table, float* means2d, float* depths,
    float* radii, float* cull_radii, unsigned char* valid, int n, int dead,
    int n_rest, int active, int width, int height, float near, float eps2d,
    float sigma_cutoff, float inv_alpha_threshold, void* stream) {
  if (n_rest > kMaxRest) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = blocks_for(n + dead);
  if (blocks == 0) return 0;
  shade_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Params{means, quats, log_scales, logit_opacities, sh_dc, sh_rest}, alive,
      offset, CamPtrs{w2c, c2w, fx, fy, cx, cy},
      Consts{n, dead, n_rest, active, width, height, near, eps2d,
             sigma_cutoff, inv_alpha_threshold},
      FwdOut{table, means2d, depths, radii, cull_radii, valid});
  return static_cast<int>(cudaGetLastError());
}

// The backward: from the table's gradient (its first n rows read, 16-byte
// aligned) each parameter group's gradient and the offset's (n, 2).
extern "C" int shade_bwd_launch(
    const float* grad_table, const float* means, const float* quats,
    const float* log_scales, const float* logit_opacities, const float* sh_dc,
    const float* sh_rest, const float* w2c, const float* c2w, const float* fx,
    const float* fy, const float* cx, const float* cy, float* g_means,
    float* g_quats, float* g_log_scales, float* g_logit_opacities,
    float* g_sh_dc, float* g_sh_rest, float* g_offset, int n, int n_rest,
    int active, int width, int height, float near, float eps2d,
    void* stream) {
  if (n_rest > kMaxRest) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = blocks_for(n);
  if (blocks == 0) return 0;
  shade_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grad_table,
      Params{means, quats, log_scales, logit_opacities, sh_dc, sh_rest},
      CamPtrs{w2c, c2w, fx, fy, cx, cy},
      Consts{n, 0, n_rest, active, width, height, near, eps2d, 0.0f, 0.0f},
      BwdOut{g_means, g_quats, g_log_scales, g_logit_opacities, g_sh_dc,
             g_sh_rest, g_offset});
  return static_cast<int>(cudaGetLastError());
}
