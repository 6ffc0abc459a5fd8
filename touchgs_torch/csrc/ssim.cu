// SSIM of two (C, H, W) images and its gradient: two fused kernels.
//
// Replaces no Pallas kernel: the JAX package's SSIM
// (touchgs_tpu/ops/ssim.py::_blur_cm) blurs the stacked maps with
// block-banded matrix products on the TPU's matrix unit.  On the H100 the
// dense band-matrix products the port first ran do about 73 times the
// operations of a separable 11-tap stencil, so these kernels take their
// place.  They compute ops/ssim.py's ssim_fwd_plain and ssim_bwd_plain:
// an 11x11 Gaussian window (σ 1.5, taps from the host), separable, zero
// padding at the borders and no renormalisation there, c1 and c2 from the
// caller, the mean of the map over C·H·W, all in float32 with fp32 FMAs
// (no fast-math: the divisions are IEEE).
//
// Bound on an H100.  The function itself needs, per pixel of one channel,
// x and y read by the forward and again by the backward and dL/dx written
// (20 bytes), and its blurs: 11 FMAs a value and pass, so 220 fp32
// operations for the five maps forward and 132 for the three backward.
// The forward is bound by its operations (223 with the products: 6.4 µs
// at 800x800x3 against 4.6 µs for its 8 bytes at 3.35 TB/s and 67
// TFLOP/s), the backward by its bytes (12 bytes: 6.9 µs).  This design
// moves 44 bytes, since the forward writes three maps and the backward
// reads them back: 85 MB at 800x800x3, 25 µs.
//
// Design: a block takes one 32x16 tile of output pixels, one a thread, and
// walks the C channels.  For each it stages the tile with a 5-pixel halo
// in shared memory (zero outside the image), blurs along rows into shared
// memory (the five products x, y, x², y², xy formed on the fly from the
// staged x and y) and along columns in registers, so each input value is
// read from device memory once and nothing but the three per-pixel
// partials the backward needs is written.  The inputs are read through
// their strides, so the (H, W, C) render's channel-major view needs no
// copy.  The forward writes, per pixel, a = ∂m/∂μx − 2μx·∂m/∂σxx −
// μy·∂m/∂σxy, b = ∂m/∂σxx and c = ∂m/∂σxy; each block adds up its m in a
// fixed order of shuffles, and the last block to finish (an integer
// ticket, zeroed by the launcher) adds the block sums in a fixed order:
// no float atomics, so two runs are bit-equal.  The backward scales the
// three maps by dL/dSSIM ÷ N, read from device memory, blurs them with the
// same window (symmetric, zero-padded: its own adjoint) and combines
// dL/dx = blur(a) + 2x·blur(b) + y·blur(c).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;                // taps of the window
constexpr int kHalf = kWin / 2;         // the halo
constexpr int kTW = 32;                 // output tile: kTW x kTH pixels
constexpr int kTH = 16;
constexpr int kThreads = kTW * kTH;     // one output pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kInW = kTW + 2 * kHalf;   // staged tile with its halo
constexpr int kInH = kTH + 2 * kHalf;
constexpr int kMaps = 3;                // a, b, c

struct Window {
  float g[kWin];
};

// a (C, H, W) float32 image read or written through its element strides
struct Image {
  float* p;
  long long sc, sh, sw;
  __device__ float get(int c, int h, int w) const {
    return __ldg(p + c * sc + h * sh + w * sw);
  }
};

// the sum of v over the block, the same order in every run; every thread
// gets the sum
__device__ float block_sum(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? s_red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  v = __shfl_sync(0xffffffffu, v, 0);
  __syncthreads();  // s_red is free again
  return v;
}

// stage channel c of n images around the tile at (y0, x0), zero outside
// the image: s[k][r][j] = scale · img[k](c, y0 − kHalf + r, x0 − kHalf + j)
template <int n>
__device__ void stage(float (*s)[kInH][kInW], const Image* img, int c,
                      int H, int W, int y0, int x0, float scale) {
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, j = i % kInW;
    const int gh = y0 - kHalf + r, gw = x0 - kHalf + j;
    const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      s[k][r][j] = in ? scale * img[k].get(c, gh, gw) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssim_fwd_kernel(Image x, Image y, int C, int H, int W, Window win, float c1,
                float c2, float* __restrict__ maps,
                float* __restrict__ block_sums, unsigned int* ticket,
                float* __restrict__ out, float n) {
  __shared__ float s_in[2][kInH][kInW];
  __shared__ float s_row[5][kInH][kTW];
  __shared__ float s_red[kWarps];
  __shared__ bool s_last;
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int w = x0 + tx, h = y0 + ty;
  const bool inside = w < W && h < H;
  const size_t plane = static_cast<size_t>(H) * W;
  const Image xy[2] = {x, y};
  float m_sum = 0.f;
  for (int c = 0; c < C; ++c) {
    stage<2>(s_in, xy, c, H, W, y0, x0, 1.f);
    __syncthreads();
    for (int i = threadIdx.x; i < kInH * kTW; i += kThreads) {
      const int r = i / kTW, j = i % kTW;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        const float g = win.g[k];
        const float vx = s_in[0][r][j + k], vy = s_in[1][r][j + k];
        a0 = fmaf(g, vx, a0);
        a1 = fmaf(g, vy, a1);
        a2 = fmaf(g, vx * vx, a2);
        a3 = fmaf(g, vy * vy, a3);
        a4 = fmaf(g, vx * vy, a4);
      }
      s_row[0][r][j] = a0;
      s_row[1][r][j] = a1;
      s_row[2][r][j] = a2;
      s_row[3][r][j] = a3;
      s_row[4][r][j] = a4;
    }
    __syncthreads();
    float b[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
#pragma unroll
      for (int v = 0; v < 5; ++v) b[v] = fmaf(win.g[k], s_row[v][ty + k][tx], b[v]);
    }
    if (inside) {
      // ssim_fwd_plain's expressions, in its order
      const float mu0 = b[0], mu1 = b[1];
      const float mu00 = mu0 * mu0, mu11 = mu1 * mu1, mu01 = mu0 * mu1;
      const float s00 = b[2] - mu00, s11 = b[3] - mu11, s01 = b[4] - mu01;
      const float a1 = 2.f * mu01 + c1, a2 = 2.f * s01 + c2;
      const float d1 = mu00 + mu11 + c1, d2 = s00 + s11 + c2;
      const float d = d1 * d2;
      const float m = (a1 * a2) / d;
      m_sum += m;
      if (maps != nullptr) {
        const float dc = 2.f * a1 / d;      // ∂m/∂σxy
        const float db = -m / d2;           // ∂m/∂σxx
        const float dmu = 2.f * mu1 * a2 / d - 2.f * mu0 * m / d1;
        const float da = dmu - 2.f * mu0 * db - mu1 * dc;
        const size_t at = (static_cast<size_t>(c) * H + h) * W + w;
        maps[at] = da;
        maps[at + C * plane] = db;
        maps[at + 2 * C * plane] = dc;
      }
    }
    __syncthreads();  // the next channel overwrites s_in
  }

  // the mean: this block's sum, then the last block adds every block's
  const int n_blocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  m_sum = block_sum(m_sum, s_red);
  if (threadIdx.x == 0) {
    block_sums[bid] = m_sum;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_blocks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile float* sums = block_sums;
  float t = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) t += sums[i];
  t = block_sum(t, s_red);
  if (threadIdx.x == 0) out[0] = t / n;
}

__global__ void __launch_bounds__(kThreads, 2)
ssim_bwd_kernel(Image x, Image y, int C, int H, int W, Window win,
                const float* __restrict__ maps, const float* __restrict__ grad,
                float n, Image dx) {
  __shared__ float s_in[kMaps][kInH][kInW];
  __shared__ float s_row[kMaps][kInH][kTW];
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int w = x0 + tx, h = y0 + ty;
  const bool inside = w < W && h < H;
  const long long plane = static_cast<long long>(H) * W;
  const float scale = __ldg(grad) / n;
  Image m[kMaps];
#pragma unroll
  for (int k = 0; k < kMaps; ++k) {
    m[k] = Image{const_cast<float*>(maps) + k * C * plane, plane, W, 1};
  }
  for (int c = 0; c < C; ++c) {
    stage<kMaps>(s_in, m, c, H, W, y0, x0, scale);
    __syncthreads();
    for (int i = threadIdx.x; i < kInH * kTW; i += kThreads) {
      const int r = i / kTW, j = i % kTW;
      float a[kMaps] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
#pragma unroll
        for (int v = 0; v < kMaps; ++v) {
          a[v] = fmaf(win.g[k], s_in[v][r][j + k], a[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < kMaps; ++v) s_row[v][r][j] = a[v];
    }
    __syncthreads();
    float b[kMaps] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
#pragma unroll
      for (int v = 0; v < kMaps; ++v) {
        b[v] = fmaf(win.g[k], s_row[v][ty + k][tx], b[v]);
      }
    }
    if (inside) {
      const float xv = x.get(c, h, w), yv = y.get(c, h, w);
      dx.p[c * dx.sc + h * dx.sh + w * dx.sw] =
          b[0] + 2.f * xv * b[1] + yv * b[2];
    }
    __syncthreads();  // the next channel overwrites s_in
  }
}

Window window_of(const float* taps) {
  Window win;
  for (int k = 0; k < kWin; ++k) win.g[k] = taps[k];
  return win;
}

dim3 grid_of(int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
}

}  // namespace

// taps: host pointer to the kWin window taps.  Strides are in elements.
// maps (3, C, H, W) contiguous, or null where no gradient is wanted;
// scratch: n_scratch words, at least ssim_scratch_words(H, W);
// out: the mean, one float.
extern "C" int ssim_fwd_launch(const float* x, const float* y, int C, int H,
                               int W, int xsc, int xsh, int xsw, int ysc,
                               int ysh, int ysw, const float* taps, float c1,
                               float c2, float* maps, float* scratch,
                               int n_scratch, float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(H, W);
  const int n_blocks = static_cast<int>(grid.x * grid.y);
  if (n_scratch < n_blocks + 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* ticket = reinterpret_cast<unsigned int*>(scratch + n_blocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_fwd_kernel<<<grid, kThreads, 0, s>>>(
      Image{const_cast<float*>(x), xsc, xsh, xsw},
      Image{const_cast<float*>(y), ysc, ysh, ysw}, C, H, W, window_of(taps),
      c1, c2, maps, scratch, ticket, out,
      static_cast<float>(static_cast<long long>(C) * H * W));
  return static_cast<int>(cudaGetLastError());
}

// the words of ssim_fwd_launch's scratch for an H x W image: a partial sum
// a tile and the ticket
extern "C" int ssim_scratch_words(int H, int W) {
  const dim3 grid = grid_of(H, W);
  return static_cast<int>(grid.x * grid.y) + 1;
}

// grad: device pointer to dL/dSSIM (one float); dx written through its
// strides.
extern "C" int ssim_bwd_launch(const float* x, const float* y, int C, int H,
                               int W, int xsc, int xsh, int xsw, int ysc,
                               int ysh, int ysw, const float* taps,
                               const float* maps, const float* grad,
                               float* dx, int dsc, int dsh, int dsw,
                               void* stream) {
  ssim_bwd_kernel<<<grid_of(H, W), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      Image{const_cast<float*>(x), xsc, xsh, xsw},
      Image{const_cast<float*>(y), ysc, ysh, ysw}, C, H, W, window_of(taps),
      maps, grad, static_cast<float>(static_cast<long long>(C) * H * W),
      Image{dx, dsc, dsh, dsw});
  return static_cast<int>(cudaGetLastError());
}
