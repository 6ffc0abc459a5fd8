// K6: does bf16 elementwise math run the α chain faster than fp32?
//
// Replaces tools/exp_kernel_anatomy.py::bf16_probe's make(dtype) kernels
// (:188-213, the pallas_call at :205).  Input (n_tiles, 512, 16) in f32 or
// bf16; per tile and pixel index i (px = i in the working type, py = 0.5·px),
// four chunks of 128 rows each add
//   Σ_rows α,  α = min(0.999, op·2^(−σ)) kept where σ ≥ 0 and α ≥ 1/255,
//   σ = ca·dx·dx + cc·dy·dy + cb·dx·dy,  dx = px − mx,  dy = py − my,
// with [mx, my, ca, cb, cc, op] the row's first six columns.
// Output (n_tiles, 1, 1024) f32.
//
// Arithmetic, as the JAX package's interpret run evaluates it (the compiled
// CPU program rounds after every operation): each operation of the α chain
// is rounded to the working type; each chunk's sum over its 128 rows is
// taken ONCE in f32 (jnp.sum upcasts a bf16 reduction) and rounded to the
// working type; the running total is kept in the working type, rounded
// after every chunk.  (The compiled JAX program also leaves the last add
// unrounded, an excess-precision artefact worth at most half a bf16 ulp of
// the output; the plain version and this kernel round it.)  The constants
// round too: 0.999 is 1.0 in bf16, 1/255 is 0.00393676758.
//
// The products and sums are the _rn intrinsics in both legs, so nothing is
// contracted and α rounds as in the plain version; the legs differ only in
// the working type.  The bf16 leg carries two neighbouring pixels per thread
// in __nv_bfloat162 and runs on the packed ALU: HMUL2/HADD2 (the FMA pipe's
// bf16x2 forms), HMNMX2 for min, HSET2 for the compares.  Its exp2 is
// h2exp2, which the CUDA 12 headers implement, for sm_80 and later, as two
// f32 ex2.approx (two MUFU.EX2) between conversions: the one step of the
// chain that is not packed.  h2exp2 is not correctly rounded: that, and the
// order of the f32 chunk sums, are the only differences from the plain
// version.
//
// fp32 operations per (row, pixel), counted from this source: dx, dy 2;
// σ 8; −σ 1; exp2 1; op·e 1; min 1; mask 4; Σ 1 = 19 + 1 = 20 (the bf16 leg
// does the first 19 in bf16, the chunk sum in f32).
//
// Bound on an H100: operations (f32 leg over the 67 TFLOP/s fp32 rate;
// bf16 leg's bf16 operations over the 989 TFLOP/s bf16 rate of the
// published table, which is the tensor cores' rate, plus its f32 sums).
//
// Design: one block per tile.  Each chunk's six used columns are staged in
// shared memory; the bf16 leg stores each value duplicated into both halves
// of a bf16x2 word, so the inner loop reads six broadcast words and
// converts nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsIn = 512;  // rows per tile
constexpr int kChunk = 128;   // rows per chunk
constexpr int kNChunks = kRowsIn / kChunk;
constexpr int kCols = 16;     // columns per row
constexpr int kUsed = 6;      // mx, my, ca, cb, cc, op
constexpr int kNpix = 1024;

__global__ void __launch_bounds__(kNpix, 1)
probe_f32_kernel(const float* __restrict__ attrs, float* __restrict__ out) {
  __shared__ float s_row[kChunk * kUsed];
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const float px = static_cast<float>(q);
  const float py = __fmul_rn(px, 0.5f);
  const float clip = 0.999f, thr = 1.f / 255.f;
  const float* tile = attrs + static_cast<size_t>(t) * kRowsIn * kCols;

  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kNChunks; ++c) {
    for (int i = q; i < kChunk * kUsed; i += kNpix)
      s_row[i] = tile[(c * kChunk + i / kUsed) * kCols + i % kUsed];
    __syncthreads();
    float sum = 0.f;
    for (int e = 0; e < kChunk; ++e) {
      const float* a = s_row + e * kUsed;
      const float dx = __fsub_rn(px, a[0]);
      const float dy = __fsub_rn(py, a[1]);
      const float sig = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(a[2], dx), dx),
                    __fmul_rn(__fmul_rn(a[4], dy), dy)),
          __fmul_rn(__fmul_rn(a[3], dx), dy));
      float al = fminf(clip, __fmul_rn(a[5], exp2f(-sig)));
      al = (sig >= 0.f && al >= thr) ? al : 0.f;
      sum = __fadd_rn(sum, al);
    }
    acc = __fadd_rn(acc, sum);
    __syncthreads();  // the chunk's rows are read by all before restaging
  }
  out[static_cast<size_t>(t) * kNpix + q] = acc;
}

__global__ void __launch_bounds__(kNpix / 2, 1)
probe_bf16_kernel(const __nv_bfloat16* __restrict__ attrs,
                  float* __restrict__ out) {
  __shared__ __nv_bfloat162 s_row[kChunk * kUsed];
  const int t = blockIdx.x;
  const int q = threadIdx.x;  // pixels 2q and 2q + 1
  const __nv_bfloat162 px = __floats2bfloat162_rn(
      static_cast<float>(2 * q), static_cast<float>(2 * q + 1));
  const __nv_bfloat162 py =
      __hmul2_rn(px, __float2bfloat162_rn(0.5f));
  const __nv_bfloat162 clip = __float2bfloat162_rn(0.999f);
  const __nv_bfloat162 thr = __float2bfloat162_rn(1.f / 255.f);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  const __nv_bfloat16* tile = attrs + static_cast<size_t>(t) * kRowsIn * kCols;

  __nv_bfloat162 acc = zero;
#pragma unroll
  for (int c = 0; c < kNChunks; ++c) {
    for (int i = q; i < kChunk * kUsed; i += kNpix / 2)
      s_row[i] = __bfloat162bfloat162(
          tile[(c * kChunk + i / kUsed) * kCols + i % kUsed]);
    __syncthreads();
    float sum_lo = 0.f, sum_hi = 0.f;
    for (int e = 0; e < kChunk; ++e) {
      const __nv_bfloat162* a = s_row + e * kUsed;
      const __nv_bfloat162 dx = __hsub2_rn(px, a[0]);
      const __nv_bfloat162 dy = __hsub2_rn(py, a[1]);
      const __nv_bfloat162 sig = __hadd2_rn(
          __hadd2_rn(__hmul2_rn(__hmul2_rn(a[2], dx), dx),
                     __hmul2_rn(__hmul2_rn(a[4], dy), dy)),
          __hmul2_rn(__hmul2_rn(a[3], dx), dy));
      __nv_bfloat162 al = __hmin2(clip, __hmul2_rn(a[5], h2exp2(__hneg2(sig))));
      // each compare gives 1 or 0 per half; α is finite and ≥ 0, so the
      // products are exactly α or 0
      al = __hmul2_rn(al, __hmul2_rn(__hge2(sig, zero), __hge2(al, thr)));
      sum_lo = __fadd_rn(sum_lo, __low2float(al));
      sum_hi = __fadd_rn(sum_hi, __high2float(al));
    }
    acc = __hadd2_rn(acc, __floats2bfloat162_rn(sum_lo, sum_hi));
    __syncthreads();
  }
  reinterpret_cast<float2*>(out + static_cast<size_t>(t) * kNpix)[q] =
      __bfloat1622float2(acc);
}

}  // namespace

// attrs: (n_tiles, 512, 16) f32, or bf16 when bf16 != 0; out: (n_tiles,
// 1024) f32.
extern "C" int bf16_probe_launch(const void* attrs, float* out, int bf16,
                                 int n_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    if (bf16) {
      probe_bf16_kernel<<<n_tiles, kNpix / 2, 0, s>>>(
          static_cast<const __nv_bfloat16*>(attrs), out);
    } else {
      probe_f32_kernel<<<n_tiles, kNpix, 0, s>>>(
          static_cast<const float*>(attrs), out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
