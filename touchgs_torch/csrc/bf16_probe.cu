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
// round too: 0.999 is 1.0 in bf16, 1/255 is 0.00393676758.  The products
// and sums are the _rn intrinsics in both legs, so nothing is contracted;
// the legs differ only in the working type.
//
// Operations per (row, pixel), counted from this source (each +, −, ×,
// unary −, min, compare, && and select is one, exp2 is one):
//   chain: dx, dy 2; σ 8; −σ 1; exp2 1; op·e 1; min 1; mask 4       = 18
//   sum: Σ 1                                                        = 1
// The chain runs in the working type, the chunk sum in f32.  (ops/anatomy.py
// PROBE_CHAIN_OPS and PROBE_SUM_OPS hold the same counts; a test parses
// them.)
//
// Bound on an H100: operations (f32 leg over the 67 TFLOP/s fp32 rate;
// bf16 leg's chain over the 989 TFLOP/s bf16 rate of the published table,
// which is the tensor cores' rate and which no elementwise chain reaches,
// plus its f32 sums).  Neither chain has an FMA, so at one instruction per
// lane and clock the f32 leg reaches about half its bound.
//
// Design.  Pixels do not depend on each other, so a block takes part of a
// tile: the 625-tile probe is thousands of small blocks, not 4.7 waves of
// one 1024-thread block a tile.  Each block stages the tile's 512 rows once.
//
// - f32 leg: 64 threads of four pixels (a quarter tile a block).  Each row
//   is staged as eight floats [mx, my, ca, cb, cc, op, 0, 0], so two 16-byte
//   shared loads serve four pairs.  The chain is as above, one pair at a
//   time, and each chunk's sum is a sequential f32 sum.
// - bf16 leg: two rows a word.  A __nv_bfloat162 holds rows (k, k + 1) of
//   one pixel, so a pixel's px and py are broadcast into both halves once,
//   and each column is staged once as row-pair words (eight words a pair:
//   the six columns and two of padding).  The chain runs on the packed
//   ALU (HMUL2/HADD2 on the FMA pipe, HMNMX2, HSET2), its exp2 as h2exp2
//   (each half converted to f32 for ex2.approx.f32 and rounded back).  The
//   α words are the B fragment of
//   mma.m16n8k16.row.col.f32.bf16.bf16.f32: lane l holds rows
//   2·(l % 4) + {0, 1} and + {8, 9} of a 16-row k-step for pixel l / 4 of
//   an 8-pixel n-tile.  With A all ones (exact products) the tensor core
//   adds each 128-row chunk, eight k-steps, in f32; each lane then reads
//   the sums of pixels 2·(l % 4) + {0, 1} of the n-tile from D, rounds them
//   to bf16 and adds them to its bf16 running totals.  A warp owns four
//   n-tiles (32 pixels), a block four warps (128 pixels, an eighth of a
//   tile).  The tensor core's f32 sum, in its own order, and the f32
//   ex2.approx under h2exp2 are the only differences from the plain
//   version.  (PTX ex2.approx.ftz.bf16x2 takes the same one MUFU a pair,
//   as two MUFU.EX2.BF16 without the conversions; it is not correctly
//   rounded in bf16, and the probe compares the working types, not two
//   exp2 instructions.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsIn = 512;  // rows per tile
constexpr int kChunk = 128;   // rows per chunk
constexpr int kNChunks = kRowsIn / kChunk;
constexpr int kCols = 16;     // columns per row
constexpr int kNpix = 1024;
constexpr int kP = 4;         // pixels a thread (bf16: n-tiles a warp)

constexpr int kF32Threads = 64;
constexpr int kF32Pix = kF32Threads * kP;    // pixels a block
constexpr int kF32Blocks = kNpix / kF32Pix;  // blocks a tile

constexpr int kBfWarps = 4;
constexpr int kBfThreads = 32 * kBfWarps;
constexpr int kBfPix = kBfWarps * 8 * kP;
constexpr int kBfBlocks = kNpix / kBfPix;
constexpr int kKStep = 16;  // rows an mma adds

__global__ void __launch_bounds__(kF32Threads)
probe_f32_kernel(const float* __restrict__ attrs, float* __restrict__ out) {
  __shared__ __align__(16) float s_row[kRowsIn * 8];
  const int t = blockIdx.x / kF32Blocks;
  const int q = threadIdx.x;
  const int pix0 = (blockIdx.x % kF32Blocks) * kF32Pix + q;
  const float* tile = attrs + static_cast<size_t>(t) * kRowsIn * kCols;
  for (int r = q; r < kRowsIn; r += kF32Threads) {
    const float4 a = *reinterpret_cast<const float4*>(tile + r * kCols);
    const float2 b = *reinterpret_cast<const float2*>(tile + r * kCols + 4);
    float4* d = reinterpret_cast<float4*>(s_row + r * 8);
    d[0] = a;
    d[1] = make_float4(b.x, b.y, 0.f, 0.f);
  }
  __syncthreads();

  const float clip = 0.999f, thr = 1.f / 255.f;
  float px[kP], py[kP], acc[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    px[j] = static_cast<float>(pix0 + j * kF32Threads);
    py[j] = __fmul_rn(px[j], 0.5f);
    acc[j] = 0.f;
  }
#pragma unroll 1
  for (int c = 0; c < kNChunks; ++c) {
    float sum[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) sum[j] = 0.f;
    for (int e = c * kChunk; e < (c + 1) * kChunk; ++e) {
      const float4* v = reinterpret_cast<const float4*>(s_row + e * 8);
      const float4 a = v[0], b = v[1];  // [mx, my, ca, cb], [cc, op, 0, 0]
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        const float dx = __fsub_rn(px[j], a.x);
        const float dy = __fsub_rn(py[j], a.y);
        const float sig = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                      __fmul_rn(__fmul_rn(b.x, dy), dy)),
            __fmul_rn(__fmul_rn(a.w, dx), dy));
        float al = fminf(clip, __fmul_rn(b.y, exp2f(-sig)));
        al = (sig >= 0.f && al >= thr) ? al : 0.f;
        sum[j] = __fadd_rn(sum[j], al);
      }
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) acc[j] = __fadd_rn(acc[j], sum[j]);
  }
  float* o = out + static_cast<size_t>(t) * kNpix + pix0;
#pragma unroll
  for (int j = 0; j < kP; ++j) o[j * kF32Threads] = acc[j];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 words(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// α of the two rows of a staged row pair (u = [mx, my, ca, cb],
// v = [cc, op, 0, 0], one row-pair word each) for one pixel.
__device__ __forceinline__ uint32_t alpha2(const uint4& u, const uint4& v,
                                           __nv_bfloat162 px,
                                           __nv_bfloat162 py,
                                           __nv_bfloat162 clip,
                                           __nv_bfloat162 thr) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  const __nv_bfloat162 dx = __hsub2_rn(px, words(u.x));
  const __nv_bfloat162 dy = __hsub2_rn(py, words(u.y));
  const __nv_bfloat162 sig = __hadd2_rn(
      __hadd2_rn(__hmul2_rn(__hmul2_rn(words(u.z), dx), dx),
                 __hmul2_rn(__hmul2_rn(words(v.x), dy), dy)),
      __hmul2_rn(__hmul2_rn(words(u.w), dx), dy));
  const __nv_bfloat162 al =
      __hmin2(clip, __hmul2_rn(words(v.y), h2exp2(__hneg2(sig))));
  // each compare gives 1 or 0 per half; α is finite and ≥ 0, so the
  // products are exactly α or 0
  return bits(__hmul2_rn(al, __hmul2_rn(__hge2(sig, zero), __hge2(al, thr))));
}

// d += ones(16x16) · b: column n of d gains the sum of B's 16 rows of
// column n, in f32 (the four registers: rows l / 4 and l / 4 + 8, columns
// 2·(l % 4) + {0, 1}; every row of d is the same).
__device__ __forceinline__ void add_rows(float (&d)[4], uint32_t b0,
                                         uint32_t b1) {
  const uint32_t one = 0x3F803F80u;  // bf16 1.0 in both halves
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(one), "r"(one), "r"(one), "r"(one), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kBfThreads)
probe_bf16_kernel(const __nv_bfloat16* __restrict__ attrs,
                  float* __restrict__ out) {
  // row pair i: [mx, my, ca, cb] and [cc, op, 0, 0] of rows 2i, 2i + 1
  __shared__ uint4 s_pair[kRowsIn / 2][2];
  const int t = blockIdx.x / kBfBlocks;
  const int q = threadIdx.x;
  const int lane = q & 31, warp = q >> 5;
  const int g = lane & 3, n = lane >> 2;
  const __nv_bfloat16* tile =
      attrs + static_cast<size_t>(t) * kRowsIn * kCols;
  for (int i = q; i < kRowsIn / 2; i += kBfThreads) {
    // columns 0..7 of each row; the low half of a word is row 2i
    const uint4 r0 = *reinterpret_cast<const uint4*>(tile + 2 * i * kCols);
    const uint4 r1 =
        *reinterpret_cast<const uint4*>(tile + (2 * i + 1) * kCols);
    s_pair[i][0] = make_uint4(
        __byte_perm(r0.x, r1.x, 0x5410), __byte_perm(r0.x, r1.x, 0x7632),
        __byte_perm(r0.y, r1.y, 0x5410), __byte_perm(r0.y, r1.y, 0x7632));
    s_pair[i][1] = make_uint4(__byte_perm(r0.z, r1.z, 0x5410),
                              __byte_perm(r0.z, r1.z, 0x7632), 0u, 0u);
  }
  __syncthreads();

  const __nv_bfloat162 clip = __float2bfloat162_rn(0.999f);
  const __nv_bfloat162 thr = __float2bfloat162_rn(1.f / 255.f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  // n-tile j of the warp: pixels pix0 + 8j .. pix0 + 8j + 7
  const int pix0 = (blockIdx.x % kBfBlocks) * kBfPix + warp * 8 * kP;
  __nv_bfloat162 px[kP], py[kP], acc[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    px[j] = __float2bfloat162_rn(static_cast<float>(pix0 + 8 * j + n));
    py[j] = __hmul2_rn(px[j], half);
    acc[j] = __float2bfloat162_rn(0.f);
  }
#pragma unroll 1
  for (int c = 0; c < kNChunks; ++c) {
    float d[kP][4];
#pragma unroll
    for (int j = 0; j < kP; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk / kKStep; ++s) {
      // rows 2g, 2g + 1 and 2g + 8, 2g + 9 of the k-step
      const int pair = (c * kChunk + s * kKStep) / 2 + g;
      const uint4 u0 = s_pair[pair][0], v0 = s_pair[pair][1];
      const uint4 u1 = s_pair[pair + 4][0], v1 = s_pair[pair + 4][1];
#pragma unroll
      for (int j = 0; j < kP; ++j)
        add_rows(d[j], alpha2(u0, v0, px[j], py[j], clip, thr),
                 alpha2(u1, v1, px[j], py[j], clip, thr));
    }
#pragma unroll
    for (int j = 0; j < kP; ++j)
      acc[j] = __hadd2_rn(acc[j], __floats2bfloat162_rn(d[j][0], d[j][1]));
  }
  // the lane holds pixels 8j + 2g and 8j + 2g + 1 of every n-tile j; the
  // lanes with n == j store n-tile j
  float* o = out + static_cast<size_t>(t) * kNpix + pix0;
#pragma unroll
  for (int j = 0; j < kP; ++j)
    if (n == j)
      *reinterpret_cast<float2*>(o + 8 * j + 2 * g) =
          __bfloat1622float2(acc[j]);
}

}  // namespace

// attrs: (n_tiles, 512, 16) f32, or bf16 when bf16 != 0, 16-byte aligned;
// out: (n_tiles, 1024) f32.
extern "C" int bf16_probe_launch(const void* attrs, float* out, int bf16,
                                 int n_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    if (bf16) {
      probe_bf16_kernel<<<n_tiles * kBfBlocks, kBfThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(attrs), out);
    } else {
      probe_f32_kernel<<<n_tiles * kF32Blocks, kF32Threads, 0, s>>>(
          static_cast<const float*>(attrs), out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
