// The backward of K1's gather rows = attrs[gidx]: the per-Gaussian rows'
// gradient, the (n_tiles, k_tile, 16) slot gradients K3 wrote added into the
// (dead + 512, 16) table by gidx, over the live slots alone.
//
// Replaces no TPU kernel: the JAX package leaves the gather's VJP to XLA's
// scatter-add (touchgs_tpu/ops/rasterize_pallas.py:620, :697), and the port
// ran PyTorch's index_put_ with accumulate=True.  That call sorts every
// slot's index, dead slots too, and gives one warp to each run of equal
// indices, which it walks one duplicate after another: each of the 512 dead
// rows (dead + ((j + 131·t) & 511), csrc/slot_lists.cu) takes thousands of
// slots, so the longest serial runs set its time.  No reader takes the dead
// rows' gradient: the shade stage's VJP reads rows < dead, the dead rows'
// concatenation drops them.  So this pair adds only slots j < counts[t] and
// writes the dead rows as zeros.
//
// Bound on an H100: bytes.  It reads each live slot's index and 64-byte
// gradient row once and writes the table once: live slots × 68 B + rows ×
// 64 B.  The two passes' own traffic (a counter and a slot number a live
// slot, written and read back) is a few bytes more a slot.
//
// Design, deterministic with no float atomics:
// - the counters n[g] are cleared (a memset, a node of a captured graph);
// - pass A, one thread a slot of a (tile, 256-slot) block: a live slot
//   claims c = atomicAdd(&n[g], 1) on an int counter and writes its slot
//   number t·k_tile + j to list[g·width + c].  A row of one grid's lists
//   lies in at most width live slots (one a tile, in at most
//   max_tiles_per_gaussian tiles, ops/tiles.py); a row past that bound, or
//   a live slot naming a row ≥ dead, is a fault of the caller and traps;
// - pass B, four threads a row, a float4 each: the row's n[g] slot numbers
//   taken in ascending order (a selection over the short list, as the
//   atomics wrote it in no fixed order) and their gradient rows summed from
//   +0.0 in that order; rows with no slot and the dead rows are written as
//   zeros, so the table needs no fill.
// Ascending slot order is the order in which index_put_'s stable sort
// presents a row's duplicates, and its sum starts from 0.0 too, so rows <
// dead equal its result bit for bit.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kDeadSpread = 512;   // dead rows appended to the table
constexpr int kQuarters = 4;       // float4s of a 16-float row
constexpr int kCountThreads = 256; // slots a block of pass A
constexpr int kSumThreads = 256;   // threads a block of pass B: 64 rows

__global__ void __launch_bounds__(kCountThreads)
scatter_rows_count_kernel(const int* __restrict__ gidx,
                          const int* __restrict__ counts, int* n_of,
                          int* __restrict__ list, int k_tile, int dead,
                          int width) {
  const int t = blockIdx.x;
  const int j = blockIdx.y * kCountThreads + threadIdx.x;
  if (j >= k_tile || j >= counts[t]) return;
  const int slot = t * k_tile + j;  // < 2^31, checked by the wrapper
  const int g = gidx[slot];
  if (g < 0 || g >= dead) __trap();
  const int c = atomicAdd(n_of + g, 1);
  if (c >= width) __trap();
  list[static_cast<size_t>(g) * width + c] = slot;
}

__global__ void __launch_bounds__(kSumThreads)
scatter_rows_sum_kernel(const float4* __restrict__ grad,
                        const int* __restrict__ n_of,
                        const int* __restrict__ list,
                        float4* __restrict__ out, int rows, int dead,
                        int width) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads
                   + threadIdx.x;
  const size_t g = i / kQuarters;
  const int q = static_cast<int>(i % kQuarters);
  if (g >= static_cast<size_t>(rows)) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g < static_cast<size_t>(dead)) {
    const int n = n_of[g];
    const int* l = list + g * width;
    int prev = -1;
    for (int r = 0; r < n; ++r) {
      int next = INT_MAX;  // the least slot number above prev
      for (int k = 0; k < n; ++k) {
        const int v = l[k];
        next = (v > prev && v < next) ? v : next;
      }
      const float4 x = grad[static_cast<size_t>(next) * kQuarters + q];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
      prev = next;
    }
  }
  out[i] = acc;
}

}  // namespace

// scratch: dead counters, then dead · width slot numbers
extern "C" int scatter_rows_launch(const float* grad, const int* gidx,
                                   const int* counts, int* scratch,
                                   float* out, int n_tiles, int k_tile,
                                   int dead, int width, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int* n_of = scratch;
  int* list = scratch + dead;
  if (dead > 0) {
    const cudaError_t e =
        cudaMemsetAsync(n_of, 0, sizeof(int) * static_cast<size_t>(dead), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_tiles > 0 && k_tile > 0) {
    const dim3 grid(n_tiles, (k_tile + kCountThreads - 1) / kCountThreads);
    scatter_rows_count_kernel<<<grid, kCountThreads, 0, s>>>(
        gidx, counts, n_of, list, k_tile, dead, width);
  }
  const int rows = dead + kDeadSpread;
  const size_t blocks =
      (static_cast<size_t>(rows) * kQuarters + kSumThreads - 1) / kSumThreads;
  scatter_rows_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                            s>>>(reinterpret_cast<const float4*>(grad), n_of,
                                 list, reinterpret_cast<float4*>(out), rows,
                                 dead, width);
  return static_cast<int>(cudaGetLastError());
}
