// K1: front-packed per-tile Gaussian lists, and the attribute rows they
// name.
//
// Replaces touchgs_tpu/ops/rasterize_pallas.py::_slot_lists (:401-474, the
// pallas_call at :468), and with the rows the gather attrs[gidx] that
// follows it (:620, :697).  Slot j of tile t is sorted position
// starts[t] + j for j < counts[t] (counts already capped at k_tile), else
// the dead row dead + ((j + 131·t) & 511).  The kernel writes that index
// to gidx and, given the packed (dead + 512, 16) f32 table attrs, the
// slot's row to rows, so that rows == attrs[gidx] bit for bit.  A launch
// over a slice of the tile grid (one shard of a sharded render) passes the
// slice's first tile as tile0: t is then tile0 + the block's tile, so the
// slice's dead indices equal those of the whole grid's lists.
//
// Bound on an H100: bytes.  It reads each tile's live run of sorted_gauss
// once and one 64-byte row per slot, and writes the (n_tiles, k_tile) int32
// table and the (n_tiles, k_tile, 16) f32 rows once; it does no arithmetic
// to speak of.
//
// Design: a block takes 64 slots of one tile.  With rows, four threads a
// slot: the first reads the slot's index once, writes it to gidx and hands
// it to the other three through a width-4 shuffle; each of the four then
// copies one 16-byte quarter of the row, so a warp reads eight whole rows
// and writes 512 contiguous bytes.  The 512 dead rows (32 KB) are read like
// live ones and stay in L2.  Without attrs, one thread a slot writes gidx
// alone.  The TPU kernel's aligned DMA and lane roll existed only because
// Mosaic cannot slice lanes at a dynamic offset; a direct indexed read
// needs neither.
#include <cuda_runtime.h>

namespace {

constexpr int kDeadSpread = 512;  // dead rows appended to the attribute table
constexpr int kSlots = 64;        // slots a block
constexpr int kQuarters = 4;      // float4s of a 16-float attribute row

// kLanes threads a slot: kQuarters to copy the rows too, 1 for gidx alone
template <int kLanes>
__global__ void __launch_bounds__(kSlots * kLanes)
slot_lists_kernel(const int* __restrict__ sorted_gauss,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  const float4* __restrict__ attrs, int* __restrict__ gidx,
                  float4* __restrict__ rows, int k_tile, int dead,
                  int tile0) {
  const int t = blockIdx.x;  // the tile within this launch's slice
  const int lane = threadIdx.x % kLanes;
  const int j = blockIdx.y * kSlots + threadIdx.x / kLanes;
  const bool in_tile = j < k_tile;
  const size_t slot = static_cast<size_t>(t) * k_tile + j;
  int g = 0;
  if (lane == 0 && in_tile) {
    g = j < counts[t] ? sorted_gauss[starts[t] + j]
                      : dead + ((j + (tile0 + t) * 131) & (kDeadSpread - 1));
    gidx[slot] = g;
  }
  if constexpr (kLanes > 1) {
    g = __shfl_sync(0xffffffffu, g, 0, kLanes);
    if (in_tile) {
      rows[slot * kQuarters + lane] =
          __ldg(attrs + static_cast<size_t>(g) * kQuarters + lane);
    }
  }
}

}  // namespace

// attrs and rows null: gidx alone
extern "C" int slot_lists_launch(const int* sorted_gauss, const int* starts,
                                 const int* counts, const float* attrs,
                                 int* gidx, float* rows, int n_tiles,
                                 int k_tile, int dead, int tile0,
                                 void* stream) {
  if (n_tiles > 0 && k_tile > 0) {
    const dim3 grid(n_tiles, (k_tile + kSlots - 1) / kSlots);
    const auto s = static_cast<cudaStream_t>(stream);
    if (attrs != nullptr) {
      slot_lists_kernel<kQuarters><<<grid, kSlots * kQuarters, 0, s>>>(
          sorted_gauss, starts, counts, reinterpret_cast<const float4*>(attrs),
          gidx, reinterpret_cast<float4*>(rows), k_tile, dead, tile0);
    } else {
      slot_lists_kernel<1><<<grid, kSlots, 0, s>>>(
          sorted_gauss, starts, counts, nullptr, gidx, nullptr, k_tile, dead,
          tile0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
