// The tile-visit schedule of the grouped expert kernel's small-row tiles
// (gmm.cu, K19's forward at 17-64 rows and its dx at 64 or fewer):
// megablox's group metadata, made inside the block.
//
// Rows are sorted by expert; group g owns rows [off_g, off_g + size_g),
// off the running sum of the int32 group sizes, which stay on the device.
// The grid's visit axis runs over at most ceil(m / BM) + E visits: a BM-row
// tile that straddles two experts is visited once per expert, each visit
// on its own rows; empty experts have no visit; blocks past the last visit
// find expert -1 and exit. Thread 0 walks the E group sizes, so the launch
// needs nothing from the host.

#pragma once

namespace {

// The tile visit of this block: its expert and the rows [lo, hi) of that
// expert within the BM-row tile; expert -1 past the last visit.
struct Visit {
  int expert, lo, hi;
};

template <int BM>
__device__ __forceinline__ Visit find_visit(const int* __restrict__ group_sizes, int E, int v) {
  __shared__ Visit s;
  if (threadIdx.x == 0) {
    Visit out{-1, 0, 0};
    int off = 0, visits = 0;
    for (int g = 0; g < E; ++g) {
      const int size = group_sizes[g];
      if (size > 0) {
        const int first = off / BM, last = (off + size - 1) / BM;
        if (v < visits + last - first + 1) {
          const int t0 = (first + v - visits) * BM;
          out.expert = g;
          out.lo = off > t0 ? off : t0;
          out.hi = off + size < t0 + BM ? off + size : t0 + BM;
          break;
        }
        visits += last - first + 1;
      }
      off += size;
    }
    s = out;
  }
  __syncthreads();
  return s;
}

}  // namespace
