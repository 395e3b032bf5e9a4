// The logical tiles of the ragged grouped GEMM (csrc/grouped_gemm.cu,
// csrc/grouped_wgmma.cu): the row partition's G + 1 contiguous segments
// (the groups' spans [ends[g-1], ends[g]), then the zero tail [ends[G-1],
// M)) cut at the M tiles of ``bm`` rows.  A partition into G + 1 segments
// meets at most cdiv(M, bm) + G (segment, M tile) pairs; each kernel's
// walk is bounded by that and finds its tiles here from the device-side
// ends, so routing never reaches the host.
#pragma once

namespace gemm_hls {

// Logical tile t: group ``grp`` (G for the zero tail), rows [r_lo, r_hi) of
// the M tile at m0.  False past the live tile count.
__device__ __forceinline__ bool locate_span(const int* ends, int G, int M, int t, int bm, int& grp,
                                            int& m0, int& r_lo, int& r_hi) {
  int start = 0;
  for (int i = 0; i <= G; ++i) {
    const int end = i < G ? ends[i] : M;
    if (end > start) {
      const int first = start / bm, tiles = (end - 1) / bm - first + 1;
      if (t < tiles) {
        grp = i;
        m0 = (first + t) * bm;
        r_lo = max(start, m0);
        r_hi = min(end, m0 + bm);
        return true;
      }
      t -= tiles;
      start = end;
    }
  }
  return false;
}

}  // namespace gemm_hls
