// K9 solid_compact: stable front-compaction of the solid columns of a
// counted distinct table, for the store checkpoint.
//
// Replaces bcalm_tpu/ops/count.py:filter_abundance_pos (with compact :56:
// a cumsum of the mask and L+2 scatters on the TPU).  Column i of the
// (L, N) table is solid when i < n_unique and amin <= count <= amax; the
// solid columns' lanes, counts and minpos move, in their order, to the
// front of one stacked (L+2, W) output (rows 0..L-1 lanes, L counts, L+1
// minpos) and n_solid receives their number.  The output has W >= n_solid
// columns (N for JAX's shape; n_solid, known from K7, for the store's
// copy); the wrapper fills it first (0, and the sentinel in the minpos
// row), as JAX's compact and its SENTINEL past n_solid do.
//
// The destination of a solid column is the exclusive prefix count of the
// mask (scan.cuh's three-launch tile scan), so the order is stable without
// atomics.  Bound: memory, the counts read twice and (L+2)*8 bytes read
// and written per solid column.
#include "scan.cuh"

namespace {

struct SolidFlag {
  const int64_t* counts;
  long long n_unique, amin, amax;
  __device__ long long operator()(long long i) const {
    long long c = counts[i];
    return (i < n_unique && c >= amin && c <= amax) ? 1 : 0;
  }
};

struct SolidScatter {
  const int64_t* unique;
  long long ustride;
  const int64_t* counts;
  const int64_t* minpos;
  int L;
  int64_t* out;
  long long ostride, W;
  __device__ void operator()(long long i, long long dest, long long keep) const {
    if (!keep || dest >= W) return;
    for (int j = 0; j < L; ++j) out[j * ostride + dest] = unique[j * ustride + i];
    out[L * ostride + dest] = counts[i];
    out[(L + 1) * ostride + dest] = minpos[i];
  }
};

}  // namespace

extern "C" int bt_solid_compact(const int64_t* unique, long long ustride,
                                const int64_t* counts, const int64_t* minpos,
                                long long N, long long n_unique, int L,
                                long long amin, long long amax,
                                long long* scratch, int64_t* out,
                                long long ostride, long long W,
                                int64_t* n_solid,
                                void* stream) {
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  SolidFlag flag{counts, n_unique, amin, amax};
  SolidScatter scatter{unique, ustride, counts, minpos, L, out, ostride, W};
  return exclusive_sum(flag, scatter, N, scratch, n_solid,
                       static_cast<cudaStream_t>(stream));
}
