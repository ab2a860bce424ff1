// Span composition of the packed chain state (shared by K4 and K16).
//
// bcalm_tpu/ops/chains.py:_composeF: a row (ptr, dist|flags, mn, dmn)
// composed with its ancestor's row.  Flags sit in bits 28-30 of the dist
// column (SETTLED, FIX, ROOTED) and dist saturates at _DMASK, exactly as
// in the JAX package; a ROOTED row absorbs (comes back unchanged).  The
// ancestor row is read only for rows that are not ROOTED.
#pragma once

#include <cstdint>

namespace bt {

constexpr long long kSettled = 1ll << 28;
constexpr long long kFix = 1ll << 29;
constexpr long long kRooted = 1ll << 30;
constexpr long long kDmask = (1ll << 28) - 1;

// out = composeF(q, a); returns true when out differs from q.
__device__ __forceinline__ bool compose_row(const int64_t* q, const int64_t* a,
                                            int64_t* out) {
  long long qd = q[1];
  if (qd & kRooted) {
    out[0] = q[0]; out[1] = qd; out[2] = q[2]; out[3] = q[3];
    return false;
  }
  long long ad = a[1];
  long long dq = qd & kDmask;
  long long dist = dq + (ad & kDmask);
  if (dist > kDmask) dist = kDmask;
  long long flg = ((qd | ad) & kRooted) | ((ad & (kFix | kRooted)) ? kSettled : 0);
  bool better = a[2] < q[2];
  long long n0 = a[0], n1 = dist | flg;
  long long n2 = better ? a[2] : q[2];
  long long n3 = better ? dq + a[3] : q[3];
  out[0] = n0; out[1] = n1; out[2] = n2; out[3] = n3;
  return n0 != q[0] || n1 != qd || n2 != q[2] || n3 != q[3];
}

}  // namespace bt
