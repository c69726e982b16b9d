// The index-order sum the kernels keep their plain versions' bits with.
#pragma once

namespace afis_sum {

// acc0 + v(0) + ... + v(n - 1) in index order, one rounding per term; the
// terms are fetched eight at a time ahead of the dependent adds.
template <class V>
__device__ __forceinline__ float ordered_sum(int n, const V& v,
                                             float acc0 = 0.f) {
  float acc = acc0;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = v(i + u);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = acc + x[u];
  }
  for (; i < n; ++i) acc = acc + v(i);
  return acc;
}

}  // namespace afis_sum
