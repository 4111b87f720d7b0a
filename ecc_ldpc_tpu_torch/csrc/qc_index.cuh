// The block permutation of the QC kernels, fixed at compile time.
//
// Check z of a block-edge with shift s reads variable var_index<XOR>(z, s, Z)
// of its block-column: (z + s) % Z for a circulant (XOR = false), z ^ s for
// an XOR permutation (XOR = true, power-of-two Z: IEEE 802.3an). check_index
// is the inverse, the check that reads variable position zv; an XOR
// permutation is its own inverse. Each kernel that takes the parameter is
// instantiated once per permutation, so neither pays a run-time branch. The
// Python twins are var_index and check_index in
// ecc_ldpc_tpu_torch/graph/qc.py.
#pragma once

namespace qc {

template <bool XOR>
__device__ __forceinline__ int var_index(int z, int s, int Z) {
  if constexpr (XOR) {
    return z ^ s;
  } else {
    int zz = z + s;
    if (zz >= Z) zz -= Z;
    return zz;
  }
}

template <bool XOR>
__device__ __forceinline__ int check_index(int zv, int s, int Z) {
  if constexpr (XOR) {
    return zv ^ s;
  } else {
    int z = zv - s;
    if (z < 0) z += Z;
    return z;
  }
}

}  // namespace qc
