// Check-node rules of flooding BP, shared by csrc/flooding.cu (K2) and
// csrc/flooding_qc.cu (K3). Each rule turns the d variable-to-check
// messages v[0..d) of one check, held in registers, into its
// check-to-variable messages, in place. They repeat the plain PyTorch rules
// of ecc_ldpc_tpu_torch/decode/cn_ops.py float for float: signs by
// (v < 0), so -0.0 counts as positive; a message is (sign product * own
// sign) * magnitude; sums in slot order; every add, subtract and multiply
// an explicit _rn intrinsic (the sources are also built with -fmad=false);
// the accurate expf, logf, tanhf, atanhf and log1pf that PyTorch's CUDA
// elementwise ops call. Loops run to the compile-time MAX_DEG so that the
// register arrays keep compile-time indices.
#pragma once

#include <math.h>

namespace bp {

constexpr float kMagCap = 1e12f;
constexpr float kTanhClip = (float)(1.0 - 1e-7);
constexpr float kIdentity = 1e9f;  // box-plus identity
enum Rule { kMinsum = 0, kSpa = 1, kMinstar = 2 };

__device__ __forceinline__ float sign_of(float x) { return x < 0.f ? -1.f : 1.f; }

// Two-min update: the (first) minimum's slot gets the second minimum, every
// other slot the minimum, so a tied minimum gives min1 everywhere; then
// min(., 1e12) and max(alpha * m - beta, 0).
template <int MAX_DEG>
__device__ __forceinline__ void minsum(float (&v)[MAX_DEG], int d, float alpha,
                                       float beta) {
  bool neg = false;
  float m1 = INFINITY, m2 = INFINITY;
#pragma unroll
  for (int j = 0; j < MAX_DEG; ++j) {
    if (j < d) {
      const float a = fabsf(v[j]);
      neg ^= (v[j] < 0.f);
      if (a < m1) {
        m2 = m1;
        m1 = a;
      } else if (a < m2) {
        m2 = a;
      }
    }
  }
  const float sp = neg ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < MAX_DEG; ++j) {
    if (j < d) {
      float mag = fabsf(v[j]) == m1 ? m2 : m1;
      mag = fminf(mag, kMagCap);
      mag = fmaxf(__fsub_rn(__fmul_rn(alpha, mag), beta), 0.f);
      v[j] = __fmul_rn(__fmul_rn(sp, sign_of(v[j])), mag);
    }
  }
}

// Sum-product by the tanh rule: lt = log(tanh(clip(|v|, 1e-10, 40) / 2)),
// acc = sum of lt in slot order, magnitude 2 * atanh(min(exp(acc - lt),
// 1 - 1e-7)). 4 transcendentals per edge.
template <int MAX_DEG>
__device__ __forceinline__ void spa(float (&v)[MAX_DEG], int d) {
  float lt[MAX_DEG];
  float acc = 0.f;
  bool neg = false;
#pragma unroll
  for (int j = 0; j < MAX_DEG; ++j) {
    if (j < d) {
      const float a = fminf(fmaxf(fabsf(v[j]), 1e-10f), 40.f);
      lt[j] = logf(tanhf(__fmul_rn(a, 0.5f)));
      acc = j == 0 ? lt[j] : __fadd_rn(acc, lt[j]);
      neg ^= (v[j] < 0.f);
    }
  }
  const float sp = neg ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < MAX_DEG; ++j) {
    if (j < d) {
      const float t = fminf(expf(__fsub_rn(acc, lt[j])), kTanhClip);
      const float mag = __fmul_rn(2.f, atanhf(t));
      v[j] = __fmul_rn(__fmul_rn(sp, sign_of(v[j])), mag);
    }
  }
}

// x [+] y = sgn * min(|x|, |y|) + (log1p(e^-|x+y|) - log1p(e^-|x-y|)).
__device__ __forceinline__ float boxplus(float x, float y) {
  const float mag = fminf(fabsf(x), fabsf(y));
  const float sgn = ((x < 0.f) != (y < 0.f)) ? -1.f : 1.f;
  const float c1 = log1pf(expf(-fabsf(__fadd_rn(x, y))));
  const float c2 = log1pf(expf(-fabsf(__fsub_rn(x, y))));
  return __fadd_rn(__fmul_rn(sgn, mag), __fsub_rn(c1, c2));
}

// Sum-product by box-plus over all d slots: slot j gets fwd[j-1] [+]
// bwd[j+1] (slot d-1: fwd[d-2]; slot 0: bwd[1]; degree 1: 1e9), clipped
// to +-1e12. Only the forward prefixes that are read (j <= d-2) are kept;
// the backward suffix runs in a register: 3(d-2) box-plus per check.
template <int MAX_DEG>
__device__ __forceinline__ void minstar(float (&v)[MAX_DEG], int d) {
  if (d == 1) {
    v[0] = kIdentity;
    return;
  }
  float w[MAX_DEG];
#pragma unroll
  for (int j = 0; j < MAX_DEG; ++j) {
    if (j == 0) {
      w[0] = v[0];
    } else if (j < d - 1) {
      w[j] = boxplus(w[j - 1], v[j]);
    }
  }
  float bwd = 0.f;
#pragma unroll
  for (int jj = 0; jj < MAX_DEG; ++jj) {
    const int j = MAX_DEG - 1 - jj;
    if (j < d) {
      float out;
      if (j == d - 1) {
        out = j >= 1 ? w[j - 1] : 0.f;  // fwd[d-2]
      } else if (j == 0) {
        out = bwd;
      } else {
        out = boxplus(w[j - 1], bwd);
      }
      if (j == d - 1) {
        bwd = v[j];
      } else if (j > 0) {
        bwd = boxplus(bwd, v[j]);
      }
      v[j] = fminf(fmaxf(out, -kMagCap), kMagCap);
    }
  }
}

template <int MAX_DEG, int RULE>
__device__ __forceinline__ void check_rule(float (&v)[MAX_DEG], int d,
                                           float alpha, float beta) {
  if constexpr (RULE == kMinsum) {
    minsum<MAX_DEG>(v, d, alpha, beta);
  } else if constexpr (RULE == kSpa) {
    spa<MAX_DEG>(v, d);
  } else {
    minstar<MAX_DEG>(v, d);
  }
}

}  // namespace bp
