// Fixed-iteration flooding min-sum in the dc-major edge layout, and its
// two ablations, for Hopper (E4).
//
// Replaces experiments/smallcode_opt2.py::_kernel_dcmajor (:62, its
// pallas_call :183, via make_dcmajor_decoder :153). The caller is
// ecc_ldpc_tpu_torch/experiments/smallcode_opt2.py, whose plain PyTorch
// version (dcmajor_plain) this kernel must match bit for bit: bits, ok and
// iterations.
//
// The TPU kernel keeps the extrinsic messages V as [dc * m_pad, Bt] (edge
// e = j * m_pad + i: slot j of check i, so each slot is a clean 2-d slab),
// runs a tournament two-min and a sign-bit XOR across the dc slabs, and
// forms the variable sums and the next V through 0/1 incidence matmuls in
// bf16 with f32 accumulation: total = llr + S (C), V = St (total) - C, the
// syndrome H (total < 0). Here those products are gathers in the kernel's
// own body, with the TPU's roundings: C and total are rounded to bf16 on
// their way into a product, and a variable's sum runs over its edges in
// ascending e (the operators' index order): ((0 + C[e0]) + C[e1]) + ...,
// then llr + sum. A padded slot reads no variable: its V is 0 - C.
//
// The frame is K2's (csrc/flooding.cu): a tile of F frames lives in one
// block's shared memory for the whole decode, frames innermost (word x * F
// + f): the LLRs [n][F], the posteriors [n][F] and the messages
// [dc * m][F], slot-major as the TPU's slabs (m unpadded: the padding is
// the TPU's (8, 128) tiling). A persistent grid of blocks takes tiles in
// turn. A thread's item is G adjacent frames of one check or variable (the
// plan's `lanes`: 2 where F is even and the tables are on chip, so a word
// pair moves as one 8-byte shared-memory access), and its items are walked without a division by
// F (st::Walk, set up once a launch). An iteration is two phases with a
// block barrier after each, as K2's:
//   CN   (full, mm_only) per (check, frames): V = bf16(total[var]) - C of
//        each slot (the TPU's V phase, recomputed from the posteriors and
//        the messages it holds: the same floats in the same order; C = 0
//        in iteration 0, a padded slot's V 0), then C = the tournament of
//        the V (full), or C = V (mm_only), stored in their place;
//   VN   (full, mm_only) per (variable, frames): total = llr + the sum of
//        bf16(C) over its edges.
// cn_only drops the products and keeps the dependency alive, as the TPU
// variant does (smallcode_opt2.py:131-145): its CN phase takes V from the
// messages (in iteration 0 formed from the LLRs, as above), then total[i]
// += C[slot 0 of check i] * 1e-9 for i < min(m, n), then V = C + total[0]
// * 1e-9, a barrier after each. The TPU's cn_only adds slab 0 of C
// ([m_pad, Bt]) to total ([n_pad, Bt]), which broadcasts only where
// m_pad == n_pad; the port adds it to rows i < min(m, n) (the TPU's rows
// m..m_pad of that slab are padded checks, whose C is 0). ok is the
// parity of total < 0 over every check's slots (the wrapper refuses a
// check that reads a variable twice, where H's 0/1 entry and the slots'
// count would differ); iterations are max_iters.
//
// Tables as K2's: cn [dc][m], the variable of each slot (-1 padded), and
// vmat [n][dv], each variable's edges in ascending e (-1 padded). With
// STAB they are staged once a block into shared memory as int16 (the
// plan's tables "smem": n and dc * m below 32768, and the tables cost the
// tile no frame), else read through the read-only path ("ldg", one frame
// an item: a code whose tables crowd out its frames runs few a tile).
//
// What bounds it: the operations, as K2's min-sum (14 fp32 operations an
// edge visit; bench/throughput.decode_bound, schedule "flooding"); in fact
// the shared-memory gathers of the two phases and their barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "state_tile.cuh"  // st::Walk

namespace {

constexpr unsigned kSign = 0x80000000u;
constexpr float kBig = 1e12f;
constexpr int kDv = 4;  // column degrees whose VN loads are unrolled
// the variants of experiments/smallcode_opt2.py (VARIANTS)
enum { kFull = 0, kMmOnly = 1, kCnOnly = 2 };

struct Args {
  const float* llr;      // [B, n] in
  uint8_t* bits;         // [B, n] out: total < 0
  uint8_t* ok;           // [B] out: the final syndrome is satisfied
  int32_t* iters;        // [B] out: max_iters
  float* post;           // [B, n] out: final posteriors, or null
  const int32_t* cn;     // [dc * m]: the variable of slot j of check i at
                         // j * m + i, -1 for a padded slot
  const int32_t* vmat;   // [n * dv]: each variable's edges j * m + i,
                         // ascending, -1 padded
  int n, m, dc, dv, B, max_iters, F, tiles;
  float alpha, beta;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// G adjacent f32 words (8-byte aligned when G = 2: F is even and every
// region starts at an even word)
template <int G>
__device__ __forceinline__ void load(const float* p, float (&x)[G]) {
  if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void store(float* p, const float (&x)[G]) {
  if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <int DC, int VAR, int G, bool STAB>
__global__ void __launch_bounds__(512, 1) dcmajor_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int fail[64];
  const int F = a.F, n = a.n, m = a.m, dc = a.dc, dv = a.dv;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int mF = m * F;
  float* llr = sm;             // [n][F]
  float* tot = llr + n * F;    // [n][F]
  float* X = tot + n * F;      // [dc * m][F]
  int16_t* cn16 = reinterpret_cast<int16_t*>(X + dc * mF);  // [dc * m]
  int16_t* vn16 = cn16 + dc * m;                             // [n * dv]
  if constexpr (STAB) {
    for (int i = tid; i < dc * m; i += nth) cn16[i] = (int16_t)a.cn[i];
    for (int i = tid; i < n * dv; i += nth) vn16[i] = (int16_t)a.vmat[i];
  }
  auto cn_at = [&](int e) -> int {
    if constexpr (STAB) {
      return cn16[e];
    } else {
      return __ldg(a.cn + e);
    }
  };
  auto vn_at = [&](int k) -> int {
    if constexpr (STAB) {
      return vn16[k];
    } else {
      return __ldg(a.vmat + k);
    }
  };
  // item k of the walk: row k / (F / G), frames G * (k % (F / G)) on
  const st::Walk w0(tid, nth, 1, F / G);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b0 = tile * F, nf = min(F, a.B - b0);
    for (int i = tid; i < n * F; i += nth) {
      const int f = i / n, v = i - f * n;
      const float x = f < nf ? a.llr[(size_t)(b0 + f) * n + v] : 0.f;
      llr[v * F + f] = x;
      tot[v * F + f] = x;
    }
    if (tid < F) fail[tid] = 0;
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < a.max_iters; ++t) {
      // CN phase: V formed from the posteriors (cn_only after iteration
      // 0: V as the dependency step left it), then C
      const bool form = VAR != kCnOnly || t == 0;
      for (st::Walk w = w0; w.a < m; w.next()) {
        const int f0 = w.f * G;
        float* Xi = X + w.a * F + f0;  // slot j at Xi[j * mF]
        float v[G][DC];
        bool real[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (j < dc) {
            const int var = cn_at(j * m + w.a);
            real[j] = var >= 0;
            if (form) {
              float r[G] = {}, c[G] = {};
              if (real[j]) {
                load<G>(tot + var * F + f0, r);
                if (t > 0) load<G>(Xi + j * mF, c);
              }
#pragma unroll
              for (int g = 0; g < G; ++g)
                v[g][j] = __fsub_rn(real[j] ? bf16_round(r[g]) : 0.f, c[g]);
            } else {
              float x[G];
              load<G>(Xi + j * mF, x);
#pragma unroll
              for (int g = 0; g < G; ++g) v[g][j] = x[g];
            }
          }
        }
        if constexpr (VAR != kMmOnly) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float m1 = kBig, m2 = kBig;
            unsigned sx = 0;
#pragma unroll
            for (int j = 0; j < DC; ++j) {
              if (j < dc) {
                const float av = real[j] ? fabsf(v[g][j]) : kBig;
                const float nm1 = fminf(m1, av);
                m2 = fminf(fmaxf(m1, av), m2);
                m1 = nm1;
                sx ^= v[g][j] < 0.f ? kSign : 0u;
              }
            }
#pragma unroll
            for (int j = 0; j < DC; ++j) {
              if (j < dc) {
                const float av = real[j] ? fabsf(v[g][j]) : kBig;
                const unsigned sb = v[g][j] < 0.f ? kSign : 0u;
                float mag = av == m1 ? m2 : m1;
                mag = fmaxf(__fsub_rn(__fmul_rn(a.alpha, mag), a.beta), 0.f);
                const float c =
                    __uint_as_float(__float_as_uint(mag) ^ sx ^ sb);
                v[g][j] = real[j] ? c : 0.f;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (j < dc) {
            float o[G];
#pragma unroll
            for (int g = 0; g < G; ++g) o[g] = v[g][j];
            store<G>(Xi + j * mF, o);
          }
        }
      }
      __syncthreads();
      if constexpr (VAR != kCnOnly) {
        // VN phase: the edges' loads back to back, then the adds in order
        for (st::Walk w = w0; w.a < n; w.next()) {
          const int f0 = w.f * G, u = w.a;
          float s[G] = {};
          if (dv <= kDv) {
            int e[kDv];
            float c[kDv][G];
#pragma unroll
            for (int k = 0; k < kDv; ++k) {
              if (k < dv) {
                e[k] = vn_at(u * dv + k);
                if (e[k] >= 0) load<G>(X + e[k] * F + f0, c[k]);
              }
            }
#pragma unroll
            for (int k = 0; k < kDv; ++k) {
              if (k < dv && e[k] >= 0) {
#pragma unroll
                for (int g = 0; g < G; ++g)
                  s[g] = __fadd_rn(s[g], bf16_round(c[k][g]));
              }
            }
          } else {
            for (int k = 0; k < dv; ++k) {
              const int e = vn_at(u * dv + k);
              if (e >= 0) {
                float c[G];
                load<G>(X + e * F + f0, c);
#pragma unroll
                for (int g = 0; g < G; ++g)
                  s[g] = __fadd_rn(s[g], bf16_round(c[g]));
              }
            }
          }
          float l[G];
          load<G>(llr + u * F + f0, l);
#pragma unroll
          for (int g = 0; g < G; ++g) l[g] = __fadd_rn(l[g], s[g]);
          store<G>(tot + u * F + f0, l);
        }
      } else {
        // slot 0 of check i is edge i: words i * F + f, as variable i's
        for (st::Walk w = w0; w.a < min(m, n); w.next()) {
          const int o = w.a * F + w.f * G;
          float x[G], y[G];
          load<G>(X + o, x);
          load<G>(tot + o, y);
#pragma unroll
          for (int g = 0; g < G; ++g)
            y[g] = __fadd_rn(y[g], __fmul_rn(x[g], 1e-9f));
          store<G>(tot + o, y);
        }
        __syncthreads();
        for (st::Walk w = w0; w.a < dc * m; w.next()) {
          const int f0 = w.f * G;
          float x[G], y[G];
          load<G>(X + w.a * F + f0, x);
          load<G>(tot + f0, y);  // variable 0's posteriors
#pragma unroll
          for (int g = 0; g < G; ++g)
            x[g] = __fadd_rn(x[g], __fmul_rn(y[g], 1e-9f));
          store<G>(X + w.a * F + f0, x);
        }
      }
      __syncthreads();
    }
    // ok: the parity of total < 0 over every check's slots
    for (st::Walk w = w0; w.a < m; w.next()) {
      const int f0 = w.f * G;
      bool par[G] = {};
      for (int j = 0; j < dc; ++j) {
        const int v = cn_at(j * m + w.a);
        if (v >= 0) {
          float r[G];
          load<G>(tot + v * F + f0, r);
#pragma unroll
          for (int g = 0; g < G; ++g) par[g] ^= r[g] < 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (par[g] && f0 + g < nf) fail[f0 + g] = 1;
    }
    __syncthreads();
    for (int i = tid; i < nf * n; i += nth) {
      const int f = i / n, v = i - f * n;
      const float x = tot[v * F + f];
      const size_t o = (size_t)(b0 + f) * n + v;
      a.bits[o] = x < 0.f ? 1 : 0;
      if (a.post) a.post[o] = x;
    }
    if (tid < nf) {
      a.ok[b0 + tid] = fail[tid] ? 0 : 1;
      a.iters[b0 + tid] = a.max_iters;
    }
    __syncthreads();
  }
}

using Kern = void (*)(Args);

template <int DC, int G, bool STAB>
Kern pick_variant(int variant) {
  if (variant == kFull) return dcmajor_kernel<DC, kFull, G, STAB>;
  if (variant == kMmOnly) return dcmajor_kernel<DC, kMmOnly, G, STAB>;
  if (variant == kCnOnly) return dcmajor_kernel<DC, kCnOnly, G, STAB>;
  return nullptr;
}

template <int DC, bool STAB>
Kern pick_lanes(int variant, int lanes) {
  if (lanes == 1) return pick_variant<DC, 1, STAB>(variant);
  if constexpr (DC <= 16 && STAB) {
    if (lanes == 2) return pick_variant<DC, 2, STAB>(variant);
  }
  return nullptr;
}

// two frames an item up to 16 slots a check, with the tables on chip
template <bool STAB>
Kern pick_dc(int dc, int variant, int lanes) {
  if (dc <= 8) return pick_lanes<8, STAB>(variant, lanes);
  if (dc <= 16) return pick_lanes<16, STAB>(variant, lanes);
  if (dc <= 32) return pick_lanes<32, STAB>(variant, lanes);
  return nullptr;
}

Kern pick(int dc, int variant, int lanes, int stab) {
  return stab ? pick_dc<true>(dc, variant, lanes)
              : pick_dc<false>(dc, variant, lanes);
}

}  // namespace

extern "C" {

// Decodes llr [B, n] with `variant` in tiles of F frames (`tiles` of them)
// on `blocks` persistent blocks of `threads` threads, `lanes` frames an
// item (2 needs an even F and `stab`), the tables in shared memory as
// int16 where `stab`, and `smem` bytes of dynamic shared memory (4 * F * (2n + dc *
// m), and with stab 2 * (dc * m + n * dv) more). post may be null.
// Returns a cudaError_t (0 on a successful launch).
int dcmajor_decode(void* llr, void* bits, void* ok, void* iters, void* post,
                   void* cn, void* vmat, int n, int m, int dc, int dv, int B,
                   int max_iters, int variant, int F, int tiles, int lanes,
                   int stab, int blocks, int threads, int smem, float alpha,
                   float beta, void* stream) {
  Kern kern = pick(dc, variant, lanes, stab);
  const size_t need = 4ull * F * (2ull * n + (size_t)dc * m) +
                      (stab ? 2ull * ((size_t)dc * m + (size_t)n * dv) : 0);
  if (!kern || dc < 1 || dv < 1 || B < 1 || max_iters < 0 || F < 1 ||
      F > 64 || F % lanes || tiles * F < B || blocks < 1 || threads < 64 ||
      threads > 512 || (size_t)smem < need ||
      (stab && (n > 32767 || dc * m > 32767)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.ok = static_cast<uint8_t*>(ok);
  a.iters = static_cast<int32_t*>(iters);
  a.post = static_cast<float*>(post);
  a.cn = static_cast<const int32_t*>(cn);
  a.vmat = static_cast<const int32_t*>(vmat);
  a.n = n; a.m = m; a.dc = dc; a.dv = dv; a.B = B; a.max_iters = max_iters;
  a.F = F; a.tiles = tiles; a.alpha = alpha; a.beta = beta;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* dcmajor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
