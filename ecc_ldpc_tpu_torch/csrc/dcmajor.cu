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
// turn. An iteration is three phases with a block barrier after each:
//   CN   (full, cn_only) per (check, frame): C = the tournament of its dc
//        messages, stored in their place;
//   VN   (full, mm_only) per (variable, frame): total = llr + the sum of
//        bf16(C) over its edges; (cn_only) total[i] += C[slot 0 of check
//        i] * 1e-9 for i < min(m, n);
//   V    (full, mm_only) per (edge, frame): V = bf16(total[var]) - C (a
//        padded slot 0 - C); (cn_only) V = C + total[0] * 1e-9.
// mm_only passes V through the CN phase (C = V); cn_only drops the
// products and keeps the dependency alive, as the TPU variants do
// (smallcode_opt2.py:131-145). The TPU's cn_only adds slab 0 of C
// ([m_pad, Bt]) to total ([n_pad, Bt]), which broadcasts only where
// m_pad == n_pad; the port adds it to rows i < min(m, n) (the TPU's rows
// m..m_pad of that slab are padded checks, whose C is 0). ok is the
// parity of total < 0 over every check's slots (the wrapper refuses a
// check that reads a variable twice, where H's 0/1 entry and the slots'
// count would differ); iterations are max_iters.
//
// What bounds it: the operations, as K2's min-sum (14 fp32 operations an
// edge visit; bench/throughput.decode_bound, schedule "flooding"); in fact
// the shared-memory gathers of the three phases and their barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kSign = 0x80000000u;
constexpr float kBig = 1e12f;
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
  const int32_t* vptr;   // [n + 1]
  const int32_t* vedge;  // [E]: each variable's edges j * m + i, ascending
  int n, m, dc, B, max_iters, F, tiles;
  float alpha, beta;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// V = bf16(total[var]) - C for every (edge, frame) of the tile
__device__ __forceinline__ void v_phase(const Args& a, const float* tot,
                                        float* X) {
  const int F = a.F, items = a.dc * a.m * F;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int e = i / F, f = i - e * F;
    const int v = a.cn[e];
    const float t = v >= 0 ? bf16_round(tot[v * F + f]) : 0.f;
    X[i] = __fsub_rn(t, X[i]);
  }
}

template <int DC, int VAR>
__global__ void __launch_bounds__(512, 1) dcmajor_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int fail[64];
  const int F = a.F, n = a.n, m = a.m, dc = a.dc;
  const int tid = threadIdx.x, nth = blockDim.x;
  float* llr = sm;             // [n][F]
  float* tot = llr + n * F;    // [n][F]
  float* X = tot + n * F;      // [dc * m][F]
  const int mF = m * F;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b0 = tile * F, nf = min(F, a.B - b0);
    for (int i = tid; i < n * F; i += nth) {
      const int f = i / n, v = i - f * n;
      const float x = f < nf ? a.llr[(size_t)(b0 + f) * n + v] : 0.f;
      llr[v * F + f] = x;
      tot[v * F + f] = x;
    }
    for (int i = tid; i < dc * mF; i += nth) X[i] = 0.f;
    if (tid < F) fail[tid] = 0;
    __syncthreads();
    v_phase(a, tot, X);  // V = St (llr): bf16(llr[var]) - 0
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < a.max_iters; ++t) {
      if constexpr (VAR != kMmOnly) {
        for (int i = tid; i < mF; i += nth) {
          const int ci = i / F;
          float av[DC];
          unsigned sb[DC];
          bool real[DC];
          float m1 = kBig, m2 = kBig;
          unsigned sx = 0;
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (j < dc) {
              const float v = X[j * mF + i];
              real[j] = a.cn[j * m + ci] >= 0;
              av[j] = real[j] ? fabsf(v) : kBig;
              sb[j] = v < 0.f ? kSign : 0u;
              const float nm1 = fminf(m1, av[j]);
              m2 = fminf(fmaxf(m1, av[j]), m2);
              m1 = nm1;
              sx ^= sb[j];
            }
          }
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (j < dc) {
              float mag = av[j] == m1 ? m2 : m1;
              mag = fmaxf(__fsub_rn(__fmul_rn(a.alpha, mag), a.beta), 0.f);
              const float c = __uint_as_float(__float_as_uint(mag) ^ sx ^ sb[j]);
              X[j * mF + i] = real[j] ? c : 0.f;
            }
          }
        }
        __syncthreads();
      }
      if constexpr (VAR != kCnOnly) {
        for (int i = tid; i < n * F; i += nth) {
          const int v = i / F, f = i - v * F;
          float s = 0.f;
          for (int k = a.vptr[v]; k < a.vptr[v + 1]; ++k)
            s = __fadd_rn(s, bf16_round(X[a.vedge[k] * F + f]));
          tot[i] = __fadd_rn(llr[i], s);
        }
        __syncthreads();
        v_phase(a, tot, X);
      } else {
        // slot 0 of check i is edge i: word i * F + f, as variable i's
        for (int i = tid; i < min(m, n) * F; i += nth)
          tot[i] = __fadd_rn(tot[i], __fmul_rn(X[i], 1e-9f));
        __syncthreads();
        for (int i = tid; i < dc * mF; i += nth) {
          const int f = i % F;
          X[i] = __fadd_rn(X[i], __fmul_rn(tot[f], 1e-9f));
        }
      }
      __syncthreads();
    }
    // ok: the parity of total < 0 over every check's slots
    for (int i = tid; i < mF; i += nth) {
      const int ci = i / F, f = i - ci * F;
      bool par = false;
      for (int j = 0; j < dc; ++j) {
        const int v = a.cn[j * m + ci];
        if (v >= 0) par ^= tot[v * F + f] < 0.f;
      }
      if (par && f < nf) fail[f] = 1;
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

template <int DC>
Kern pick_variant(int variant) {
  if (variant == kFull) return dcmajor_kernel<DC, kFull>;
  if (variant == kMmOnly) return dcmajor_kernel<DC, kMmOnly>;
  if (variant == kCnOnly) return dcmajor_kernel<DC, kCnOnly>;
  return nullptr;
}

Kern pick(int dc, int variant) {
  if (dc <= 8) return pick_variant<8>(variant);
  if (dc <= 16) return pick_variant<16>(variant);
  if (dc <= 32) return pick_variant<32>(variant);
  return nullptr;
}

}  // namespace

extern "C" {

// Decodes llr [B, n] with `variant` in tiles of F frames (`tiles` of them)
// on `blocks` persistent blocks of `threads` threads and `smem` bytes of
// dynamic shared memory (4 * F * (2n + dc * m)). post may be null.
// Returns a cudaError_t (0 on a successful launch).
int dcmajor_decode(void* llr, void* bits, void* ok, void* iters, void* post,
                   void* cn, void* vptr, void* vedge, int n, int m, int dc,
                   int B, int max_iters, int variant, int F, int tiles,
                   int blocks, int threads, int smem, float alpha,
                   float beta, void* stream) {
  Kern kern = pick(dc, variant);
  if (!kern || dc < 1 || B < 1 || max_iters < 0 || F < 1 || F > 64 ||
      tiles * F < B || blocks < 1 || threads < 64 || threads > 512 ||
      (size_t)smem < 4ull * F * (2ull * n + (size_t)dc * m))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.ok = static_cast<uint8_t*>(ok);
  a.iters = static_cast<int32_t*>(iters);
  a.post = static_cast<float*>(post);
  a.cn = static_cast<const int32_t*>(cn);
  a.vptr = static_cast<const int32_t*>(vptr);
  a.vedge = static_cast<const int32_t*>(vedge);
  a.n = n; a.m = m; a.dc = dc; a.B = B; a.max_iters = max_iters;
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
