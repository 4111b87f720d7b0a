// Layered exact belief propagation (spa, minstar) on QC graphs, for Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel in its
// dup-free exact-BP form (sweep_exact, :501, with _boxplus, :491, and
// syndrome_fail), in fixed-iteration and in track (early-termination)
// mode. The caller is ecc_ldpc_tpu_torch/decode/layered_qc.py
// (layered_exact_cuda); the plain PyTorch twin there (_cn_spa,
// _cn_minstar) is the reference this kernel must match.
//
// Layout and launch are those of csrc/layered_qc.cu (K1a): frames in tiles
// of FT = 8, each tile's state contiguous with frames innermost,
//   posteriors total f32 [tiles, nb*Z, FT]
//   messages   C     f32 [tiles, BE*Z, FT], one row per (sweep slot, check)
// one block per tile, threads over (frame, z), the layers walked in
// layer_order with one __syncthreads() per layer. Check z of slot (col, s)
// reads variable qc::var_index<XOR>(z, s, Z) of block-column col: (z + s)
// % Z on a circulant graph, z ^ s on an XOR graph (IEEE 802.3an, where the
// JAX package serves these rules on its XLA tier). Exact BP sends a
// different magnitude on every edge, so unlike K1a the check state is the
// full message array.
//
// Per check, the d rolled posteriors and d old messages go to registers:
//   spa      pass 1: v = r - Cold; lt = logf(tanhf(clip(|v|, 1e-10, 40)/2));
//                    acc += lt in slot order; XOR of the sign bits.
//            pass 2: t = min(expf(acc - lt), f32(1 - 1e-7));
//                    mag = log1pf(t) - log1pf(-t); Cnew = bits(mag) | flip.
//            lt stays in registers, so each edge costs 5 transcendentals
//            (the TPU kernel recomputes it in pass 2: 7).
//   minstar  pass 1: forward box-plus prefixes fwd[j] (only those pass 2
//                    reads: j <= d-3).
//            pass 2: backward, with a running suffix: slot j gets
//                    fwd[j-1] [+] bwd (slot d-1: fwd[d-2]; slot 0: bwd;
//                    degree 1: 1e9), clipped to +-1e12; 3(d-2) box-plus
//                    per check, 4 transcendentals each.
// and the posterior is written as v + Cnew (set form: a dup-free layer
// writes each column once).
//
// Exact f32 semantics: built with -fmad=false, explicit _rn intrinsics for
// every add/sub/mul, and the accurate expf, logf, tanhf and log1pf (the
// functions PyTorch's CUDA elementwise ops call), never the __expf-style
// intrinsics or --use_fast_math. Hard decisions, the syndrome and track
// mode's layer parity use x < 0; the flip test compares sign bits.
// Track mode is K1a's: per-frame freeze, the "parity passed and no sign
// flipped" stop rule, per-tile early exit.
//
// What bounds it on an H100: the true bound is the operations side, 5
// (spa) or ~8.6 (minstar at rate 1/2) transcendentals per edge visit at
// the special-function rate (16 per clock per SM x 132 SMs x 1.98 GHz),
// which outlasts the arithmetic at 67 TFLOP/s issued beside it: about
// 28 ms (spa) and 48 ms (minstar) for 4096 frames x 25 iterations of
// dvbs2/64800/12
// (bench/throughput.decode_bound). This simple design moves 16 B per edge
// visit through HBM instead (posterior and message, each read and
// written), about 372 GB for that batch, so it is bound by memory traffic
// (PERF.md has the timings). Keeping messages in 16 bits and a tile's
// posteriors on chip is the way toward the bound, and work for a later
// change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_rules.cuh"
#include "qc_index.cuh"

namespace {

using bp::boxplus;
using bp::kIdentity;
using bp::kMagCap;
using bp::kTanhClip;
using bp::log_tanh_half;

constexpr int FT = 8;
constexpr unsigned kSign = 0x80000000u;
enum Rule { kSpa = 0, kMinstar = 1 };

struct Params {
  float* total;          // [tiles, nb*Z, FT] in: channel LLRs; out: posteriors
  float* C;              // [tiles, BE*Z, FT] scratch: check-to-variable messages
  uint8_t* bits;         // [tiles, nb*Z, FT] out: hard decisions
  uint8_t* ok;           // [B] out: final syndrome satisfied
  int32_t* iters;        // [B] out: iterations used
  const int32_t* tab;    // [mb+1 | BE | BE] layer_ptr, column, shift
  int Z, mb, nb, BE, B, max_iters;
};

__device__ __forceinline__ size_t at(size_t row) {
  return row * FT + threadIdx.x;
}

// Parity failure of the hard decisions (x < 0) over the checks this thread
// owns (its frame, z = threadIdx.y + k * blockDim.y) in every layer.
template <bool XOR>
__device__ bool syndrome_fail_part(const Params& p, const float* tot,
                                   const int* lptr, const int* scol,
                                   const int* sshift) {
  bool fail = false;
  for (int L = 0; L < p.mb; ++L) {
    const int s0 = lptr[L], s1 = lptr[L + 1];
    for (int z = threadIdx.y; z < p.Z; z += blockDim.y) {
      bool par = false;
      for (int s = s0; s < s1; ++s) {
        const int zz = qc::var_index<XOR>(z, sshift[s], p.Z);
        par ^= (tot[at(scol[s] * p.Z + zz)] < 0.f);
      }
      fail |= par;
    }
  }
  return fail;
}

template <int MAX_DEG, int RULE, bool TRACK, bool XOR>
__global__ void __launch_bounds__(512)
layered_exact_kernel(Params p) {
  extern __shared__ int smem[];
  int* lptr = smem;
  int* scol = lptr + p.mb + 1;
  int* sshift = scol + p.BE;
  __shared__ int fail_s[FT];
  __shared__ int done_s[FT];

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ntab = p.mb + 1 + 2 * p.BE;
  for (int i = tid; i < ntab; i += nthreads) smem[i] = p.tab[i];

  const int Z = p.Z;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * FT + tx;
  const bool live = b < p.B;
  const size_t tile = blockIdx.x;
  float* tot = p.total + tile * p.nb * Z * FT;
  float* C = p.C + tile * (size_t)p.BE * Z * FT;

  // zero the messages this thread owns in the sweep below
  if (live)
    for (int s = 0; s < p.BE; ++s)
      for (int z = threadIdx.y; z < Z; z += blockDim.y)
        C[at((size_t)s * Z + z)] = 0.f;
  if (threadIdx.y == 0) fail_s[tx] = 0;
  __syncthreads();

  if constexpr (TRACK) {
    // done_0: frames whose channel hard decisions already satisfy H
    if (live && syndrome_fail_part<XOR>(p, tot, lptr, scol, sshift))
      atomicOr(&fail_s[tx], 1);
    __syncthreads();
    if (threadIdx.y == 0) done_s[tx] = live ? !fail_s[tx] : 1;
  }
  int used = 0;  // iterations of frame b, kept by the threadIdx.y == 0 row

  for (int t = 0; t < p.max_iters; ++t) {
    if constexpr (TRACK) {
      // the tile stops once every frame in it is done (per-frame results
      // are those of a decode that ran all frames to the global stop)
      if (__syncthreads_and(threadIdx.y == 0 ? done_s[tx] : 1)) break;
      if (threadIdx.y == 0) fail_s[tx] = 0;
    }
    const bool active = live && (!TRACK || !done_s[tx]);
    bool fail = false;   // some layer parity failed (track mode)
    unsigned flip = 0;   // some posterior changed sign (track mode)

    for (int L = 0; L < p.mb; ++L) {
      const int s0 = lptr[L];
      const int d = lptr[L + 1] - s0;
      if (active) {
        for (int z = threadIdx.y; z < Z; z += blockDim.y) {
          float v[MAX_DEG];  // extrinsic inputs r - Cold
          float w[MAX_DEG];  // spa: log|tanh(v/2)|; minstar: forward prefixes
          unsigned rneg = 0;  // sign bits of the rolled posteriors
          bool par = false;
          float acc = 0.f;    // spa: running log|tanh| sum
          unsigned sg = 0;    // spa: XOR of the extrinsic sign bits
          // pass 1
#pragma unroll
          for (int j = 0; j < MAX_DEG; ++j) {
            if (j < d) {
              const int zz = qc::var_index<XOR>(z, sshift[s0 + j], Z);
              const float r = tot[at(scol[s0 + j] * Z + zz)];
              const float x = __fsub_rn(r, C[at((size_t)(s0 + j) * Z + z)]);
              v[j] = x;
              if constexpr (TRACK) {
                par ^= (r < 0.f);
                rneg |= (__float_as_uint(r) >> 31) << j;
              }
              if constexpr (RULE == kSpa) {
                const float lt = log_tanh_half(x);
                w[j] = lt;
                acc = j == 0 ? lt : __fadd_rn(acc, lt);
                sg ^= __float_as_uint(x);
              } else {
                // fwd[j] for j <= d-3 (fwd[d-2] is read as slot d-1's
                // message; fwd[d-1] is never read)
                if (j == 0) {
                  w[0] = x;
                } else if (j < d - 1) {
                  w[j] = boxplus(w[j - 1], x);
                }
              }
            }
          }
          if constexpr (TRACK) fail |= par;
          // pass 2: messages out, posteriors written back as v + Cnew
          // (spa forward, minstar backward with its running suffix)
          float bwd = 0.f;
#pragma unroll
          for (int jj = 0; jj < MAX_DEG; ++jj) {
            const int j = RULE == kSpa ? jj : MAX_DEG - 1 - jj;
            if (j < d) {
              float cn;
              if constexpr (RULE == kSpa) {
                const float tt = fminf(expf(__fsub_rn(acc, w[j])), kTanhClip);
                const float mag = __fsub_rn(log1pf(tt), log1pf(-tt));
                const unsigned neg = (sg ^ __float_as_uint(v[j])) & kSign;
                cn = __uint_as_float(__float_as_uint(mag) | neg);
              } else {
                float out;
                if (d == 1) {
                  out = kIdentity;
                } else if (j == d - 1) {
                  out = j >= 1 ? w[j - 1] : 0.f;  // fwd[d-2]
                } else if (j == 0) {
                  out = bwd;
                } else {
                  out = boxplus(j >= 1 ? w[j - 1] : 0.f, bwd);
                }
                cn = fminf(fmaxf(out, -kMagCap), kMagCap);
                if (j == d - 1) {
                  bwd = v[j];
                } else if (j > 0) {
                  bwd = boxplus(bwd, v[j]);
                }
              }
              const float nw = __fadd_rn(v[j], cn);
              if constexpr (TRACK)
                flip |= (__float_as_uint(nw) >> 31) ^ ((rneg >> j) & 1u);
              const int zz = qc::var_index<XOR>(z, sshift[s0 + j], Z);
              tot[at(scol[s0 + j] * Z + zz)] = nw;
              C[at((size_t)(s0 + j) * Z + z)] = cn;
            }
          }
        }
      }
      __syncthreads();
    }
    if constexpr (TRACK) {
      if (active && (fail || flip)) atomicOr(&fail_s[tx], 1);
      __syncthreads();
      if (threadIdx.y == 0 && active) {
        ++used;
        if (!fail_s[tx]) done_s[tx] = 1;
      }
    }
  }

  // truthful ok: one final syndrome over the emitted hard decisions
  if (threadIdx.y == 0) fail_s[tx] = 0;
  __syncthreads();
  if (live) {
    if (syndrome_fail_part<XOR>(p, tot, lptr, scol, sshift))
      atomicOr(&fail_s[tx], 1);
    uint8_t* bits = p.bits + tile * p.nb * Z * FT;
    for (int i = threadIdx.y; i < p.nb * Z; i += blockDim.y)
      bits[at(i)] = tot[at(i)] < 0.f ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    p.ok[b] = fail_s[tx] ? 0 : 1;
    p.iters[b] = TRACK ? used : p.max_iters;
  }
}

template <int MAX_DEG, int RULE, bool TRACK, bool XOR>
cudaError_t launch(const Params& p, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream) {
  auto kern = layered_exact_kernel<MAX_DEG, RULE, TRACK, XOR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAX_DEG, bool XOR>
cudaError_t launch_rule(const Params& p, int minstar, int track, dim3 grid,
                        dim3 block, size_t smem, cudaStream_t st) {
  if (minstar) {
    if (track) return launch<MAX_DEG, kMinstar, true, XOR>(p, grid, block, smem, st);
    return launch<MAX_DEG, kMinstar, false, XOR>(p, grid, block, smem, st);
  }
  if (track) return launch<MAX_DEG, kSpa, true, XOR>(p, grid, block, smem, st);
  return launch<MAX_DEG, kSpa, false, XOR>(p, grid, block, smem, st);
}

template <bool XOR>
cudaError_t launch_width(const Params& p, int dcb_max, int minstar, int track,
                         dim3 grid, dim3 block, size_t smem, cudaStream_t st) {
  if (dcb_max <= 8) return launch_rule<8, XOR>(p, minstar, track, grid, block, smem, st);
  if (dcb_max <= 16) return launch_rule<16, XOR>(p, minstar, track, grid, block, smem, st);
  return launch_rule<32, XOR>(p, minstar, track, grid, block, smem, st);
}

}  // namespace

extern "C" {

// Decodes B frames in ceil(B / FT) tiles of FT = 8 frames (the arrays hold
// whole tiles; lanes past B are left alone) with the spa (minstar = 0) or
// minstar (minstar = 1) rule on a circulant (xor_perm = 0) or an
// XOR-permutation graph (xor_perm = 1); returns a cudaError_t (0 on a
// successful launch). dcb_max must be <= 32 and 8 * threads_z <= 512; the
// wrapper checks both.
int layered_exact_decode(void* total, void* C, void* bits, void* ok,
                         void* iters, void* tab, int Z, int mb, int nb, int BE,
                         int B, int max_iters, int dcb_max, int minstar,
                         int track, int threads_z, int xor_perm, void* stream) {
  if (threads_z < 1 || FT * threads_z > 512 || dcb_max > 32 || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.total = static_cast<float*>(total);
  p.C = static_cast<float*>(C);
  p.bits = static_cast<uint8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.tab = static_cast<const int32_t*>(tab);
  p.Z = Z; p.mb = mb; p.nb = nb; p.BE = BE; p.B = B;
  p.max_iters = max_iters;
  const dim3 block(FT, threads_z);
  const dim3 grid((B + FT - 1) / FT);
  const size_t smem = sizeof(int) * (size_t)(mb + 1 + 2 * BE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xor_perm)
    return (int)launch_width<true>(p, dcb_max, minstar, track, grid, block, smem, st);
  return (int)launch_width<false>(p, dcb_max, minstar, track, grid, block, smem, st);
}

const char* layered_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
