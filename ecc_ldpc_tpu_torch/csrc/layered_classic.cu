// Layered belief propagation on circulant QC graphs whose block-rows may
// repeat a block-column (multi-edge protographs such as CCSDS AR4JA), for
// Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel in its two
// "classic" forms: sweep_classic (:415, min-sum, K1b) and
// sweep_exact_classic (:630, spa and minstar, K1c'), with syndrome_fail, in
// fixed-iteration and in track (early-termination) mode. The caller is
// ecc_ldpc_tpu_torch/decode/layered_qc.py (layered_classic_cuda); the plain
// PyTorch version there (_sweep_plain with accumulate=True) is the
// reference this kernel must match float for float.
//
// Layout and launch are those of csrc/layered_exact.cu (K1c): frames in
// tiles of FT = 8, each tile's state contiguous with frames innermost,
//   posteriors total f32 [tiles, nb*Z, FT]
//   messages   C     f32 [tiles, BE*Z, FT], one row per (sweep slot, check)
//   deltas     D     f32 [tiles, dcb_max*Z, FT], Cnew - Cold of one layer
// one block per tile, threads over (frame, z), the layers walked in
// layer_order. Check z of slot (col, s) reads variable (z + s) % Z of
// block-column col.
//
// What is new against K1c is the accumulate step. When a layer holds one
// block-column in two slots a and b, check z (slot a) and check z' (slot b)
// with z + s_a = z' + s_b (mod Z) update the same posterior, from two
// threads. The JAX oracle (decode/xla/layered.py:187-234) reads every
// slot's rolled posterior first, then adds each slot's Cnew - Cold in
// layer order (reverse order for minstar, whose Pallas pass 2 runs
// backward). So, per layer:
//   pass 1      every thread reads its checks' rolled posteriors r and old
//               messages Cold, computes v = r - Cold and the new messages
//               with the check rule (csrc/bp_rules.cuh, count signs: v < 0),
//               and writes C = Cnew and D = Cnew - Cold;
//   barrier;
//   accumulate  slot by slot in the oracle's order, every thread adds its
//               checks' D to the posteriors they read, with a barrier before
//               a slot whose column an earlier slot wrote since the last
//               barrier (slots of different columns touch different
//               posteriors), and one at the end of the layer.
// The f32 sums are then the oracle's, in the oracle's order. Track mode
// ORs a sign-flip flag after every slot's add (a posterior one slot flips
// and another flips back still counts as flipped) and a layer-parity flag
// from the rolled posteriors; a frozen frame's threads skip both passes, so
// its state stays exactly as it was (the Pallas sweep writes
// old + (Cold - Cold), which turns a -0.0 posterior into +0.0; the oracle
// keeps it). The stop rule is K1a's and K1c's: per-frame freeze when the
// layer parity passed and no sign flipped, per-tile early exit, and a final
// true syndrome for ok.
//
// Rules: min-sum (sweep_classic) with scalar or per-iteration alpha/beta,
// magnitude max(alpha * min(m, 1e12) - beta, 0); spa with the magnitude
// log1p(t) - log1p(-t) (5 transcendentals per edge visit: log|tanh| stays
// in registers; the TPU kernel recomputes it, 7); minstar by box-plus.
// Exact f32: built with -fmad=false, _rn intrinsics, and the accurate
// expf, logf, tanhf and log1pf.
//
// What bounds it on an H100: at ccsds/4096/12 the operations bound of 4096
// frames x 25 iterations is 0.66 ms for min-sum, 3.76 ms for spa and
// 5.42 ms for minstar (bench/throughput.decode_bound). This simple design
// moves 28 B per edge visit through HBM instead (posterior read twice and
// written once, message read and written, delta written and read), 88 GB
// for that batch, so memory traffic bounds it (PERF.md has the timings).
// Keeping a tile's posteriors and deltas on chip, and 16-bit messages,
// are the way toward the bound, and work for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_rules.cuh"

namespace {

constexpr int FT = 8;

struct Params {
  float* total;          // [tiles, nb*Z, FT] in: channel LLRs; out: posteriors
  float* C;              // [tiles, BE*Z, FT] scratch: check-to-variable messages
  float* D;              // [tiles, dmax*Z, FT] scratch: one layer's Cnew - Cold
  uint8_t* bits;         // [tiles, nb*Z, FT] out: hard decisions
  uint8_t* ok;           // [B] out: final syndrome satisfied
  int32_t* iters;        // [B] out: iterations used
  const int32_t* tab;    // [mb+1 | BE | BE] layer_ptr, column, shift
  const float* ab;       // [2, max_iters] alpha_t then beta_t, or null
  int Z, mb, nb, BE, dmax, B, max_iters;
  float alpha, beta;
};

__device__ __forceinline__ size_t at(size_t row) {
  return row * FT + threadIdx.x;
}

// Parity failure of the hard decisions (x < 0) over the checks this thread
// owns (its frame, z = threadIdx.y + k * blockDim.y) in every layer.
__device__ bool syndrome_fail_part(const Params& p, const float* tot,
                                   const int* lptr, const int* scol,
                                   const int* sshift) {
  bool fail = false;
  for (int L = 0; L < p.mb; ++L) {
    const int s0 = lptr[L], s1 = lptr[L + 1];
    for (int z = threadIdx.y; z < p.Z; z += blockDim.y) {
      bool par = false;
      for (int s = s0; s < s1; ++s) {
        int zz = z + sshift[s];
        if (zz >= p.Z) zz -= p.Z;
        par ^= (tot[at(scol[s] * p.Z + zz)] < 0.f);
      }
      fail |= par;
    }
  }
  return fail;
}

template <int MAX_DEG, int RULE, bool TRACK>
__global__ void __launch_bounds__(512)
layered_classic_kernel(Params p) {
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
  float* D = p.D + tile * (size_t)p.dmax * Z * FT;

  // zero the messages this thread owns in the sweep below
  if (live)
    for (int s = 0; s < p.BE; ++s)
      for (int z = threadIdx.y; z < Z; z += blockDim.y)
        C[at((size_t)s * Z + z)] = 0.f;
  if (threadIdx.y == 0) fail_s[tx] = 0;
  __syncthreads();

  if constexpr (TRACK) {
    // done_0: frames whose channel hard decisions already satisfy H
    if (live && syndrome_fail_part(p, tot, lptr, scol, sshift))
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
    const float alpha = p.ab ? p.ab[t] : p.alpha;
    const float beta = p.ab ? p.ab[p.max_iters + t] : p.beta;
    const bool active = live && (!TRACK || !done_s[tx]);
    bool fail = false;   // some layer parity failed (track mode)
    unsigned flip = 0;   // some posterior changed sign (track mode)

    for (int L = 0; L < p.mb; ++L) {
      const int s0 = lptr[L];
      const int d = lptr[L + 1] - s0;
      // pass 1: new messages of every check of the layer, from posteriors
      // no thread has written yet in this layer
      if (active) {
        for (int z = threadIdx.y; z < Z; z += blockDim.y) {
          float v[MAX_DEG];     // extrinsic inputs r - Cold, then Cnew
          float cold[MAX_DEG];  // old messages
          bool par = false;
#pragma unroll
          for (int j = 0; j < MAX_DEG; ++j) {
            if (j < d) {
              int zz = z + sshift[s0 + j];
              if (zz >= Z) zz -= Z;
              const float r = tot[at(scol[s0 + j] * Z + zz)];
              cold[j] = C[at((size_t)(s0 + j) * Z + z)];
              v[j] = __fsub_rn(r, cold[j]);
              if constexpr (TRACK) par ^= (r < 0.f);
            }
          }
          if constexpr (TRACK) fail |= par;
          if constexpr (RULE == bp::kMinsum) {
            bp::minsum<MAX_DEG>(v, d, alpha, beta);
          } else if constexpr (RULE == bp::kSpa) {
            bp::spa<MAX_DEG, true>(v, d);
          } else {
            bp::minstar<MAX_DEG>(v, d);
          }
#pragma unroll
          for (int j = 0; j < MAX_DEG; ++j) {
            if (j < d) {
              C[at((size_t)(s0 + j) * Z + z)] = v[j];
              D[at((size_t)j * Z + z)] = __fsub_rn(v[j], cold[j]);
            }
          }
        }
      }
      __syncthreads();
      // accumulate: slot by slot in the oracle's order; each thread adds
      // the deltas of its own checks (written by itself in pass 1)
      int since = 0;  // first slot (in visit order) since the last barrier
      for (int q = 0; q < d; ++q) {
        const int j = RULE == bp::kMinstar ? d - 1 - q : q;
        const int col = scol[s0 + j];
        bool clash = false;
        for (int q2 = since; q2 < q; ++q2)
          clash |= scol[s0 + (RULE == bp::kMinstar ? d - 1 - q2 : q2)] == col;
        if (clash) {
          __syncthreads();
          since = q;
        }
        if (active) {
          const int sh = sshift[s0 + j];
          for (int z = threadIdx.y; z < Z; z += blockDim.y) {
            int zz = z + sh;
            if (zz >= Z) zz -= Z;
            float* x = &tot[at(col * Z + zz)];
            const float old = *x;
            const float nw = __fadd_rn(old, D[at((size_t)j * Z + z)]);
            *x = nw;
            if constexpr (TRACK)
              flip |= (__float_as_uint(nw) ^ __float_as_uint(old)) >> 31;
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
    if (syndrome_fail_part(p, tot, lptr, scol, sshift)) atomicOr(&fail_s[tx], 1);
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

template <int MAX_DEG, int RULE, bool TRACK>
cudaError_t launch(const Params& p, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream) {
  auto kern = layered_classic_kernel<MAX_DEG, RULE, TRACK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAX_DEG, int RULE>
cudaError_t launch_mode(const Params& p, int track, dim3 grid, dim3 block,
                        size_t smem, cudaStream_t st) {
  if (track) return launch<MAX_DEG, RULE, true>(p, grid, block, smem, st);
  return launch<MAX_DEG, RULE, false>(p, grid, block, smem, st);
}

template <int MAX_DEG>
cudaError_t launch_rule(const Params& p, int rule, int track, dim3 grid,
                        dim3 block, size_t smem, cudaStream_t st) {
  if (rule == bp::kSpa)
    return launch_mode<MAX_DEG, bp::kSpa>(p, track, grid, block, smem, st);
  if (rule == bp::kMinstar)
    return launch_mode<MAX_DEG, bp::kMinstar>(p, track, grid, block, smem, st);
  return launch_mode<MAX_DEG, bp::kMinsum>(p, track, grid, block, smem, st);
}

}  // namespace

extern "C" {

// Decodes B frames in ceil(B / FT) tiles of FT = 8 frames (the arrays hold
// whole tiles; lanes past B are left alone) with rule 0 (min-sum, alpha and
// beta or the per-iteration ab table), 1 (spa) or 2 (minstar); returns a
// cudaError_t (0 on a successful launch). dcb_max must be <= 32 and
// 8 * threads_z <= 512; the wrapper checks both.
int layered_classic_decode(void* total, void* C, void* D, void* bits,
                           void* ok, void* iters, void* tab, void* ab, int Z,
                           int mb, int nb, int BE, int B, int max_iters,
                           int dcb_max, float alpha, float beta, int rule,
                           int track, int threads_z, void* stream) {
  if (threads_z < 1 || FT * threads_z > 512 || dcb_max > 32 || B < 1 ||
      rule < 0 || rule > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.total = static_cast<float*>(total);
  p.C = static_cast<float*>(C);
  p.D = static_cast<float*>(D);
  p.bits = static_cast<uint8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.tab = static_cast<const int32_t*>(tab);
  p.ab = static_cast<const float*>(ab);
  p.Z = Z; p.mb = mb; p.nb = nb; p.BE = BE; p.dmax = dcb_max; p.B = B;
  p.max_iters = max_iters; p.alpha = alpha; p.beta = beta;
  const dim3 block(FT, threads_z);
  const dim3 grid((B + FT - 1) / FT);
  const size_t smem = sizeof(int) * (size_t)(mb + 1 + 2 * BE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dcb_max <= 8) return (int)launch_rule<8>(p, rule, track, grid, block, smem, st);
  if (dcb_max <= 16) return (int)launch_rule<16>(p, rule, track, grid, block, smem, st);
  return (int)launch_rule<32>(p, rule, track, grid, block, smem, st);
}

const char* layered_classic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
