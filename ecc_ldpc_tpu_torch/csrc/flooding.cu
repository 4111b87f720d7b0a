// Flooding belief propagation (minsum, spa, minstar) on unstructured
// graphs, for Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/fused_mm.py::_kernel (:151, with
// _cn_minsum_slabs :68 and _cn_spa_slabs :116), which computes
// decode/xla/flooding.py::decode_flooding with the gathers written as 0/1
// incidence matmuls, because the TPU has no vector gather. Here the VN
// accumulate is a gather over vn_edge. minstar is this kernel's third rule;
// the JAX package serves it only through its XLA gather form. The caller
// is ecc_ldpc_tpu_torch/decode/flooding.py (flooding_decode_cuda); the
// plain PyTorch twin there is the reference this kernel must match.
//
// Layout: frames in tiles of FT = 8, each tile's state contiguous with
// frames innermost,
//   llr   f32 [tiles, n, FT]      channel LLRs (read only)
//   total f32 [tiles, n, FT]      posteriors (out)
//   C     f32 [tiles, m*dc, FT]   check-to-variable messages, edge i*dc + j
// one block per tile runs every iteration, threads over (frame, row).
// Tables (global, read through the cache): cn[m*dc] the variable of each
// check slot (-1 where padded), vn[n*dv] the edge of each variable slot
// (-1 where padded).
//
// Per iteration, as the oracle does it:
//   CN phase  one thread per (check, frame): v = total[cn] - C (a padded
//             slot holds 1e9 for minstar, as the oracle's masked form),
//             C = rule(v) (csrc/bp_rules.cuh);
//   VN phase  one thread per (variable, frame): total = llr + s, where
//             s = ((0 + C[e0]) + C[e1]) + ... over the slots in order, a
//             padded slot adding 0.0, as the oracle's masked sum;
//   track     the syndrome of (total < 0), taken on the post-sweep state.
// The oracle's V = total[cn] - C is recomputed from (total, C) on the fly:
// the same floats. Track mode follows flooding.py:53-70: a frame done
// before the sweep keeps its state, `iters` counts the sweeps of frames not
// yet done, done_0 is the syndrome of the channel LLRs; the tile stops
// once all its frames are done.
//
// What bounds it on an H100: at mackay1008 (n=1008, 3024 edges) a tile's
// state is 160 KB and a batch of 2048 frames 41 MB, inside the 50 MB L2;
// this design moves 16 B per edge visit and 8 B per variable through the
// cache hierarchy and pays three block barriers per iteration, so short
// phases and barrier latency, not HBM, are expected to bound it. Keeping
// the tile's state in shared memory (160 KB at FT = 8 fits the 227 KB a
// block may have) is the first step toward speed, and later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_rules.cuh"

namespace {

constexpr int FT = 8;

struct Params {
  const float* llr;   // [tiles, n, FT]
  float* total;       // [tiles, n, FT] out: posteriors
  float* C;           // [tiles, m*dc, FT] scratch: messages
  uint8_t* bits;      // [tiles, n, FT] out: hard decisions
  uint8_t* ok;        // [B] out: final syndrome satisfied
  int32_t* iters;     // [B] out: iterations used
  const int32_t* cn;  // [m*dc] variable per check slot, -1 padded
  const int32_t* vn;  // [n*dv] edge per variable slot, -1 padded
  int n, m, dc, dv, B, max_iters;
  float alpha, beta;
};

__device__ __forceinline__ size_t at(size_t row) { return row * FT + threadIdx.x; }

// Parity failure of (total < 0) over the checks this thread owns.
__device__ __forceinline__ bool syndrome_fail_part(const Params& p,
                                                   const float* tot) {
  bool fail = false;
  for (int i = threadIdx.y; i < p.m; i += blockDim.y) {
    bool par = false;
    for (int j = 0; j < p.dc; ++j) {
      const int v = __ldg(p.cn + i * p.dc + j);
      if (v >= 0) par ^= (tot[at(v)] < 0.f);
    }
    fail |= par;
  }
  return fail;
}

template <int MAX_DC, int RULE, bool TRACK>
__global__ void __launch_bounds__(512) flooding_kernel(Params p) {
  __shared__ int fail_s[FT];
  __shared__ int done_s[FT];
  const int tx = threadIdx.x;
  const int b = blockIdx.x * FT + tx;
  const bool live = b < p.B;
  const size_t tile = blockIdx.x;
  const float* L = p.llr + tile * p.n * FT;
  float* tot = p.total + tile * p.n * FT;
  float* C = p.C + tile * (size_t)p.m * p.dc * FT;

  for (int v = threadIdx.y; v < p.n; v += blockDim.y) tot[at(v)] = L[at(v)];
  for (int e = threadIdx.y; e < p.m * p.dc; e += blockDim.y) C[at(e)] = 0.f;
  if (threadIdx.y == 0) fail_s[tx] = 0;
  __syncthreads();
  if constexpr (TRACK) {
    if (live && syndrome_fail_part(p, tot)) atomicOr(&fail_s[tx], 1);
    __syncthreads();
    if (threadIdx.y == 0) {
      done_s[tx] = live ? !fail_s[tx] : 1;
      fail_s[tx] = 0;
    }
  }
  int used = 0;  // iterations of frame b, kept by the threadIdx.y == 0 row

  for (int t = 0; t < p.max_iters; ++t) {
    if constexpr (TRACK) {
      if (__syncthreads_and(threadIdx.y == 0 ? done_s[tx] : 1)) break;
    }
    const bool active = live && (!TRACK || !done_s[tx]);
    if (active) {
      for (int i = threadIdx.y; i < p.m; i += blockDim.y) {
        float v[MAX_DC];
        int deg = 0;
#pragma unroll
        for (int j = 0; j < MAX_DC; ++j) {
          if (j < p.dc) {
            const int var = __ldg(p.cn + i * p.dc + j);
            if (var >= 0) {
              v[j] = __fsub_rn(tot[at(var)], C[at((size_t)i * p.dc + j)]);
              deg = j + 1;
            } else {
              v[j] = bp::kIdentity;
            }
          }
        }
        bp::check_rule<MAX_DC, RULE>(v, RULE == bp::kMinstar ? p.dc : deg,
                                     p.alpha, p.beta);
#pragma unroll
        for (int j = 0; j < MAX_DC; ++j)
          if (j < deg) C[at((size_t)i * p.dc + j)] = v[j];
      }
    }
    __syncthreads();
    if (active) {
      for (int u = threadIdx.y; u < p.n; u += blockDim.y) {
        float s = 0.f;
        for (int j = 0; j < p.dv; ++j) {
          const int e = __ldg(p.vn + u * p.dv + j);
          s = __fadd_rn(s, e >= 0 ? C[at(e)] : 0.f);
        }
        tot[at(u)] = __fadd_rn(L[at(u)], s);
      }
    }
    __syncthreads();
    if constexpr (TRACK) {
      if (active && syndrome_fail_part(p, tot)) atomicOr(&fail_s[tx], 1);
      __syncthreads();
      if (threadIdx.y == 0) {
        if (active) {
          ++used;
          if (!fail_s[tx]) done_s[tx] = 1;
        }
        fail_s[tx] = 0;
      }
    }
  }

  // truthful ok: one final syndrome over the emitted hard decisions
  __syncthreads();
  if (live) {
    if (syndrome_fail_part(p, tot)) atomicOr(&fail_s[tx], 1);
    uint8_t* bits = p.bits + tile * p.n * FT;
    for (int u = threadIdx.y; u < p.n; u += blockDim.y)
      bits[at(u)] = tot[at(u)] < 0.f ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    p.ok[b] = fail_s[tx] ? 0 : 1;
    p.iters[b] = TRACK ? used : p.max_iters;
  }
}

template <int MAX_DC, int RULE, bool TRACK>
cudaError_t launch(const Params& p, dim3 grid, dim3 block, cudaStream_t st) {
  flooding_kernel<MAX_DC, RULE, TRACK><<<grid, block, 0, st>>>(p);
  return cudaGetLastError();
}

template <int MAX_DC>
cudaError_t launch_rule(const Params& p, int rule, int track, dim3 grid,
                        dim3 block, cudaStream_t st) {
  switch (rule) {
    case bp::kMinsum:
      return track ? launch<MAX_DC, bp::kMinsum, true>(p, grid, block, st)
                   : launch<MAX_DC, bp::kMinsum, false>(p, grid, block, st);
    case bp::kSpa:
      return track ? launch<MAX_DC, bp::kSpa, true>(p, grid, block, st)
                   : launch<MAX_DC, bp::kSpa, false>(p, grid, block, st);
    default:
      return track ? launch<MAX_DC, bp::kMinstar, true>(p, grid, block, st)
                   : launch<MAX_DC, bp::kMinstar, false>(p, grid, block, st);
  }
}

}  // namespace

extern "C" {

// Decodes B frames in ceil(B / FT) tiles of FT = 8 frames (the arrays hold
// whole tiles; lanes past B are left alone) with rule 0 (minsum), 1 (spa)
// or 2 (minstar); returns a cudaError_t (0 on a successful launch). dc must
// be <= 32 and 8 * threads_y <= 512; the wrapper checks both.
int flooding_decode(void* llr, void* total, void* C, void* bits, void* ok,
                    void* iters, void* cn, void* vn, int n, int m, int dc,
                    int dv, int B, int max_iters, int rule, float alpha,
                    float beta, int track, int threads_y, void* stream) {
  if (threads_y < 1 || FT * threads_y > 512 || dc > 32 || dc < 1 || B < 1 ||
      rule < 0 || rule > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.llr = static_cast<const float*>(llr);
  p.total = static_cast<float*>(total);
  p.C = static_cast<float*>(C);
  p.bits = static_cast<uint8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.cn = static_cast<const int32_t*>(cn);
  p.vn = static_cast<const int32_t*>(vn);
  p.n = n; p.m = m; p.dc = dc; p.dv = dv; p.B = B; p.max_iters = max_iters;
  p.alpha = alpha; p.beta = beta;
  const dim3 block(FT, threads_y);
  const dim3 grid((B + FT - 1) / FT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dc <= 8) return (int)launch_rule<8>(p, rule, track, grid, block, st);
  return (int)launch_rule<32>(p, rule, track, grid, block, st);
}

const char* flooding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
