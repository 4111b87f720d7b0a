// Flooding belief propagation (minsum, spa, minstar) on QC graphs, for
// Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/flooding_qc.py::_kernel (:85, sweep
// :113), which computes decode/xla/flooding_qc.py::decode_flooding_qc; its
// XOR instantiation replaces ecc_ldpc_tpu/decode/pallas/layered_xor.py::
// _kernel's `sweep_flooding` (K4's flooding mode, min-sum) and also runs spa
// and minstar on XOR graphs. The caller is
// ecc_ldpc_tpu_torch/decode/flooding_qc.py (flooding_qc_decode_cuda); the
// plain PyTorch twin there is the reference this kernel must match. Check z
// of block-edge (col, s) reads variable col*Z + qc::var_index<XOR>(z, s, Z):
// (z + s) % Z on a circulant graph, z ^ s on an XOR graph (qc_index.cuh).
// The permutations are index arithmetic, so unlike the TPU kernels there is
// no Z % 8 envelope, no bf16 fallback, no one-hot matmul and no VMEM cap.
//
// Layout: frames in tiles of FT = 8, each tile's state contiguous with
// frames innermost,
//   llr        f32 [tiles, nb*Z, FT]   channel LLRs (read only)
//   total, nxt f32 [tiles, nb*Z, FT]   stale posteriors and the next ones
//   C          f32 [tiles, BE*Z, FT]   messages, one row per (sweep slot, check)
// one block per tile runs every iteration, threads over (frame, row).
// Table (shared memory): per block-row in layer_order its slots' column and
// shift (the sweep order of csrc/layered_qc.cu), and per block-column the
// (slot, shift) of its edges in the same sweep order.
//
// Per iteration:
//   CN phase  one thread per (check, frame) reads the d rolled stale
//             posteriors r, forms v = r - C_old and C = rule(v)
//             (csrc/bp_rules.cuh); in track mode the parity of the rolled
//             hard decisions (r < 0) is the stale-posterior `fail`.
//   VN phase  one thread per (variable, frame) rebuilds its posterior as
//             llr + C_1 + C_2 + ... in exactly the oracle's order: block-
//             rows in layer_order, edges in edge-id order within a row. No
//             atomics, which would change the order of the sums.
//   swap      each frame keeps the index of its current buffer.
// Freeze (track mode, decode/xla/flooding_qc.py:159-172): a frame whose
// pre-sweep state passed keeps that state (keep_end = done | ~fail); C is
// frozen on the old `done`; `iters` counts the sweeps applied to the state
// reported; `ok` is the syndrome of the reported state.
//
// What bounds it on an H100: 16 B per edge visit (the rolled posterior,
// the old message and the new one in the CN phase; the message again in
// the VN phase) and 8 B per variable (LLR read, posterior written): 4.15 MB
// per frame-iteration at dvbs2/64800/12, 425 GB for 4096 frames x 25
// iterations, so minsum is bound by memory traffic; spa (4
// transcendentals per edge) and minstar (~8.6) by the accurate
// transcendentals' instruction count as K1c is. 16-bit messages and the
// retry fallback's tiny batches spread over more blocks are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_rules.cuh"
#include "qc_index.cuh"

namespace {

constexpr int FT = 8;

struct Params {
  const float* llr;      // [tiles, nb*Z, FT]
  float* total;          // [tiles, nb*Z, FT] out: posteriors
  float* nxt;            // [tiles, nb*Z, FT] scratch: the other buffer
  float* C;              // [tiles, BE*Z, FT] scratch: messages
  uint8_t* bits;         // [tiles, nb*Z, FT] out: hard decisions
  uint8_t* ok;           // [B] out: final syndrome satisfied
  int32_t* iters;        // [B] out: iterations used
  const int32_t* tab;    // [mb+1 | BE | BE | nb+1 | BE | BE]
  int Z, mb, nb, BE, B, max_iters;
  float alpha, beta;
};

struct Tab {
  const int *rptr, *scol, *sshift, *cptr, *cslot, *cshift;
};

__device__ __forceinline__ size_t at(size_t row) { return row * FT + threadIdx.x; }

// Parity failure of (tot < 0) over the checks this thread owns.
template <bool XOR>
__device__ __forceinline__ bool syndrome_fail_part(const Params& p, Tab t,
                                                   const float* tot) {
  bool fail = false;
  const int Z = p.Z;
  for (int q = threadIdx.y; q < p.mb * Z; q += blockDim.y) {
    const int L = q / Z, z = q - L * Z;
    bool par = false;
    for (int s = t.rptr[L]; s < t.rptr[L + 1]; ++s) {
      const int zz = qc::var_index<XOR>(z, t.sshift[s], Z);
      par ^= (tot[at(t.scol[s] * Z + zz)] < 0.f);
    }
    fail |= par;
  }
  return fail;
}

template <int MAX_DEG, int RULE, bool TRACK, bool XOR>
__global__ void __launch_bounds__(512) flooding_qc_kernel(Params p) {
  extern __shared__ int smem[];
  Tab t;
  t.rptr = smem;
  t.scol = t.rptr + p.mb + 1;
  t.sshift = t.scol + p.BE;
  t.cptr = t.sshift + p.BE;
  t.cslot = t.cptr + p.nb + 1;
  t.cshift = t.cslot + p.BE;
  __shared__ int fail_s[FT];
  __shared__ int done_s[FT];

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ntab = p.mb + 1 + p.nb + 1 + 4 * p.BE;
  for (int i = tid; i < ntab; i += nthreads) smem[i] = p.tab[i];

  const int Z = p.Z, n = p.nb * Z;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * FT + tx;
  const bool live = b < p.B;
  const size_t tile = blockIdx.x;
  const float* L = p.llr + tile * n * FT;
  // the two posterior buffers, chosen by a select on `cur` (an array
  // indexed at run time would go to local memory)
  float* const buf0 = p.total + tile * n * FT;
  float* const buf1 = p.nxt + tile * n * FT;
  float* C = p.C + tile * (size_t)p.BE * Z * FT;
  int cur = 0;  // this frame's current posterior buffer

  for (int v = threadIdx.y; v < n; v += blockDim.y) buf0[at(v)] = L[at(v)];
  for (int e = threadIdx.y; e < p.BE * Z; e += blockDim.y) C[at(e)] = 0.f;
  if (threadIdx.y == 0) fail_s[tx] = 0;
  __syncthreads();
  if constexpr (TRACK) {
    if (live && syndrome_fail_part<XOR>(p, t, buf0)) atomicOr(&fail_s[tx], 1);
    __syncthreads();
    if (threadIdx.y == 0) {
      done_s[tx] = live ? !fail_s[tx] : 1;
      fail_s[tx] = 0;
    }
  }
  int used = 0;  // sweeps applied to frame b's state (threadIdx.y == 0 row)

  for (int it = 0; it < p.max_iters; ++it) {
    if constexpr (TRACK) {
      if (__syncthreads_and(threadIdx.y == 0 ? done_s[tx] : 1)) break;
    }
    const bool active = live && (!TRACK || !done_s[tx]);
    const float* tot = cur ? buf1 : buf0;
    bool fail = false;
    if (active) {
      for (int q = threadIdx.y; q < p.mb * Z; q += blockDim.y) {
        const int Lr = q / Z, z = q - Lr * Z;
        const int s0 = t.rptr[Lr];
        const int d = t.rptr[Lr + 1] - s0;
        float v[MAX_DEG];
        bool par = false;
#pragma unroll
        for (int j = 0; j < MAX_DEG; ++j) {
          if (j < d) {
            const int zz = qc::var_index<XOR>(z, t.sshift[s0 + j], Z);
            const float r = tot[at(t.scol[s0 + j] * Z + zz)];
            if constexpr (TRACK) par ^= (r < 0.f);
            v[j] = __fsub_rn(r, C[at((size_t)(s0 + j) * Z + z)]);
          }
        }
        if constexpr (TRACK) fail |= par;
        bp::check_rule<MAX_DEG, RULE>(v, d, p.alpha, p.beta);
#pragma unroll
        for (int j = 0; j < MAX_DEG; ++j)
          if (j < d) C[at((size_t)(s0 + j) * Z + z)] = v[j];
      }
    }
    if constexpr (TRACK) {
      if (active && fail) atomicOr(&fail_s[tx], 1);
    }
    __syncthreads();
    // the frame advances unless its pre-sweep state passed (or it is done)
    const bool adv = active && (!TRACK || fail_s[tx]);
    if (adv) {
      float* out = cur ? buf0 : buf1;
      for (int q = threadIdx.y; q < n; q += blockDim.y) {
        const int col = q / Z, zv = q - col * Z;
        float acc = L[at(q)];
        for (int k = t.cptr[col]; k < t.cptr[col + 1]; ++k) {
          const int z = qc::check_index<XOR>(zv, t.cshift[k], Z);
          acc = __fadd_rn(acc, C[at((size_t)t.cslot[k] * Z + z)]);
        }
        out[at(q)] = acc;
      }
      cur ^= 1;
    }
    __syncthreads();
    if constexpr (TRACK) {
      if (threadIdx.y == 0) {
        if (adv) ++used;
        if (active && !fail_s[tx]) done_s[tx] = 1;
        fail_s[tx] = 0;
      }
    }
  }

  // truthful ok: one final syndrome over the reported state, which then
  // goes to `total` (buffer 0) as the posteriors
  __syncthreads();
  if (live) {
    const float* tot = cur ? buf1 : buf0;
    if (syndrome_fail_part<XOR>(p, t, tot)) atomicOr(&fail_s[tx], 1);
    uint8_t* bits = p.bits + tile * n * FT;
    for (int q = threadIdx.y; q < n; q += blockDim.y) {
      const float x = tot[at(q)];
      bits[at(q)] = x < 0.f ? 1 : 0;
      if (cur) buf0[at(q)] = x;
    }
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
  auto kern = flooding_qc_kernel<MAX_DEG, RULE, TRACK, XOR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAX_DEG, bool XOR>
cudaError_t launch_rule(const Params& p, int rule, int track, dim3 grid,
                        dim3 block, size_t smem, cudaStream_t st) {
  switch (rule) {
    case bp::kMinsum:
      return track ? launch<MAX_DEG, bp::kMinsum, true, XOR>(p, grid, block, smem, st)
                   : launch<MAX_DEG, bp::kMinsum, false, XOR>(p, grid, block, smem, st);
    case bp::kSpa:
      return track ? launch<MAX_DEG, bp::kSpa, true, XOR>(p, grid, block, smem, st)
                   : launch<MAX_DEG, bp::kSpa, false, XOR>(p, grid, block, smem, st);
    default:
      return track ? launch<MAX_DEG, bp::kMinstar, true, XOR>(p, grid, block, smem, st)
                   : launch<MAX_DEG, bp::kMinstar, false, XOR>(p, grid, block, smem, st);
  }
}

template <bool XOR>
cudaError_t launch_width(const Params& p, int dcb_max, int rule, int track,
                         dim3 grid, dim3 block, size_t smem, cudaStream_t st) {
  if (dcb_max <= 8) return launch_rule<8, XOR>(p, rule, track, grid, block, smem, st);
  if (dcb_max <= 16) return launch_rule<16, XOR>(p, rule, track, grid, block, smem, st);
  return launch_rule<32, XOR>(p, rule, track, grid, block, smem, st);
}

}  // namespace

extern "C" {

// Decodes B frames in ceil(B / FT) tiles of FT = 8 frames (the arrays hold
// whole tiles; lanes past B are left alone) with rule 0 (minsum), 1 (spa)
// or 2 (minstar) on a circulant (xor_perm = 0) or an XOR-permutation graph
// (xor_perm = 1); returns a cudaError_t (0 on a successful launch).
// dcb_max must be <= 32 and 8 * threads_y <= 512; the wrapper checks both.
int flooding_qc_decode(void* llr, void* total, void* nxt, void* C, void* bits,
                       void* ok, void* iters, void* tab, int Z, int mb, int nb,
                       int BE, int B, int max_iters, int dcb_max, int rule,
                       float alpha, float beta, int track, int threads_y,
                       int xor_perm, void* stream) {
  if (threads_y < 1 || FT * threads_y > 512 || dcb_max > 32 || B < 1 ||
      rule < 0 || rule > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.llr = static_cast<const float*>(llr);
  p.total = static_cast<float*>(total);
  p.nxt = static_cast<float*>(nxt);
  p.C = static_cast<float*>(C);
  p.bits = static_cast<uint8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.tab = static_cast<const int32_t*>(tab);
  p.Z = Z; p.mb = mb; p.nb = nb; p.BE = BE; p.B = B;
  p.max_iters = max_iters; p.alpha = alpha; p.beta = beta;
  const dim3 block(FT, threads_y);
  const dim3 grid((B + FT - 1) / FT);
  const size_t smem = sizeof(int) * (size_t)(mb + 1 + nb + 1 + 4 * BE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xor_perm)
    return (int)launch_width<true>(p, dcb_max, rule, track, grid, block, smem, st);
  return (int)launch_width<false>(p, dcb_max, rule, track, grid, block, smem, st);
}

const char* flooding_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
