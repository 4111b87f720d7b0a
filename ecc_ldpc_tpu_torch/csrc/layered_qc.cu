// Layered normalized/offset min-sum on QC graphs, for Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel in its
// dup-free min-sum form (sweep_delta, syndrome_fail), in fixed-iteration
// and in track (early-termination) mode, with scalar or per-iteration
// alpha/beta; its XOR instantiation replaces
// ecc_ldpc_tpu/decode/pallas/layered_xor.py::_kernel's layered `sweep`
// (K4) on XOR-permutation graphs (IEEE 802.3an). The caller is
// ecc_ldpc_tpu_torch/decode/layered_qc.py (layered_decode_cuda); the plain
// PyTorch twin there is the reference this kernel must match bit for bit.
//
// Layout: frames are cut into tiles of FT = 8 frames (one 32-byte sector
// of f32 per row), and each tile's state is contiguous, frames innermost,
// so a block's reads of neighbouring checks land on neighbouring bytes:
//   posteriors  total f32 [tiles, nb*Z, FT]
//   check state cs u32   [tiles, mb*Z, NW, FT], one row per check in sweep
//               order: mag1, mag2, sign bits of the d messages, and the
//               slot that took mag2 (packed beside the signs when d <= 16).
// The check state is a lossless form of the reference's message array
// C [BE, Z]: message j of a check is (j == slot ? mag2 : mag1) with sign
// bit j, exactly the float the reference stored (with a tied minimum
// mag2 == mag1, so the slot chosen does not matter). It moves 12-16 bytes
// per check where C moves 4 per edge.
// Check z of block-edge (col, s) reads variable qc::var_index<XOR>(z, s, Z)
// of block-column col: (z + s) % Z on a circulant graph, z ^ s on an XOR
// graph (qc_index.cuh). A block permutation is index arithmetic here, so
// the TPU's rolls, one-hot permutation matmuls, delta-shift storage and
// replica packing are gone.
//
// Parallelism: one block owns a tile of frames (threadIdx.x, coalesced
// loads) and walks every check z of every layer (threadIdx.y strides z).
// Within a layer the Z checks of a frame touch distinct variables, so the
// only order to keep is layer after layer, which one __syncthreads() per
// layer gives. One launch decodes the whole batch for all iterations.
//
// Exact f32 semantics (built with -fmad=false, and the _rn intrinsics):
// signs are the XOR of sign bits (-0.0 counts as negative); hard
// decisions, the syndrome and track mode's layer parity use x < 0; the
// magnitude is the running two-min with |v| == min1 ? mag2 : mag1; the
// posterior is written as v + Cnew.
//
// What bounds it on an H100: the state round-trips through HBM on every
// edge visit (posterior read and write, 8 B per edge visit per frame) and
// every check visit (check state read and write, 24-32 B), about 10.6 GB
// per iteration at B=4096 on dvbs2/64800/12, so it is bound by memory
// traffic far above the true bound. Each thread issues the loads of two
// checks before it stores either (ZPT), which keeps enough bytes in
// flight to approach the card's memory rate (PERF.md has the timings).
// The true bound (what chip_smoke.py reports) is the larger of
//   bytes: 4 B of LLR in + 1 B of bits out per bit per frame
//          (1.33 GB at B=4096, n=64800: 0.40 ms at 3.35 TB/s), and
//   operations: 12 fp32/int operations per edge visit (pass 1: subtract,
//          abs, min, max, min, sign xor; pass 2: abs-compare, select,
//          xor, and, or, add) x 227,160 edges x 25 iterations per frame
//          (2.79e11 at B=4096: 4.2 ms at 67 TFLOP/s fp32),
// so the operations side bounds it, at a few ms per 4096 frames. Keeping
// a frame tile's posteriors on chip (a thread-block cluster with
// distributed shared memory) is the way toward that bound, and work for a
// later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qc_index.cuh"

namespace {

// frames per block (blockDim.x): 8 beat 16 and 32 on every benchmark leg
// on an H100 (PERF.md)
constexpr int FT = 8;
constexpr unsigned kSign = 0x80000000u;
constexpr float kMagCap = 1e12f;

struct Params {
  float* total;          // [tiles, nb*Z, FT] in: channel LLRs; out: posteriors
  uint32_t* cs;          // [tiles, mb*Z, 4, FT] scratch: check state
  uint8_t* bits;         // [tiles, nb*Z, FT] out: hard decisions
  uint8_t* ok;           // [B] out: final syndrome satisfied
  int32_t* iters;        // [B] out: iterations used
  const int32_t* tab;    // [mb+1 | BE | BE] layer_ptr, column, shift
  const float* ab;       // [2, max_iters] alpha_t then beta_t, or null
  int Z, mb, nb, BE, B, max_iters;
  float alpha, beta;
};

// Element `row` of this thread's frame in a tile whose rows are FT wide.
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

template <int MAX_DEG, bool TRACK, bool FAST_MAG, bool XOR>
__global__ void __launch_bounds__(512)
layered_qc_kernel(Params p) {
  // words per check: mag1, mag2, signs | slot << 16 (d <= 16), or
  // mag1, mag2, signs, slot
  constexpr int NW = MAX_DEG <= 16 ? 3 : 4;
  // checks per thread per round (their loads overlap); 1 at the widest
  // rows, where two checks' inputs would not fit in registers
  constexpr int ZPT = MAX_DEG <= 16 ? 2 : 1;
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
  uint32_t* cs = p.cs + tile * p.mb * Z * 4 * FT;
  const size_t ws = FT;  // stride between the words of one check

  // zero messages on the checks this thread owns in the sweep below
  if (live)
    for (int L = 0; L < p.mb; ++L)
      for (int z = threadIdx.y; z < Z; z += blockDim.y)
        for (int w = 0; w < NW; ++w) cs[at(((size_t)L * Z + z) * NW + w)] = 0u;
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
      // the tile stops once every frame in it is done; per-frame results
      // are those of a decode that ran all frames to the global stop.
      // Only the threadIdx.y == 0 row reads done_s here: it wrote it.
      if (__syncthreads_and(threadIdx.y == 0 ? done_s[tx] : 1)) break;
      if (threadIdx.y == 0) fail_s[tx] = 0;
    }
    const float a = p.ab ? p.ab[t] : p.alpha;
    const float bt = p.ab ? p.ab[p.max_iters + t] : p.beta;
    const bool active = live && (!TRACK || !done_s[tx]);
    bool fail = false;     // some layer parity failed (track mode)
    unsigned flip = 0;     // some posterior changed sign (track mode)

    for (int L = 0; L < p.mb; ++L) {
      const int s0 = lptr[L];
      const int d = lptr[L + 1] - s0;
      if (active) {
        for (int z0 = threadIdx.y; z0 < Z; z0 += ZPT * blockDim.y) {
          // all loads of this thread's ZPT checks come first: the checks
          // of one layer touch distinct variables, so no store below
          // aliases them, and ZPT checks' loads are in flight at once
          float rv[ZPT][MAX_DEG];
          uint32_t* c[ZPT];
          uint32_t old1[ZPT], old2[ZPT], oldw[ZPT], old3[ZPT];
#pragma unroll
          for (int k = 0; k < ZPT; ++k) {
            const int z = z0 + k * blockDim.y;
            if (z < Z) {
              c[k] = cs + at(((size_t)L * Z + z) * NW);
              old1[k] = c[k][0];
              old2[k] = c[k][ws];
              oldw[k] = c[k][2 * ws];
              old3[k] = NW == 3 ? 0u : c[k][3 * ws];
#pragma unroll
              for (int j = 0; j < MAX_DEG; ++j) {
                if (j < d) {
                  const int zz = qc::var_index<XOR>(z, sshift[s0 + j], Z);
                  rv[k][j] = tot[at(scol[s0 + j] * Z + zz)];
                }
              }
            }
          }
#pragma unroll
          for (int k = 0; k < ZPT; ++k) {
            const int z = z0 + k * blockDim.y;
            if (z >= Z) continue;
            // the messages this check sent last time (all +0.0 at first)
            const uint32_t oldsg = NW == 3 ? (oldw[k] & 0xFFFFu) : oldw[k];
            const int oldslot = NW == 3 ? (int)(oldw[k] >> 16) : (int)old3[k];
            float v[MAX_DEG];
            float min1 = INFINITY, min2 = INFINITY;
            unsigned sg = 0;
            bool par = false;
            // pass 1: extrinsic inputs, running two-min, sign-bit product
#pragma unroll
            for (int j = 0; j < MAX_DEG; ++j) {
              if (j < d) {
                const float cv = __uint_as_float(
                    (j == oldslot ? old2[k] : old1[k]) | (((oldsg >> j) & 1u) << 31));
                const float x = __fsub_rn(rv[k][j], cv);
                v[j] = x;
                if constexpr (TRACK) par ^= (rv[k][j] < 0.f);
                const float ax = fabsf(x);
                min2 = fminf(min2, fmaxf(min1, ax));
                min1 = fminf(min1, ax);
                sg ^= __float_as_uint(x);
              }
            }
            float mag1, mag2;
            if constexpr (FAST_MAG) {
              // beta == 0 and alpha >= 0, no schedule, every row degree
              // >= 2 (min2 finite): max(a*m - 0, 0) is a*m. The cap stays:
              // without it a decoded frame's magnitudes grow by about
              // alpha*(d - 1) a sweep, past 1e12 and toward f32 overflow
              mag1 = __fmul_rn(a, fminf(min1, kMagCap));
              mag2 = __fmul_rn(a, fminf(min2, kMagCap));
            } else {
              mag1 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min1, kMagCap)), bt), 0.f);
              mag2 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min2, kMagCap)), bt), 0.f);
            }
            if constexpr (TRACK) fail |= par;
            // pass 2: messages out, posteriors written back as v + Cnew
            uint32_t newsg = 0;
            int slot = -1;
#pragma unroll
            for (int j = 0; j < MAX_DEG; ++j) {
              if (j < d) {
                const float x = v[j];
                const bool is_min = fabsf(x) == min1;
                if (is_min && slot < 0) slot = j;
                const uint32_t neg = (sg ^ __float_as_uint(x)) & kSign;
                newsg |= (neg >> 31) << j;
                const float cn = __uint_as_float(
                    __float_as_uint(is_min ? mag2 : mag1) | neg);
                const float nw = __fadd_rn(x, cn);
                if constexpr (TRACK)
                  flip |= (__float_as_uint(nw) ^ __float_as_uint(rv[k][j])) & kSign;
                const int zz = qc::var_index<XOR>(z, sshift[s0 + j], Z);
                tot[at(scol[s0 + j] * Z + zz)] = nw;
              }
            }
            c[k][0] = __float_as_uint(mag1);
            c[k][ws] = __float_as_uint(mag2);
            if constexpr (NW == 3) {
              c[k][2 * ws] = newsg | ((uint32_t)slot << 16);
            } else {
              c[k][2 * ws] = newsg;
              c[k][3 * ws] = (uint32_t)slot;
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

template <int MAX_DEG, bool TRACK, bool FAST_MAG, bool XOR>
cudaError_t launch(const Params& p, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream) {
  auto kern = layered_qc_kernel<MAX_DEG, TRACK, FAST_MAG, XOR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAX_DEG, bool XOR>
cudaError_t launch_mode(const Params& p, int track, int fast_mag, dim3 grid,
                        dim3 block, size_t smem, cudaStream_t stream) {
  if (track) return launch<MAX_DEG, true, false, XOR>(p, grid, block, smem, stream);
  if (fast_mag) return launch<MAX_DEG, false, true, XOR>(p, grid, block, smem, stream);
  return launch<MAX_DEG, false, false, XOR>(p, grid, block, smem, stream);
}

template <bool XOR>
cudaError_t launch_width(const Params& p, int dcb_max, int track, int fast_mag,
                         dim3 grid, dim3 block, size_t smem, cudaStream_t st) {
  if (dcb_max <= 8) return launch_mode<8, XOR>(p, track, fast_mag, grid, block, smem, st);
  if (dcb_max <= 16) return launch_mode<16, XOR>(p, track, fast_mag, grid, block, smem, st);
  return launch_mode<32, XOR>(p, track, fast_mag, grid, block, smem, st);
}

}  // namespace

extern "C" {

// Decodes B frames in ceil(B / FT) tiles of FT = 8 frames (the arrays
// hold whole tiles; lanes past B are left alone) on a circulant graph
// (xor_perm = 0) or an XOR-permutation graph (xor_perm = 1, power-of-two
// Z); returns a cudaError_t (0 on a successful launch). dcb_max must be
// <= 32 and 8 * threads_z <= 512; the wrapper checks both.
int layered_qc_decode(void* total, void* cs, void* bits, void* ok, void* iters,
                      void* tab, void* ab, int Z, int mb, int nb, int BE,
                      int B, int max_iters, int dcb_max, float alpha,
                      float beta, int track, int fast_mag, int threads_z,
                      int xor_perm, void* stream) {
  if (threads_z < 1 || FT * threads_z > 512 || dcb_max > 32 || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.total = static_cast<float*>(total);
  p.cs = static_cast<uint32_t*>(cs);
  p.bits = static_cast<uint8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.tab = static_cast<const int32_t*>(tab);
  p.ab = static_cast<const float*>(ab);
  p.Z = Z; p.mb = mb; p.nb = nb; p.BE = BE; p.B = B;
  p.max_iters = max_iters; p.alpha = alpha; p.beta = beta;
  const dim3 block(FT, threads_z);
  const dim3 grid((B + FT - 1) / FT);
  const size_t smem = sizeof(int) * (size_t)(mb + 1 + 2 * BE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xor_perm)
    return (int)launch_width<true>(p, dcb_max, track, fast_mag, grid, block, smem, st);
  return (int)launch_width<false>(p, dcb_max, track, fast_mag, grid, block, smem, st);
}

const char* layered_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
