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
// Design (csrc/cluster_tile.cuh): a tile of F frames keeps its f32
// posteriors on chip for the whole decode, in the shared memory of a
// thread-block cluster of CS blocks, and a persistent grid of clusters
// takes tiles from an atomic counter. decode/layered_qc.tile_plan picks CS
// and F and the kernel obeys the plan: on a batch that fills the card a
// cluster of one a tile (one dvbs2/64800 frame an SM, the parity
// columns read by the fewest layers in an L2-resident scratch; 16 802.3an
// frames an SM, all on chip), on a small batch (the retry fallback's ~13
// frames) one frame spread over a cluster of 8 SMs through distributed
// shared memory. LLRs come straight from llr [B, n]; bits (and, when
// asked, posteriors) go straight to [B, n].
// Check state: per check, in HBM, prefetched a layer ahead with cp.async:
// mag1, mag2, the sign bits of the d messages and the slot that took mag2
// (packed beside the signs when d <= 16), NW = 3, 4 or 5 (d > 32) words.
// It is a lossless form of the reference's message array C [BE, Z]:
// message j of a check is (j == slot ? mag2 : mag1) with sign bit j,
// exactly the float the reference stored (with a tied minimum mag2 ==
// mag1, so the slot chosen does not matter). It moves 12-20 bytes per
// check where C moves 4 per edge. Check z of block-edge (col, s) reads variable
// qc::var_index<XOR>(z, s, Z) of block-column col: (z + s) % Z on a
// circulant graph, z ^ s on an XOR graph (qc_index.cuh). A block
// permutation is index arithmetic here, so the TPU's rolls, one-hot
// permutation matmuls, delta-shift storage and replica packing are gone.
//
// Row widths: one build each for rows of up to 8, 16, 32 and 64 slots
// (the 64-wide one, for dvbs2/16200/910's degree 34 and loaded matrices,
// holds 64 posteriors a thread and spills at 512 threads; PERF.md), and a
// wide build for any wider row (MinsumWide: the row is read from the
// tile's posteriors twice instead of held in registers; its check state
// is 3 + ceil(d/32) words). A long row is never split: layered min-sum
// over a split row is another decoder.
//
// Exact f32 semantics (built with -fmad=false, and the _rn intrinsics):
// signs are the XOR of sign bits (-0.0 counts as negative); hard
// decisions, the syndrome and track mode's layer parity use x < 0; the
// magnitude is the running two-min with |v| == min1 ? mag2 : mag1; the
// posterior is written as v + Cnew.
//
// Message precision: built with LAYERED_PREC 1 (the precision library,
// csrc/cluster_tile.cuh) the kernels take a ct::Prec, uniform over the
// launch (bf16, the TPU kernel's message and LLR storage, or q:BITS:STEP),
// round the LLRs as the tile loads them, and keep Q(mag1) and Q(mag2) in
// the state, which is Q of every stored message since Q is odd; the
// posterior adds Q(Cnew) under q: and in bf16 track mode, and the
// unrounded Cnew in bf16 fixed mode (ecc_ldpc_tpu/decode/pallas/
// layered_qc.py:394 against :376-380). The f32 library's kernels are the
// code above, unchanged.
//
// What bounds it on an H100: the true bound (what chip_smoke.py reports)
// is the larger of
//   bytes: 4 B of LLR in + 1 B of bits out per bit per frame
//          (1.33 GB at B=4096, n=64800: 0.40 ms at 3.35 TB/s), and
//   operations: 12 fp32/int operations per edge visit (pass 1: subtract,
//          abs, min, max, min, sign xor; pass 2: abs-compare, select,
//          xor, and, or, add) x 227,160 edges x 25 iterations per frame
//          (2.79e11 at B=4096: 4.2 ms at 67 TFLOP/s fp32),
// so the operations side bounds it. The earlier design kept posteriors in
// HBM and moved ~10.6 GB per iteration at B=4096 on dvbs2/64800/12, ~75%
// of them posteriors, at ~75% of the card's memory rate. Here ~80% of a
// frame's posteriors stay in shared memory (the rest, degree-2 parity
// columns read by ~1/3 of the layers, in L2) and the check state (12 B
// per check, read and written once an iteration: ~0.78 MB a frame an
// iteration) is prefetched a layer ahead. What bounds it now is latency:
// a tile is one frame on one SM, 360 checks a layer step on 12 warps, and
// each step is a chain of shared-memory (and L2) loads, the check
// arithmetic, stores and a block barrier, 25 x 90 of them per frame
// (~1.2 us a step on an H100, bench/cluster_probe.py; PERF.md). A
// cluster of several SMs per tile shares a frame's posteriors through
// distributed shared memory, but its barrier is a GPU-scope fence and
// makes a step 0.3-0.4 us slower, so only small batches, which would
// leave SMs idle, take it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_tile.cuh"
#include "qc_index.cuh"  // the XOR template parameter's permutation

namespace {

constexpr unsigned kSign = 0x80000000u;
constexpr float kMagCap = 1e12f;
// the widest register build (decode/layered_qc.MAX_DEG); wider rows take
// the wide build
constexpr int kMaxDeg = 64;

struct MinsumParams {
  const float* ab;  // [2, max_iters] alpha_t then beta_t, or null
  float alpha, beta;
  int max_iters;
};

// Normalized/offset min-sum on one check, its state compressed to NW words.
template <int DEG, bool FAST_MAG>
struct Minsum {
  static constexpr int MAX_DEG = DEG;
  // words per check: mag1, mag2, signs | slot << 16 (d <= 16), or
  // mag1, mag2, signs, slot (d <= 32), or mag1, mag2, the signs of slots
  // 0-31, those of 32-63, slot (d <= 64; decode/layered_qc.candidate_plans)
  static constexpr int NW = DEG <= 16 ? 3 : DEG <= 32 ? 4 : 5;
  using Mask = ct::SignMask<DEG>;
  MinsumParams p;
  float a, bt;
  ct::Prec q;  // the precision library's rounding

  __device__ void begin(int t) {
    a = p.ab ? p.ab[t] : p.alpha;
    bt = p.ab ? p.ab[p.max_iters + t] : p.beta;
  }

  __device__ void update(float (&r)[DEG], int d, const uint32_t* old,
                         bool zero, uint32_t* out, int ws) const {
    // the messages this check sent last time (all +0.0 at first)
    uint32_t old1 = 0, old2 = 0, oldw = 0, old3 = 0, old4 = 0;
    if (!zero) {
      old1 = old[0];
      old2 = old[ws];
      oldw = old[2 * ws];
      if (NW >= 4) old3 = old[3 * ws];
      if (NW == 5) old4 = old[4 * ws];
    }
    Mask oldsg;
    int oldslot;
    if constexpr (NW == 3) {
      oldsg = oldw & 0xFFFFu;
      oldslot = (int)(oldw >> 16);
    } else if constexpr (NW == 4) {
      oldsg = oldw;
      oldslot = (int)old3;
    } else {
      oldsg = (Mask)oldw | ((Mask)old3 << 32);
      oldslot = (int)old4;
    }
    float min1 = INFINITY, min2 = INFINITY;
    unsigned sg = 0;
    // pass 1: extrinsic inputs, running two-min, sign-bit product
#pragma unroll
    for (int j = 0; j < DEG; ++j) {
      if (j < d) {
        const float cv = __uint_as_float(
            (j == oldslot ? old2 : old1) |
            ((uint32_t)((oldsg >> j) & 1u) << 31));
        const float x = __fsub_rn(r[j], cv);
        r[j] = x;
        const float ax = fabsf(x);
        min2 = fminf(min2, fmaxf(min1, ax));
        min1 = fminf(min1, ax);
        sg ^= __float_as_uint(x);
      }
    }
    float mag1, mag2;
    if constexpr (FAST_MAG) {
      // beta == 0 and alpha >= 0, no schedule, every row degree >= 2 (min2
      // finite): max(a*m - 0, 0) is a*m. The cap stays: without it a
      // decoded frame's magnitudes grow by about alpha*(d - 1) a sweep,
      // past 1e12 and toward f32 overflow
      mag1 = __fmul_rn(a, fminf(min1, kMagCap));
      mag2 = __fmul_rn(a, fminf(min2, kMagCap));
    } else {
      mag1 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min1, kMagCap)), bt), 0.f);
      mag2 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min2, kMagCap)), bt), 0.f);
    }
    if constexpr (ct::kPrec) {
      // the stored messages are Q(Cnew) = sign | Q(mag); the posterior
      // takes the rounded message where q.post, else the unrounded one
      const float q1 = q(mag1), q2 = q(mag2);
      out[0] = __float_as_uint(q1);
      out[ws] = __float_as_uint(q2);
      if (q.post) {
        mag1 = q1;
        mag2 = q2;
      }
    }
    // pass 2: messages out, posteriors as v + Cnew
    Mask newsg = 0;
    int slot = -1;
#pragma unroll
    for (int j = 0; j < DEG; ++j) {
      if (j < d) {
        const float x = r[j];
        const bool is_min = fabsf(x) == min1;
        if (is_min && slot < 0) slot = j;
        const uint32_t neg = (sg ^ __float_as_uint(x)) & kSign;
        newsg |= (Mask)(neg >> 31) << j;
        const float cn =
            __uint_as_float(__float_as_uint(is_min ? mag2 : mag1) | neg);
        r[j] = __fadd_rn(x, cn);
      }
    }
    if constexpr (!ct::kPrec) {
      out[0] = __float_as_uint(mag1);
      out[ws] = __float_as_uint(mag2);
    }
    if constexpr (NW == 3) {
      out[2 * ws] = (uint32_t)newsg | ((uint32_t)slot << 16);
    } else if constexpr (NW == 4) {
      out[2 * ws] = (uint32_t)newsg;
      out[3 * ws] = (uint32_t)slot;
    } else {
      out[2 * ws] = (uint32_t)newsg;
      out[3 * ws] = (uint32_t)(newsg >> 32);
      out[4 * ws] = (uint32_t)slot;
    }
  }
};

// Min-sum on a check of any degree d (the wide build), its posteriors
// reached through at(j) and its state 3 + ceil(d/32) words: mag1, mag2,
// the slot of mag2, then the sign bits of slots 32k..32k+31 in word 3 + k.
// Pass 1 forms each extrinsic input v = r - Cold and keeps the running
// two-min and the sign-bit product; pass 2 forms v again (no posterior of
// the row is written before it is read, and the old state is the
// prefetched copy, so it is the same float), then the message and the
// posterior v + Cnew, exactly as Minsum's two passes do.
template <bool FAST_MAG>
struct MinsumWide {
  static constexpr int MAX_DEG = ct::kWide;
  MinsumParams p;
  float a, bt;
  ct::Prec q;  // as Minsum's

  __device__ void begin(int t) {
    a = p.ab ? p.ab[t] : p.alpha;
    bt = p.ab ? p.ab[p.max_iters + t] : p.beta;
  }

  template <bool TRACK, class At>
  __device__ bool update_wide(At at, int d, const uint32_t* old, bool zero,
                              uint32_t* out, int ws) const {
    uint32_t old1 = 0, old2 = 0;
    int oldslot = 0;
    if (!zero) {
      old1 = old[0];
      old2 = old[ws];
      oldslot = (int)old[2 * ws];
    }
    // the message slot j sent last time; w holds its word of sign bits
    auto cold = [&](int j, uint32_t w) {
      return __uint_as_float((j == oldslot ? old2 : old1) |
                             (((w >> (j & 31)) & 1u) << 31));
    };
    float min1 = INFINITY, min2 = INFINITY;
    unsigned sg = 0;
    bool par = false;
    uint32_t w = 0;
    for (int j = 0; j < d; ++j) {
      if ((j & 31) == 0) w = zero ? 0u : old[(3 + (j >> 5)) * ws];
      const float r = *at(j);
      if constexpr (TRACK) par ^= r < 0.f;
      const float x = __fsub_rn(r, cold(j, w));
      const float ax = fabsf(x);
      min2 = fminf(min2, fmaxf(min1, ax));
      min1 = fminf(min1, ax);
      sg ^= __float_as_uint(x);
    }
    float mag1, mag2;
    if constexpr (FAST_MAG) {
      mag1 = __fmul_rn(a, fminf(min1, kMagCap));
      mag2 = __fmul_rn(a, fminf(min2, kMagCap));
    } else {
      mag1 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min1, kMagCap)), bt), 0.f);
      mag2 = fmaxf(__fsub_rn(__fmul_rn(a, fminf(min2, kMagCap)), bt), 0.f);
    }
    if constexpr (ct::kPrec) {  // as Minsum's
      const float q1 = q(mag1), q2 = q(mag2);
      out[0] = __float_as_uint(q1);
      out[ws] = __float_as_uint(q2);
      if (q.post) {
        mag1 = q1;
        mag2 = q2;
      }
    }
    bool flip = false;
    int slot = -1;
    uint32_t nw = 0;
    for (int j = 0; j < d; ++j) {
      if ((j & 31) == 0) w = zero ? 0u : old[(3 + (j >> 5)) * ws];
      float* pj = at(j);
      const float r = *pj;
      const float x = __fsub_rn(r, cold(j, w));
      const bool is_min = fabsf(x) == min1;
      if (is_min && slot < 0) slot = j;
      const uint32_t neg = (sg ^ __float_as_uint(x)) & kSign;
      nw |= (neg >> 31) << (j & 31);
      const float cn =
          __uint_as_float(__float_as_uint(is_min ? mag2 : mag1) | neg);
      const float y = __fadd_rn(x, cn);
      *pj = y;
      if constexpr (TRACK)
        flip |= ((__float_as_uint(y) ^ __float_as_uint(r)) >> 31) != 0;
      if ((j & 31) == 31 || j == d - 1) {
        out[(3 + (j >> 5)) * ws] = nw;
        nw = 0;
      }
    }
    if constexpr (!ct::kPrec) {
      out[0] = __float_as_uint(mag1);
      out[ws] = __float_as_uint(mag2);
    }
    out[2 * ws] = (uint32_t)slot;
    return par || flip;
  }
};

template <int DEG, bool FAST_MAG>
struct RuleOf {
  using type = Minsum<DEG, FAST_MAG>;
};
template <bool FAST_MAG>
struct RuleOf<ct::kWide, FAST_MAG> {
  using type = MinsumWide<FAST_MAG>;
};

#if LAYERED_PREC
using Params = ct::WithPrec<MinsumParams>;

template <int DEG, bool TRACK, bool FAST_MAG, bool XOR>
__global__ void __launch_bounds__(512, 1)
layered_qc_kernel(ct::Args a, Params w) {
  typename RuleOf<DEG, FAST_MAG>::type rule{w.p};
  rule.q = w.q;
  ct::decode_tiles<TRACK, XOR>(a, rule);
}
#else
using Params = MinsumParams;

template <int DEG, bool TRACK, bool FAST_MAG, bool XOR>
__global__ void __launch_bounds__(512, 1)
layered_qc_kernel(ct::Args a, MinsumParams p) {
  typename RuleOf<DEG, FAST_MAG>::type rule{p};
  ct::decode_tiles<TRACK, XOR>(a, rule);
}
#endif

using Kern = void (*)(ct::Args, Params);

template <int DEG, bool XOR>
Kern pick_mode(int track, int fast_mag) {
  if (track) return layered_qc_kernel<DEG, true, false, XOR>;
#if !LAYERED_PREC
  // the precision library takes the general magnitude (the same floats)
  if (fast_mag) return layered_qc_kernel<DEG, false, true, XOR>;
#endif
  return layered_qc_kernel<DEG, false, false, XOR>;
}

template <bool XOR>
Kern pick_width(int dcb_max, int track, int fast_mag) {
  if (dcb_max <= 8) return pick_mode<8, XOR>(track, fast_mag);
  if (dcb_max <= 16) return pick_mode<16, XOR>(track, fast_mag);
  if (dcb_max <= 32) return pick_mode<32, XOR>(track, fast_mag);
  if (dcb_max <= kMaxDeg) return pick_mode<64, XOR>(track, fast_mag);
  return pick_mode<ct::kWide, XOR>(track, fast_mag);
}

Kern pick(int dcb_max, int track, int fast_mag, int xor_perm) {
  return xor_perm ? pick_width<true>(dcb_max, track, fast_mag)
                  : pick_width<false>(dcb_max, track, fast_mag);
}

}  // namespace

extern "C" {

// The number of clusters of `cs` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory that can be resident at once, for the
// kernel instance the other arguments pick (0: the plan does not fit).
int layered_qc_clusters(int dcb_max, int track, int fast_mag, int xor_perm,
                        int cs, int threads, int smem, void* out) {
  if (dcb_max < 1) return (int)cudaErrorInvalidValue;
  return (int)ct::max_clusters(pick(dcb_max, track, fast_mag, xor_perm), cs,
                               threads, (size_t)smem, static_cast<int*>(out));
}

// Decodes llr [B, n] on a circulant graph (xor_perm = 0) or an
// XOR-permutation graph (xor_perm = 1, power-of-two Z) by the tile plan
// (cs, F, tiles, stride, nchip, threads, smem; decode/layered_qc.
// tile_plan) on `clusters` resident clusters; state holds clusters * cs *
// mb * stride words, spill clusters * (nb - nchip) * Z * F floats, home the
// plan's column homes, counter one int (the launch zeroes it). post may be null. The
// message precision: prec 0 (f32; the f32 library takes nothing else), 1
// (bf16) or 2 (the q: grid of `step` and +-lim levels; both the precision
// library's), post_round whether the posteriors take the rounded message
// (ct::Prec). Returns a cudaError_t (0 on a successful launch).
int layered_qc_decode(void* llr, void* bits, void* post, void* ok, void* iters,
                      void* state, void* spill, void* home, void* counter,
                      void* tab, void* ab, int Z,
                      int mb, int nb, int BE, int B, int max_iters,
                      int dcb_max, float alpha, float beta, int track,
                      int fast_mag, int xor_perm, int cs, int lg_cs, int F,
                      int tiles, int stride, int nchip, int threads,
                      int smem, int clusters, int prec, int post_round,
                      float step, float lim, void* stream) {
  if (dcb_max < 1 || B < 1 || max_iters < 1 ||
      (LAYERED_PREC ? prec < 1 || prec > 2 : prec != 0))
    return (int)cudaErrorInvalidValue;
  ct::Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.post = static_cast<float*>(post);
  a.ok = static_cast<uint8_t*>(ok);
  a.iters = static_cast<int32_t*>(iters);
  a.state = static_cast<uint32_t*>(state);
  a.spill = static_cast<float*>(spill);
  a.home = static_cast<const int32_t*>(home);
  a.counter = static_cast<int*>(counter);
  a.tab = static_cast<const int32_t*>(tab);
  a.Z = Z; a.mb = mb; a.nb = nb; a.BE = BE; a.B = B; a.max_iters = max_iters;
  a.cs = cs; a.lg_cs = lg_cs; a.F = F; a.R = cs > 0 ? Z / cs : 0;
  a.tiles = tiles; a.stride = stride; a.nchip = nchip;
  MinsumParams mp{static_cast<const float*>(ab), alpha, beta, max_iters};
#if LAYERED_PREC
  const Params p{mp, ct::Prec{prec, post_round, step, lim}};
#else
  const Params& p = mp;
#endif
  return (int)ct::launch(pick(dcb_max, track, fast_mag, xor_perm), a, p,
                         clusters, threads, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
}

const char* layered_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
