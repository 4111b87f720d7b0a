// Layered exact belief propagation (spa, minstar) on QC graphs, for Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel in its
// dup-free exact-BP form (sweep_exact, :501, with _boxplus, :491, and
// syndrome_fail), in fixed-iteration and in track (early-termination)
// mode. The caller is ecc_ldpc_tpu_torch/decode/layered_qc.py
// (layered_exact_cuda); the plain PyTorch twin there (_cn_spa,
// _cn_minstar) is the reference this kernel must match.
//
// Design: csrc/cluster_tile.cuh, shared with csrc/layered_qc.cu (K1a): a
// tile of F frames keeps its f32 posteriors in the shared memory of a
// thread-block cluster for the whole decode (decode/layered_qc.tile_plan
// picks the cluster size CS and F), checks reach them through distributed
// shared memory with one cluster barrier per layer, a persistent grid of
// clusters takes tiles from an atomic counter, and LLRs, bits and
// posteriors move straight between llr [B, n] and the tile. Check z of
// slot (col, s) reads variable qc::var_index<XOR>(z, s, Z) of block-column
// col: (z + s) % Z on a circulant graph, z ^ s on an XOR graph (IEEE
// 802.3an, where the JAX package serves these rules on its XLA tier).
// Exact BP sends a different magnitude on every edge, so unlike K1a the
// check state is every message: f32, one word per edge, in HBM, prefetched
// a layer ahead with cp.async (d words per check).
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
// dvbs2/64800/12 (bench/throughput.decode_bound). The earlier design moved
// 16 B per edge visit through HBM (posterior and message, each read and
// written), ~372 GB for that batch. Here the posteriors stay on chip (a
// frame an SM, its lowest-traffic columns in L2) and the messages move
// 8 B per edge visit (~186 GB, ~56 ms at 3.35 TB/s). Measured (PERF.md)
// the time stays near the earlier design's for spa and falls ~27% for
// minstar: each accurate transcendental is a sequence of tens of
// instructions, five or more per edge visit, and 12 warps an SM issue
// them with long dependent chains, so instruction issue and latency bound
// it, not bytes. On the production fallback's ~13 frames the plan spreads
// one frame over a cluster of 8 blocks, so ~100 SMs work where the
// earlier design had 2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_rules.cuh"
#include "cluster_tile.cuh"
#include "qc_index.cuh"  // the XOR template parameter's permutation

namespace {

using bp::boxplus;
using bp::kIdentity;
using bp::kMagCap;
using bp::kTanhClip;
using bp::log_tanh_half;

constexpr unsigned kSign = 0x80000000u;
enum Rule { kSpa = 0, kMinstar = 1 };

struct NoParams {};

// Exact BP on one check; its state is its d f32 messages.
template <int DEG, int RULE>
struct Exact {
  static constexpr int MAX_DEG = DEG;

  __device__ void begin(int) {}

  __device__ void update(float (&r)[DEG], int d, const uint32_t* old,
                         bool zero, uint32_t* out, int ws) const {
    float w[DEG];     // spa: log|tanh(v/2)|; minstar: forward prefixes
    float acc = 0.f;  // spa: running log|tanh| sum
    unsigned sg = 0;  // spa: XOR of the extrinsic sign bits
    // pass 1: v = r - Cold in place
#pragma unroll
    for (int j = 0; j < DEG; ++j) {
      if (j < d) {
        const float cold = zero ? 0.f : __uint_as_float(old[j * ws]);
        const float x = __fsub_rn(r[j], cold);
        r[j] = x;
        if constexpr (RULE == kSpa) {
          const float lt = log_tanh_half(x);
          w[j] = lt;
          acc = j == 0 ? lt : __fadd_rn(acc, lt);
          sg ^= __float_as_uint(x);
        } else {
          // fwd[j] for j <= d-3 (fwd[d-2] is read as slot d-1's message;
          // fwd[d-1] is never read)
          if (j == 0) {
            w[0] = x;
          } else if (j < d - 1) {
            w[j] = boxplus(w[j - 1], x);
          }
        }
      }
    }
    // pass 2: messages out, posteriors as v + Cnew (spa forward, minstar
    // backward with its running suffix)
    float bwd = 0.f;
#pragma unroll
    for (int jj = 0; jj < DEG; ++jj) {
      const int j = RULE == kSpa ? jj : DEG - 1 - jj;
      if (j < d) {
        float cn;
        if constexpr (RULE == kSpa) {
          const float tt = fminf(expf(__fsub_rn(acc, w[j])), kTanhClip);
          const float mag = __fsub_rn(log1pf(tt), log1pf(-tt));
          const unsigned neg = (sg ^ __float_as_uint(r[j])) & kSign;
          cn = __uint_as_float(__float_as_uint(mag) | neg);
        } else {
          float o;
          if (d == 1) {
            o = kIdentity;
          } else if (j == d - 1) {
            o = j >= 1 ? w[j - 1] : 0.f;  // fwd[d-2]
          } else if (j == 0) {
            o = bwd;
          } else {
            o = boxplus(j >= 1 ? w[j - 1] : 0.f, bwd);
          }
          cn = fminf(fmaxf(o, -kMagCap), kMagCap);
          if (j == d - 1) {
            bwd = r[j];
          } else if (j > 0) {
            bwd = boxplus(bwd, r[j]);
          }
        }
        out[j * ws] = __float_as_uint(cn);
        r[j] = __fadd_rn(r[j], cn);
      }
    }
  }
};

template <int DEG, int RULE, bool TRACK, bool XOR>
__global__ void __launch_bounds__(512, 1)
layered_exact_kernel(ct::Args a, NoParams) {
  Exact<DEG, RULE> rule;
  ct::decode_tiles<TRACK, XOR>(a, rule);
}

using Kern = void (*)(ct::Args, NoParams);

template <int DEG, bool XOR>
Kern pick_rule(int minstar, int track) {
  if (minstar)
    return track ? layered_exact_kernel<DEG, kMinstar, true, XOR>
                 : layered_exact_kernel<DEG, kMinstar, false, XOR>;
  return track ? layered_exact_kernel<DEG, kSpa, true, XOR>
               : layered_exact_kernel<DEG, kSpa, false, XOR>;
}

template <bool XOR>
Kern pick_width(int dcb_max, int minstar, int track) {
  if (dcb_max <= 8) return pick_rule<8, XOR>(minstar, track);
  if (dcb_max <= 16) return pick_rule<16, XOR>(minstar, track);
  return pick_rule<32, XOR>(minstar, track);
}

Kern pick(int dcb_max, int minstar, int track, int xor_perm) {
  return xor_perm ? pick_width<true>(dcb_max, minstar, track)
                  : pick_width<false>(dcb_max, minstar, track);
}

}  // namespace

extern "C" {

// The number of clusters of `cs` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory that can be resident at once, for the
// kernel instance the other arguments pick (0: the plan does not fit).
int layered_exact_clusters(int dcb_max, int minstar, int track, int xor_perm,
                           int cs, int threads, int smem, void* out) {
  if (dcb_max > 32 || dcb_max < 1) return (int)cudaErrorInvalidValue;
  return (int)ct::max_clusters(pick(dcb_max, minstar, track, xor_perm), cs,
                               threads, (size_t)smem, static_cast<int*>(out));
}

// Decodes llr [B, n] with the spa (minstar = 0) or minstar (minstar = 1)
// rule on a circulant (xor_perm = 0) or an XOR-permutation graph
// (xor_perm = 1) by the tile plan (cs, F, tiles, stride, threads, smem;
// decode/layered_qc.tile_plan) on `clusters` resident clusters; state holds
// clusters * cs * mb * stride words, spill clusters * (nb - nchip) * Z * F
// floats, home the plan's column homes, counter one int (the launch zeroes it). post may
// be null. Returns a cudaError_t (0 on a successful launch).
int layered_exact_decode(void* llr, void* bits, void* post, void* ok,
                         void* iters, void* state, void* spill, void* home,
                         void* counter, void* tab,
                         int Z, int mb, int nb, int BE, int B, int max_iters,
                         int dcb_max, int minstar, int track, int xor_perm,
                         int cs, int lg_cs, int F, int tiles, int stride,
                         int nchip, int threads, int smem, int clusters,
                         void* stream) {
  if (dcb_max > 32 || dcb_max < 1 || B < 1 || max_iters < 1)
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
  return (int)ct::launch(pick(dcb_max, minstar, track, xor_perm), a,
                         NoParams{}, clusters, threads, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
}

const char* layered_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
