// Layered belief propagation on QC graphs whose block-rows may repeat a
// block-column (multi-edge protographs such as CCSDS AR4JA), circulant or
// XOR-permutation, for Hopper.
//
// Replaces ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel in its two
// "classic" forms: sweep_classic (:415, min-sum, K1b) and
// sweep_exact_classic (:630, spa and minstar, K1c'), with syndrome_fail, in
// fixed-iteration and in track (early-termination) mode. The caller is
// ecc_ldpc_tpu_torch/decode/layered_qc.py (layered_classic_cuda); the plain
// PyTorch version there (_sweep_plain with accumulate=True) is the
// reference this kernel must match float for float.
//
// Design (csrc/state_tile.cuh): a tile of F frames keeps its whole decoder
// state in shared memory for the whole decode, on one SM or spread over a
// thread-block cluster of CS SMs: posteriors [nb][R][F], every message
// [BE][R][F] (one per edge, as the oracle keeps them) and one layer's
// message changes D [dcb_max][R][F]. decode/layered_qc.tile_plan (form
// "classic") picks CS and F: on ccsds/4096/12 a frame an SM (160 KB of
// state and 48 KB of D), on ccsds/1024 several frames an SM, on
// ccsds/16384 a frame over a cluster of 4, and on a batch too small to fill
// the card (the retry fallback's ~16 frames) a frame over a cluster of 8.
// A persistent grid of clusters takes tiles from an atomic counter; LLRs
// come straight from llr [B, n] and bits (and posteriors) go straight to
// [B, n]. Check z of slot (col, s) reads variable qc::var_index<XOR>(z, s,
// Z) of block-column col: (z + s) % Z on a circulant graph, z ^ s on an
// XOR graph (qc_index.cuh), the kernel built once for each. The JAX
// package's xor kernel takes no such graph, but its XLA tier decodes one
// (decode/xla/layered.py with count signs, as here), and
// graph/qc.qc_graph_from_block_edges(..., perm="xor") builds one.
//
// Row widths: builds for rows of up to 8, 16, 32 and 64 slots, whose pass
// 1 holds the row in registers, and a wide build for any wider row, which
// writes the extrinsic inputs into the layer's delta rows D and runs the
// check rule there in place (csrc/bp_rules.cuh's wide rules, slot order,
// the same _rn arithmetic; minstar's prefixes in a per-thread scratch row
// in device memory). Above 32 slots a layer's barrier mask takes
// ceil(d / 32) words.
//
// The accumulate step. When a layer holds one block-column in two slots a
// and b, check z (slot a) and check z' (slot b) with z + s_a = z' + s_b
// (mod Z) update the same posterior, from two threads. The JAX oracle
// (decode/xla/layered.py:187-234) reads every slot's rolled posterior
// first, then adds each slot's Cnew - Cold in layer order (reverse order
// for minstar, whose Pallas pass 2 runs backward). So, per layer:
//   pass 1      every thread reads its checks' rolled posteriors r and old
//               messages Cold (all zeros in iteration 0), computes
//               v = r - Cold and the new messages with the check rule
//               (csrc/bp_rules.cuh, count signs: v < 0), and writes C = Cnew
//               and D = Cnew - Cold (the precision library, LAYERED_PREC 1:
//               C = Q(Cnew) and D = Q(Cnew) - Cold in every mode, by its
//               ct::Prec, bf16 or q:, and the LLRs rounded as the tile
//               loads them);
//   barrier;
//   accumulate  slot by slot in the oracle's order, every thread adds its
//               checks' D to the posteriors they read, with a barrier before
//               a slot whose column an earlier slot wrote since the last
//               barrier (slots of different columns touch different
//               posteriors; the host's table gives the barriers as a mask
//               per layer, decode/layered_qc.classic_barriers), and one at
//               the end of the layer.
// The barriers are the cluster's when CS > 1 (a check's posteriors live on
// every rank). The f32 sums are then the oracle's, in the oracle's order.
// Track mode ORs a sign-flip flag after every slot's add (a posterior one
// slot flips and another flips back still counts as flipped) and a
// layer-parity flag from the rolled posteriors; a frozen frame's threads
// skip both passes, so its state stays exactly as it was (the Pallas sweep
// writes old + (Cold - Cold), which turns a -0.0 posterior into +0.0; the
// oracle keeps it). The stop rule is K1a's and K1c's: per-frame freeze when
// the layer parity passed and no sign flipped, per-tile early exit, and a
// final true syndrome for ok.
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
// 5.42 ms for minstar (bench/throughput.decode_bound); the bytes bound (the
// LLRs in, the bits out) is far below. The earlier design kept the state
// in HBM, 28 B per edge visit (88 GB for that batch), and memory traffic
// bounded it. Here HBM moves only the LLRs and bits; what bounds it is
// instruction issue and shared-memory latency: a frame an SM is 2048
// checks a layer on 32 warps, each layer a chain of pass 1, a few slot
// barriers and the adds (PERF.md has the timings).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_rules.cuh"
#include "state_tile.cuh"

namespace {

struct ClassicParams {
  const float* ab;  // [2, max_iters] alpha_t then beta_t, or null
  float alpha, beta;
  int dmax;         // the graph's largest row degree (D's rows)
  float* scratch;   // the wide minstar build's prefixes, or null
};

#if LAYERED_PREC
using Params = ct::WithPrec<ClassicParams>;
#else
using Params = ClassicParams;
#endif

template <int MAX_DEG, int RULE, bool TRACK, bool XOR>
__global__ void __launch_bounds__(st::max_threads(MAX_DEG), 1)
#if LAYERED_PREC
layered_classic_kernel(st::Args a, Params w) {
  const ClassicParams p = w.p;
  const ct::Prec q = w.q;
#else
layered_classic_kernel(st::Args a, ClassicParams p) {
  const ct::Prec q{};  // the f32 library rounds nothing
#endif
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ st::Shared sh;
  const int F = a.F, RF = a.R * F, cs = a.cs, mb = a.mb, nb = a.nb;
  const int BE = a.BE;
  // table: layer_ptr [mb+1], column [BE], shift [BE], barrier masks
  // [mb][W] (W words a layer: 1 to 32 slots, ceil(dmax / 32) above)
  constexpr bool kWideMask = MAX_DEG == ct::kWide || MAX_DEG > 32;
  const int W = kWideMask ? (p.dmax + 31) >> 5 : 1;
  const int32_t* tcol = a.tab + mb + 1;
  const int32_t* tshift = tcol + BE;
  float* post = reinterpret_cast<float*>(smem);  // [nb][R][F]
  float* C = post + nb * RF;                      // [BE][R][F]
  float* D = C + BE * RF;                         // [dmax][R][F]
  const int words = (nb + BE + p.dmax) * RF;
  float** sbase = reinterpret_cast<float**>(post + ((words + 3) & ~3));
  int* soff = reinterpret_cast<int*>(sbase + BE);  // [BE]
  int* lptr = soff + BE;                           // [mb + 1]
  int* bars = lptr + mb + 1;                       // [mb][W]

  st::Frame fr = st::begin(sh, post, cs, F);
  const int tid = threadIdx.x, nth = blockDim.x, rank = fr.rank;
  for (int i = tid; i <= mb; i += nth) lptr[i] = a.tab[i];
  for (int i = tid; i < mb * W; i += nth)
    bars[i] = a.tab[mb + 1 + 2 * BE + i];
  __syncthreads();
  st::edges<XOR>(a, sh, rank, tcol, tshift, BE, 0, false, sbase, soff);
  ct::sync_tile(cs);

  for (;;) {
    const int tile = fr.next_tile(a.counter);
    if (tile >= a.tiles) break;
    const int b0 = tile * F;
    const int nf = min(F, a.B - b0);  // live frames (the last tile is ragged)
    if constexpr (ct::kPrec) {
      st::move_in_rounded(a, sh, rank, b0, nf, q);
    } else {
      st::move<true>(a, sh, rank, b0, nf, 0);
    }
    ct::sync_tile(cs);
    if constexpr (TRACK) {
      // done_0: frames whose channel hard decisions already satisfy H
      st::syndrome<XOR, MAX_DEG>(a, sh, lptr, sbase, soff, nf);
      fr.reduce();
      for (int f = tid; f < F; f += nth) {
        sh.done[f] = f < nf ? !sh.flag[f] : 1;
        sh.used[f] = 0;
      }
      __syncthreads();
    }
    for (int t = 0; t < a.max_iters; ++t) {
      // the tile stops once every frame in it is done; a frozen frame
      // writes nothing, so per-frame results do not depend on the tile
      if (TRACK && fr.all_done()) break;
      const float alpha = p.ab ? p.ab[t] : p.alpha;
      const float beta = p.ab ? p.ab[a.max_iters + t] : p.beta;
      for (int L = 0; L < mb; ++L) {
        const int s0 = lptr[L], d = lptr[L + 1] - s0;
        // pass 1: new messages of every check of the layer, from
        // posteriors no thread has written yet in this layer
        for (st::Walk w(tid, nth, a.R, F); w.a == 0; w.next()) {
          const int f = w.f, zf = w.zf();
          if (f >= nf || (TRACK && sh.done[f])) continue;
          bool par = false;
          if constexpr (MAX_DEG == ct::kWide) {
            // v = r - Cold into D's rows, the rule there in place, then
            // C = Cnew (Q(Cnew)) and D = C - Cold slot by slot
            const bp::Row v{D + zf, (size_t)RF};
            for (int j = 0; j < d; ++j) {
              const float r = *st::at<XOR>(sbase[s0 + j], soff[s0 + j],
                                           w.zl, zf, RF, F);
              v[j] = __fsub_rn(r, t == 0 ? 0.f : C[(s0 + j) * RF + zf]);
              if constexpr (TRACK) par ^= (r < 0.f);
            }
            if constexpr (RULE == bp::kMinsum) {
              bp::minsum_wide(v, d, alpha, beta);
            } else if constexpr (RULE == bp::kSpa) {
              bp::spa_wide<true>(v, d);
            } else {
              const size_t T = (size_t)gridDim.x * nth;
              bp::minstar_wide(
                  v, bp::Row{p.scratch + (size_t)blockIdx.x * nth + tid, T},
                  d);
            }
            for (int j = 0; j < d; ++j) {
              float c = v[j];
              if constexpr (ct::kPrec) c = q(c);  // Q(Cnew)
              const float cold = t == 0 ? 0.f : C[(s0 + j) * RF + zf];
              C[(s0 + j) * RF + zf] = c;
              v[j] = __fsub_rn(c, cold);
            }
          } else {
            float v[MAX_DEG];     // extrinsic inputs r - Cold, then Cnew
            float cold[MAX_DEG];  // old messages
#pragma unroll
            for (int j = 0; j < MAX_DEG; ++j) {
              if (j < d) {
                const float r = *st::at<XOR>(sbase[s0 + j], soff[s0 + j],
                                             w.zl, zf, RF, F);
                cold[j] = t == 0 ? 0.f : C[(s0 + j) * RF + zf];
                v[j] = __fsub_rn(r, cold[j]);
                if constexpr (TRACK) par ^= (r < 0.f);
              }
            }
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
                if constexpr (ct::kPrec) v[j] = q(v[j]);  // Q(Cnew)
                C[(s0 + j) * RF + zf] = v[j];
                D[j * RF + zf] = __fsub_rn(v[j], cold[j]);
              }
            }
          }
          if (TRACK && par) sh.part[f] = 1;
        }
        ct::sync_tile(cs);
        // accumulate: slot by slot in the oracle's order; each thread adds
        // the deltas of its own checks (written by itself in pass 1)
        const unsigned bar = static_cast<unsigned>(bars[L * W]);
        for (int q = 0; q < d; ++q) {
          const int j = RULE == bp::kMinstar ? d - 1 - q : q;
          bool wait;
          if constexpr (kWideMask) {
            wait = (static_cast<unsigned>(bars[L * W + (q >> 5)]) >>
                    (q & 31)) & 1u;
          } else {
            wait = (bar >> q) & 1u;
          }
          if (wait) ct::sync_tile(cs);
          float* const base = sbase[s0 + j];
          const int off = soff[s0 + j];
          const float* dj = D + j * RF;
          for (st::Walk w(tid, nth, a.R, F); w.a == 0; w.next()) {
            const int f = w.f, zf = w.zf();
            if (f >= nf || (TRACK && sh.done[f])) continue;
            float* x = st::at<XOR>(base, off, w.zl, zf, RF, F);
            const float old = *x;
            const float nw = __fadd_rn(old, dj[zf]);
            *x = nw;
            if (TRACK && ((__float_as_uint(nw) ^ __float_as_uint(old)) >> 31))
              sh.part[f] = 1;
          }
        }
        ct::sync_tile(cs);
      }
      if constexpr (TRACK) {
        // a failed parity or a sign flip keeps the frame running
        fr.reduce();
        for (int f = tid; f < F; f += nth) {
          if (!sh.done[f]) {
            ++sh.used[f];
            if (!sh.flag[f]) sh.done[f] = 1;
          }
        }
        __syncthreads();
      }
    }
    // truthful ok: one final syndrome over the emitted hard decisions
    st::syndrome<XOR, MAX_DEG>(a, sh, lptr, sbase, soff, nf);
    fr.reduce();
    st::results(a, sh, rank, b0, nf, TRACK);
    st::move<false>(a, sh, rank, b0, nf, 0);
  }
  // no block leaves while a peer may still read its shared memory
  ct::sync_tile(cs);
}

using Kern = void (*)(st::Args, Params);

template <int MAX_DEG, int RULE, bool XOR>
Kern pick_mode(int track) {
  if (track) return layered_classic_kernel<MAX_DEG, RULE, true, XOR>;
  return layered_classic_kernel<MAX_DEG, RULE, false, XOR>;
}

template <int MAX_DEG, bool XOR>
Kern pick_rule(int rule, int track) {
  if (rule == bp::kSpa) return pick_mode<MAX_DEG, bp::kSpa, XOR>(track);
  if (rule == bp::kMinstar)
    return pick_mode<MAX_DEG, bp::kMinstar, XOR>(track);
  return pick_mode<MAX_DEG, bp::kMinsum, XOR>(track);
}

template <bool XOR>
Kern pick_width(int dcb_max, int rule, int track) {
  if (dcb_max <= 8) return pick_rule<8, XOR>(rule, track);
  if (dcb_max <= 16) return pick_rule<16, XOR>(rule, track);
  if (dcb_max <= 32) return pick_rule<32, XOR>(rule, track);
  if (dcb_max <= 64) return pick_rule<64, XOR>(rule, track);
  return pick_rule<ct::kWide, XOR>(rule, track);
}

// null where the library holds no instance of the permutation
// (LAYERED_PERM, csrc/cluster_tile.cuh: the precision library builds in a
// circulant and a xor half, which build in parallel)
Kern pick(int dcb_max, int rule, int track, int xor_perm) {
#if LAYERED_PERM != 1
  if (xor_perm) return pick_width<true>(dcb_max, rule, track);
#endif
#if LAYERED_PERM != 2
  if (!xor_perm) return pick_width<false>(dcb_max, rule, track);
#endif
  return nullptr;
}

// the widest register build (decode/layered_qc.MAX_DEG); wider rows take
// the wide build
constexpr int kMaxDeg = 64;

bool bad(int dcb_max, int rule, int xor_perm) {
  return dcb_max < 1 || rule < 0 || rule > 2 ||
         (LAYERED_PERM == 1 && xor_perm) || (LAYERED_PERM == 2 && !xor_perm);
}

}  // namespace

extern "C" {

// The number of clusters of `cs` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory that can be resident at once, for the
// kernel instance the other arguments pick (0: the plan does not fit).
int layered_classic_clusters(int dcb_max, int rule, int track, int xor_perm,
                             int cs, int threads, int smem, void* out) {
  if (bad(dcb_max, rule, xor_perm)) return (int)cudaErrorInvalidValue;
  return (int)ct::max_clusters(pick(dcb_max, rule, track, xor_perm), cs,
                               threads, (size_t)smem,
                               static_cast<int*>(out));
}

// Decodes llr [B, n] with rule 0 (min-sum, alpha and beta or the
// per-iteration ab table), 1 (spa) or 2 (minstar) on a circulant
// (xor_perm = 0) or an XOR-permutation graph (xor_perm = 1) by the plan
// (cs, F, tiles, threads, smem; decode/layered_qc.tile_plan, form
// "classic") on `clusters` resident clusters; tab is layer_ptr [mb+1],
// column [BE], shift [BE] and the accumulate's barrier masks [mb][W] (W =
// 1 to 32 slots, ceil(dcb_max / 32) above); counter one int (the launch
// zeroes it). post may be null; scratch, for minstar on rows wider than
// 64, holds dcb_max floats for each thread of the grid (else null). The
// message precision: prec 0
// (f32; the f32 library takes nothing else), 1 (bf16) or 2 (the q: grid of
// `step` and +-lim levels; both the precision library's); the accumulate
// form adds Q(Cnew) - Cold in every mode. Returns a cudaError_t (0 on a
// successful launch).
int layered_classic_decode(void* llr, void* bits, void* post, void* ok,
                           void* iters, void* counter, void* tab, void* ab,
                           void* scratch, int Z, int mb, int nb, int BE,
                           int B, int max_iters, int dcb_max, float alpha,
                           float beta, int rule, int track, int xor_perm,
                           int cs, int lg_cs, int F, int tiles, int threads,
                           int smem, int clusters, int prec, float step,
                           float lim, void* stream) {
  if (bad(dcb_max, rule, xor_perm) ||
      (LAYERED_PREC ? prec < 1 || prec > 2 : prec != 0) ||
      (rule == bp::kMinstar && dcb_max > kMaxDeg && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  st::Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.post = static_cast<float*>(post);
  a.ok = static_cast<uint8_t*>(ok);
  a.iters = static_cast<int32_t*>(iters);
  a.counter = static_cast<int*>(counter);
  a.tab = static_cast<const int32_t*>(tab);
  a.Z = Z; a.mb = mb; a.nb = nb; a.BE = BE; a.B = B; a.max_iters = max_iters;
  a.cs = cs; a.lg_cs = lg_cs; a.F = F; a.R = cs > 0 ? Z / cs : 0;
  a.tiles = tiles;
  ClassicParams cp{static_cast<const float*>(ab), alpha, beta, dcb_max,
                   static_cast<float*>(scratch)};
#if LAYERED_PREC
  const Params p{cp, ct::Prec{prec, 1, step, lim}};
#else
  const Params& p = cp;
#endif
  return (int)st::launch(pick(dcb_max, rule, track, xor_perm), a, p,
                         clusters, threads, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
}

const char* layered_classic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
