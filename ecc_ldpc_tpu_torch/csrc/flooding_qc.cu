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
// Row widths: builds for rows of up to 8, 16, 32 and 64 slots, whose
// check rule holds the row in registers, and a wide build for any wider
// row, whose rule works on the row in place in the check's message slots
// (csrc/bp_rules.cuh, the wide rules).
//
// Design (csrc/state_tile.cuh): a tile of F frames keeps its whole decoder
// state in shared memory for the whole decode, on one SM or spread over a
// thread-block cluster of CS SMs: posteriors [nb][R][F], every message
// [BE][R][F] and, where they fit, the LLRs [nb][R][F] (else the variable
// phase reads them from llr [B, n], in L2). decode/layered_qc.tile_plan
// (form "flooding") picks CS and F: a dvbs2/64800 frame over a cluster of
// 8 (~174 KB a block at rate 1/2), dvbs2/16200 over 2, and several 802.3an
// or CCSDS frames an SM. A persistent grid of clusters takes tiles from an
// atomic counter; LLRs come straight from [B, n] and bits (and posteriors)
// go straight to [B, n]. Rank r owns rows z = r (mod CS) of every
// block-row and block-column. Per iteration:
//   CN phase  each (check, frame) of the rank reads its d stale posteriors
//             r (other ranks' through distributed shared memory), forms
//             v = r - C_old (all zeros in iteration 0) and C = rule(v)
//             (csrc/bp_rules.cuh) in its own shared memory; in track mode
//             the parity of r < 0 is the stale-posterior `fail`.
//   barrier   (the cluster's; in track mode the one of the reduction that
//             makes `fail` the cluster's)
//   VN phase  each (variable, frame) of the rank rebuilds its posterior as
//             llr + C_1 + C_2 + ... in exactly the oracle's order: block-
//             rows in layer_order, edges in edge-id order within a row
//             (other ranks' messages through distributed shared memory). No
//             atomics, which would change the order of the sums.
//   barrier
// One posterior copy suffices: the VN phase reads only LLRs and messages,
// starts after every check has read the stale posteriors, and the next CN
// phase after every posterior is written. Freeze (track mode,
// decode/xla/flooding_qc.py:159-172): a frame whose pre-sweep state passed
// keeps that state (its VN phase is skipped); C is frozen on the old
// `done`; `iters` counts the sweeps applied to the state reported; `ok` is
// the syndrome of the reported state.
//
// Precision (the TPU kernels' roundings under `/pallas`): built with
// LAYERED_PREC 1 (ecc_ldpc_tpu_torch/_build.py, the library
// flooding_qc_prec) the kernels take `prec`: 1 is K3's bf16 storage
// (ecc_ldpc_tpu/decode/pallas/flooding_qc.py with every state dtype bf16:
// the LLRs rounded as they load, every message rounded as it is stored,
// and each posterior sum rounded after every add, acc = bf16(acc + C),
// :201-206), 3 is K4's flooding mode (layered_xor.py:195-254, each
// permutation one bf16 matmul pass: the stale posterior a check reads and
// each message a variable adds rounded, the sums and messages f32). Both
// read a posterior through the permutation rounded, in the parity and the
// syndrome too (bf16 of a bf16 value is itself). Circulant graphs take
// every rule, xor graphs min-sum only, as the TPU's XOR kernel did. The
// f32 library's kernels are the code below with no rounding.
//
// What bounds it on an H100: the bytes bound is the LLRs in and the bits
// out (0.33 GB at dvbs2/64800/12, B = 4096); the operations bound, about
// 12 fp32 operations per edge visit for minsum and 4 (spa) or ~8.6
// (minstar) accurate transcendentals at the special-function rate, is the
// larger (bench/throughput.decode_bound). The earlier design moved 16 B
// per edge visit through HBM (425 GB for that batch) and memory traffic
// bounded it. Here what bounds it is instruction issue and the latency of
// distributed shared-memory loads (7 of 8 of a frame's are remote on a
// cluster of 8), behind two cluster barriers an iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_rules.cuh"
#include "qc_index.cuh"  // the XOR template parameter's permutation
#include "state_tile.cuh"

namespace {

struct FloodParams {
  float alpha, beta;
  int llr_chip;    // the LLRs have a region of shared memory
  float* scratch;  // the wide minstar build's prefixes, or null
#if LAYERED_PREC
  int prec;        // 1 bf16 storage, 3 bf16 permutations
#endif
};

template <int MAX_DEG, int RULE, bool TRACK, bool XOR>
__global__ void __launch_bounds__(st::max_threads(MAX_DEG), 1)
flooding_qc_kernel(st::Args a, FloodParams p) {
  constexpr bool kPrec = ct::kPrec;
#if LAYERED_PREC
  const bool store = p.prec == 1;  // bf16 storage (K3), else permutations
#else
  constexpr bool store = false;
#endif
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ st::Shared sh;
  const int F = a.F, RF = a.R * F, cs = a.cs, mb = a.mb, nb = a.nb;
  const int BE = a.BE, Z = a.Z, n = nb * Z;
  // table: rptr [mb+1], column [BE], shift [BE] (sweep order), then per
  // block-column cptr [nb+1], slot [BE], shift [BE] (the same order)
  const int32_t* tcol = a.tab + mb + 1;
  const int32_t* tshift = tcol + BE;
  const int32_t* tcptr = tshift + BE;
  const int32_t* tslot = tcptr + nb + 1;
  const int32_t* tcshift = tslot + BE;
  float* post = reinterpret_cast<float*>(smem);  // [nb][R][F]
  float* C = post + nb * RF;                      // [BE][R][F]
  float* llrs = C + BE * RF;                      // [nb][R][F] if llr_chip
  const int words = (nb + BE + (p.llr_chip ? nb : 0)) * RF;
  float** cbase = reinterpret_cast<float**>(post + ((words + 3) & ~3));
  float** vbase = cbase + BE;                       // [BE]
  int* coff = reinterpret_cast<int*>(vbase + BE);   // [BE]
  int* voff = coff + BE;                            // [BE]
  int* rptr = voff + BE;                            // [mb + 1]
  int* cptr = rptr + mb + 1;                        // [nb + 1]

  st::Frame fr = st::begin(sh, post, cs, F);
  const int tid = threadIdx.x, nth = blockDim.x, rank = fr.rank;
  for (int i = tid; i <= mb; i += nth) rptr[i] = a.tab[i];
  for (int i = tid; i <= nb; i += nth) cptr[i] = tcptr[i];
  __syncthreads();
  // a check's posteriors; a variable's messages (the checks that read it)
  st::edges<XOR>(a, sh, rank, tcol, tshift, BE, 0, false, cbase, coff);
  st::edges<XOR>(a, sh, rank, tslot, tcshift, BE, nb * RF, true, vbase,
                 voff);
  ct::sync_tile(cs);

  for (;;) {
    const int tile = fr.next_tile(a.counter);
    if (tile >= a.tiles) break;
    const int b0 = tile * F;
    const int nf = min(F, a.B - b0);  // live frames (the last tile is ragged)
    if constexpr (kPrec) {
      if (store) {
        st::move<true, true>(a, sh, rank, b0, nf,
                             p.llr_chip ? (nb + BE) * RF : 0);
      } else {
        st::move<true>(a, sh, rank, b0, nf, p.llr_chip ? (nb + BE) * RF : 0);
      }
    } else {
      st::move<true>(a, sh, rank, b0, nf, p.llr_chip ? (nb + BE) * RF : 0);
    }
    ct::sync_tile(cs);
    if constexpr (TRACK) {
      st::syndrome<XOR, MAX_DEG, kPrec>(a, sh, rptr, cbase, coff, nf);
      fr.reduce();
      for (int f = tid; f < F; f += nth) {
        sh.done[f] = f < nf ? !sh.flag[f] : 1;
        sh.used[f] = 0;
      }
      __syncthreads();
    }
    for (int t = 0; t < a.max_iters; ++t) {
      if (TRACK && fr.all_done()) break;
      // CN phase
      for (st::Walk w(tid, nth, a.R, F); w.a < mb; w.next()) {
        const int f = w.f, zf = w.zf();
        if (f >= nf || (TRACK && sh.done[f])) continue;
        const int s0 = rptr[w.a], d = rptr[w.a + 1] - s0;
        if constexpr (MAX_DEG == ct::kWide) {
          // the row in place in the check's message slots: v = r - C_old,
          // then C = rule(v) (csrc/bp_rules.cuh, the wide rules)
          float* Cr = C + s0 * RF + zf;
          bool par = false;
          for (int j = 0; j < d; ++j) {
            float r = *st::at<XOR>(cbase[s0 + j], coff[s0 + j], w.zl, zf,
                                   RF, F);
            if constexpr (kPrec) r = st::bf16(r);
            if constexpr (TRACK) par ^= (r < 0.f);
            Cr[j * RF] = __fsub_rn(r, t == 0 ? 0.f : Cr[j * RF]);
          }
          const size_t T = (size_t)gridDim.x * nth;
          bp::check_rule_wide<RULE>(
              bp::Row{Cr, (size_t)RF},
              bp::Row{p.scratch + (size_t)blockIdx.x * nth + tid, T}, d,
              p.alpha, p.beta);
          if (kPrec && store)
            for (int j = 0; j < d; ++j) Cr[j * RF] = st::bf16(Cr[j * RF]);
          if (TRACK && par) sh.part[f] = 1;
        } else {
          float v[MAX_DEG];
          bool par = false;
#pragma unroll
          for (int j = 0; j < MAX_DEG; ++j) {
            if (j < d) {
              float r = *st::at<XOR>(cbase[s0 + j], coff[s0 + j], w.zl, zf,
                                     RF, F);
              if constexpr (kPrec) r = st::bf16(r);
              if constexpr (TRACK) par ^= (r < 0.f);
              v[j] = __fsub_rn(r, t == 0 ? 0.f : C[(s0 + j) * RF + zf]);
            }
          }
          bp::check_rule<MAX_DEG, RULE>(v, d, p.alpha, p.beta);
#pragma unroll
          for (int j = 0; j < MAX_DEG; ++j) {
            if (j < d) {
              if (kPrec && store) v[j] = st::bf16(v[j]);
              C[(s0 + j) * RF + zf] = v[j];
            }
          }
          if (TRACK && par) sh.part[f] = 1;
        }
      }
      // the frame advances unless its pre-sweep state passed (or it is
      // done): flag[f] is the cluster's `fail`
      if constexpr (TRACK) {
        fr.reduce();
      } else {
        ct::sync_tile(cs);
      }
      // VN phase
      for (st::Walk w(tid, nth, a.R, F); w.a < nb; w.next()) {
        const int f = w.f, zf = w.zf(), col = w.a;
        if (f >= nf || (TRACK && (sh.done[f] || !sh.flag[f]))) continue;
        float acc = p.llr_chip
                        ? llrs[col * RF + zf]
                        : a.llr[(size_t)(b0 + f) * n + col * Z +
                                w.zl * cs + rank];
        if (kPrec && store) acc = st::bf16(acc);  // (on chip: already)
        // (loading a variable's messages 8 at a time before the adds
        // measured slower on the DVB-S2 legs)
        const int k1 = cptr[col + 1];
        for (int k = cptr[col]; k < k1; ++k) {
          if constexpr (kPrec) {
            acc = __fadd_rn(acc, st::bf16(*st::at<XOR>(vbase[k], voff[k],
                                                       w.zl, zf, RF, F)));
            if (store) acc = st::bf16(acc);
          } else {
            acc = __fadd_rn(acc, *st::at<XOR>(vbase[k], voff[k], w.zl, zf,
                                              RF, F));
          }
        }
        post[col * RF + zf] = acc;
      }
      if constexpr (TRACK) {
        __syncthreads();
        for (int f = tid; f < F; f += nth) {
          if (!sh.done[f]) {
            if (sh.flag[f]) {
              ++sh.used[f];
            } else {
              sh.done[f] = 1;
            }
          }
        }
      }
      ct::sync_tile(cs);
    }
    // truthful ok: one final syndrome over the reported state
    st::syndrome<XOR, MAX_DEG, kPrec>(a, sh, rptr, cbase, coff, nf);
    fr.reduce();
    st::results(a, sh, rank, b0, nf, TRACK);
    st::move<false>(a, sh, rank, b0, nf, 0);
  }
  // no block leaves while a peer may still read its shared memory
  ct::sync_tile(cs);
}

using Kern = void (*)(st::Args, FloodParams);

template <int MAX_DEG, int RULE, bool XOR>
Kern pick_mode(int track) {
  if (track) return flooding_qc_kernel<MAX_DEG, RULE, true, XOR>;
  return flooding_qc_kernel<MAX_DEG, RULE, false, XOR>;
}

template <int MAX_DEG, bool XOR>
Kern pick_rule(int rule, int track) {
  // the precision library's xor instances are min-sum's alone (bad())
  if constexpr (!(ct::kPrec && XOR)) {
    if (rule == bp::kSpa) return pick_mode<MAX_DEG, bp::kSpa, XOR>(track);
    if (rule == bp::kMinstar)
      return pick_mode<MAX_DEG, bp::kMinstar, XOR>(track);
  }
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

Kern pick(int dcb_max, int rule, int track, int xor_perm) {
  return xor_perm ? pick_width<true>(dcb_max, rule, track)
                  : pick_width<false>(dcb_max, rule, track);
}

// the widest register build (decode/flooding_qc.MAX_DEG); wider rows take
// the wide build
constexpr int kMaxDeg = 64;

bool bad(int dcb_max, int rule, int xor_perm) {
  return dcb_max < 1 || rule < 0 || rule > 2 ||
         (ct::kPrec && xor_perm && rule != bp::kMinsum);
}

}  // namespace

extern "C" {

// The number of clusters of `cs` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory that can be resident at once, for the
// kernel instance the other arguments pick (0: the plan does not fit).
int flooding_qc_clusters(int dcb_max, int rule, int track, int xor_perm,
                         int cs, int threads, int smem, void* out) {
  if (bad(dcb_max, rule, xor_perm)) return (int)cudaErrorInvalidValue;
  return (int)ct::max_clusters(pick(dcb_max, rule, track, xor_perm), cs,
                               threads, (size_t)smem, static_cast<int*>(out));
}

// Decodes llr [B, n] with rule 0 (minsum), 1 (spa) or 2 (minstar) on a
// circulant (xor_perm = 0) or an XOR-permutation graph (xor_perm = 1) by
// the plan (cs, F, tiles, llr_chip, threads, smem; decode/layered_qc.
// tile_plan, form "flooding") on `clusters` resident clusters; counter one
// int (the launch zeroes it). post may be null; scratch, for minstar on rows
// wider than 64, holds dcb_max floats for each thread of the grid (else
// null). prec: 0 f32 (the f32 library takes nothing else), 1 bf16 storage
// or 3 bf16 permutations (the precision library's). Returns a cudaError_t
// (0 on a successful launch).
int flooding_qc_decode(void* llr, void* bits, void* post, void* ok,
                       void* iters, void* counter, void* tab, void* scratch,
                       int Z, int mb,
                       int nb, int BE, int B, int max_iters, int dcb_max,
                       int rule, float alpha, float beta, int track,
                       int xor_perm, int cs, int lg_cs, int F, int tiles,
                       int llr_chip, int threads, int smem, int clusters,
                       int prec, void* stream) {
  if (bad(dcb_max, rule, xor_perm) ||
      (LAYERED_PREC ? prec != 1 && prec != 3 : prec != 0) ||
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
#if LAYERED_PREC
  FloodParams p{alpha, beta, llr_chip, static_cast<float*>(scratch), prec};
#else
  FloodParams p{alpha, beta, llr_chip, static_cast<float*>(scratch)};
#endif
  return (int)st::launch(pick(dcb_max, rule, track, xor_perm), a, p,
                         clusters, threads, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
}

const char* flooding_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
