// Flooding belief propagation (minsum, spa, minstar) on unstructured
// graphs, for Hopper (K2).
//
// Replaces ecc_ldpc_tpu/decode/pallas/fused_mm.py::_kernel (:151, with
// _cn_minsum_slabs :68 and _cn_spa_slabs :116), which computes
// decode/xla/flooding.py::decode_flooding with the gathers written as 0/1
// incidence matmuls, because the TPU has no vector gather, and keeps its
// whole message state in VMEM across the iterations. Here the gathers are
// index tables, and a tile's whole state stays in shared memory. minstar
// is this kernel's third rule; the JAX package serves it only through its
// XLA gather form. The caller is ecc_ldpc_tpu_torch/decode/flooding.py
// (flooding_decode_cuda); the plain PyTorch twin there is the reference
// this kernel must match.
//
// Design: a tile of F frames belongs to one block for the whole decode; a
// persistent grid of blocks takes tiles from an atomic counter with the
// tile kernels' frame control (ct::Frame, csrc/cluster_tile.cuh, a cluster
// of one here). A tile's state, row-major with frames innermost (word
// x * F + f of row x, frame f):
//   posteriors  [n][F]
//   messages    [dc][m][F]  slot j of check i at row j * m + i, so the
//                           checks of a warp touch adjacent words
//   LLRs        [n][F]      where they fit (`llr_chip`); else re-read from
//                           llr [B, n], where they stay in L2
// Row widths: builds for checks of up to 6, 8, 32 and 64 slots; the
// 64-wide one takes one frame a thread's item (a loaded matrix's long rows;
// decode/flooding.MAX_DC). A wider row takes the wide build, one frame an
// item, whose check rule works on the row in place in the check's message
// slots (csrc/bp_rules.cuh, the wide rules; minstar's prefixes in a
// per-thread scratch row in device memory).
// decode/flooding.flooding_plan picks the form and F from the graph's size:
//   "chip"    the state in dynamic shared memory (mackay1008: 16,128 B a
//             frame, 20,160 with its LLRs);
//   "global"  a frame too large for a block's 227 KB: the same state in a
//             scratch in device memory, one slab of F frames per resident
//             block, reached through the same arithmetic.
// LLRs are read from llr [B, n] and bits (and, when asked, the posteriors)
// written to [B, n] directly. Tables (global, read through the L1): cn
// [dc][m] the variable of each check slot (-1 where padded), vn [n][dv]
// the message row of each variable slot (-1 where padded).
//
// Per iteration, in the oracle's order (flooding.py:53-70), a thread's item
// G frames (the plan's `lanes`: 2 in the form "chip" when F is even, so a
// word pair of adjacent frames moves as one 8-byte shared-memory access):
//   CN phase  per (check, frames): r = total[var] (the stale posterior),
//             v = r - C (C = 0 in iteration 0; a padded slot holds
//             bp::kIdentity and minstar passes dc, not deg), C = rule(v)
//             (csrc/bp_rules.cuh) for each frame that advances; in track
//             mode also the parity of r < 0 over the check, counted by
//             (r < 0), so -0.0 is positive;
//   barrier   (track mode: the reduction that makes the parities per-frame
//             flags)
//   VN phase  per (variable, frames): total = llr + s, where s = ((0 +
//             C[e0]) + C[e1]) + ... over the slots in order, a padded slot
//             adding 0.0;
//   barrier.
// The oracle's V = total[cn] - C is recomputed from (total, C): the same
// floats. Track mode: the oracle takes the syndrome of the post-sweep
// state after each sweep; here the next sweep's CN phase reads exactly
// those posteriors, so it takes the parity on the fly. A frame whose parity
// passes is done: its VN phase is skipped, so its state is the one that
// passed, and `iters` counts the sweeps applied, as the oracle counts the
// sweeps of frames not yet done (done_0, the channel LLRs' syndrome, is
// iteration 0's parity). The messages of a frame that does not advance may
// be overwritten (its item's other frame stores a pair): they are never
// read again, nor a ragged tile's dead lanes. The tile stops when all its
// frames are done, one CN phase later than the oracle would, with the same
// results. ok is one syndrome of the emitted decisions.
//
// Precision: built with LAYERED_PREC 1 (ecc_ldpc_tpu_torch/_build.py, the
// library flooding_prec) the kernels are min-sum with the TPU kernel's
// bf16 matmul inputs under `/pallas` (fused_mm.py:289-295, mxu_dtype
// bf16): a check reads bf16(r) - C (the parity still r < 0, the
// syndrome's input being exact), and a variable adds bf16(C) of its slots
// in f32 to its f32 LLR; the messages and the sums stay f32. The f32
// library's kernels are the code below with no rounding.
//
// What bounds it on an H100: the operations bound (14 fp32 operations per
// edge visit for minsum; 4 spa or ~8.6 minstar transcendentals at the
// special-function rate) is the larger (bench/throughput.decode_bound);
// HBM sees only the LLRs in and the bits out. The earlier design kept the
// state in HBM/L2 as [tiles, n, 8] and moved 16 B per edge visit through
// the cache hierarchy, with three block barriers an iteration in track
// mode, plus transposes into and out of tiles around the kernel. Here an
// edge visit is shared-memory words, 2 barriers an iteration (5 in track
// mode, ct::Frame's reduction). What is left is the issue of the loads,
// stores and index arithmetic (on mackay1008 minsum, trial builds without
// the check rule or without the VN phase each ran far faster, so the rule
// is not most of it; two frames an item, halving the shared-memory
// instructions, was faster on every leg), bank conflicts on the gathers,
// and for spa and minstar the accurate transcendentals.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bp_rules.cuh"
#include "state_tile.cuh"  // st::Walk, st::max_threads; ct::Frame

namespace {

constexpr int kDv = 4;  // column degrees whose VN loads are unrolled

struct Args {
  const float* llr;    // [B, n] in: channel LLRs
  uint8_t* bits;       // [B, n] out: hard decisions
  float* post;         // [B, n] out: final posteriors, or null
  uint8_t* ok;         // [B] out: final syndrome satisfied
  int32_t* iters;      // [B] out: iterations used
  int* counter;        // [1], zeroed by the launch: the next tile to take
  const int32_t* cn;   // [dc][m] variable of each check slot, -1 padded
  const int32_t* vn;   // [n][dv] message row of each variable slot, -1 padded
  float* state;        // form "global": [blocks][n + m*dc][F]; else null
  float* wide;         // the wide minstar build's prefixes: [dc][threads]
  int n, m, dc, dv, B, max_iters;
  int F, tiles, llr_chip;  // the plan
  float alpha, beta;
};

// The frame control of a block that holds its tile alone (a cluster of
// one, launched without cluster dimensions): ct::begin without the
// cluster mapping.
__device__ __forceinline__ ct::Frame begin_block(ct::Shared& sh, int F) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < 3 * ct::kSlotWords; i += nth) (&sh.slots[0][0])[i] = 0;
  for (int i = tid; i < ct::kMaxFrames; i += nth) sh.part[i] = 0;
  return ct::Frame{sh, &sh.slots[0][0], 0, 1, F, tid, nth};
}

// G adjacent f32 words of a tile's state (8-byte aligned when G = 2: F is
// even and every region starts at an even word).
template <int G>
__device__ __forceinline__ void load(const float* p, float (&x)[G]) {
  if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void store(float* p, const float (&x)[G]) {
  if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// part[f] = 1 where a check of live frame f < nf fails on x < 0.
template <int MAX_DC, class Idx>
__device__ void syndrome(const Args& a, ct::Shared& sh, const float* post,
                         int nf) {
  const int F = a.F, m = a.m;
  for (st::Walk w(threadIdx.x, blockDim.x, 1, F); w.a < m; w.next()) {
    if (w.f >= nf) continue;
    bool par = false;
    if constexpr (MAX_DC == ct::kWide) {
      for (int j = 0; j < a.dc; ++j) {
        const int var = __ldg(a.cn + j * m + w.a);
        if (var >= 0) par ^= post[(Idx)var * F + w.f] < 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < MAX_DC; ++j) {
        if (j < a.dc) {
          const int var = __ldg(a.cn + j * m + w.a);
          if (var >= 0) par ^= post[(Idx)var * F + w.f] < 0.f;
        }
      }
    }
    if (par) sh.part[w.f] = 1;
  }
}

template <int MAX_DC, int RULE, bool TRACK, bool GLOBAL, int G>
__global__ void __launch_bounds__(st::max_threads(MAX_DC), 1)
flooding_kernel(Args a) {
  // a tile's words: 32-bit offsets in shared memory, 64-bit in the scratch
  using Idx = std::conditional_t<GLOBAL, size_t, int>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ct::Shared sh;
  const int F = a.F, n = a.n, m = a.m, dc = a.dc, dv = a.dv;
  const Idx nF = (Idx)n * F, E = (Idx)m * dc;
  float* post = GLOBAL ? a.state + blockIdx.x * (size_t)(nF + E * F)
                       : reinterpret_cast<float*>(smem);
  float* C = post + nF;      // [dc][m][F]
  float* L = C + E * F;      // [n][F] if llr_chip (never in form "global")
  ct::Frame fr = begin_block(sh, F);
  const int tid = threadIdx.x, nth = blockDim.x;
  __syncthreads();

  for (;;) {
    const int tile = fr.next_tile(a.counter);
    if (tile >= a.tiles) break;
    const int b0 = tile * F;
    const int nf = min(F, a.B - b0);  // live frames (the last tile is ragged)
    for (int i = tid; i < nf * n; i += nth) {
      const int f = i / n, v = i - f * n;
      const float x = a.llr[(size_t)(b0 + f) * n + v];
      post[(Idx)v * F + f] = x;
      if (a.llr_chip) L[(Idx)v * F + f] = x;
    }
    if constexpr (TRACK) {
      for (int f = tid; f < F; f += nth) {
        sh.done[f] = f >= nf;
        sh.used[f] = 0;
      }
    }
    __syncthreads();
    for (int t = 0; t < a.max_iters; ++t) {
      if (TRACK && fr.all_done()) break;
      // CN phase: G frames f0.. of check i an item
      for (st::Walk w(tid, nth, 1, F / G); w.a < m; w.next()) {
        const int f0 = w.f * G, i = w.a;
        bool act[G], any = false;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          act[g] = f0 + g < nf && !(TRACK && sh.done[f0 + g]);
          any |= act[g];
        }
        if (!any) continue;
        float* Ci = C + ((Idx)i * F + f0);  // slot j at Ci[j * m * F]
        const Idx mF = (Idx)m * F;
        if constexpr (MAX_DC == ct::kWide) {
          static_assert(G == 1, "the wide build takes one frame an item");
          // the row in place in the check's message slots (a padded slot
          // bp::kIdentity): v = r - C, then C = rule(v)
          int deg = 0;
          bool par = false;
          for (int j = 0; j < dc; ++j) {
            const int var = __ldg(a.cn + j * m + i);
            float x = bp::kIdentity;
            if (var >= 0) {
              const float r = post[(Idx)var * F + f0];
              if constexpr (TRACK) par ^= r < 0.f;
              x = __fsub_rn(ct::kPrec ? st::bf16(r) : r,
                            t > 0 ? Ci[j * mF] : 0.f);
              deg = j + 1;
            }
            Ci[j * mF] = x;
          }
          const size_t T = (size_t)gridDim.x * nth;
          bp::check_rule_wide<RULE>(
              bp::Row{Ci, (size_t)mF},
              bp::Row{a.wide + (size_t)blockIdx.x * nth + tid, T},
              RULE == bp::kMinstar ? dc : deg, a.alpha, a.beta);
          if (TRACK && par) sh.part[f0] = 1;
        } else {
          float v[G][MAX_DC];
          int deg = 0;
          bool par[G] = {};
#pragma unroll
          for (int j = 0; j < MAX_DC; ++j) {
            if (j < dc) {
              const int var = __ldg(a.cn + j * m + i);
              if (var >= 0) {
                float r[G], c[G] = {};
                load<G>(post + ((Idx)var * F + f0), r);
                if (t > 0) load<G>(Ci + j * mF, c);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                  if constexpr (TRACK) par[g] ^= r[g] < 0.f;
                  if constexpr (ct::kPrec) r[g] = st::bf16(r[g]);
                  v[g][j] = __fsub_rn(r[g], c[g]);
                }
                deg = j + 1;
              } else {
#pragma unroll
                for (int g = 0; g < G; ++g) v[g][j] = bp::kIdentity;
              }
            }
          }
          // a lane not advancing stores its extrinsics: a done frame's
          // messages are never read again, nor a dead lane's
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (act[g])
              bp::check_rule<MAX_DC, RULE>(v[g], RULE == bp::kMinstar ? dc : deg,
                                           a.alpha, a.beta);
#pragma unroll
          for (int j = 0; j < MAX_DC; ++j) {
            if (j < deg) {
              float o[G];
#pragma unroll
              for (int g = 0; g < G; ++g) o[g] = v[g][j];
              store<G>(Ci + j * mF, o);
            }
          }
          if constexpr (TRACK) {
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (act[g] && par[g]) sh.part[f0 + g] = 1;
          }
        }
      }
      // flag[f]: frame f's stale posteriors fail a check, so it advances
      if constexpr (TRACK) {
        fr.reduce();
      } else {
        __syncthreads();
      }
      // VN phase: G frames f0.. of variable u an item
      for (st::Walk w(tid, nth, 1, F / G); w.a < n; w.next()) {
        const int f0 = w.f * G, u = w.a;
        bool adv[G], any = false, all = true;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int f = f0 + g;
          adv[g] = f < nf && (!TRACK || (!sh.done[f] && sh.flag[f]));
          any |= adv[g];
          all &= adv[g];
        }
        if (!any) continue;
        float s[G] = {};
        if (dv <= kDv) {  // the loads back to back, then the adds in order
          int e[kDv];
          float c[kDv][G];
#pragma unroll
          for (int k = 0; k < kDv; ++k)
            if (k < dv) e[k] = __ldg(a.vn + u * dv + k);
#pragma unroll
          for (int k = 0; k < kDv; ++k) {
            if (k < dv) {
              if (e[k] >= 0) {
                load<G>(C + ((Idx)e[k] * F + f0), c[k]);
              } else {
#pragma unroll
                for (int g = 0; g < G; ++g) c[k][g] = 0.f;
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kDv; ++k) {
            if (k < dv) {
#pragma unroll
              for (int g = 0; g < G; ++g) {
                if constexpr (ct::kPrec) c[k][g] = st::bf16(c[k][g]);
                s[g] = __fadd_rn(s[g], c[k][g]);
              }
            }
          }
        } else {
          for (int k = 0; k < dv; ++k) {
            const int e = __ldg(a.vn + u * dv + k);
            float c[G] = {};
            if (e >= 0) load<G>(C + ((Idx)e * F + f0), c);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if constexpr (ct::kPrec) c[g] = st::bf16(c[g]);
              s[g] = __fadd_rn(s[g], c[g]);
            }
          }
        }
        float l[G];
        if (a.llr_chip) {
          load<G>(L + ((Idx)u * F + f0), l);
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g)
            l[g] = adv[g] ? __ldg(a.llr + (size_t)(b0 + f0 + g) * n + u) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) l[g] = __fadd_rn(l[g], s[g]);
        float* pu = post + ((Idx)u * F + f0);
        if (all) {
          store<G>(pu, l);
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (adv[g]) pu[g] = l[g];
        }
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
      __syncthreads();
    }
    // truthful ok: one final syndrome over the emitted hard decisions
    syndrome<MAX_DC, Idx>(a, sh, post, nf);
    fr.reduce();
    for (int f = tid; f < nf; f += nth) {
      a.ok[b0 + f] = sh.flag[f] ? 0 : 1;
      a.iters[b0 + f] = TRACK ? sh.used[f] : a.max_iters;
    }
    for (int i = tid; i < nf * n; i += nth) {
      const int f = i / n, v = i - f * n;
      const float x = post[(Idx)v * F + f];
      const size_t o = (size_t)(b0 + f) * n + v;
      a.bits[o] = x < 0.f ? 1 : 0;
      if (a.post) a.post[o] = x;
    }
  }
}

using Kern = void (*)(Args);

template <int MAX_DC, int RULE, bool GLOBAL, int G>
Kern pick_mode(int track) {
  if (track) return flooding_kernel<MAX_DC, RULE, true, GLOBAL, G>;
  return flooding_kernel<MAX_DC, RULE, false, GLOBAL, G>;
}

template <int MAX_DC, bool GLOBAL, int G>
Kern pick_rule(int rule, int track) {
  // the precision library is min-sum's alone (bad())
  if constexpr (!ct::kPrec) {
    if (rule == bp::kSpa)
      return pick_mode<MAX_DC, bp::kSpa, GLOBAL, G>(track);
    if (rule == bp::kMinstar)
      return pick_mode<MAX_DC, bp::kMinstar, GLOBAL, G>(track);
  }
  return pick_mode<MAX_DC, bp::kMinsum, GLOBAL, G>(track);
}

// the widest register build (decode/flooding.MAX_DC; wider rows take the
// wide build), and the widest that takes two frames an item
// (decode/flooding.MAX_DC_PAIRS)
constexpr int kMaxDc = 64;
constexpr int kPairDc = 32;

template <bool GLOBAL, int G>
Kern pick_width(int dc, int rule, int track) {
  if (dc <= 6) return pick_rule<6, GLOBAL, G>(rule, track);
  if (dc <= 8) return pick_rule<8, GLOBAL, G>(rule, track);
  if (dc <= kPairDc) return pick_rule<kPairDc, GLOBAL, G>(rule, track);
  if (dc <= kMaxDc)
    return pick_rule<kMaxDc, GLOBAL, 1>(rule, track);  // one frame an item
  return pick_rule<ct::kWide, GLOBAL, 1>(rule, track);
}

// lanes: frames an item (G), 2 only in the form "chip" with F even
Kern pick(int dc, int rule, int track, int global, int lanes) {
  if (global) return pick_width<true, 1>(dc, rule, track);
  return lanes == 2 ? pick_width<false, 2>(dc, rule, track)
                    : pick_width<false, 1>(dc, rule, track);
}

bool bad(int dc, int rule, int global, int lanes) {
  return dc < 1 || rule < 0 || rule > 2 || (ct::kPrec && rule != 0) ||
         lanes < 1 ||
         lanes > 2 || (global && lanes != 1) || (dc > kPairDc && lanes != 1);
}

}  // namespace

extern "C" {

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// can be resident at once on the current card, for the kernel instance the
// other arguments pick (0: the plan does not fit).
int flooding_blocks(int dc, int rule, int track, int global, int lanes,
                    int threads, int smem, void* out) {
  if (bad(dc, rule, global, lanes)) return (int)cudaErrorInvalidValue;
  const Kern kern = pick(dc, rule, track, global, lanes);
  cudaError_t e = ct::prepare(kern, 1, (size_t)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      (size_t)smem);
  *static_cast<int*>(out) = per_sm * sms;
  return (int)e;
}

// Decodes llr [B, n] with rule 0 (minsum), 1 (spa) or 2 (minstar) by the
// plan (F, tiles, llr_chip, threads, smem; decode/flooding.flooding_plan)
// on `blocks` resident blocks; state is the form "global" scratch
// ([blocks, n + m*dc, F] f32) or null for the form "chip"; counter one int
// (the launch zeroes it). post may be null; wide, for minstar on rows wider
// than 64, holds dc floats for each thread of the grid (else null). Returns
// a cudaError_t (0 on a successful launch).
int flooding_decode(void* llr, void* bits, void* post, void* ok, void* iters,
                    void* counter, void* cn, void* vn, void* state,
                    void* wide, int n,
                    int m, int dc, int dv, int B, int max_iters, int rule,
                    float alpha, float beta, int track, int lanes, int F,
                    int tiles, int llr_chip, int threads, int smem,
                    int blocks, void* stream) {
  const bool global = state != nullptr;
  if (bad(dc, rule, global, lanes) || F % lanes || dv < 1 || n < 1 ||
      m < 1 || B < 1 || max_iters < 1 ||
      F < 1 || F > ct::kMaxFrames || tiles < 1 || (long long)tiles * F < B ||
      threads < 32 || threads > st::max_threads(dc <= 8 ? 8 : 32) ||
      blocks < 1 || (global && (llr_chip || smem != 0)) ||
      (rule == bp::kMinstar && dc > kMaxDc && wide == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.post = static_cast<float*>(post);
  a.ok = static_cast<uint8_t*>(ok);
  a.iters = static_cast<int32_t*>(iters);
  a.counter = static_cast<int*>(counter);
  a.cn = static_cast<const int32_t*>(cn);
  a.vn = static_cast<const int32_t*>(vn);
  a.state = static_cast<float*>(state);
  a.wide = static_cast<float*>(wide);
  a.n = n; a.m = m; a.dc = dc; a.dv = dv; a.B = B; a.max_iters = max_iters;
  a.F = F; a.tiles = tiles; a.llr_chip = llr_chip;
  a.alpha = alpha; a.beta = beta;
  const Kern kern = pick(dc, rule, track, global, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = ct::prepare(kern, 1, (size_t)smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.counter, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kern), dim3(blocks),
                       dim3(threads), args, (size_t)smem, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* flooding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
