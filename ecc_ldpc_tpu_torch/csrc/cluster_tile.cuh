// A frame tile's posteriors held on chip for a whole layered decode: the
// frame shared by csrc/layered_qc.cu (K1a, min-sum) and
// csrc/layered_exact.cu (K1c, exact BP) on dup-free QC graphs, for Hopper.
//
// The plan (decode/layered_qc.tile_plan, obeyed here as given): a tile of
// F frames is held by a thread-block cluster of CS blocks (CS a power of
// two dividing Z) for the whole decode; a persistent grid of clusters
// takes tiles from an atomic counter, so a tile held by slow frames holds
// one cluster, not the kernel. Rank r of the cluster owns rows z = r, r +
// CS, ... of every block-column for all F frames, and the checks of the
// same rows; variable (col, z) of frame f is f32 word (k * R + z / CS) * F
// + f of rank z % CS's shared memory, k = home[col] the column's on-chip
// slot, R = Z / CS. Within a layer the checks of a frame touch distinct
// variables, so the only order to keep is layer after layer: one barrier
// per layer.
//  - CS > 1 (batches too small to give every SM a tile): every
//    block-column is on chip, and a check reaches its posteriors through
//    distributed shared memory (generic pointers from map_shared_rank),
//    most of them on other ranks. The barrier is the cluster's
//    (barrier.cluster arrive.release / wait.acquire), which ptxas turns
//    into a GPU-scope fence, the barrier and an L1 invalidate: a layer
//    step 0.3-0.4 us slower than a cluster of one's on an H100
//    (bench/cluster_probe.py).
//  - CS = 1 (a batch that fills the card): the block's own bar.sync.
//    Block-columns that do not fit the SM's shared memory live in an
//    L2-resident scratch, `spill` (home[col] = -1 - j), chosen so that
//    they are read by few layers, reached through the same generic
//    pointers.
// Check state stays in HBM, one slab of `stride` words per (cluster, rank,
// layer), word w of the check's item i = zl * F + f at i + w * R * F; it is
// prefetched a layer ahead into two buffers with cp.async while the
// current layer computes (the addresses do not depend on the data; a slab
// written in one iteration is read in the next, at least one layer step
// later, so the graph needs two layers) and not read in iteration 0,
// where it is all zeros. (Two layers ahead in three buffers measured 0.7%
// faster on the headline and left three fewer block-columns on chip.)
// Per-frame flags (a parity failed or a sign flipped; the syndrome) are
// reduced across the cluster in rank 0's shared memory, so every rank
// takes the same stop decision. LLRs are read from
// llr [B, n] and bits (and, when asked, the posteriors) written to [B, n]:
// rank r moves whole block-columns c = r (mod CS), coalesced in HBM.
//
// A Rule supplies the per-check arithmetic (layered_qc.cu, layered_exact.cu):
//   static constexpr int MAX_DEG;
//   void begin(int t);  iteration t's parameters
//   void update(float (&r)[MAX_DEG], int d, const uint32_t* old, bool zero,
//               uint32_t* out, int ws);
//     r: the check's d posteriors in, its new posteriors out; old: its last
//     messages' words in the prefetched slab (word stride ws), all zeros
//     when `zero`; out: the same words in HBM (in the precision library,
//     the messages rounded by the rule's Prec q).
// or, for rows wider than the register builds (MAX_DEG == kWide):
//   template <bool TRACK, class At>
//   bool update_wide(At at, int d, const uint32_t* old, bool zero,
//                    uint32_t* out, int ws);
//     at(j): the address of the check's posterior in slot j, read in slot
//     order twice: in a dup-free layer no posterior of the row is written
//     before the second pass reaches it, and `old` is the prefetched copy,
//     so each extrinsic input r - Cold is recomputed to the same float.
//     Returns (TRACK) whether the layer's parity failed or a sign flipped.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qc_index.cuh"

// The layered sources build twice (ecc_ldpc_tpu_torch/_build.py): with
// LAYERED_PREC 0 the f32 library, whose device code is the f32 kernels'
// alone, and with LAYERED_PREC 1 the precision library, whose kernels
// take a Prec beside their parameters (WithPrec) and round as it says. So
// the rounding code never shares a register allocation with the f32
// kernels, and the libraries build side by side. LAYERED_PERM 1 or 2
// keeps a library to the circulant or the xor instances (layered_exact.cu's
// precision build comes in two such halves, which build in parallel).
#ifndef LAYERED_PREC
#define LAYERED_PREC 0
#endif
#ifndef LAYERED_PERM
#define LAYERED_PERM 0
#endif

namespace ct {

constexpr bool kPrec = LAYERED_PREC;

// Message precision (decode/quant.py), uniform over a launch: kind 0 is
// f32 (no rounding), 1 the bf16 round trip of the TPU kernel's message
// and LLR storage, 2 the q:BITS:STEP grid. The precision kernels round the
// LLRs as a tile loads them and every message a rule stores; `post` says
// whether a set-form layer adds the rounded message to the posteriors
// (q:, and bf16 in track mode) or the unrounded one (bf16 fixed mode).
// Both roundings are odd functions, Q(-m) = -Q(m) with the sign of zero
// kept, so K1a's compressed state (two magnitudes and the sign bits)
// rounds its two magnitudes and stays the stored messages exactly. The q:
// grid is the JAX package's quantize in its op order: a true division,
// round half to even, the clip to +-lim, the product with step, then x's
// sign bit.
struct Prec {
  int kind = 0;
  int post = 0;
  float step = 1.f, lim = 0.f;

  __device__ __forceinline__ float operator()(float x) const {
    if (kind == 1) return __bfloat162float(__float2bfloat16_rn(x));
    if (kind == 2) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(x, step)), -lim), lim);
      return copysignf(__fmul_rn(q, step), x);
    }
    return x;
  }
};

// A precision kernel's parameters: its f32 kernel's, and the precision
template <class P>
struct WithPrec {
  P p;
  Prec q;
};

namespace cg = cooperative_groups;

constexpr int kMaxFrames = 64;    // frames per tile at most (plan.frames)
constexpr int kMaxCluster = 16;   // 16 needs the non-portable size
constexpr int kSlotWords = kMaxFrames + 1;
// MAX_DEG of the builds for rows wider than the widest register build:
// the check's row stays in memory (csrc/bp_rules.cuh, the wide rules)
constexpr int kWide = 0;

// One bit per slot of a check of up to DEG slots (the 64-wide builds take
// two words)
template <int DEG>
using SignMask = std::conditional_t<(DEG > 32), unsigned long long, uint32_t>;

struct Args {
  const float* llr;       // [B, n] in: channel LLRs
  uint8_t* bits;          // [B, n] out: hard decisions
  float* post;            // [B, n] out: final posteriors, or null
  uint8_t* ok;            // [B] out: final syndrome satisfied
  int32_t* iters;         // [B] out: iterations used
  uint32_t* state;        // [clusters * CS, mb, stride] scratch: check state
  float* spill;           // [clusters, nb - nchip, Z, F] scratch: posteriors
                          // of the block-columns not held on chip (CS = 1)
  const int32_t* home;    // [nb] column -> on-chip slot k, or -1 - spill slot
  int* counter;           // [1], zeroed by launch: the next tile to take
  const int32_t* tab;     // [mb+1 | BE | BE] layer_ptr, column, shift
  int Z, mb, nb, BE, B, max_iters;
  int cs, lg_cs, F, R, tiles, stride, nchip;  // the plan
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The barrier between layers: the block's own with a cluster of one (the
// large-batch plans; no cluster fence), else the cluster's
__device__ __forceinline__ void sync_tile(int cs) {
  if (cs == 1) {
    __syncthreads();
  } else {
    cluster_sync();
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Static shared state of a tile's frame (within decode/layered_qc's
// _SMEM_STATIC), csrc/state_tile.cuh's too.
struct Shared {
  float* peer[kMaxCluster];       // each rank's dynamic shared memory
  int slots[3][kSlotWords];       // rank 0's: the cluster's reductions
  int part[kMaxFrames];           // this block's share of one
  int flag[kMaxFrames];           // its result
  int done[kMaxFrames];           // track mode: frame frozen
  int used[kMaxFrames];           // track mode: iterations run
};

// The cluster's reductions and tile counter, in rank 0's slots: reduction
// q uses slots[q % 3]; rank 0 clears the slot two reductions ahead (every
// rank read it before this barrier, and none writes it before the next).
struct Frame {
  Shared& s;
  int* slots0;  // rank 0's slots, reached from every rank
  int rank, cs, F, tid, nth;
  int q = 0;

  __device__ void retire() {
    if (rank == 0)
      for (int i = tid; i < kSlotWords; i += nth) s.slots[(q + 2) % 3][i] = 0;
    ++q;
  }
  // flag[f] = OR over the cluster's part[f], f < F; part cleared. Its
  // cluster barrier also orders every shared write before it.
  __device__ void reduce() {
    __syncthreads();
    int* slot = slots0 + (q % 3) * kSlotWords;
    if (tid < F) {
      if (s.part[tid]) slot[tid] = 1;
      s.part[tid] = 0;
    }
    sync_tile(cs);
    if (tid < F) s.flag[tid] = slot[tid];
    retire();
    __syncthreads();
  }
  __device__ int next_tile(int* counter) {
    if (rank == 0 && tid == 0)
      s.slots[q % 3][kMaxFrames] = atomicAdd(counter, 1);
    sync_tile(cs);
    const int tile = slots0[(q % 3) * kSlotWords + kMaxFrames];
    retire();
    return tile;
  }
  // track mode: every frame of the tile is frozen
  __device__ bool all_done() const {
    bool all = true;
    for (int f = 0; f < F; ++f) all &= s.done[f] != 0;
    return all;
  }
};

// Sets up the frame: the peer pointers, cleared slots and flags. The
// caller fills its tables, then syncs the cluster before any remote access.
__device__ __forceinline__ Frame begin(Shared& sh, float* dyn, int cs, int F) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nth = blockDim.x;
  if (tid < cs) sh.peer[tid] = cluster.map_shared_rank(dyn, tid);
  for (int i = tid; i < 3 * kSlotWords; i += nth) (&sh.slots[0][0])[i] = 0;
  for (int i = tid; i < kMaxFrames; i += nth) sh.part[i] = 0;
  return Frame{sh, cluster.map_shared_rank(&sh.slots[0][0], 0),
               cluster_rank(), cs, F, tid, nth};
}

template <bool TRACK, bool XOR, class Rule>
__device__ __forceinline__ void decode_tiles(const Args& a, Rule& rule) {
  constexpr int D = Rule::MAX_DEG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, Z = a.Z, cs = a.cs, mb = a.mb, nb = a.nb, BE = a.BE;
  const int RF = a.R * F;
  float* post = reinterpret_cast<float*>(smem);  // [nchip * R * F]
  uint32_t* buf =
      reinterpret_cast<uint32_t*>(post + ((a.nchip * RF + 3) & ~3));
  // per sweep slot, for this rank's checks: the first word of the slot's
  // block-column where the rows they read live (a rank's shared memory, the
  // same rank for every check of this rank, or the spill), and the row
  // offset
  float** sbase = reinterpret_cast<float**>(buf + 2 * a.stride);  // [BE]
  int* soff = reinterpret_cast<int*>(sbase + BE);                  // [BE]
  int* lptr = soff + BE;                                           // [mb + 1]
  int* home = lptr + mb + 1;                                       // [nb]
  __shared__ Shared sh;

  Frame fr = begin(sh, post, cs, F);
  auto& peer = sh.peer;  // each rank's posteriors
  auto& part = sh.part;
  auto& flag = sh.flag;
  auto& done = sh.done;
  auto& used = sh.used;
  const int tid = threadIdx.x, nth = blockDim.x, rank = fr.rank;
  const int n = nb * Z;
  uint32_t* state = a.state + (size_t)blockIdx.x * mb * a.stride;
  float* spill = a.spill + (size_t)(blockIdx.x / cs) * (nb - a.nchip) * Z * F;

  for (int i = tid; i <= mb; i += nth) lptr[i] = a.tab[i];
  for (int i = tid; i < nb; i += nth) home[i] = a.home[i];
  __syncthreads();
  // check z = zl * CS + rank reads row zz = qc::var_index(z, s) of its
  // column: on rank zz % CS, row zz / CS. Z is a multiple of CS, so both
  // follow from check z = rank's: circulant, rank (rank + s) % Z % CS and
  // row (zl + (rank + s) % Z / CS) % R; xor, rank (rank ^ s) % CS and row
  // zl ^ (s / CS). A spilled column (CS = 1) has the same rows.
  for (int i = tid; i < BE; i += nth) {
    const int zz = qc::var_index<XOR>(rank, a.tab[mb + 1 + BE + i], Z);
    const int owner = zz & (cs - 1), ro = zz >> a.lg_cs;
    const int h = home[a.tab[mb + 1 + i]];
    sbase[i] = h >= 0 ? peer[owner] + h * RF : spill + (-1 - h) * RF;
    soff[i] = XOR ? ro : ro * F;
  }
  sync_tile(cs);

  // row zz of block-column col, frame f (the tile's loads and stores)
  auto var = [&](int col, int zz, int f) -> float* {
    const int h = home[col];
    return h >= 0 ? peer[zz & (cs - 1)] + (h * a.R + (zz >> a.lg_cs)) * F + f
                  : spill + ((-1 - h) * Z + zz) * F + f;
  };
  // the posterior that check zl * CS + rank, frame f (zf = zl * F + f),
  // reads in sweep slot s
  auto edge = [&](int s, int zl, int zf) -> float* {
    int o;
    if constexpr (XOR) {
      o = zf + ((zl ^ soff[s]) - zl) * F;
    } else {
      o = zf + soff[s];
      if (o >= RF) o -= RF;
    }
    return sbase[s] + o;
  };
  // item i is check zl = i / F, frame f = i % F: an f32 estimate, then
  // one correction (no integer division)
  const float inv_f = 1.f / F;
  auto split = [&](int i, int& zl, int& f) {
    zl = __float2int_rz((i + 0.5f) * inv_f);
    f = i - zl * F;
    if (f < 0) {
      --zl;
      f += F;
    } else if (f >= F) {
      ++zl;
      f -= F;
    }
  };
  // part[f] = 1 where a check of live frame f < nf fails on x < 0
  auto syndrome = [&](int nf) {
    for (int L = 0; L < mb; ++L) {
      const int s0 = lptr[L], d = lptr[L + 1] - s0;
      for (int i = tid; i < RF; i += nth) {
        int zl, f;
        split(i, zl, f);
        if (f >= nf) continue;
        bool par = false;
        if constexpr (D == kWide) {
          for (int j = 0; j < d; ++j) par ^= *edge(s0 + j, zl, i) < 0.f;
        } else {
          float r[D];
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j < d) r[j] = *edge(s0 + j, zl, i);
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j < d) par ^= r[j] < 0.f;
        }
        if (par) part[f] = 1;
      }
    }
  };

  const int ncol = (nb - rank + cs - 1) / cs;  // block-columns this rank moves
  for (;;) {
    const int tile = fr.next_tile(a.counter);
    if (tile >= a.tiles) break;
    const int b0 = tile * F;
    const int nf = min(F, a.B - b0);  // live frames (the last tile is ragged)
    for (int i = tid; i < nf * ncol * Z; i += nth) {
      const int z = i % Z, c = (i / Z) % ncol, f = i / (Z * ncol);
      const int col = c * cs + rank;
      float x = a.llr[(size_t)(b0 + f) * n + col * Z + z];
      if constexpr (kPrec) x = rule.q(x);
      *var(col, z, f) = x;
    }
    sync_tile(cs);
    if constexpr (TRACK) {
      // done_0: frames whose channel hard decisions already satisfy H
      syndrome(nf);
      fr.reduce();
      for (int f = tid; f < F; f += nth) {
        done[f] = f < nf ? !flag[f] : 1;
        used[f] = 0;
      }
      __syncthreads();
    }
    for (int t = 0; t < a.max_iters; ++t) {
      if constexpr (TRACK) {
        // the tile stops once every frame in it is done; a frozen frame
        // writes nothing, so per-frame results do not depend on the tile
        if (fr.all_done()) break;
      }
      rule.begin(t);
      for (int L = 0; L < mb; ++L) {
        // prefetch the next layer step's slab (step g = t * mb + L reads
        // buffer g % 2); none for a step of iteration 0 (all zeros) or
        // past the last
        const int g = t * mb + L, tn = (g + 1) / mb;
        if (tn >= 1 && tn < a.max_iters) {
          const uint32_t* src = state + (size_t)((g + 1) % mb) * a.stride;
          const uint32_t dst = smem_u32(buf) + 4u * ((g + 1) % 2) * a.stride;
          for (int w = 4 * tid; w < a.stride; w += 4 * nth)
            cp_async16(dst + 4u * w, src + w);
        }
        const int s0 = lptr[L], d = lptr[L + 1] - s0;
        const uint32_t* old = buf + (g % 2) * a.stride;
        uint32_t* out = state + (size_t)L * a.stride;
        for (int i = tid; i < RF; i += nth) {
          int zl, f;
          split(i, zl, f);
          if (f >= nf) continue;
          if constexpr (TRACK) {
            if (done[f]) continue;
          }
          if constexpr (D == kWide) {
            auto at = [&](int j) { return edge(s0 + j, zl, i); };
            const bool run = rule.template update_wide<TRACK>(
                at, d, old + i, t == 0, out + i, RF);
            if (TRACK && run) part[f] = 1;
          } else {
            // the d loads back to back, their uses after them all, so their
            // latencies overlap; the widest rows recompute the addresses for
            // the stores rather than hold 32 pointers
            constexpr bool kKeep = D <= 16;
            float* p[kKeep ? D : 1];
            float r[D];
#pragma unroll
            for (int j = 0; j < D; ++j) {
              if (j < d) {
                float* e = edge(s0 + j, zl, i);
                if constexpr (kKeep) p[j] = e;
                r[j] = *e;
              }
            }
            // track mode: sign bits of the posteriors read
            SignMask<D> rneg = 0;
            bool par = false;   // and the layer's parity on them (x < 0)
            if constexpr (TRACK) {
#pragma unroll
              for (int j = 0; j < D; ++j) {
                if (j < d) {
                  rneg |= (SignMask<D>)(__float_as_uint(r[j]) >> 31) << j;
                  par ^= r[j] < 0.f;
                }
              }
            }
            rule.update(r, d, old + i, t == 0, out + i, RF);
            SignMask<D> nneg = 0;
#pragma unroll
            for (int j = 0; j < D; ++j) {
              if (j < d) {
                if constexpr (kKeep) {
                  *p[j] = r[j];
                } else {
                  *edge(s0 + j, zl, i) = r[j];
                }
                if constexpr (TRACK)
                  nneg |= (SignMask<D>)(__float_as_uint(r[j]) >> 31) << j;
              }
            }
            if constexpr (TRACK) {
              // a failed parity or a sign flip keeps the frame running
              if (par || nneg != rneg) part[f] = 1;
            }
          }
        }
        cp_async_wait_all();
        sync_tile(cs);
      }
      if constexpr (TRACK) {
        fr.reduce();
        for (int f = tid; f < F; f += nth) {
          if (!done[f]) {
            ++used[f];
            if (!flag[f]) done[f] = 1;
          }
        }
        __syncthreads();
      }
    }
    // truthful ok: one final syndrome over the emitted hard decisions
    syndrome(nf);
    fr.reduce();
    if (rank == 0) {
      for (int f = tid; f < nf; f += nth) {
        a.ok[b0 + f] = flag[f] ? 0 : 1;
        a.iters[b0 + f] = TRACK ? used[f] : a.max_iters;
      }
    }
    for (int i = tid; i < nf * ncol * Z; i += nth) {
      const int z = i % Z, c = (i / Z) % ncol, f = i / (Z * ncol);
      const int col = c * cs + rank;
      const float v = *var(col, z, f);
      const size_t o = (size_t)(b0 + f) * n + col * Z + z;
      a.bits[o] = v < 0.f ? 1 : 0;
      if (a.post) a.post[o] = v;
    }
  }
  // no block leaves while a peer may still read its shared memory
  sync_tile(cs);
}

// Host side: the launch configuration of a plan, its occupancy, its launch.
template <class Kern>
cudaError_t prepare(Kern kern, int cs, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Config(int clusters, int cs, int threads, size_t smem, cudaStream_t st) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(clusters * cs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// clusters of this plan that can be resident at once (0: none fits)
template <class Kern>
cudaError_t max_clusters(Kern kern, int cs, int threads, size_t smem,
                         int* out) {
  cudaError_t e = prepare(kern, cs, smem);
  if (e != cudaSuccess) return e;
  Config c(1, cs, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, kern, &c.cfg);
}

template <class Kern, class P>
cudaError_t launch(Kern kern, const Args& a, const P& p, int clusters,
                   int threads, size_t smem, cudaStream_t st) {
  if (a.cs < 1 || a.cs > kMaxCluster || (a.cs & (a.cs - 1)) ||
      a.Z % a.cs || a.R * a.cs != a.Z || (1 << a.lg_cs) != a.cs ||
      a.F < 1 || a.F > kMaxFrames || a.tiles * a.F < a.B || a.stride % 4 ||
      threads < 32 || threads > 512 || threads < a.F || clusters < 1 ||
      a.mb < 2 || a.nchip < 0 || a.nchip > a.nb || (a.cs > 1 && a.nchip < a.nb))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, a.cs, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.counter, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  Config c(clusters, a.cs, threads, smem, st);
  e = cudaLaunchKernelEx(&c.cfg, kern, a, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace ct
