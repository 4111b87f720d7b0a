// A tile's whole decoder state (posteriors and messages) held on chip for a
// whole decode: the frame shared by csrc/layered_classic.cu (K1b, K1c';
// layered BP in the accumulate form) and csrc/flooding_qc.cu (K3, and K4's
// flooding mode), for Hopper. csrc/cluster_tile.cuh is its sibling for K1a
// and K1c, whose check state stays in HBM; this one keeps every message in
// shared memory, so HBM sees the LLRs in and the bits out.
//
// The plan (decode/layered_qc.tile_plan with form "classic" or "flooding",
// obeyed here as given): a tile of F frames is held by a thread-block
// cluster of CS blocks (CS a power of two dividing Z) for the whole decode;
// a persistent grid of clusters takes tiles from an atomic counter. Rank r
// owns rows z = r, r + CS, ... (z = zl * CS + r, R = Z / CS of them) of
// every block-column and of every block-row, and the messages of its
// checks. In each rank's dynamic shared memory, R * F words per block (a
// row zl and frame f at word zl * F + f):
//   posteriors  [nb][R][F]    variable (col, z) of frame f
//   messages    [BE][R][F]    sweep slot s's message to check z
//   then the kernel's own: the layered deltas or the flooding LLRs.
// A check reads its d posteriors (and a flooding variable its messages)
// through generic pointers from map_shared_rank, on other ranks when
// CS > 1 (distributed shared memory): `edges` gives, per sweep slot, the
// first word of the region its rows live in on the owning rank and the row
// offset. With CS = 1 every barrier is the block's bar.sync; with CS > 1
// the cluster's (a GPU-scope fence, 0.3-0.4 us more on an H100:
// bench/cluster_probe.py), which flooding pays twice an iteration and the
// layered accumulate form a few times a layer.
// Per-frame flags (a parity failed, a sign flipped; the syndrome) are
// reduced across the cluster in rank 0's shared memory, so every rank
// takes the same stop decision. LLRs are read from llr [B, n] and bits
// (and, when asked, the posteriors) written to [B, n]: rank r moves whole
// block-columns c = r (mod CS), coalesced in HBM.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_tile.cuh"

namespace st {

namespace cg = cooperative_groups;
using ct::Frame;
using ct::kMaxCluster;
using ct::kMaxFrames;
using ct::kSlotWords;
using ct::Shared;
using ct::begin;

struct Args {
  const float* llr;     // [B, n] in: channel LLRs
  uint8_t* bits;        // [B, n] out: hard decisions
  float* post;          // [B, n] out: final posteriors, or null
  uint8_t* ok;          // [B] out: final syndrome satisfied
  int32_t* iters;       // [B] out: iterations used
  int* counter;         // [1], zeroed by launch: the next tile to take
  const int32_t* tab;   // the kernel's table (layer_ptr, column, shift, ...)
  int Z, mb, nb, BE, B, max_iters;
  int cs, lg_cs, F, R, tiles;  // the plan
};

// Threads a block at most (__launch_bounds__; decode/layered_qc.
// _threads_cap): 1024 where a check's row fits 8 slots, whose registers
// then fit 64 a thread with (almost) no spilling, else 512. 32 warps hide
// more of the shared-memory and transcendental latency than 16: faster on
// the CCSDS and DVB-S2 flooding legs of an H100.
__host__ __device__ constexpr int max_threads(int max_deg) {
  return max_deg != ct::kWide && max_deg <= 8 ? 1024 : 512;
}

// Items [n0, R, F] (a block-row or block-column, a row zl of this rank, a
// frame f) walked by thread tid in steps of nth as mixed-radix digits, so
// no item costs a division.
struct Walk {
  int a, zl, f, da, dzl, df, R, F;
  __device__ Walk(int start, int step, int R_, int F_) : R(R_), F(F_) {
    const int RF = R * F;
    a = start / RF;
    zl = start % RF / F;
    f = start % F;
    da = step / RF;
    dzl = step % RF / F;
    df = step % F;
  }
  __device__ __forceinline__ int zf() const { return zl * F + f; }
  __device__ __forceinline__ void next() {
    f += df;
    int c = f >= F;
    if (c) f -= F;
    zl += dzl + c;
    c = zl >= R;
    if (c) zl -= R;
    a += da + c;
  }
};

// The rows a rank's rows zl meet across a block with shift s: check
// z = zl * CS + rank reads variable qc::var_index(z, s) (inverse = false),
// variable zv = zl * CS + rank is read by check qc::check_index(zv, s)
// (inverse = true). Z is a multiple of CS, so the owner is the same rank
// for every zl and the row is zl plus an offset: circulant, t = (rank +- s)
// mod Z on rank t % CS, row (zl + t / CS) mod R; xor, rank (rank ^ s) % CS,
// row zl ^ (s / CS). `off` is in words (rows times F) for a circulant.
template <bool XOR>
__device__ __forceinline__ void meet(int rank, int s, bool inverse, int Z,
                                     int cs, int lg, int F, int& owner,
                                     int& off) {
  if constexpr (XOR) {
    owner = (rank ^ s) & (cs - 1);
    off = s >> lg;
  } else {
    int t = inverse ? rank - s : rank + s;
    if (t < 0) t += Z;
    if (t >= Z) t -= Z;
    owner = t & (cs - 1);
    off = (t >> lg) * F;
  }
}

// The word that row zl (zf = zl * F + f) meets through (base, off).
template <bool XOR>
__device__ __forceinline__ float* at(float* base, int off, int zl, int zf,
                                     int RF, int F) {
  int o;
  if constexpr (XOR) {
    o = zf + ((zl ^ off) - zl) * F;
  } else {
    o = zf + off;
    if (o >= RF) o -= RF;
  }
  return base + o;
}

// Per sweep slot of a table (column or slot, shift), for this rank: the
// first word of the rows it meets on the owning rank (R * F f32 per
// column or slot, from `region` words into each rank's dynamic shared
// memory) and the row offset.
template <bool XOR>
__device__ __forceinline__ void edges(const Args& a, const Shared& sh,
                                      int rank, const int32_t* which,
                                      const int32_t* shift, int n, int region,
                                      bool inverse, float** base, int* off) {
  const int RF = a.R * a.F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int owner, o;
    meet<XOR>(rank, shift[i], inverse, a.Z, a.cs, a.lg_cs, a.F, owner, o);
    base[i] = sh.peer[owner] + region + which[i] * RF;
    off[i] = o;
  }
}

// part[f] = 1 where a check of live frame f < nf fails on x < 0; the checks
// of this rank in every layer (lptr, and the posteriors' `edges`).
template <bool XOR, int D>
__device__ void syndrome(const Args& a, Shared& sh, const int* lptr,
                         float* const* sbase, const int* soff, int nf) {
  const int F = a.F, RF = a.R * F;
  for (Walk w(threadIdx.x, blockDim.x, a.R, F); w.a < a.mb; w.next()) {
    if (w.f >= nf) continue;
    const int s0 = lptr[w.a], d = lptr[w.a + 1] - s0, zf = w.zf();
    bool par = false;
    if constexpr (D == ct::kWide) {
      for (int j = 0; j < d; ++j)
        par ^= *at<XOR>(sbase[s0 + j], soff[s0 + j], w.zl, zf, RF, F) < 0.f;
    } else {
      float r[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < d)
          r[j] = *at<XOR>(sbase[s0 + j], soff[s0 + j], w.zl, zf, RF, F);
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < d) par ^= r[j] < 0.f;
    }
    if (par) sh.part[w.f] = 1;
  }
}

// Moves the tile's frames between [B, n] and the posteriors (rank r moves
// block-columns c = r mod CS): in, the LLRs, also to `copy` words further
// on when copy > 0; out, bits and (when asked) posteriors.
template <bool IN>
__device__ void move(const Args& a, const Shared& sh, int rank, int b0,
                     int nf, int copy) {
  const int cs = a.cs, Z = a.Z, n = a.nb * Z;
  const int ncol = (a.nb - rank + cs - 1) / cs;
  for (int i = threadIdx.x; i < nf * ncol * Z; i += blockDim.x) {
    const int z = i % Z, c = (i / Z) % ncol, f = i / (Z * ncol);
    const int col = c * cs + rank;
    float* p = sh.peer[z & (cs - 1)] + (col * a.R + (z >> a.lg_cs)) * a.F + f;
    const size_t o = (size_t)(b0 + f) * n + col * Z + z;
    if constexpr (IN) {
      const float x = a.llr[o];
      *p = x;
      if (copy) p[copy] = x;
    } else {
      const float v = *p;
      a.bits[o] = v < 0.f ? 1 : 0;
      if (a.post) a.post[o] = v;
    }
  }
}

// The LLRs in as move<true> moves them (copy 0), each rounded by q: the
// layered precision kernels' load.
__device__ __forceinline__ void move_in_rounded(const Args& a,
                                                const Shared& sh, int rank,
                                                int b0, int nf,
                                                const ct::Prec& q) {
  const int cs = a.cs, Z = a.Z, n = a.nb * Z;
  const int ncol = (a.nb - rank + cs - 1) / cs;
  for (int i = threadIdx.x; i < nf * ncol * Z; i += blockDim.x) {
    const int z = i % Z, c = (i / Z) % ncol, f = i / (Z * ncol);
    const int col = c * cs + rank;
    float* p = sh.peer[z & (cs - 1)] + (col * a.R + (z >> a.lg_cs)) * a.F + f;
    *p = q(a.llr[(size_t)(b0 + f) * n + col * Z + z]);
  }
}

// After the final syndrome's reduce: rank 0 writes ok and iterations.
__device__ __forceinline__ void results(const Args& a, const Shared& sh,
                                        int rank, int b0, int nf, bool track) {
  if (rank != 0) return;
  for (int f = threadIdx.x; f < nf; f += blockDim.x) {
    a.ok[b0 + f] = sh.flag[f] ? 0 : 1;
    a.iters[b0 + f] = track ? sh.used[f] : a.max_iters;
  }
}

// Host side: the launch of a plan (ct::max_clusters gives its occupancy).
template <class Kern, class P>
cudaError_t launch(Kern kern, const Args& a, const P& p, int clusters,
                   int threads, size_t smem, cudaStream_t st) {
  if (a.cs < 1 || a.cs > kMaxCluster || (a.cs & (a.cs - 1)) ||
      a.Z % a.cs || a.R * a.cs != a.Z || (1 << a.lg_cs) != a.cs ||
      a.F < 1 || a.F > kMaxFrames || a.tiles * a.F < a.B || a.B < 1 ||
      threads < 32 || threads > 1024 || threads < a.F || clusters < 1 ||
      a.mb < 1 || a.max_iters < 1)
    return cudaErrorInvalidValue;
  cudaError_t e = ct::prepare(kern, a.cs, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.counter, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  ct::Config c(clusters, a.cs, threads, smem, st);
  e = cudaLaunchKernelEx(&c.cfg, kern, a, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace st
