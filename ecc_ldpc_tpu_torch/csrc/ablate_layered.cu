// K1a's fixed-iteration layered min-sum with its costs removed one at a
// time, for Hopper: the ablation kernels E1, E2 and E3.
//
// Replaces experiments/ablate_layered.py::_kernel (:33, its pallas_call
// :116; runtime row tables, E1), experiments/ablate_layered2.py::_kernel
// (:37, :113; static rows, E2) and experiments/static_unroll.py::
// _kernel_static (:38, :108; the fully static sweep, E3). The caller is
// ecc_ldpc_tpu_torch/experiments/ablate.py, whose plain PyTorch version
// (ablate_plain) these kernels must match bit for bit: bits and final
// posteriors.
//
// The frame is K1a's at its cluster-of-one plan, the one the headline
// runs (csrc/cluster_tile.cuh's ct::decode_tiles, restated here for the
// fixed-iteration path without its syndrome and track mode: the roll flag
// removes index arithmetic inside its layer loop and the static form
// replaces that loop, and the shared header stays as it is, so the
// production kernels keep their code): a tile of F frames
// keeps its f32 posteriors in one block's shared memory for the whole
// decode, the block-columns that do not fit in an L2 scratch (`spill`,
// home[col] = -1 - j; decode/layered_qc.column_homes), check z reads row
// (z + s) mod Z of its block-column (the TPU's roll), and the check state
// is K1a's three words a check (mag1, mag2, the signs and the slot of
// mag2) in HBM slabs, prefetched a layer ahead with cp.async. The row
// rule (`check`) is K1a's Minsum::update with bf16 message storage (its
// precision library's kind 1: the stored magnitudes rounded to bf16,
// which is the bf16 C_s of the TPU kernels, since the rounding is odd),
// in fixed-iteration mode, with no syndrome and no ok. The kernels skip
// the decode's entry and exit rotations as the TPU scripts do; the
// wrapper maps the TPU's delta-shift planes onto variables and back.
//
// The flags (template parameter FL), each what its TPU flag removed:
//   kRoll   the circulant index (z + s) mod Z: off, check z reads row z
//   kSign   the sign-bit XOR: off, every message is its magnitude
//   kMin2   the second-minimum tournament: off, every message is mag1
//   kVrow   the row values kept between the two passes: off, pass 2 takes
//           min1 for every slot's extrinsic value (so every slot's message
//           is one magnitude; the state stores it twice)
//   kCastq  the posterior takes the bf16-rounded message (E1 castq_on,
//           E3); off, the unrounded one (E1 nocastq, every E2 variant).
//           The stored messages are bf16 either way.
//   kSub    the old-message subtract (and its prefetch): off, a check reads
//           the bare posteriors (E2 nosub)
//   kCap    the magnitude cap min(m, 1e12) (E1 only)
// E1's variants keep kSub and kCap, E2's and E3's drop kCap.
//
// Row form: runtime tables (E1; the slot's column base and row offset in
// shared memory, read per slot, as K1a reads them), or, built with
// ABLATE_STATIC_FLAGS, compile-time tables made from the rows of
// dvbs2/64800/12 in the generated csrc/ablate_static_dvbs2_64800_12.cuh,
// with the code's shapes (Z, the layer count, the state stride, one frame
// a tile) as constants. Each row has a shape: its degree, which of its
// slots' columns are in the L2 scratch, which shifts are 0. The sweep is a
// rolled loop over the layers that runs, for each, the body compiled for
// its row's shape (10 shapes on this code), the slots unrolled in it, so
// that a slot is a shared-memory or an L2 access as the shape says and a
// zero shift costs nothing; each slot's column offset and shift come from
// a __constant__ table built at compile time, read a layer ahead into
// registers. The body stays in the SM's instruction caches: about 4.7k
// instructions for full, where the sweep unrolled layer by layer, every
// home and shift an immediate, was some 37k and ran 2.1x slower on an
// H100. Each
// static instance is a library of its own (ecc_ldpc_tpu_torch/_build.py),
// so they build in parallel.
//
// What bounds them: as K1a (csrc/layered_qc.cu), the operations (12 a
// full edge visit; bench/throughput.decode_bound) on paper, and the
// latency of a layer step (loads, the row rule, stores, one barrier) in
// fact; these variants measure what each part of that step costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_tile.cuh"  // ct::cp_async16, ct::smem_u32, ct::cp_async_wait_all

#ifdef ABLATE_STATIC_FLAGS
#include "ablate_static_dvbs2_64800_12.cuh"
#endif

namespace {

enum : int {
  kRoll = 1, kSignF = 2, kMin2 = 4, kVrow = 8, kCastq = 16, kSub = 32,
  kCap = 64
};
constexpr unsigned kSign = 0x80000000u;
constexpr float kMagCap = 1e12f;

struct Args {
  const float* llr;      // [B, n] in: LLRs on the variables
  uint8_t* bits;         // [B, n] out: hard decisions (v < 0)
  float* post;           // [B, n] out: final posteriors, or null
  uint32_t* state;       // [blocks, mb, stride] scratch: check state
  float* spill;          // [blocks, nb - nchip, Z, F] scratch
  const int32_t* home;   // [nb] column -> on-chip slot, or -1 - spill slot
  const int32_t* tab;    // [mb+1 | BE | BE] layer_ptr, column, shift
  int Z, mb, nb, BE, B, iters;
  int F, tiles, stride, nchip;  // the plan
  float alpha;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One check of degree d (<= DEG): r holds its d posteriors in and its new
// posteriors out; old its state words in the prefetched slab (all zeros
// when `zero`), out the same words in HBM, word stride ws.
template <int DEG, int FL>
__device__ __forceinline__ void check(float (&r)[DEG], int d,
                                      const uint32_t* old, bool zero,
                                      uint32_t* out, int ws, float alpha) {
  constexpr bool SIGN = FL & kSignF, MIN2 = FL & kMin2, VROW = FL & kVrow,
                 CASTQ = FL & kCastq, SUB = FL & kSub, CAP = FL & kCap;
  static_assert(DEG <= 16, "the state's third word holds 16 signs");
  uint32_t old1 = 0, old2 = 0, oldw = 0;
  if (SUB && !zero) {
    old1 = old[0];
    old2 = old[ws];
    oldw = old[2 * ws];
  }
  const int oldslot = (int)(oldw >> 16);
  float min1 = INFINITY, min2 = INFINITY;
  unsigned sg = 0;
  // pass 1: extrinsic inputs, running two-min, sign-bit product
#pragma unroll
  for (int j = 0; j < DEG; ++j) {
    if (j < d) {
      float x = r[j];
      if constexpr (SUB) {
        const float cv = __uint_as_float((j == oldslot ? old2 : old1) |
                                         (((oldw >> j) & 1u) << 31));
        x = __fsub_rn(x, cv);
        r[j] = x;
      }
      const float ax = fabsf(x);
      if constexpr (MIN2) min2 = fminf(min2, fmaxf(min1, ax));
      min1 = fminf(min1, ax);
      if constexpr (SIGN) sg ^= __float_as_uint(x);
    }
  }
  const float mag1 = __fmul_rn(alpha, CAP ? fminf(min1, kMagCap) : min1);
  float mag2 = mag1;
  if constexpr (MIN2)
    mag2 = __fmul_rn(alpha, CAP ? fminf(min2, kMagCap) : min2);
  const float q1 = bf16_round(mag1), q2 = bf16_round(mag2);
  const float p1 = CASTQ ? q1 : mag1, p2 = CASTQ ? q2 : mag2;
  // pass 2: messages out, posteriors as v + Cnew
  uint32_t newsg = 0;
  int slot = -1;
#pragma unroll
  for (int j = 0; j < DEG; ++j) {
    if (j < d) {
      const float v = VROW ? r[j] : min1;
      bool is_min = false;
      if constexpr (MIN2) {
        is_min = fabsf(v) == min1;
        if (is_min && slot < 0) slot = j;
      }
      uint32_t neg = 0;
      if constexpr (SIGN) neg = (sg ^ __float_as_uint(v)) & kSign;
      newsg |= (neg >> 31) << j;
      const float cn = __uint_as_float(__float_as_uint(is_min ? p2 : p1) | neg);
      r[j] = __fadd_rn(v, cn);
    }
  }
  // slot j's message is (j == slot ? q2 : q1) with sign bit j; without the
  // row values every slot took one magnitude, q2 with the tournament
  uint32_t w1 = __float_as_uint(q1), w2 = __float_as_uint(q2);
  if constexpr (!VROW && MIN2) w1 = w2;
  out[0] = w1;
  out[ws] = w2;
  out[2 * ws] = newsg | ((uint32_t)slot << 16);
}

// Prefetch the check-state slab of layer step g + 1 into buffer (g + 1) % 2
// (none for a step of iteration 0, all zeros, or past the last)
__device__ __forceinline__ void prefetch(const uint32_t* state, uint32_t* buf,
                                         int stride, int mb, int iters,
                                         int g) {
  const int tn = (g + 1) / mb;
  if (tn >= 1 && tn < iters) {
    const uint32_t* src = state + (size_t)((g + 1) % mb) * stride;
    const uint32_t dst = ct::smem_u32(buf) + 4u * ((g + 1) % 2) * stride;
    for (int w = 4 * threadIdx.x; w < stride; w += 4 * blockDim.x)
      ct::cp_async16(dst + 4u * w, src + w);
  }
}

// The posterior of row z of block-column col, frame f
__device__ __forceinline__ float* var_at(const Args& a, float* post,
                                         float* spill, const int* home,
                                         int col, int z, int f) {
  const int h = home[col];
  return h >= 0 ? post + (h * a.Z + z) * a.F + f
                : spill + ((-1 - h) * a.Z + z) * a.F + f;
}

// A tile's LLRs in, and its bits (and posteriors) out, for both row forms
__device__ __forceinline__ void load_tile(const Args& a, float* post,
                                          float* spill, const int* home,
                                          int b0, int nf) {
  const int n = a.nb * a.Z;
  for (int i = threadIdx.x; i < nf * n; i += blockDim.x) {
    const int z = i % a.Z, col = (i / a.Z) % a.nb, f = i / n;
    *var_at(a, post, spill, home, col, z, f) =
        a.llr[(size_t)(b0 + f) * n + col * a.Z + z];
  }
}

__device__ __forceinline__ void store_tile(const Args& a, float* post,
                                           float* spill, const int* home,
                                           int b0, int nf) {
  const int n = a.nb * a.Z;
  for (int i = threadIdx.x; i < nf * n; i += blockDim.x) {
    const int z = i % a.Z, col = (i / a.Z) % a.nb, f = i / n;
    const float v = *var_at(a, post, spill, home, col, z, f);
    const size_t o = (size_t)(b0 + f) * n + col * a.Z + z;
    a.bits[o] = v < 0.f ? 1 : 0;
    if (a.post) a.post[o] = v;
  }
}

#ifndef ABLATE_STATIC_FLAGS

// E1: runtime row tables, as K1a
template <int DEG, int FL>
__global__ void __launch_bounds__(512, 1) ablate_kernel(Args a) {
  constexpr bool ROLL = FL & kRoll, SUB = FL & kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, mb = a.mb, BE = a.BE, RF = a.Z * F;
  float* post = reinterpret_cast<float*>(smem);  // [nchip * Z * F]
  uint32_t* buf = reinterpret_cast<uint32_t*>(post + ((a.nchip * RF + 3) & ~3));
  float** sbase = reinterpret_cast<float**>(buf + 2 * a.stride);  // [BE]
  int* soff = reinterpret_cast<int*>(sbase + BE);                  // [BE]
  int* lptr = soff + BE;                                           // [mb + 1]
  int* home = lptr + mb + 1;                                       // [nb]
  const int tid = threadIdx.x, nth = blockDim.x;
  uint32_t* state = a.state + (size_t)blockIdx.x * mb * a.stride;
  float* spill = a.spill + (size_t)blockIdx.x * (a.nb - a.nchip) * RF;
  for (int i = tid; i <= mb; i += nth) lptr[i] = a.tab[i];
  for (int i = tid; i < a.nb; i += nth) home[i] = a.home[i];
  __syncthreads();
  for (int i = tid; i < BE; i += nth) {
    const int h = home[a.tab[mb + 1 + i]];
    sbase[i] = h >= 0 ? post + h * RF : spill + (-1 - h) * RF;
    soff[i] = a.tab[mb + 1 + BE + i] * F;
  }
  __syncthreads();
  // item i is check zl = i / F of frame f = i % F (K1a's split)
  const float inv_f = 1.f / F;
  auto split = [&](int i) {
    int zl = __float2int_rz((i + 0.5f) * inv_f);
    int f = i - zl * F;
    if (f < 0) f += F;
    else if (f >= F) f -= F;
    return f;
  };
  auto edge = [&](int s, int i) -> float* {
    int o = i;
    if constexpr (ROLL) {
      o += soff[s];
      if (o >= RF) o -= RF;
    }
    return sbase[s] + o;
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b0 = tile * F, nf = min(F, a.B - b0);
    load_tile(a, post, spill, home, b0, nf);
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < a.iters; ++t) {
      for (int L = 0; L < mb; ++L) {
        const int g = t * mb + L;
        if constexpr (SUB) prefetch(state, buf, a.stride, mb, a.iters, g);
        const int s0 = lptr[L], d = lptr[L + 1] - s0;
        const uint32_t* old = buf + (g % 2) * a.stride;
        uint32_t* out = state + (size_t)L * a.stride;
        for (int i = tid; i < RF; i += nth) {
          if (split(i) >= nf) continue;
          float* p[DEG];
          float r[DEG];
#pragma unroll
          for (int j = 0; j < DEG; ++j) {
            if (j < d) {
              p[j] = edge(s0 + j, i);
              r[j] = *p[j];
            }
          }
          check<DEG, FL>(r, d, old + i, t == 0, out + i, RF, a.alpha);
#pragma unroll
          for (int j = 0; j < DEG; ++j)
            if (j < d) *p[j] = r[j];
        }
        ct::cp_async_wait_all();
        __syncthreads();
      }
    }
    store_tile(a, post, spill, home, b0, nf);
    __syncthreads();
  }
}

// E1's variants (experiments/variants.py E1_VARIANTS)
#define ABLATE_E1_FLAGS(X) X(127) X(126) X(125) X(123) X(119) X(111) X(96)

using Kern = void (*)(Args);

template <int DEG>
Kern pick_flags(int flags) {
#define ABLATE_CASE(FL) \
  if (flags == FL) return ablate_kernel<DEG, FL>;
  ABLATE_E1_FLAGS(ABLATE_CASE)
#undef ABLATE_CASE
  return nullptr;
}

// rows of up to 8 slots (dvbs2/64800/12 has 7)
Kern pick(int dcb_max, int flags) {
  return dcb_max <= 8 ? pick_flags<8>(flags) : nullptr;
}

#else  // the static row form: one instance, ABLATE_STATIC_FLAGS

// The header's rows at compile time, as it lists them: layer, degree, and
// the slots' (home, shift) pairs in slot order, zeros past the degree
struct HeaderRow {
  int L, d;
  int hs[2 * kStaticDeg];
};
#define ABLATE_HROW(L, D, ...) {L, D, {__VA_ARGS__}},
constexpr HeaderRow kHeader[kStaticMb] = {ABLATE_STATIC_ROWS(ABLATE_HROW)};
#undef ABLATE_HROW
static_assert(kStaticDeg <= 8, "a shape holds 8 slots' bits");

// A row's shape, which its body is compiled for: the degree (bits 0-3),
// the slots whose column is in the L2 scratch (bits 4-11) and the slots of
// shift 0 (bits 12-19)
__host__ __device__ constexpr unsigned shape_of(int L) {
  unsigned key = (unsigned)kHeader[L].d;
  for (int j = 0; j < kHeader[L].d; ++j) {
    if (kHeader[L].hs[2 * j] < 0) key |= 1u << (4 + j);
    if (kHeader[L].hs[2 * j + 1] == 0) key |= 1u << (12 + j);
  }
  return key;
}

// The code's distinct shapes, in sweep order of first use
struct Shapes {
  int n;
  unsigned key[kStaticMb];
};
__host__ __device__ constexpr Shapes static_shapes() {
  Shapes s{0, {}};
  for (int L = 0; L < kStaticMb; ++L) {
    const unsigned key = shape_of(L);
    bool seen = false;
    for (int i = 0; i < s.n; ++i) seen = seen || s.key[i] == key;
    if (!seen) s.key[s.n++] = key;
  }
  return s;
}
__host__ __device__ constexpr unsigned shape_key(int i) {
  return static_shapes().key[i];
}
constexpr int kShapes = static_shapes().n;

// The rows as the kernel reads them, from the constant bank: each layer's
// shape (an index into static_shapes), and each slot's column (its first
// row's byte offset in the on-chip posteriors or in the L2 scratch) and
// shift
struct StaticRow {
  int shape;
  int off[kStaticDeg];
  int shift[kStaticDeg];
};
struct StaticRows {
  StaticRow r[kStaticMb];
};
__host__ __device__ constexpr StaticRows static_rows() {
  const Shapes s = static_shapes();
  StaticRows t{};
  for (int L = 0; L < kStaticMb; ++L) {
    for (int i = 0; i < s.n; ++i)
      if (s.key[i] == shape_of(L)) t.r[L].shape = i;
    for (int j = 0; j < kHeader[L].d; ++j) {
      const int home = kHeader[L].hs[2 * j];
      t.r[L].off[j] = (home >= 0 ? home : -1 - home) * kStaticZ * 4;
      t.r[L].shift[j] = kHeader[L].hs[2 * j + 1];
    }
  }
  return t;
}
__constant__ StaticRows kRows = static_rows();

__host__ __device__ constexpr bool rows_in_sweep_order() {
  for (int L = 0; L < kStaticMb; ++L)
    if (kHeader[L].L != L) return false;
  return true;
}
static_assert(rows_in_sweep_order(), "the header's rows are layers 0, 1, ...");

// Layer L of sweep t, of shape KEY, for the tile's one frame (F = 1) at
// Z = kStaticZ: whether each slot's column is on chip or in the L2
// scratch, and whether its shift is 0, are compile-time; its offset and
// shift come from its row of kRows (in registers)
template <int FL, unsigned KEY>
__device__ __forceinline__ void static_layer(const StaticRow& row,
                                             float* post, float* spill,
                                             uint32_t* buf, uint32_t* state,
                                             int iters, float alpha, int t,
                                             int L) {
  constexpr bool ROLL = FL & kRoll, SUB = FL & kSub;
  constexpr int Z = kStaticZ, MB = kStaticMb, stride = kStaticStride;
  constexpr int D = KEY & 15;
  const int g = t * MB + L;
  if constexpr (SUB) prefetch(state, buf, stride, MB, iters, g);
  const uint32_t* old = buf + (g % 2) * stride;
  uint32_t* out = state + (size_t)L * stride;
  for (int i = threadIdx.x; i < Z; i += blockDim.x) {
    float* p[D];
    float r[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      int zz = i;
      if (ROLL && !((KEY >> (12 + j)) & 1)) {
        zz += row.shift[j];
        if (zz >= Z) zz -= Z;
      }
      p[j] = reinterpret_cast<float*>(
          reinterpret_cast<char*>(((KEY >> (4 + j)) & 1 ? spill : post) + zz) +
          row.off[j]);
      r[j] = *p[j];
    }
    check<D, FL>(r, D, old + i, t == 0, out + i, Z, alpha);
#pragma unroll
    for (int j = 0; j < D; ++j) *p[j] = r[j];
  }
}

// static_layer of the row's shape: one body for each shape the code has
template <int FL, int I = 0>
__device__ __forceinline__ void static_step(const StaticRow& row,
                                            float* post, float* spill,
                                            uint32_t* buf, uint32_t* state,
                                            int iters, float alpha, int t,
                                            int L) {
  if constexpr (I < kShapes) {
    if (row.shape == I) {
      static_layer<FL, shape_key(I)>(row, post, spill, buf, state, iters,
                                     alpha, t, L);
      return;
    }
    static_step<FL, I + 1>(row, post, spill, buf, state, iters, alpha, t,
                           L);
  }
}

// The sweep is a rolled loop over the layers, the slots unrolled to the
// row's degree
template <int FL>
__global__ void __launch_bounds__(512, 1) ablate_static_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* post = reinterpret_cast<float*>(smem);  // [kStaticChip * Z]
  uint32_t* buf = reinterpret_cast<uint32_t*>(
      post + ((kStaticChip * kStaticZ + 3) & ~3));
  int* home = reinterpret_cast<int*>(buf + 2 * kStaticStride);  // [nb]
  uint32_t* state = a.state + (size_t)blockIdx.x * kStaticMb * kStaticStride;
  float* spill =
      a.spill + (size_t)blockIdx.x * (kStaticNb - kStaticChip) * kStaticZ;
  asm("" : "+l"(spill));  // kept in registers, not recomputed a slot
  const int iters = a.iters;
  const float alpha = a.alpha;
  for (int i = threadIdx.x; i < kStaticNb; i += blockDim.x)
    home[i] = a.home[i];
  __syncthreads();
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    load_tile(a, post, spill, home, tile, 1);
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < iters; ++t) {
      // each layer's row is read a layer ahead, so that its loads wait
      // behind the layer before and not after its barrier
      StaticRow next = kRows.r[0];
#pragma unroll 1
      for (int L = 0; L < kStaticMb; ++L) {
        const StaticRow row = next;
        next = kRows.r[L + 1 < kStaticMb ? L + 1 : 0];
        static_step<FL>(row, post, spill, buf, state, iters, alpha, t, L);
        ct::cp_async_wait_all();
        __syncthreads();
      }
    }
    store_tile(a, post, spill, home, tile, 1);
    __syncthreads();
  }
}

using Kern = void (*)(Args);

Kern pick(int dcb_max, int flags) {
  return dcb_max == kStaticDeg && flags == ABLATE_STATIC_FLAGS
             ? ablate_static_kernel<ABLATE_STATIC_FLAGS>
             : nullptr;
}

#endif

}  // namespace

extern "C" {

// Decodes llr [B, n] with the variant `flags` by the cluster-of-one tile
// plan (F, tiles, stride, nchip, threads, smem; experiments/ablate.py
// ablate_plan) on `blocks` persistent blocks; state holds blocks * mb *
// stride words, spill blocks * (nb - nchip) * Z * F floats. A static
// library takes only its own flags and its code's shapes (F = 1). post
// may be null. Returns a cudaError_t (0 on a successful launch).
int ablate_layered_decode(void* llr, void* bits, void* post, void* state,
                          void* spill, void* home, void* tab, int Z, int mb,
                          int nb, int BE, int B, int iters, int dcb_max,
                          int flags, int F, int tiles, int stride, int nchip,
                          int threads, int smem, int blocks, float alpha,
                          void* stream) {
  Kern kern = pick(dcb_max, flags);
  if (!kern || B < 1 || iters < 0 || mb < 2 || F < 1 || F > 64 ||
      tiles * F < B || stride % 4 || threads < 32 || threads > 512 ||
      blocks < 1 || nchip < 0 || nchip > nb)
    return (int)cudaErrorInvalidValue;
#ifdef ABLATE_STATIC_FLAGS
  if (Z != kStaticZ || mb != kStaticMb || nb != kStaticNb ||
      BE != kStaticBE || nchip != kStaticChip || F != 1 ||
      stride != kStaticStride)
    return (int)cudaErrorInvalidValue;
#endif
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<uint8_t*>(bits);
  a.post = static_cast<float*>(post);
  a.state = static_cast<uint32_t*>(state);
  a.spill = static_cast<float*>(spill);
  a.home = static_cast<const int32_t*>(home);
  a.tab = static_cast<const int32_t*>(tab);
  a.Z = Z; a.mb = mb; a.nb = nb; a.BE = BE; a.B = B; a.iters = iters;
  a.F = F; a.tiles = tiles; a.stride = stride; a.nchip = nchip;
  a.alpha = alpha;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* ablate_layered_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
