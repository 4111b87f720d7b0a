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
// Row form: runtime tables (E1), or, built with
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
// E1's runtime table (experiments/ablate.e1_table) is one word a slot and
// each row's kinds as masks, read from shared memory a step ahead, and it
// pipelines the layer step across its barrier: a slot whose block-column
// the layer before does not touch ("early"; 521 of dvbs2/64800/12's 631)
// or one with the layer before's block-column and shift ("forwarded", 87:
// the dual-diagonal parity, a row the same thread has just stored) is
// loaded before the layer before's barrier, and only the rest ("late",
// 23, in 21 of the 90 layers) after it. A slot's space is in its word, so
// an on-chip slot is a shared-memory load from a 32-bit offset.
//
// What bounds them: as K1a (csrc/layered_qc.cu), the operations (12 a
// full edge visit; bench/throughput.decode_bound) on paper, and in fact
// the layer step (loads, the row rule, stores, one barrier). Taking the
// loads off the step's critical path (E1's pipeline) did not make it
// faster, so what is left is the instruction stream and its stalls, not
// split; these variants measure what each part of that step costs.

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
// when `zero`), out the same words in HBM, word stride ws. With PAD the
// caller has set r[j] = +inf past the degree, so every slot runs the rule
// without a branch: +inf (less a finite message) moves neither minimum
// nor the sign product, and the caller drops those slots' posteriors.
template <int DEG, int FL, bool PAD = false>
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
    if (PAD || j < d) {
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
    if (PAD || j < d) {
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

// E1: runtime row tables, the layer step pipelined across its barrier.
// Its table (experiments/ablate.e1_table) holds kRowWords words a layer:
// one a slot (the shift times F, bits 0-10; the block-column's slot,
// 11-21; the space, 22: the L2 scratch; the kind, 23-24: 1 early, 2
// forwarded, 3 late; zero past the degree), then the row's degree and its
// early, forwarded and late slots as masks (bits 0-3, 8-15, 16-23, 24-31:
// bit j is slot j), and its slots in the L2 scratch as a mask.
constexpr int kRowWords = 12;  // 8 slots, 2 masks, 2 pad: three uint4

// A predicated load of a slot's posterior (`p` nonzero) through a 32-bit
// shared-memory address (LDS), with no branch
__device__ __forceinline__ void lds_if(float& x, uint32_t addr, uint32_t p) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.shared.f32 %0, [%1];\n\t}"
      : "+f"(x) : "r"(addr), "r"(p) : "memory");
}

// One layer's row in registers: its two mask words, each item's word
// offsets in the slots' spaces, and the posteriors read
template <int DEG, int IT>
struct Row {
  uint32_t kinds, spill;
  int o[IT][DEG];
  float x[IT][DEG];
};

// Items 0..IT-1 of a thread are i = tid + it * blockDim.x: check zl = i / F
// of frame i % F, the same in every layer. A layer step g (layer L of
// sweep g / mb) holds its row in registers, read during step g - 1 with
// its slots' posteriors, and then:
//   starts the copy of the next step's check-state slab (cp.async into
//   the other of two buffers);
//   reloads its late slots, whose block-columns the layer before wrote at
//   another shift (the first step of a tile has read every slot after the
//   tile's barrier);
//   reads the next row from shared memory and works out its offsets;
//   runs the row rule and stores every slot;
//   loads every slot of the next row: an early slot's block-column is not
//   this layer's, a forwarded slot's row is the one this thread has just
//   stored, and a late slot's value is replaced after the barrier;
//   waits for the slab and takes the one barrier.
// So no table entry and no early or forwarded slot is read after the
// barrier: only the late slots (23 of dvbs2/64800/12's 631, in 21 of its
// 90 layers), and the check state from the slab copied before it. Every
// predicate, select or branch a slot takes is issued by every warp in
// every step, so the step carries none it can drop: the slots past the
// degree run the rule as +inf (check's PAD), the next row's loads are not
// predicated, and a row with a slot in the L2 scratch takes generic
// accesses, the others shared-memory ones, one uniform branch a row. Two
// steps a turn alternate the two rows' registers.
template <int DEG, int FL, int IT>
__global__ void __launch_bounds__(512, 1) ablate_kernel(Args a) {
  constexpr bool ROLL = FL & kRoll, SUB = FL & kSub;
  static_assert(DEG == 8, "a row holds 8 slot words");
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, mb = a.mb, RF = a.Z * F, stride = a.stride;
  float* post = reinterpret_cast<float*>(smem);  // [nchip * Z * F]
  uint32_t* buf = reinterpret_cast<uint32_t*>(
      post + ((a.nchip * RF + 3) & ~3));                   // [2][stride]
  uint32_t* rows = buf + 2 * stride;                       // [mb][kRowWords]
  int* home = reinterpret_cast<int*>(rows + mb * kRowWords);  // [nb]
  const uint32_t post_s = ct::smem_u32(post);
  const int tid = threadIdx.x, nth = blockDim.x;
  uint32_t* state = a.state + (size_t)blockIdx.x * mb * stride;
  float* spill = a.spill + (size_t)blockIdx.x * (a.nb - a.nchip) * RF;
  for (int i = tid; i < mb * kRowWords; i += nth)
    rows[i] = static_cast<uint32_t>(a.tab[i]);
  for (int i = tid; i < a.nb; i += nth) home[i] = a.home[i];
  const int G = a.iters * mb;
  int item[IT], frame[IT], at[IT];  // at: the item, 0 where it is idle
  bool act[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    item[it] = tid + it * nth;
    frame[it] = item[it] % F;
  }
  // row L's masks and offsets into r
  auto read_row = [&](Row<DEG, IT>& r, int L) {
    const uint4* src = reinterpret_cast<const uint4*>(rows + L * kRowWords);
    const uint4 q0 = src[0], q1 = src[1], q2 = src[2];
    const uint32_t w[DEG] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    r.kinds = q2.x;
    r.spill = q2.y;
#pragma unroll
    for (int j = 0; j < DEG; ++j) {
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        int o = at[it];
        if constexpr (ROLL) {
          o += (int)(w[j] & 0x7FF);
          o = o >= RF ? o - RF : o;
        }
        r.o[it][j] = (int)((w[j] >> 11) & 0x7FF) * RF + o;
      }
    }
  };
  // every slot's posterior, or (`late`) the late slots'
  auto load = [&](Row<DEG, IT>& r, bool late) {
    if (r.spill) {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
#pragma unroll
        for (int it = 0; it < IT; ++it)
          if (!late || (r.kinds >> (24 + j)) & 1)
            r.x[it][j] =
                *((r.spill & (1u << j) ? spill : post) + r.o[it][j]);
    } else if (late) {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
#pragma unroll
        for (int it = 0; it < IT; ++it)
          lds_if(r.x[it][j], post_s + 4u * r.o[it][j],
                 r.kinds & (1u << (24 + j)));
    } else {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
#pragma unroll
        for (int it = 0; it < IT; ++it) r.x[it][j] = post[r.o[it][j]];
    }
  };
  // the check-state slab of step g into buffer g % 2 (none in iteration 0)
  auto prefetch_state = [&](int g, int L) {
    if (SUB && g >= mb && g < G) {
      const uint32_t* src = state + (size_t)L * stride;
      const uint32_t dst = ct::smem_u32(buf) + 4u * (g & 1) * stride;
      for (int w = 4 * tid; w < stride; w += 4 * nth)
        ct::cp_async16(dst + 4u * w, src + w);
    }
  };
  auto step = [&](int g, int L, Row<DEG, IT>& cur, Row<DEG, IT>& nxt) {
    const int Ln = L + 1 == mb ? 0 : L + 1;
    const bool more = g + 1 < G;
    const int d = (int)(cur.kinds & 15);
    prefetch_state(g + 1, Ln);
    if (g > 0 && cur.kinds >> 24) load(cur, true);
    if (more) read_row(nxt, Ln);
    const uint32_t* old = buf + (g & 1) * stride;
    uint32_t* out = state + (size_t)L * stride;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
        cur.x[it][j] = j < d ? cur.x[it][j] : INFINITY;
      if (act[it])
        check<DEG, FL, true>(cur.x[it], d, old + item[it], g < mb,
                             out + item[it], RF, a.alpha);
    }
    if (cur.spill) {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
#pragma unroll
        for (int it = 0; it < IT; ++it)
          if (act[it] && j < d)
            *((cur.spill & (1u << j) ? spill : post) + cur.o[it][j]) =
                cur.x[it][j];
    } else {
#pragma unroll
      for (int j = 0; j < DEG; ++j)
#pragma unroll
        for (int it = 0; it < IT; ++it)
          if (act[it] && j < d) post[cur.o[it][j]] = cur.x[it][j];
    }
    if (more) load(nxt, false);
    ct::cp_async_wait_all();
    __syncthreads();
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int b0 = tile * F, nf = min(F, a.B - b0);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      act[it] = item[it] < RF && frame[it] < nf;
      at[it] = act[it] ? item[it] : 0;
    }
    __syncthreads();  // the tables (first tile), the last tile's stores
    load_tile(a, post, spill, home, b0, nf);
    __syncthreads();
    Row<DEG, IT> r0, r1;
    if (G > 0) {
      read_row(r0, 0);
      load(r0, false);  // the first step reads every slot here
    }
    // two steps a turn, each row's registers in turn the current and the
    // next
    int L = 0;
#pragma unroll 1
    for (int g = 0; g < G; g += 2) {
      step(g, L, r0, r1);
      L = L + 1 == mb ? 0 : L + 1;
      if (g + 1 < G) {
        step(g + 1, L, r1, r0);
        L = L + 1 == mb ? 0 : L + 1;
      }
    }
    store_tile(a, post, spill, home, b0, nf);
  }
}

// E1's variants (experiments/variants.py E1_VARIANTS)
#define ABLATE_E1_FLAGS(X) X(127) X(126) X(125) X(123) X(119) X(111) X(96)

using Kern = void (*)(Args);

template <int DEG, int IT>
Kern pick_flags(int flags) {
#define ABLATE_CASE(FL) \
  if (flags == FL) return ablate_kernel<DEG, FL, IT>;
  ABLATE_E1_FLAGS(ABLATE_CASE)
#undef ABLATE_CASE
  return nullptr;
}

// rows of up to 8 slots (dvbs2/64800/12 has 7 and 8), one or two items a
// thread
Kern pick(int dcb_max, int flags, int items) {
  if (dcb_max > 8) return nullptr;
  if (items == 1) return pick_flags<8, 1>(flags);
  if (items == 2) return pick_flags<8, 2>(flags);
  return nullptr;
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
// stride words, spill blocks * (nb - nchip) * Z * F floats. The dynamic
// library takes E1's row table in `tab` (experiments/ablate.e1_table, mb
// * 8 words) and one or two items a thread; a static library takes only
// its own flags and its code's shapes (F = 1), and reads no table. post
// may be null. Returns a cudaError_t (0 on a successful launch).
int ablate_layered_decode(void* llr, void* bits, void* post, void* state,
                          void* spill, void* home, void* tab, int Z, int mb,
                          int nb, int BE, int B, int iters, int dcb_max,
                          int flags, int F, int tiles, int stride, int nchip,
                          int threads, int smem, int blocks, float alpha,
                          void* stream) {
  if (B < 1 || iters < 0 || mb < 2 || F < 1 || F > 64 || tiles * F < B ||
      stride % 4 || threads < 32 || threads > 512 || blocks < 1 ||
      nchip < 0 || nchip > nb)
    return (int)cudaErrorInvalidValue;
#ifdef ABLATE_STATIC_FLAGS
  Kern kern = pick(dcb_max, flags);
  if (!kern || Z != kStaticZ || mb != kStaticMb || nb != kStaticNb ||
      BE != kStaticBE || nchip != kStaticChip || F != 1 ||
      stride != kStaticStride)
    return (int)cudaErrorInvalidValue;
#else
  const int items = (Z * F + threads - 1) / threads;
  Kern kern = pick(dcb_max, flags, items);
  const long need = 4l * ((nchip * Z * F + 3) & ~3) + 8l * stride +
                    4l * mb * kRowWords + 4l * nb;
  if (!kern || Z * F > 2048 || nb > 2048 || stride < 3 * Z * F ||
      smem < need)
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
