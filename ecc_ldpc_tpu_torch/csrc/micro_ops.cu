// Per-op micro-benchmarks of the vector units, for Hopper (E5, E6, E7).
//
// Replaces experiments/micro_vpu.py::_ew_kernel (:29, its pallas_call
// :73), ::_roll_kernel (:45, :92) and experiments/micro_vpu2.py::
// make_kernel's kernel (:26, :66). The caller is
// ecc_ldpc_tpu_torch/experiments/micro.py, whose plain PyTorch versions
// these kernels must match bit for bit.
//
//   ew    x <- min(x, |x - 1|) + 1, inner * reps dependent steps a word,
//         x read as f32 and converted to the dtype first, written back as
//         f32 (E5).
//   roll  x <- roll(x, s[i % 8], axis 0), inner * reps steps over the
//         whole [Z, L] array (E6): out[z] = x[(z - s) mod Z], as jnp.roll.
//   op    four independent chains x_i <- op(x_i, b), x_i = a + i, summed
//         as ((x0 + x1) + x2) + x3 in the dtype, written as f32 (E7).
//
// A thread's item is one 32-bit word: one f32 or int32, or a packed pair
// of bf16, f16 or int16, or four int8. The 16- and 8-bit types use
// Hopper's packed forms: __hsub2/__hadd2/__hmul2/__habs2/__hmin2 on
// __nv_bfloat162 and __half2 (one instruction for two lanes, rounded to
// the type after every op, as the TPU kernel's types say), and the SIMD
// intrinsics __vsub2/__vadd2/__vabs2/__vmins2 on int16x2 and
// __vsub4/__vadd4/__vabs4/__vmins4 on int8x4. __vabs2 and __vabs4 wrap
// (|-32768| = -32768, as jnp.abs and torch.abs do), where __vabsss2
// would saturate. E7's bf16 compare-select has no packed form here (a
// compare of two bf16x2 gives 0/1 values, not a lane mask): its two lanes
// compare and select as scalar bf16. int32 add, subtract and multiply run
// in unsigned arithmetic, so their overflow wraps as XLA's and PyTorch's
// do (signed overflow is undefined in C++). Built with -fmad=false: no
// multiply-add is fused. Every chain's value passes an empty asm after
// every step (`keep`), so the compiler cannot fold a chain (min(min(x, b),
// b) is min(x, b), and an int32 add chain is x + n * b in closed form):
// every step is issued, as on the TPU. It emits no instruction.
//
// The roll gives each warp strips of whole word-columns: the rotation is
// along Z, so a strip of one 32-bit word-column across all Z rows never
// needs a word from outside its warp (packing lanes along L costs nothing),
// and no step has a block-wide barrier. In registers (Z <= 384 and every
// shift below 32 rows mod Z): lane l holds rows l + 32 k, k < K = ceil(Z /
// 32), of each of its warp's S strips. For a shift s, slot k of lane l
// takes __shfl_sync(slot k, (l - s) & 31) where l >= s, and the previous
// slot's shuffle where l < s; slot 0's lanes l < s wrap to rows Z - s + l,
// which one more shuffle brings from lane (l - s + Z) & 31, whose sent word
// is its last slot's where that slot holds its row (lane < Z - 32 (K - 1))
// and the slot before's otherwise. So a step is K + 1 shuffles and K
// selects a strip. Otherwise (a longer Z, a longer shift) a warp owns one
// strip in two buffers of its own shared memory, a load and a store a word
// a step behind a __syncwarp(). experiments/micro.roll_plan picks the route,
// S and the grid (one wave where the registers allow), roll_source is the
// register route's source map in Python. Every step is issued: `keep` after
// each, so nvcc cannot fold the chain into one rotation.
//
// What bounds them: the issue of the ops (ew, op: one slot an op a word,
// four warp instructions a clock an SM; experiments/micro.ops_seconds) or
// the exchange of every step (roll: each word crosses lanes once a step,
// and an SM shuffles 32 words a clock; experiments/micro.roll_step_seconds).
// The arrays are a few MB at most; the kernels touch HBM once. The roll's
// least time for its output is that of one rotation through HBM, since
// the chain is one rotation by the shifts' sum (torch.roll computes it so);
// the kernel issues every step by design and cannot come near it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the dtype codes of experiments/micro.py (DTYPES)
enum { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3, kI8 = 4, kF16 = 5 };
// the op codes of experiments/micro.py (OPS)
enum { kAdd = 0, kMin = 1, kMinLax = 2, kAbs = 3, kMul = 4, kCmpSel = 5 };

__device__ __forceinline__ int trunc_int(float x) { return __float2int_rz(x); }

// The optimisation barrier on a chain's 32-bit word (see the header)
template <class W>
__device__ __forceinline__ void keep(W& x) {
  static_assert(sizeof(W) == 4, "a chain's item is one 32-bit word");
  uint32_t u;
  memcpy(&u, &x, 4);
  asm("" : "+r"(u));
  memcpy(&x, &u, 4);
}

template <int DT>
struct T;

template <>
struct T<kF32> {
  using W = float;
  static constexpr int P = 1;
  static __device__ W load(const float* x) { return x[0]; }
  static __device__ void store(W w, float* o) { o[0] = w; }
  static __device__ W of(int i) { return (float)i; }
  static __device__ W add(W a, W b) { return __fadd_rn(a, b); }
  static __device__ W sub(W a, W b) { return __fsub_rn(a, b); }
  static __device__ W mul(W a, W b) { return __fmul_rn(a, b); }
  static __device__ W abs(W a) { return fabsf(a); }
  static __device__ W min(W a, W b) { return fminf(a, b); }
  static __device__ W cmpsel(W x, W b) { return x < b ? __fadd_rn(x, b) : b; }
};

template <>
struct T<kI32> {
  using W = uint32_t;  // two's complement bits: add, sub and mul wrap
  static constexpr int P = 1;
  static __device__ W load(const float* x) { return (W)trunc_int(x[0]); }
  static __device__ void store(W w, float* o) { o[0] = (float)(int32_t)w; }
  static __device__ W of(int i) { return (W)i; }
  static __device__ W add(W a, W b) { return a + b; }
  static __device__ W sub(W a, W b) { return a - b; }
  static __device__ W mul(W a, W b) { return a * b; }
  static __device__ W abs(W a) { return (int32_t)a < 0 ? 0u - a : a; }
  static __device__ W min(W a, W b) { return (int32_t)a < (int32_t)b ? a : b; }
  static __device__ W cmpsel(W x, W b) {
    return (int32_t)x < (int32_t)b ? x + b : b;
  }
};

template <>
struct T<kBF16> {
  using W = __nv_bfloat162;
  static constexpr int P = 2;
  static __device__ W load(const float* x) {
    return __floats2bfloat162_rn(x[0], x[1]);
  }
  static __device__ void store(W w, float* o) {
    o[0] = __low2float(w);
    o[1] = __high2float(w);
  }
  static __device__ W of(int i) { return __float2bfloat162_rn((float)i); }
  static __device__ W add(W a, W b) { return __hadd2(a, b); }
  static __device__ W sub(W a, W b) { return __hsub2(a, b); }
  static __device__ W mul(W a, W b) { return __hmul2(a, b); }
  static __device__ W abs(W a) { return __habs2(a); }
  static __device__ W min(W a, W b) { return __hmin2(a, b); }
  static __device__ W cmpsel(W x, W b) {  // scalar: see the header
    const __nv_bfloat16 lo = __hlt(x.x, b.x) ? __hadd(x.x, b.x) : b.x;
    const __nv_bfloat16 hi = __hlt(x.y, b.y) ? __hadd(x.y, b.y) : b.y;
    return __halves2bfloat162(lo, hi);
  }
};

template <>
struct T<kF16> {
  using W = __half2;
  static constexpr int P = 2;
  static __device__ W load(const float* x) {
    return __floats2half2_rn(x[0], x[1]);
  }
  static __device__ void store(W w, float* o) {
    o[0] = __low2float(w);
    o[1] = __high2float(w);
  }
  static __device__ W of(int i) { return __float2half2_rn((float)i); }
  static __device__ W add(W a, W b) { return __hadd2(a, b); }
  static __device__ W sub(W a, W b) { return __hsub2(a, b); }
  static __device__ W mul(W a, W b) { return __hmul2(a, b); }
  static __device__ W abs(W a) { return __habs2(a); }
  static __device__ W min(W a, W b) { return __hmin2(a, b); }
  static __device__ W cmpsel(W x, W b) {
    const __half lo = __hlt(x.x, b.x) ? __hadd(x.x, b.x) : b.x;
    const __half hi = __hlt(x.y, b.y) ? __hadd(x.y, b.y) : b.y;
    return __halves2half2(lo, hi);
  }
};

template <>
struct T<kI16> {
  using W = uint32_t;  // two int16 lanes, the first in the low half
  static constexpr int P = 2;
  static __device__ W load(const float* x) {
    return (uint32_t)(uint16_t)(int16_t)trunc_int(x[0]) |
           ((uint32_t)(uint16_t)(int16_t)trunc_int(x[1]) << 16);
  }
  static __device__ void store(W w, float* o) {
    o[0] = (float)(int16_t)(w & 0xFFFFu);
    o[1] = (float)(int16_t)(w >> 16);
  }
  static __device__ W of(int i) {
    return (uint32_t)(uint16_t)i * 0x00010001u;
  }
  static __device__ W add(W a, W b) { return __vadd2(a, b); }
  static __device__ W sub(W a, W b) { return __vsub2(a, b); }
  static __device__ W abs(W a) { return __vabs2(a); }
  static __device__ W min(W a, W b) { return __vmins2(a, b); }
};

template <>
struct T<kI8> {
  using W = uint32_t;  // four int8 lanes, the first in the low byte
  static constexpr int P = 4;
  static __device__ W load(const float* x) {
    W w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= (uint32_t)(uint8_t)(int8_t)trunc_int(x[k]) << (8 * k);
    return w;
  }
  static __device__ void store(W w, float* o) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = (float)(int8_t)(w >> (8 * k));
  }
  static __device__ W of(int i) { return (uint32_t)(uint8_t)i * 0x01010101u; }
  static __device__ W add(W a, W b) { return __vadd4(a, b); }
  static __device__ W sub(W a, W b) { return __vsub4(a, b); }
  static __device__ W abs(W a) { return __vabs4(a); }
  static __device__ W min(W a, W b) { return __vmins4(a, b); }
};

// E5: the sub-abs-min-add chain of every word
template <int DT>
__global__ void __launch_bounds__(256)
ew_kernel(const float* x, float* o, long words, int inner, int reps) {
  using D = T<DT>;
  const long w = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (w >= words) return;
  typename D::W v = D::load(x + w * D::P);
  const typename D::W one = D::of(1);
  for (int r = 0; r < reps; ++r) {
#pragma unroll 8
    for (int i = 0; i < inner; ++i) {
      v = D::add(D::min(v, D::abs(D::sub(v, one))), one);
      keep(v);
    }
  }
  D::store(v, o + w * D::P);
}

template <int DT, int OP>
__device__ __forceinline__ typename T<DT>::W apply(typename T<DT>::W x,
                                                   typename T<DT>::W b) {
  using D = T<DT>;
  if constexpr (OP == kAdd) return D::add(x, b);
  if constexpr (OP == kMin || OP == kMinLax) return D::min(x, b);
  if constexpr (OP == kAbs) return D::sub(D::abs(x), b);
  if constexpr (OP == kMul) return D::mul(x, b);
  if constexpr (OP == kCmpSel) return D::cmpsel(x, b);
}

// E7: four independent chains of one op a word, summed
template <int DT, int OP>
__global__ void __launch_bounds__(256)
op_kernel(const typename T<DT>::W* a, const typename T<DT>::W* b, float* o,
          long words, int inner, int reps) {
  using D = T<DT>;
  const long w = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (w >= words) return;
  const typename D::W bw = b[w], aw = a[w];
  typename D::W x0 = D::add(aw, D::of(0)), x1 = D::add(aw, D::of(1));
  typename D::W x2 = D::add(aw, D::of(2)), x3 = D::add(aw, D::of(3));
  for (int r = 0; r < reps; ++r) {
#pragma unroll 4
    for (int i = 0; i < inner; ++i) {
      x0 = apply<DT, OP>(x0, bw);
      x1 = apply<DT, OP>(x1, bw);
      x2 = apply<DT, OP>(x2, bw);
      x3 = apply<DT, OP>(x3, bw);
      keep(x0);
      keep(x1);
      keep(x2);
      keep(x3);
    }
  }
  D::store(D::add(D::add(D::add(x0, x1), x2), x3), o + w * D::P);
}

// E6's shifts, reduced mod Z, by value
struct RollShifts {
  int s[8];
};

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kRollSlots = 12;  // slots a lane in registers: Z <= 384
constexpr int kRollWords = 96;  // words a lane in registers: S * K

// A word of dtype dt read from f32 values (its lanes at x[0], x[1]) as its
// 32 bits, and written back
__device__ __forceinline__ uint32_t load_bits(int dt, const float* x) {
  uint32_t u;
  if (dt == kBF16) {
    const __nv_bfloat162 w = T<kBF16>::load(x);
    memcpy(&u, &w, 4);
  } else if (dt == kI16) {
    u = T<kI16>::load(x);
  } else {
    u = __float_as_uint(x[0]);
  }
  return u;
}

__device__ __forceinline__ void store_bits(int dt, uint32_t u, float* o) {
  if (dt == kBF16) {
    __nv_bfloat162 w;
    memcpy(&w, &u, 4);
    T<kBF16>::store(w, o);
  } else if (dt == kI16) {
    T<kI16>::store(u, o);
  } else {
    o[0] = __uint_as_float(u);
  }
}

// E6 in registers: warp g owns the word-columns [S g, S g + S) of every
// row, lane l rows l + 32 k (k < K) of each; every shift below 32
template <int K, int S>
__global__ void __launch_bounds__(256, 2)
roll_reg_kernel(const float* x, float* o, RollShifts shifts, int dt, int Z,
                int rw, int inner, int reps) {
  __shared__ int sh[8];
  if (threadIdx.x < 8) sh[threadIdx.x] = shifts.s[threadIdx.x];
  __syncthreads();  // once, before the chain
  const int lane = threadIdx.x & 31;
  const int c0 = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * S;
  if (c0 >= rw) return;  // the whole warp
  const int P = dt == kF32 ? 1 : 2;
  const size_t L = (size_t)rw * P;
  uint32_t v[S][K];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int z = 32 * k + lane, c = c0 + j;
      v[j][k] = z < Z && c < rw ? load_bits(dt, x + z * L + c * P) : 0u;
    }
  const bool last = lane < Z - 32 * (K - 1);  // lane's row of slot K - 1
  for (int n = 0; n < reps; ++n) {
    for (int i = 0; i < inner; ++i) {
      const int s = sh[i & 7];
      const int src = (lane - s) & 31, wsrc = (lane - s + Z) & 31;
      const bool own = lane >= s;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        // the wrap: rows Z - s + l for slot 0's lanes l < s
        uint32_t prev = __shfl_sync(
            kAll, K == 1 || last ? v[j][K - 1] : v[j][K > 1 ? K - 2 : 0],
            wsrc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t t = __shfl_sync(kAll, v[j][k], src);
          v[j][k] = own ? t : prev;
          prev = t;
          keep(v[j][k]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int z = 32 * k + lane, c = c0 + j;
      if (z < Z && c < rw) store_bits(dt, v[j][k], o + z * L + c * P);
    }
}

// E6 in shared memory: warp g owns word-column g, in two buffers of Z
// words of its own; any Z that fits, any shift
__global__ void __launch_bounds__(256)
roll_smem_kernel(const float* x, float* o, RollShifts shifts, int dt, int Z,
                 int rw, int inner, int reps) {
  extern __shared__ uint32_t strip[];  // [warps][2][Z]
  __shared__ int sh[8];
  if (threadIdx.x < 8) sh[threadIdx.x] = shifts.s[threadIdx.x];
  __syncthreads();  // once, before the chain
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (c >= rw) return;  // the whole warp
  const int P = dt == kF32 ? 1 : 2;
  const size_t L = (size_t)rw * P;
  uint32_t* a = strip + (size_t)w * 2 * Z;
  uint32_t* b = a + Z;
  for (int z = lane; z < Z; z += 32) a[z] = load_bits(dt, x + z * L + c * P);
  __syncwarp();
  for (int n = 0; n < reps; ++n) {
    for (int i = 0; i < inner; ++i) {
      const int s = sh[i & 7];
      for (int z = lane; z < Z; z += 32) {
        int zs = z - s;
        if (zs < 0) zs += Z;
        b[z] = a[zs];
      }
      __syncwarp();
      uint32_t* t = a;
      a = b;
      b = t;
    }
  }
  for (int z = lane; z < Z; z += 32) store_bits(dt, a[z], o + z * L + c * P);
}

using EwKern = void (*)(const float*, float*, long, int, int);
using RollKern = void (*)(const float*, float*, RollShifts, int, int, int,
                          int, int);

EwKern pick_ew(int dt) {
  switch (dt) {
    case kF32: return ew_kernel<kF32>;
    case kBF16: return ew_kernel<kBF16>;
    case kI32: return ew_kernel<kI32>;
    case kI16: return ew_kernel<kI16>;
    case kI8: return ew_kernel<kI8>;
    case kF16: return ew_kernel<kF16>;
  }
  return nullptr;
}

template <int K>
RollKern pick_strips(int strips) {
  switch (strips) {
    case 1: return roll_reg_kernel<K, 1>;
    case 2: return roll_reg_kernel<K, 2>;
    case 4: return roll_reg_kernel<K, 4>;
    case 8:
      if constexpr (8 * K <= kRollWords) return roll_reg_kernel<K, 8>;
  }
  return nullptr;
}

// the register instance of K slots and S strips a lane
template <int K = 1>
RollKern pick_roll(int slots, int strips) {
  if constexpr (K > kRollSlots) {
    return nullptr;
  } else {
    return slots == K ? pick_strips<K>(strips)
                      : pick_roll<K + 1>(slots, strips);
  }
}

template <int DT>
cudaError_t launch_op(int op, const void* a, const void* b, float* o,
                      long words, int inner, int reps, cudaStream_t st) {
  using W = typename T<DT>::W;
  const W* aw = static_cast<const W*>(a);
  const W* bw = static_cast<const W*>(b);
  const int blocks = (int)((words + 255) / 256);
  switch (op) {
    case kAdd: op_kernel<DT, kAdd><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    case kMin: op_kernel<DT, kMin><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    case kMinLax: op_kernel<DT, kMinLax><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    case kAbs: op_kernel<DT, kAbs><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    case kMul: op_kernel<DT, kMul><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    case kCmpSel: op_kernel<DT, kCmpSel><<<blocks, 256, 0, st>>>(aw, bw, o, words, inner, reps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int lanes(int dt) {
  return dt == kI8 ? 4 : (dt == kBF16 || dt == kI16 || dt == kF16) ? 2 : 1;
}

}  // namespace

extern "C" {

// E5 on `elems` f32 values (a multiple of the dtype's lanes a word).
// Returns a cudaError_t (0 on a successful launch).
int micro_ops_ew(void* x, void* o, long elems, int dtype, int inner,
                 int reps, void* stream) {
  EwKern k = pick_ew(dtype);
  if (!k || elems < 1 || elems % lanes(dtype) || inner < 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const long words = elems / lanes(dtype);
  k<<<(unsigned)((words + 255) / 256), 256, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), words, inner,
      reps);
  return (int)cudaGetLastError();
}

// E6 on f32 [Z, L] (L a multiple of the dtype's lanes), by the plan of
// experiments/micro.roll_plan: route 0 in registers (S = strips a warp),
// 1 in shared memory (one strip a warp), `warps` warps a block, `blocks`
// blocks; shifts int32 [8] on the host, each in [0, Z) (below 32 in
// registers).
int micro_ops_roll(void* x, void* o, const int* shifts, int Z, int L,
                   int dtype, int inner, int reps, int route, int strips,
                   int warps, int blocks, void* stream) {
  if ((dtype != kF32 && dtype != kBF16 && dtype != kI16) || Z < 1 || L < 1 ||
      L % lanes(dtype) || inner < 0 || reps < 0 || warps < 1 || warps > 8 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int rw = L / lanes(dtype);
  RollShifts sh;
  for (int i = 0; i < 8; ++i) {
    sh.s[i] = shifts[i];
    if (sh.s[i] < 0 || sh.s[i] >= Z || (route == 0 && sh.s[i] >= 32))
      return (int)cudaErrorInvalidValue;
  }
  RollKern k = nullptr;
  size_t smem = 0;
  if (route == 0) {
    k = pick_roll((Z + 31) / 32, strips);
  } else if (route == 1 && strips == 1) {
    k = roll_smem_kernel;
    smem = (size_t)warps * 2 * Z * 4;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // every word-column in one strip of one warp
  if (!k || (long)blocks * warps * strips < rw ||
      (long)(blocks - 1) * warps * strips >= rw)
    return (int)cudaErrorInvalidValue;
  k<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), sh, dtype, Z, rw,
      inner, reps);
  return (int)cudaGetLastError();
}

// E7 on `elems` values of the dtype (f32, bf16 or int32) in a and b.
int micro_ops_op(void* a, void* b, void* o, long elems, int dtype, int op,
                 int inner, int reps, void* stream) {
  if (elems < 1 || elems % lanes(dtype) || inner < 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const long words = elems / lanes(dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  switch (dtype) {
    case kF32: return (int)launch_op<kF32>(op, a, b, out, words, inner, reps, st);
    case kBF16: return (int)launch_op<kBF16>(op, a, b, out, words, inner, reps, st);
    case kI32: return (int)launch_op<kI32>(op, a, b, out, words, inner, reps, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* micro_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
