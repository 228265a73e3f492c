// Fused bf16 stochastic-rounding AdamW update for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fused_kernel` of
// sdxl_training_improvements_tpu/ops/fused_adamw.py (driven by
// `fused_adamw_update`).  It runs the whole per-element chain of the JAX
// optimizer's default path (training/optimizers/adamw_bf16.py,
// `bf16_update` with noise="hash") in one pass:
//
//   m  = SR(fma(g, 1 - b1, bf16_rn(m * b1)))                 noise n0
//   v  = bf16_rn(fma((1 - b2) * g, g, v * b2))
//   sh = SR(sh + (-lr_eff * m) / (sqrt(v) + eps))            noise n0 >> 16
//   p' = SR(p + sh)                                          noise n1
//   sh = SR(sh + (p - p'))                                   noise n1 >> 16
//   sh = bf16_rn(fma(p', -decay, sh))
//   delta = bf16_rn(p' - p)
//
// with n0 = lowbias32(j ^ seed0), n1 = lowbias32(j ^ seed1) over the
// element's flat index j = base + i in memory order, which is
// ops/stochastic.py's counter_noise ("hash" noise); base is 0 for a whole
// leaf and a ZeRO chunk's offset in its leaf, so that the chunks of a
// sharded leaf draw the whole leaf's noise.  A megatron slice of a leaf
// (parallel/mesh.py TPSplit) is a strided set of the leaf's elements:
// there element i is element k = base + i of the slice, and j is its
// place in the whole leaf, j = off + (k / run) * stride + k % run, plus
// jump in the second half of a run (k % run >= half: a GEGLU slice holds
// [value_r | gate_r] in each row).  The map costs a division a element,
// so it is a template instantiation of its own (kMap = kStrided), beside
// the contiguous chunk's (kMap = kBase: j = base + i) and the whole
// leaf's (kMap = kWhole: j = i), which keep their registers.  The "rbg" variant (template parameter
// kPlanes) reads n0 and n1 from two uint32 planes drawn beforehand, n0 =
// planes[i] and n1 = planes[n + i], as JAX's `_noise_planes` materialises
// them.  The Pallas kernel draws the TPU's hardware random bits instead;
// this kernel is held to the XLA chain, bit for bit.
//
// Decay: one amount for the whole launch (a leaf, or a flat group of the
// flat and hybrid layouts), or with `decay_vec` one per slice of
// `slice_n` elements (the stacked layout's per-leaf decay, which JAX
// computes outside Pallas: decay = decay_vec[i / slice_n]).
//
// Bit-exactness: the three fma() above are where XLA:CPU fuses the JAX
// chain's a*b+c forms (ops/fused_adamw.py says how that was measured), and
// are explicit __fmaf_rn; every other product, sum, quotient and square
// root is its own correctly rounded fp32 operation (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), in JAX's order, and the file is built with
// --fmad=false so that nvcc contracts nothing else.  Never build it with
// --use_fast_math.
//
// Bound: pure HBM streaming.  Per element it reads p, m, v, shift (bf16)
// and g (fp32, or bf16), 12 bytes (10 with a bf16 g; the rbg variant
// reads 8 more for the planes), and writes delta, m, v, shift (bf16),
// 8 bytes.  m, v and shift are updated in place.  A grid-stride loop with
// one element per thread per iteration; the noise is computed in registers
// and never touches memory.
//
// C interface for ctypes; the launcher returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Round to nearest even, NaN to 0x7FC0: PyTorch's float -> bf16 cast.
__device__ __forceinline__ uint16_t f32_to_bf16_rn(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  u += 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

// Stochastic rounding: add the low 16 noise bits, keep the high half.
__device__ __forceinline__ uint16_t f32_to_bf16_sr(float x, uint32_t noise) {
  const uint32_t u = __float_as_uint(x) + (noise & 0xFFFFu);
  return static_cast<uint16_t>(u >> 16);
}

template <typename G>
__device__ __forceinline__ float load_g(const G* g, int64_t i);

template <>
__device__ __forceinline__ float load_g<float>(const float* g, int64_t i) {
  return g[i];
}

template <>
__device__ __forceinline__ float load_g<uint16_t>(const uint16_t* g,
                                                  int64_t i) {
  return bf16_to_f32(g[i]);
}

// the noise index of element i: the whole leaf's, a contiguous chunk's,
// or a strided slice's (see the top of the file)
enum : int { kWhole = 0, kBase = 1, kStrided = 2 };

struct IndexMap {
  uint32_t off, run, stride, half, jump;
};

template <typename G, bool kPlanes, int kMap>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const uint16_t* __restrict__ p, const G* __restrict__ g,
                   uint16_t* __restrict__ m, uint16_t* __restrict__ v,
                   uint16_t* __restrict__ sh, uint16_t* __restrict__ delta,
                   int64_t n, float neg_lr_eff, float decay_all,
                   const float* __restrict__ decay_vec, int64_t slice_n,
                   uint32_t seed0, uint32_t seed1, uint32_t base,
                   IndexMap map,
                   const uint32_t* __restrict__ planes, float beta1,
                   float one_minus_beta1, float beta2, float one_minus_beta2,
                   float eps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    uint32_t n0, n1;
    if constexpr (kPlanes) {
      n0 = planes[i];
      n1 = planes[n + i];
    } else {
      // a ZeRO chunk or a megatron slice hashes the index of its element
      // in the whole leaf (32-bit arithmetic: the noise index wraps as
      // JAX's uint32 iota)
      uint32_t idx = static_cast<uint32_t>(i);
      if constexpr (kMap != kWhole) idx += base;
      if constexpr (kMap == kStrided) {
        const uint32_t q = idx / map.run;
        const uint32_t r = idx - q * map.run;
        idx = map.off + q * map.stride + r + (r >= map.half ? map.jump : 0u);
      }
      n0 = lowbias32(idx ^ seed0);
      n1 = lowbias32(idx ^ seed1);
    }
    const float decay = decay_vec ? decay_vec[i / slice_n] : decay_all;
    const float g32 = load_g<G>(g, i);
    const float p32 = bf16_to_f32(p[i]);

    // m: bf16_rn(m * b1) first, then the stochastic fused add of (1 - b1) g
    const float m_half = bf16_to_f32(f32_to_bf16_rn(
        __fmul_rn(bf16_to_f32(m[i]), beta1)));
    const uint16_t m_new = f32_to_bf16_sr(
        __fmaf_rn(g32, one_minus_beta1, m_half), n0);
    const float m32 = bf16_to_f32(m_new);

    // v: nearest rounding of ((1 - b2) * g) * g + v * b2
    const uint16_t v_new = f32_to_bf16_rn(
        __fmaf_rn(__fmul_rn(one_minus_beta2, g32), g32,
                  __fmul_rn(bf16_to_f32(v[i]), beta2)));
    const float denom = __fadd_rn(__fsqrt_rn(bf16_to_f32(v_new)), eps);

    // shift += (-lr_eff * m) / denom
    const uint16_t sh1 = f32_to_bf16_sr(
        __fadd_rn(bf16_to_f32(sh[i]),
                  __fdiv_rn(__fmul_rn(neg_lr_eff, m32), denom)),
        n0 >> 16);
    const float sh1_32 = bf16_to_f32(sh1);

    // p' = SR(shift + p); shift carries the rounding residual p - p'
    const uint16_t p_new = f32_to_bf16_sr(__fadd_rn(sh1_32, p32), n1);
    const float pn32 = bf16_to_f32(p_new);
    const uint16_t sh2 = f32_to_bf16_sr(
        __fadd_rn(__fsub_rn(p32, pn32), sh1_32), n1 >> 16);

    // batched weight decay (decay = 0 when it does not fire this step)
    const uint16_t sh3 = f32_to_bf16_rn(
        __fmaf_rn(pn32, -decay, bf16_to_f32(sh2)));

    m[i] = m_new;
    v[i] = v_new;
    sh[i] = sh3;
    delta[i] = f32_to_bf16_rn(__fsub_rn(pn32, p32));
  }
}

template <typename G, bool kPlanes>
int launch(const void* p, const void* g, void* m, void* v, void* sh,
           void* delta, int64_t n, float neg_lr_eff, float decay,
           const void* decay_vec, int64_t slice_n, uint32_t seed0,
           uint32_t seed1, int64_t base, IndexMap map, const void* planes,
           float beta1, float one_minus_beta1, float beta2,
           float one_minus_beta2, float eps, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  // the add of a chunk's base costs the hash variant 3 registers (35
  // against 32: 3/4 of the threads resident), so a whole leaf (base 0,
  // every one-card launch) takes the instantiation without it, and only
  // a strided slice (map.run != 0) the one with the division
  auto kernel = fused_adamw_kernel<G, kPlanes, kWhole>;
  if constexpr (!kPlanes) {
    if (map.run != 0) {
      kernel = fused_adamw_kernel<G, false, kStrided>;
    } else if (base != 0) {
      kernel = fused_adamw_kernel<G, false, kBase>;
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(p), static_cast<const G*>(g),
      static_cast<uint16_t*>(m), static_cast<uint16_t*>(v),
      static_cast<uint16_t*>(sh), static_cast<uint16_t*>(delta), n,
      neg_lr_eff, decay, static_cast<const float*>(decay_vec), slice_n,
      seed0, seed1, static_cast<uint32_t>(base), map,
      static_cast<const uint32_t*>(planes), beta1,
      one_minus_beta1, beta2, one_minus_beta2, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int launch_noise(const void* planes, const void* p, const void* g, void* m,
                 void* v, void* sh, void* delta, int64_t n, float neg_lr_eff,
                 float decay, const void* decay_vec, int64_t slice_n,
                 uint32_t seed0, uint32_t seed1, int64_t base, IndexMap map,
                 float beta1, float one_minus_beta1, float beta2,
                 float one_minus_beta2, float eps, cudaStream_t st) {
  if (planes) {
    return launch<G, true>(p, g, m, v, sh, delta, n, neg_lr_eff, decay,
                           decay_vec, slice_n, seed0, seed1, base, map,
                           planes, beta1, one_minus_beta1, beta2,
                           one_minus_beta2, eps, st);
  }
  return launch<G, false>(p, g, m, v, sh, delta, n, neg_lr_eff, decay,
                          decay_vec, slice_n, seed0, seed1, base, map,
                          planes, beta1, one_minus_beta1, beta2,
                          one_minus_beta2, eps, st);
}

}  // namespace

// g_is_bf16: 0 for an fp32 gradient, 1 for a bf16 gradient.  planes: null
// for the hash noise of (seed0, seed1), else 2 x n uint32 ("rbg").
// decay_vec: null for one decay amount, else one fp32 amount per slice of
// slice_n elements.  base: the index of element 0 in the whole leaf (a ZeRO
// chunk's offset; 0 for a whole leaf), which the hash noise hashes; with
// run != 0 the index of element 0 in a megatron slice, whose elements lie
// in the whole leaf at off + (k / run) * stride + k % run (+ jump where
// k % run >= half).
extern "C" int fused_adamw_bf16(const void* p, const void* g, int g_is_bf16,
                                void* m, void* v, void* sh, void* delta,
                                int64_t n, float neg_lr_eff, float decay,
                                const void* decay_vec, int64_t slice_n,
                                uint32_t seed0, uint32_t seed1,
                                int64_t base, uint32_t off, uint32_t run,
                                uint32_t stride, uint32_t half,
                                uint32_t jump, const void* planes,
                                float beta1, float one_minus_beta1,
                                float beta2, float one_minus_beta2,
                                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const IndexMap map{off, run, stride, half, jump};
  if (g_is_bf16) {
    return launch_noise<uint16_t>(planes, p, g, m, v, sh, delta, n,
                                  neg_lr_eff, decay, decay_vec, slice_n,
                                  seed0, seed1, base, map, beta1,
                                  one_minus_beta1, beta2, one_minus_beta2,
                                  eps, st);
  }
  return launch_noise<float>(planes, p, g, m, v, sh, delta, n, neg_lr_eff,
                             decay, decay_vec, slice_n, seed0, seed1, base,
                             map, beta1, one_minus_beta1, beta2,
                             one_minus_beta2, eps, st);
}
