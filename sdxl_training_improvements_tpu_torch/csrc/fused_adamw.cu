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
// with n0 = lowbias32(i ^ seed0), n1 = lowbias32(i ^ seed1) over the
// element's flat index i in memory order, which is ops/stochastic.py's
// counter_noise.  The Pallas kernel draws the TPU's hardware random bits
// instead; this kernel is held to the XLA chain, bit for bit.
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
// and g (fp32, or bf16), 12 bytes, and writes delta, m, v, shift (bf16),
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

template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const uint16_t* __restrict__ p, const G* __restrict__ g,
                   uint16_t* __restrict__ m, uint16_t* __restrict__ v,
                   uint16_t* __restrict__ sh, uint16_t* __restrict__ delta,
                   int64_t n, float neg_lr_eff, float decay, uint32_t seed0,
                   uint32_t seed1, float beta1, float one_minus_beta1,
                   float beta2, float one_minus_beta2, float eps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint32_t idx = static_cast<uint32_t>(i);
    const uint32_t n0 = lowbias32(idx ^ seed0);
    const uint32_t n1 = lowbias32(idx ^ seed1);
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

template <typename G>
int launch(const void* p, const void* g, void* m, void* v, void* sh,
           void* delta, int64_t n, float neg_lr_eff, float decay,
           uint32_t seed0, uint32_t seed1, float beta1,
           float one_minus_beta1, float beta2, float one_minus_beta2,
           float eps, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  fused_adamw_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const uint16_t*>(p), static_cast<const G*>(g),
      static_cast<uint16_t*>(m), static_cast<uint16_t*>(v),
      static_cast<uint16_t*>(sh), static_cast<uint16_t*>(delta), n,
      neg_lr_eff, decay, seed0, seed1, beta1, one_minus_beta1, beta2,
      one_minus_beta2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g_is_bf16: 0 for an fp32 gradient, 1 for a bf16 gradient.
extern "C" int fused_adamw_bf16(const void* p, const void* g, int g_is_bf16,
                                void* m, void* v, void* sh, void* delta,
                                int64_t n, float neg_lr_eff, float decay,
                                uint32_t seed0, uint32_t seed1, float beta1,
                                float one_minus_beta1, float beta2,
                                float one_minus_beta2, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    return launch<uint16_t>(p, g, m, v, sh, delta, n, neg_lr_eff, decay,
                            seed0, seed1, beta1, one_minus_beta1, beta2,
                            one_minus_beta2, eps, st);
  }
  return launch<float>(p, g, m, v, sh, delta, n, neg_lr_eff, decay, seed0,
                       seed1, beta1, one_minus_beta1, beta2,
                       one_minus_beta2, eps, st);
}
