// Flash-attention backward in fp32 for Hopper (sm_90a), on the tensor
// cores: fp32 q, k, v, dO in, fp32 dq, dk, dv out, fp32 lse and
// Delta = rowsum(dO * O) (training.mixed_precision = "no").
//
// Replaces the Pallas kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py for fp32 inputs,
// where they multiply in fp32, and keeps their split, as the 16-bit kernels
// of flash_bwd.cu do:
//
// * dq: one block per (128-row q tile, batch*head), looping over kv tiles:
//   dq = sum_kv dS k, dS = P * (dP - Delta) * scale, P = exp(q k^T * scale
//   - lse), dP = dO v^T;
// * dk/dv: one block per (128-row kv tile, batch*head[, q split]), looping
//   over q tiles: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Split TF32.  wgmma has no fp32 operands, and TF32 keeps 10 mantissa bits.
// Every operand enters as two TF32 parts, hi = rna(x) and lo = rna(x - hi)
// (hopper.cuh: Tf32), and every product as three TF32 products into one
// accumulator, the two small ones first: lo_a hi_b, hi_a lo_b, hi_a hi_b.
// The products keep about 2^-21 of relative accuracy against fp32's 2^-24
// (CUTLASS's OpMultiplyAddFastF32 on mma.sync does the same).  The tensor
// cores add into their fp32 accumulators by truncation, not rounding to
// nearest, so the gradient sums, which run over the whole sequence, take a
// fresh accumulator each streamed tile (its small products of all k steps
// first), added to the running sum by FADD.
//
// Bound: 6*S*T*D flops (dq) and 8*S*T*D (dk/dv), each at three TF32 products:
// 495 / 3 = 165 TFLOP/s of fp32-accurate products (1.56 and 2.08 ms at B4
// S=T=4096 H10 D64); the O((S + T) * D) bytes are far below that.
//
// Design, the warp-specialised shape of flash_bwd.cu (the pieces shared
// with the fp32 forward are in flash_f32_common.cuh):
//
// * three warpgroups a block: two consumers of 64 own rows each (q rows for
//   dq, kv rows for dk/dv) that keep their fp32 gradient sums in registers,
//   and a producer whose first warp issues TMA (4-D tensor maps over the
//   [B, N, H, D] strides) and whose other three warps split tiles;
//   setmaxnreg gives the consumers 232 registers and the producer 40;
// * the own tiles (q, dO; k, v) arrive once by TMA, raw.  Each k step of a
//   score product the consumers load their A fragments from them and split
//   them in registers (RS wgmma: A in registers, B in shared memory), which
//   keeps the own tiles at one fp32 copy and halves the shared-memory
//   traffic of a product against an SS wgmma;
// * the streamed tiles (kStream rows: 32, 16 at D = 128) arrive by TMA in a
//   ring of kStages stages (as many as shared memory holds, at most 3), an
//   mbarrier for the raw tiles, one for the split ones and one for their
//   release.  The splitting warps turn each raw tile, in place, into its hi
//   part and write its lo part beside it;
// * TF32 wgmma reads both operands K-major only (the transpose bits exist
//   for 16-bit types).  The score products (S = q k^T and dP = dO v^T;
//   S^T = k q^T and dP^T = v dO^T) are K-major as TMA lands them.  The
//   gradient products (dq = dS k, dv = P^T dO, dk = dS^T q) contract over
//   the streamed rows, so the splitting pass also writes the streamed tiles
//   they read (k; q and dO) transposed, hi and lo: the transpose costs the
//   pass's stores, not a pass of its own, and no register operand moves;
// * P and dS are formed in registers on the accumulator layout, split
//   there, and are the gradient products' A fragments.  A TF32 A fragment
//   holds columns t and t + 4 of each 8-column k step where the accumulator
//   holds 2t and 2t + 1: the transposed tiles hold their streamed rows in
//   that order (row 8n + pi(j) at column 8n + j, pi = 0 2 4 6 1 3 5 7), so
//   no value moves between threads.
//
// Shared memory per block (a build fact, `Cfg`): the two own tiles, and per
// stage the two raw-then-hi tiles, their lo tiles and the transposed hi and
// lo tiles (6 tiles for dq, 8 for dk/dv), each kStream x D fp32; at D = 64,
// 64 KB own + 3 x 48 KB (dq) or 2 x 64 KB (dk/dv).
//
// Masking from S and T, with no padded copies: TMA fills rows >= S and
// >= T with zeros; the dq kernel sets P = 0 in kv columns >= T, the dk/dv
// kernel gives q rows >= S an lse of +inf (so P = 0); rows beyond the
// sequence are never stored.  P = expf(s * scale - lse), as the plain
// version forms it.
//
// Small T (cross-attention, T = 77: one kv tile per head, too few blocks
// for 132 SMs): the wrapper splits the dk/dv q loop over `splits` blocks
// (ops/flash_attention.py: plan_dkv_splits on this kernel's kStream).
// Each writes fp32 partial dk and dv into scratch the wrapper allocates, and
// `flash_f32_dkv_reduce_kernel` sums them in split order.  No atomics
// anywhere: two launches give bit-equal gradients.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// launches (or hopper::kEncodeError + the CUresult of a tensor map it cannot
// build).

#include "flash_f32_common.cuh"

namespace {

using namespace flash_f32;

// dq (kDkv false) and dk/dv: kStream streamed rows (32, 16 at D = 128);
// per stage A, B raw then hi | A lo, B lo | A^T hi, A^T lo (| B^T hi,
// B^T lo for dk/dv); A = k, B = v for dq, A = q, B = dO for dk/dv; the
// dk/dv kernel's lse and Delta of the streamed q rows; the gradient
// products kN columns wide (32 at D = 128, where the consumers hold
// 2 x 128 gradient sums, keeps their registers unspilled).
constexpr int stream_rows(int d) { return d <= 64 ? 32 : 16; }

template <int D, bool kDkv>
struct Cfg : Geometry<D, stream_rows(D), 2, kDkv ? 8 : 6,
                      kDkv ? 2 * stream_rows(D) * 4 : 0, D <= 64 ? D : 32,
                      1> {
  __host__ __device__ static constexpr bool natural(int) { return true; }
  __host__ __device__ static constexpr int lo_slot(int x) { return 2 + x; }
  __host__ __device__ static constexpr bool transposed(int x) {
    return x == 0 || kDkv;
  }
  __host__ __device__ static constexpr int t_slot(int x) { return 4 + 2 * x; }
};

struct Strides {  // (batch, seq, head) element strides
  int64_t q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

// S = A B^T and P = A' B'^T over D (64 x kStream each): A, A' the
// consumer's own rows (split fragments from an own tile), B, B' natural
// streamed tiles as their hi and lo parts; each k step's small products
// before its hi * hi, one k step's fragments loaded while the last one's
// products run.  Returns with the products complete.
template <class C>
__device__ __forceinline__ void scores2(
    const Smem<C>& sm, int row, int t, float (&s)[C::kStream / 2],
    uint32_t own_s, uint32_t s_hi, uint32_t s_lo, float (&p)[C::kStream / 2],
    uint32_t own_p, uint32_t p_hi, uint32_t p_lo) {
  constexpr int kStream = C::kStream;
#pragma unroll
  for (int i = 0; i < kStream / 2; ++i) s[i] = p[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::D / 8; ++kk) {
    uint32_t sh[4], sl[4], ph[4], pl[4];
    own_fragment<C>(sm, own_s, row, kk, t, sh, sl);
    own_fragment<C>(sm, own_p, row, kk, t, ph, pl);
    const uint64_t bsh = nat_desc<C>(s_hi, kk);
    const uint64_t bph = nat_desc<C>(p_hi, kk);
    wgmma_fence();
    wgmma_rs<Tf32, kStream>(s, sl, bsh);
    wgmma_rs<Tf32, kStream>(s, sh, nat_desc<C>(s_lo, kk));
    wgmma_rs<Tf32, kStream>(s, sh, bsh);
    wgmma_rs<Tf32, kStream>(p, pl, bph);
    wgmma_rs<Tf32, kStream>(p, ph, nat_desc<C>(p_lo, kk));
    wgmma_rs<Tf32, kStream>(p, ph, bph);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(s);
  fence_operands(p);
}

// acc[64 x kN] += X B over the streamed rows (issue_over_stream), through
// a fresh accumulator added by FADD.
template <class C>
__device__ __forceinline__ void gradient(
    float (&acc)[C::kN / 2], const uint32_t (&xh)[C::kStream / 8][4],
    const uint32_t (&xl)[C::kStream / 8][4], uint32_t t_hi, uint32_t t_lo,
    int c) {
  float part[C::kN / 2];
  issue_over_stream<C>(part, xh, xl, t_hi, t_lo, c);
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < C::kN / 2; ++i) acc[i] += part[i];
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, false>::kThreads, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int T, int64_t dq_sb, int64_t dq_ss,
                    int64_t dq_sh, float scale) {
  using C = Cfg<D, false>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (T + kStream - 1) / kStream;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: own q, dO; streamed k, v
    setmaxnreg_dec<40>();
    const int u = threadIdx.x - 256;
    if (u == 0) {
      load_own<C>(sm, &q_map, &do_map, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.empty(st), ((j / C::kStages) & 1) ^ 1);
        load_stream<C>(sm, st, &k_map, &v_map, h, j * kStream, b);
      }
    } else if (u >= 32) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.raw_full(st), (j / C::kStages) & 1);
        split_stage<C>(sm, st, u - 32);
        fence_proxy_async();
        mbar_arrive(sm.split_full(st));
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int r0 = m0 + row;
    const int r1 = r0 + 8;
    const int64_t rows = static_cast<int64_t>(bh) * S;
    // rows >= S hold zeros in q and dO, so dS is 0 there for any lse
    const float lse0 = r0 < S ? lse[rows + r0] : 0.f;
    const float lse1 = r1 < S ? lse[rows + r1] : 0.f;
    const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
    const float dl1 = r1 < S ? delta[rows + r1] : 0.f;

    float acc[D / C::kN][C::kN / 2];
#pragma unroll
    for (int c = 0; c < D / C::kN; ++c) {
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) acc[c][i] = 0.f;
    }
    float s[kStream / 2], dp[kStream / 2];
    uint32_t dsh[kStream / 8][4], dsl[kStream / 8][4];

    mbar_wait(sm.own_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(sm.split_full(st), (j / C::kStages) & 1);
      // S = q k^T, dP = dO v^T
      scores2<C>(sm, row, t, s, sm.own(0), sm.tile(st, 0),
                        sm.tile(st, 2), dp, sm.own(1), sm.tile(st, 1),
                        sm.tile(st, 3));
      // s[4 n + e]: row r0 (e < 2) or r1, kv column n0 + 8 n + 2 t + e % 2
      const int n0 = j * kStream;
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = n0 + 8 * n + 2 * t + (e & 1) < T;
          const float p =
              valid ? expf(s[4 * n + e] * scale - (e < 2 ? lse0 : lse1))
                    : 0.f;
          s[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }
      acc_fragments<kStream>(s, dsh, dsl);
      fence_operands(dsh);
      fence_operands(dsl);
#pragma unroll
      for (int c = 0; c < D / C::kN; ++c) {  // dq += dS k
        gradient<C>(acc[c], dsh, dsl, sm.tile(st, 4), sm.tile(st, 5),
                           c);
      }
      mbar_arrive(sm.empty(st));
    }
    store_rows<C>(dq + b * dq_sb + h * dq_sh, dq_ss, acc, r0, S, t);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, true>::kThreads, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int H, int S, int T, int q_tiles_per_split, Strides st,
                     float scale) {
  using C = Cfg<D, true>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int n0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_tiles = (S + kStream - 1) / kStream;
  const int first = blockIdx.z * q_tiles_per_split;
  const int n_tiles = min(q_tiles_per_split, q_tiles - first);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: own k, v; streamed q, dO, lse, Delta
    setmaxnreg_dec<40>();
    const int u = threadIdx.x - 256;
    if (u == 0) {
      load_own<C>(sm, &k_map, &v_map, h, n0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        mbar_wait(sm.empty(s), ((i / C::kStages) & 1) ^ 1);
        load_stream<C>(sm, s, &q_map, &do_map, h,
                             (first + i) * kStream, b);
      }
    } else if (u >= 32) {
      const int64_t rows = static_cast<int64_t>(bh) * S;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        const int m = (first + i) * kStream;
        mbar_wait(sm.raw_full(s), (i / C::kStages) & 1);
        split_stage<C>(sm, s, u - 32);
        // q rows >= S: lse = +inf, so P = expf(-inf) = 0 there
        if (u - 32 < kStream) {
          const int r = u - 32;
          const bool in = m + r < S;
          sm.lse(s)[r] = in ? lse[rows + m + r] : __int_as_float(0x7f800000);
          sm.delta(s)[r] = in ? delta[rows + m + r] : 0.f;
        }
        fence_proxy_async();
        mbar_arrive(sm.split_full(s));
      }
    }
  } else {  // consumers: warpgroup wg owns kv rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);

    float dk_acc[D / C::kN][C::kN / 2], dv_acc[D / C::kN][C::kN / 2];
#pragma unroll
    for (int c = 0; c < D / C::kN; ++c) {
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
    }
    float s[kStream / 2], dp[kStream / 2];
    uint32_t ph[kStream / 8][4], pl[kStream / 8][4];
    uint32_t dsh[kStream / 8][4], dsl[kStream / 8][4];

    mbar_wait(sm.own_full(), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s_ = i % C::kStages;
      mbar_wait(sm.split_full(s_), (i / C::kStages) & 1);
      // S^T = k q^T, dP^T = v dO^T
      scores2<C>(sm, row, t, s, sm.own(0), sm.tile(s_, 0),
                       sm.tile(s_, 2), dp, sm.own(1), sm.tile(s_, 1),
                       sm.tile(s_, 3));
      // s[4 n + e]: kv row (e < 2) or row + 8, q column 8 n + 2 t + e % 2
      const float* ls = sm.lse(s_);
      const float* dls = sm.delta(s_);
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
        const float2 dl =
            *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              expf(s[4 * n + e] * scale - ((e & 1) ? l.y : l.x));
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) *
                          scale;
        }
      }
      acc_fragments<kStream>(s, ph, pl);
      acc_fragments<kStream>(dp, dsh, dsl);
      fence_operands(ph);
      fence_operands(pl);
      fence_operands(dsh);
      fence_operands(dsl);
#pragma unroll
      for (int c = 0; c < D / C::kN; ++c) {
        // dv += P^T dO, dk += dS^T q
        gradient<C>(dv_acc[c], ph, pl, sm.tile(s_, 6), sm.tile(s_, 7),
                          c);
        gradient<C>(dk_acc[c], dsh, dsl, sm.tile(s_, 4),
                          sm.tile(s_, 5), c);
      }
      mbar_arrive(sm.empty(s_));
    }
    const int r0 = n0 + row;
    if (dk_part != nullptr) {
      const int64_t part =
          (static_cast<int64_t>(blockIdx.z) * gridDim.y + bh) * T * D;
      store_rows<C>(dk_part + part, D, dk_acc, r0, T, t);
      store_rows<C>(dv_part + part, D, dv_acc, r0, T, t);
    } else {
      store_rows<C>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dk_acc,
                          r0, T, t);
      store_rows<C>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dv_acc,
                          r0, T, t);
    }
  }
}

// dk, dv = sum over splits of the fp32 partials [splits, B*H, T, D], in
// split order; one thread per pair of columns.
__global__ void flash_f32_dkv_reduce_kernel(const float* __restrict__ dk_part,
                                            const float* __restrict__ dv_part,
                                            float* __restrict__ dk,
                                            float* __restrict__ dv,
                                            int splits, int H, int T, int D,
                                            int64_t pairs, Strides st) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= pairs) return;
  const int64_t e = 2 * i;
  const int d = static_cast<int>(e % D);
  const int64_t row = e / D;
  const int t = static_cast<int>(row % T);
  const int bh = static_cast<int>(row / T);
  const int b = bh / H;
  const int h = bh - b * H;
  float2 k2 = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 pk = reinterpret_cast<const float2*>(dk_part)[s * pairs + i];
    const float2 pv = reinterpret_cast<const float2*>(dv_part)[s * pairs + i];
    k2.x += pk.x;
    k2.y += pk.y;
    v2.x += pv.x;
    v2.y += pv.y;
  }
  *reinterpret_cast<float2*>(dk + b * st.dk[0] + t * st.dk[1] + h * st.dk[2] +
                             d) = k2;
  *reinterpret_cast<float2*>(dv + b * st.dv[0] + t * st.dv[1] + h * st.dv[2] +
                             d) = v2;
}

Strides unpack(const int64_t* s) {
  Strides st;
  int64_t* dst[7] = {st.q, st.k, st.v, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = s[3 * i + j];
  }
  return st;
}

// Tensor maps of q, dO (seq S) and k, v (seq T) with boxes of `q_rows` and
// `kv_rows` rows and kNat columns.
template <int D>
int make_maps(CUtensorMap* q_map, CUtensorMap* do_map, CUtensorMap* k_map,
              CUtensorMap* v_map, const void* q, const void* k, const void* v,
              const void* dO, int B, int H, int S, int T, const Strides& st,
              int q_rows, int kv_rows) {
  int rc = make_f32_map<D>(q_map, q, B, S, H, st.q, q_rows);
  if (rc == 0) rc = make_f32_map<D>(do_map, dO, B, S, H, st.dO, q_rows);
  if (rc == 0) rc = make_f32_map<D>(k_map, k, B, T, H, st.k, kv_rows);
  if (rc == 0) rc = make_f32_map<D>(v_map, v, B, T, H, st.v, kv_rows);
  return rc;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int S, int T, const Strides& st, float scale,
              cudaStream_t stream) {
  using C = Cfg<D, false>;
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, kOwn, C::kStream);
  if (rc != 0) return rc;
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e = allow_smem(flash_f32_dq_kernel<D>, C::kSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_f32_dq_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, S, T,
      st.dq[0], st.dq[1], st.dq[2], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv,
               void* dk_part, void* dv_part, int B, int H, int S, int T,
               int splits, int q_tiles_per_split, const Strides& st,
               float scale, cudaStream_t stream) {
  using C = Cfg<D, true>;
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, C::kStream, kOwn);
  if (rc != 0) return rc;
  static uint64_t smem_allowed = 0;
  cudaError_t e = allow_smem(flash_f32_dkv_kernel<D>, C::kSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool split = splits > 1;
  dim3 grid((T + kOwn - 1) / kOwn, B * H, splits);
  flash_f32_dkv_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      k_map, v_map, q_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), split ? static_cast<float*>(dk_part) : nullptr,
      split ? static_cast<float*>(dv_part) : nullptr, H, S, T,
      q_tiles_per_split, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const int64_t pairs = static_cast<int64_t>(B) * H * T * D / 2;
  const int threads = 256;
  flash_f32_dkv_reduce_kernel<<<
      static_cast<unsigned>((pairs + threads - 1) / threads), threads, 0,
      stream>>>(static_cast<const float*>(dk_part),
                static_cast<const float*>(dv_part), static_cast<float*>(dk),
                static_cast<float*>(dv), splits, H, T, D, pairs, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq, dk,
// dv in turn.  lse and delta are [B*H, S] fp32.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int S, int T, int D, const int64_t* strides,
                                float scale, void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 32: return launch_dq<32>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 64: return launch_dq<64>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 128: return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// splits > 1 splits each kv tile's q loop over that many blocks of
// q_tiles_per_split q tiles, with fp32 partials in dk_part and dv_part
// ([splits, B*H, T, D] each) summed by the reduction kernel.
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 void* dk_part, void* dv_part, int B, int H,
                                 int S, int T, int D, int splits,
                                 int q_tiles_per_split,
                                 const int64_t* strides, float scale,
                                 void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
