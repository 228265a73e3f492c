// GroupNorm + SiLU for Hopper (sm_90a): a forward kernel and a backward
// kernel, each one cooperative launch.
//
// Forward, gn_silu_fwd_kernel: y = silu((x - mean_g) * rstd_g * scale +
// bias), with the (image, group) statistics mean_g and rstd_g =
// 1 / sqrt(var_g + eps).  It replaces the three Pallas kernels of
// sdxl_training_improvements_tpu/ops/groupnorm.py: `_gn_silu_kernel` (one
// block per image), and the chunked pair `_gn_stats_kernel` and
// `_gn_apply_kernel`.  It also writes mean_g and rstd_g, [B, G] fp32, for
// the backward.
//
// Backward, gn_silu_bwd_kernel, from x, dy, scale, bias and the saved
// mean_g, rstd_g: with xhat = (x - mean_g) * rstd_g, z = xhat * scale +
// bias, s = sigmoid(z), dz = dy * s * (1 + z (1 - s)), dxhat = dz * scale
// and the group sums A = sum dxhat, Bg = sum dxhat * xhat over the N =
// S * C / G elements of a group,
//   dx = rstd_g * (dxhat - A / N - xhat * Bg / N),
//   dscale = sum over images and rows of dz * xhat,  dbias = sum of dz.
// The TPU has no backward kernel: JAX's `_fused_bwd` (groupnorm.py:251)
// is jax.vjp of the plain reference.
//
// Layout: x, y, dy, dx [B, S, C] channels-last and contiguous; G groups
// of C / G adjacent channels; scale, bias [C] fp32; statistics and all
// arithmetic fp32; x, y, dy, dx fp32, bf16 or fp16 (one instantiation
// each).
//
// Bound: device-memory bytes.  Per element the forward must read x and
// write y, the backward read x and dy and write dx; a few dozen fp32
// operations an element are far below the card's rate.  The statistics
// need every element of an image before the first output of that image,
// so each kernel has two phases with one grid barrier between them:
//
//   phase 1: the grid holds as many blocks as the card runs at once (the
//   occupancy query: one block of 512 threads an SM), each image cut into
//   row chunks, about one chunk per block.  A block streams its chunk once
//   and reduces it to per-group partials.  Forward: each thread keeps
//   Welford's (mean, M2) of its 8 channels over its rows; a thread per
//   channel merges the row offsets with Chan's formula, and a half-warp
//   per group merges its channels (equal counts) in two passes, mean
//   first.
//   Backward: (sum dz, sum dz * xhat) per channel, the chunk's share of
//   dbias and dscale, and weighted by scale and summed over a group's
//   channels its share of A and Bg.  cooperative_groups grid sync.
//   phase 2: each block loads its image's chunk partials (a half-warp per
//   group), queues the stream of the same chunk behind those loads, last
//   rows first (the rows it read most recently may still sit in the 50 MB
//   L2), and merges the partials while the stream's first stages fly
//   (forward: the two-pass merge whose plain form is
//   ops/groupnorm.py:combine_chunk_stats).  Then it writes the output
//   from registers with 16-byte stores.
//
// Streaming: a chunk's rows are contiguous in memory, so one thread of the
// block copies it into a ring of four 32 KB shared-memory stages with 1-D
// TMA bulk copies (hopper.cuh bulk_load), each stage completing on its
// mbarrier; up to 128 KB an SM is in flight without holding registers.
// Thread t of the block reads the 8 elements at t * 8 of each pass of
// kThreads * 8 elements (8 channels of one row; a row is C / 8 threads),
// 16 bytes a thread side by side for the 16-bit types, so every thread
// keeps its 8 channels from pass to pass.
//
// A group straddles the 8-channel vectors (C / G is 10 at C = 320, 4 in
// the VAE), so partials are kept per channel until the block's
// reduction, which maps each channel to its group.  Every sum runs in a
// fixed order (threads, then warp shuffles, then chunks in index order);
// there are no atomics, so a rerun is bit-equal.  The variance is merged
// from centred moments, never E[x^2] - E[x]^2, which cancels over the
// 4.2 M elements of a VAE group.
//
// Limits: C a multiple of 8 and at most 4096 (C / 8 threads of one
// 512-thread block for a row), at most 128 groups, 16-byte aligned
// tensors.  The C functions return the cudaError_t of the launch
// (cudaErrorInvalidValue when a limit is not met); the wrapper raises on
// anything else than 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // channels a thread reads at once
constexpr int kMaxGroups = 128;
constexpr int kStages = 4;
constexpr int kStageBytes = 32 * 1024;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kRedBytes = kThreads * kVec * static_cast<int>(sizeof(float2));
// the ring, each thread's per-channel partials, each channel's partial
constexpr int kSmemBytes = kRingBytes + 2 * kRedBytes;
// a group's reductions run on a half-warp; the chunk partials a lane
// holds while merging an image's chunks
constexpr int kHalf = 16;
constexpr int kMergeSlots = 9;
constexpr int kMaxDevices = 64;

// How the [B, S, C] tensor is cut among blocks and threads.
struct Plan {
  int B, S, C, G, CG;
  int NV;   // 8-channel vectors in a row: C / 8
  int rpp;  // rows one pass of a block covers: kThreads / NV
  int P;    // chunks per image
  int R;    // rows per chunk (the last one may be shorter)
  int W;    // work items: B * P
};

bool valid(int B, int S, int C, int G) {
  return B > 0 && S > 0 && G > 0 && G <= kMaxGroups && C % G == 0 &&
         C % kVec == 0 && C / kVec <= kThreads;
}

Plan make_plan(int B, int S, int C, int G, int blocks) {
  Plan p;
  p.B = B;
  p.S = S;
  p.C = C;
  p.G = G;
  p.CG = C / G;
  p.NV = C / kVec;
  p.rpp = kThreads / p.NV;
  int chunks = blocks / B;
  if (chunks > kHalf * kMergeSlots) chunks = kHalf * kMergeSlots;
  if (chunks < 1) chunks = 1;
  if (chunks > S) chunks = S;
  p.R = (S + chunks - 1) / chunks;
  p.P = (S + p.R - 1) / p.R;
  p.W = B * p.P;
  return p;
}

// 8 consecutive elements <-> 8 floats, in 16-byte accesses.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <typename H2>
__device__ __forceinline__ uint32_t bits(H2 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[kVec]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bits(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Io<__half> {
  static __device__ __forceinline__ void load(const __half* p,
                                              float (&v)[kVec]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __half2 h;
      memcpy(&h, &w[i], 4);
      const float2 f = __half22float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p,
                                               const float (&v)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bits(__floats2half2_rn(v[2 * i], v[2 * i + 1]));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Chan et al.: merge (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float tot = n + nb;
  const float f = __fdividef(nb, tot);
  const float delta = mb - mean;
  mean = fmaf(delta, f, mean);
  m2 = m2 + m2b + delta * delta * (n * f);
  n = tot;
}

// The sum over a half-warp, added in a fixed tree order and given to its
// 16 lanes; every lane of the warp takes part.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = kHalf / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xFFFFFFFFu, v, off, kHalf);
  }
  return __shfl_sync(0xFFFFFFFFu, v, 0, kHalf);
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// The per-thread partial at (row offset i, channel c) in `red`.
__device__ __forceinline__ int red_at(const Plan& pl, int i, int c) {
  return (i * pl.NV + c / kVec) * kVec + c % kVec;
}

// A thread's place in its block: row offset ti in a pass, first channel
// c0; threads past rpp * NV read nothing.
struct Lane {
  int t, ti, c0;
  bool active;
  __device__ explicit Lane(const Plan& pl)
      : t(threadIdx.x), ti(threadIdx.x / pl.NV),
        c0((threadIdx.x % pl.NV) * kVec),
        active(threadIdx.x < pl.rpp * pl.NV) {}
};

// The shared-memory ring: kStages stages that thread 0 fills with bulk
// copies and every thread reads, one mbarrier per stage.  `uses` counts
// the stages filled so far, the same in every thread, which gives each
// stage's slot and the parity of its barrier.
struct Ring {
  unsigned char* buf;
  uint32_t bars;
  uint32_t uses;

  __device__ Ring(unsigned char* ring, uint64_t* full)
      : buf(ring), bars(hopper::smem_u32(full)), uses(0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) hopper::mbar_init(bars + 8 * s, 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
  }
};

// One sweep over a chunk of `rows` rows of NT tensors through the ring,
// in row order or last stage first.  A stage holds kPasses passes of
// each tensor (its NT parts side by side).
template <typename T, int NT>
struct Sweep {
  static constexpr int kPasses =
      kStageBytes / (NT * kThreads * kVec * static_cast<int>(sizeof(T)));
  Ring& ring;
  const T* src[NT];
  int rows, C, rpp, stage_rows, n;
  bool reverse;

  __device__ Sweep(Ring& r, const T* const (&s)[NT], int rows_,
                   const Plan& pl, bool reverse_)
      : ring(r), rows(rows_), C(pl.C), rpp(pl.rpp),
        stage_rows(kPasses * pl.rpp),
        n((rows_ + kPasses * pl.rpp - 1) / (kPasses * pl.rpp)),
        reverse(reverse_) {
    for (int j = 0; j < NT; ++j) src[j] = s[j];
  }

  __device__ int stage_of(int i) const { return reverse ? n - 1 - i : i; }

  // Thread 0: the bulk copies of the sweep's i-th stage.
  __device__ void load_stage(int i) const {
    const int r0 = stage_of(i) * stage_rows;
    const int nr = min(stage_rows, rows - r0);
    const uint32_t bytes = static_cast<uint32_t>(nr) * C * sizeof(T);
    const uint32_t slot = (ring.uses + i) % kStages;
    const uint32_t bar = ring.bars + 8 * slot;
    hopper::mbar_arrive_expect_tx(bar, NT * bytes);
    for (int j = 0; j < NT; ++j) {
      hopper::bulk_load(
          hopper::smem_u32(ring.buf + slot * kStageBytes +
                           j * (kStageBytes / NT)),
          src[j] + static_cast<int64_t>(r0) * C, bytes, bar);
    }
  }

  // Start the first stages; the block may work on other things meanwhile.
  __device__ void prefetch() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < n && i < kStages; ++i) load_stage(i);
    }
  }

  // consume(v, r) for each of the thread's rows r of the chunk, v[j] its 8
  // channels of tensor j in shared memory; refills each stage once every
  // thread is done with it.
  template <typename F>
  __device__ void run(const Lane& ln, F&& consume) {
    for (int i = 0; i < n; ++i) {
      const uint32_t u = ring.uses + i, slot = u % kStages;
      hopper::mbar_wait(ring.bars + 8 * slot, (u / kStages) & 1);
      if (ln.active) {
        const unsigned char* stage = ring.buf + slot * kStageBytes;
        for (int k = 0; k < kPasses; ++k) {
          const int r = stage_of(i) * stage_rows + k * rpp + ln.ti;
          if (r >= rows) break;
          const T* v[NT];
          for (int j = 0; j < NT; ++j) {
            v[j] = reinterpret_cast<const T*>(stage +
                                              j * (kStageBytes / NT)) +
                   k * rpp * C + ln.t * kVec;
          }
          consume(v, r);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && i + kStages < n) load_stage(i + kStages);
    }
    ring.uses += n;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, float2* __restrict__ part,
                   const Plan pl, const float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];
  __shared__ float2 stat[kMaxGroups];  // the image's (mean, rstd)
  float2* red = reinterpret_cast<float2*>(smem + kRingBytes);
  float2* cstat = reinterpret_cast<float2*>(smem + kRingBytes + kRedBytes);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Lane ln(pl);
  Ring ring(smem, full);

  // phase 1: (mean, M2) of each group over each chunk
  for (int item = blockIdx.x; item < pl.W; item += gridDim.x) {
    const int b = item / pl.P, row0 = (item % pl.P) * pl.R;
    const int rows = min(pl.R, pl.S - row0);
    const T* src[1] = {x + (static_cast<int64_t>(b) * pl.S + row0) * pl.C};
    Sweep<T, 1> sweep(ring, src, rows, pl, false);
    sweep.prefetch();
    float mean[kVec], m2[kVec], n = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) mean[e] = m2[e] = 0.f;
    sweep.run(ln, [&](const T* const (&v)[1], int) {  // Welford, one row
      float f[kVec];
      Io<T>::load(v[0], f);
      n += 1.f;
      const float inv = __frcp_rn(n);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = f[e] - mean[e];
        mean[e] = fmaf(d, inv, mean[e]);
        m2[e] = fmaf(d, f[e] - mean[e], m2[e]);
      }
    });
    if (ln.active) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        red[ln.t * kVec + e] = make_float2(mean[e], m2[e]);
      }
    }
    __syncthreads();
    // each channel over the row offsets (Chan: the thread at offset i had
    // base + (i < extra) rows)
    const int offsets = min(pl.rpp, rows), base = rows / pl.rpp,
              extra = rows % pl.rpp;
    for (int c = t; c < pl.C; c += kThreads) {
      float cn = 0.f, cmean = 0.f, cm2 = 0.f;
      for (int i = 0; i < offsets; ++i) {
        const float2 e = red[red_at(pl, i, c)];
        chan(cn, cmean, cm2, static_cast<float>(base + (i < extra)), e.x,
             e.y);
      }
      cstat[c] = make_float2(cmean, cm2);
    }
    __syncthreads();
    // a half-warp per group: its channels, `rows` elements each, in two
    // passes
    for (int g0 = 2 * warp; g0 < pl.G; g0 += 2 * kWarps) {
      const int g = g0 + lane / kHalf, hl = lane % kHalf;
      const bool has = g < pl.G;
      const float2* cs = cstat + (has ? g : 0) * pl.CG;
      float sum = 0.f;
      for (int k = hl; has && k < pl.CG; k += kHalf) sum += cs[k].x;
      const float gmean = half_sum(sum) / pl.CG;
      float m2 = 0.f;
      for (int k = hl; has && k < pl.CG; k += kHalf) {
        const float d = cs[k].x - gmean;
        m2 += fmaf(static_cast<float>(rows) * d, d, cs[k].y);
      }
      m2 = half_sum(m2);
      if (has && hl == 0) {
        part[static_cast<int64_t>(item) * pl.G + g] = make_float2(gmean, m2);
      }
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // phase 2: merge the image's chunks, then normalise, affine, SiLU
  for (int item = blockIdx.x; item < pl.W; item += gridDim.x) {
    const int b = item / pl.P, p = item % pl.P, row0 = p * pl.R;
    const int rows = min(pl.R, pl.S - row0);
    const int64_t off = (static_cast<int64_t>(b) * pl.S + row0) * pl.C;
    const T* src[1] = {x + off};
    Sweep<T, 1> sweep(ring, src, rows, pl, true);
    const float total = static_cast<float>(pl.S) * pl.CG;
    for (int g0 = 2 * warp; g0 < pl.G; g0 += 2 * kWarps) {
      // a half-warp per group: the chunks' (mean, M2) and counts, all
      // loads first; then the two-pass merge of combine_chunk_stats
      const int g = g0 + lane / kHalf, hl = lane % kHalf;
      float2 e[kMergeSlots];
      float nq[kMergeSlots];
#pragma unroll
      for (int j = 0; j < kMergeSlots; ++j) {
        const int q = hl + kHalf * j;
        const bool here = g < pl.G && q < pl.P;
        e[j] = here ? __ldcg(part + (static_cast<int64_t>(b) * pl.P + q) *
                                        pl.G + g)
                    : make_float2(0.f, 0.f);
        nq[j] = here ? static_cast<float>(min(pl.R, pl.S - q * pl.R)) * pl.CG
                     : 0.f;
      }
      // the stream's first stages, queued behind these small loads
      if (g0 == 0) sweep.prefetch();
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMergeSlots; ++j) sum = fmaf(nq[j], e[j].x, sum);
      const float gmean = half_sum(sum) / total;
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < kMergeSlots; ++j) {
        const float d = e[j].x - gmean;
        m2 += fmaf(nq[j] * d, d, e[j].y);
      }
      m2 = half_sum(m2);
      if (g < pl.G && hl == 0) {
        const float r = rsqrtf(m2 / total + eps);
        stat[g] = make_float2(gmean, r);
        if (p == 0) {
          mean_out[b * pl.G + g] = gmean;
          rstd_out[b * pl.G + g] = r;
        }
      }
    }
    __syncthreads();
    float mu[kVec], a[kVec], s[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int c = ln.active ? ln.c0 + e : 0;
      const float2 st = stat[c / pl.CG];
      mu[e] = st.x;
      a[e] = st.y * __ldg(scale + c);
      s[e] = __ldg(bias + c);
    }
    T* out = y + off + ln.c0;
    sweep.run(ln, [&](const T* const (&v)[1], int r) {
      float f[kVec];
      Io<T>::load(v[0], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float z = fmaf(f[e] - mu[e], a[e], s[e]);
        f[e] = z * sigmoid(z);
      }
      Io<T>::store(out + static_cast<int64_t>(r) * pl.C, f);
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   float2* __restrict__ gpart, float2* __restrict__ cpart,
                   const Plan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];
  __shared__ float2 stat[kMaxGroups];  // the image's (mean, rstd)
  __shared__ float2 sums[kMaxGroups];  // the image's (A / N, Bg / N)
  float2* red = reinterpret_cast<float2*>(smem + kRingBytes);
  float2* cstat = reinterpret_cast<float2*>(smem + kRingBytes + kRedBytes);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Lane ln(pl);
  Ring ring(smem, full);
  float w[kVec], bb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int c = ln.active ? ln.c0 + e : 0;
    w[e] = __ldg(scale + c);
    bb[e] = __ldg(bias + c);
  }

  // phase 1: per chunk, sum dz and sum dz * xhat of each channel
  for (int item = blockIdx.x; item < pl.W; item += gridDim.x) {
    const int b = item / pl.P, row0 = (item % pl.P) * pl.R;
    const int rows = min(pl.R, pl.S - row0);
    const int64_t off = (static_cast<int64_t>(b) * pl.S + row0) * pl.C;
    const T* src[2] = {x + off, dy + off};
    Sweep<T, 2> sweep(ring, src, rows, pl, false);
    sweep.prefetch();
    if (t < pl.G) {
      stat[t] = make_float2(mean[b * pl.G + t], rstd[b * pl.G + t]);
    }
    __syncthreads();
    float mu[kVec], r[kVec], sdz[kVec], sdzx[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float2 st = stat[(ln.active ? ln.c0 + e : 0) / pl.CG];
      mu[e] = st.x;
      r[e] = st.y;
      sdz[e] = sdzx[e] = 0.f;
    }
    sweep.run(ln, [&](const T* const (&v)[2], int) {
      float xv[kVec], gv[kVec];
      Io<T>::load(v[0], xv);
      Io<T>::load(v[1], gv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xv[e] - mu[e]) * r[e];
        const float z = fmaf(xh, w[e], bb[e]);
        const float s = sigmoid(z);
        const float dz = gv[e] * s * fmaf(z, 1.f - s, 1.f);
        sdz[e] += dz;
        sdzx[e] = fmaf(dz, xh, sdzx[e]);
      }
    });
    if (ln.active) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        red[t * kVec + e] = make_float2(sdz[e], sdzx[e]);
      }
    }
    __syncthreads();
    // the chunk's dbias, dscale partials: each channel over the row offsets
    const int offsets = min(pl.rpp, rows);
    for (int c = t; c < pl.C; c += kThreads) {
      float sx = 0.f, sy = 0.f;
      for (int i = 0; i < offsets; ++i) {
        const float2 e = red[red_at(pl, i, c)];
        sx += e.x;
        sy += e.y;
      }
      cpart[static_cast<int64_t>(item) * pl.C + c] = make_float2(sx, sy);
      const float wc = __ldg(scale + c);
      cstat[c] = make_float2(wc * sx, wc * sy);
    }
    __syncthreads();
    // the chunk's A and Bg: a half-warp per group, scale times the sums
    // above
    for (int g0 = 2 * warp; g0 < pl.G; g0 += 2 * kWarps) {
      const int g = g0 + lane / kHalf, hl = lane % kHalf;
      float sa = 0.f, sb = 0.f;
      for (int k = hl; g < pl.G && k < pl.CG; k += kHalf) {
        sa += cstat[g * pl.CG + k].x;
        sb += cstat[g * pl.CG + k].y;
      }
      sa = half_sum(sa);
      sb = half_sum(sb);
      if (g < pl.G && hl == 0) {
        gpart[static_cast<int64_t>(item) * pl.G + g] = make_float2(sa, sb);
      }
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // phase 2: the image's A and Bg over its chunks, then dx
  const float inv_n = 1.f / (static_cast<float>(pl.S) * pl.CG);
  for (int item = blockIdx.x; item < pl.W; item += gridDim.x) {
    const int b = item / pl.P, row0 = (item % pl.P) * pl.R;
    const int rows = min(pl.R, pl.S - row0);
    const int64_t off = (static_cast<int64_t>(b) * pl.S + row0) * pl.C;
    const T* src[2] = {x + off, dy + off};
    Sweep<T, 2> sweep(ring, src, rows, pl, true);
    if (t < pl.G) {
      stat[t] = make_float2(mean[b * pl.G + t], rstd[b * pl.G + t]);
    }
    for (int g0 = 2 * warp; g0 < pl.G; g0 += 2 * kWarps) {
      // a half-warp per group: the chunks' (A, Bg), all loads first
      const int g = g0 + lane / kHalf, hl = lane % kHalf;
      float2 e[kMergeSlots];
#pragma unroll
      for (int j = 0; j < kMergeSlots; ++j) {
        const int q = hl + kHalf * j;
        e[j] = g < pl.G && q < pl.P
                   ? __ldcg(gpart + (static_cast<int64_t>(b) * pl.P + q) *
                                        pl.G + g)
                   : make_float2(0.f, 0.f);
      }
      // the stream's first stages, queued behind these small loads
      if (g0 == 0) sweep.prefetch();
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < kMergeSlots; ++j) {
        sa += e[j].x;
        sb += e[j].y;
      }
      sa = half_sum(sa);
      sb = half_sum(sb);
      if (g < pl.G && hl == 0) sums[g] = make_float2(sa * inv_n, sb * inv_n);
    }
    __syncthreads();
    float mu[kVec], r[kVec], ma[kVec], mb[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int g = (ln.active ? ln.c0 + e : 0) / pl.CG;
      mu[e] = stat[g].x;
      r[e] = stat[g].y;
      ma[e] = sums[g].x;
      mb[e] = sums[g].y;
    }
    T* out = dx + off + ln.c0;
    sweep.run(ln, [&](const T* const (&v)[2], int row) {
      float xv[kVec], gv[kVec];
      Io<T>::load(v[0], xv);
      Io<T>::load(v[1], gv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xv[e] - mu[e]) * r[e];
        const float z = fmaf(xh, w[e], bb[e]);
        const float s = sigmoid(z);
        const float dxh = gv[e] * s * fmaf(z, 1.f - s, 1.f) * w[e];
        xv[e] = r[e] * (dxh - ma[e] - xh * mb[e]);
      }
      Io<T>::store(out + static_cast<int64_t>(row) * pl.C, xv);
    });
  }

  // dscale, dbias: each channel's chunk partials, in chunk order
  for (int c = blockIdx.x * kThreads + t; c < pl.C;
       c += gridDim.x * kThreads) {
    float sx = 0.f, sy = 0.f;
    for (int item = 0; item < pl.W; ++item) {
      const float2 e = __ldcg(cpart + static_cast<int64_t>(item) * pl.C + c);
      sx += e.x;
      sy += e.y;
    }
    dbias[c] = sx;
    dscale[c] = sy;
  }
}

// Blocks of `kernel` the card holds at once, for the current device (its
// shared memory allowed first).
template <typename K>
int resident_blocks(K kernel) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, kSmemBytes) !=
          cudaSuccess) {
    return 0;
  }
  if (dev < kMaxDevices) cached[dev] = sms * per_sm;
  return sms * per_sm;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Floats of workspace a launch takes: the forward's (mean, M2) per
// (chunk, group); the backward's (A, Bg) per (chunk, group) and (dbias,
// dscale) per (chunk, channel).
int64_t workspace_floats(const Plan& pl, bool backward) {
  const int64_t w = pl.W;
  return 2 * w * pl.G + (backward ? 2 * w * pl.C : 0);
}

template <typename T>
int64_t query(int B, int S, int C, int G, int backward) {
  if (!valid(B, S, C, G)) return -1;
  const int blocks = backward ? resident_blocks(gn_silu_bwd_kernel<T>)
                              : resident_blocks(gn_silu_fwd_kernel<T>);
  if (blocks < 1) return -1;
  return workspace_floats(make_plan(B, S, C, G, blocks), backward != 0);
}

template <typename T>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               void* mean, void* rstd, void* ws, int64_t ws_floats, int B,
               int S, int C, int G, float eps, cudaStream_t stream) {
  if (!valid(B, S, C, G) || !aligned(x) || !aligned(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = resident_blocks(gn_silu_fwd_kernel<T>);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Plan pl = make_plan(B, S, C, G, blocks);
  if (ws_floats < workspace_floats(pl, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  float2* pp = static_cast<float2*>(ws);
  void* args[] = {&xp, &sp, &bp, &yp, &mp, &rp, &pp,
                  const_cast<Plan*>(&pl), &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_silu_fwd_kernel<T>),
      dim3(blocks < pl.W ? blocks : pl.W), dim3(kThreads), args, kSmemBytes,
      stream));
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* scale,
               const void* bias, const void* mean, const void* rstd,
               void* dx, void* dscale, void* dbias, void* ws,
               int64_t ws_floats, int B, int S, int C, int G,
               cudaStream_t stream) {
  if (!valid(B, S, C, G) || !aligned(x) || !aligned(dy) || !aligned(dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = resident_blocks(gn_silu_bwd_kernel<T>);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Plan pl = make_plan(B, S, C, G, blocks);
  if (ws_floats < workspace_floats(pl, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* gp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* dsp = static_cast<float*>(dscale);
  float* dbp = static_cast<float*>(dbias);
  float2* gpart = static_cast<float2*>(ws);
  float2* cpart = gpart + static_cast<int64_t>(pl.W) * pl.G;
  void* args[] = {&gp, &xp, &sp, &bp, &mp, &rp, &dxp, &dsp, &dbp,
                  &gpart, &cpart, const_cast<Plan*>(&pl)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_silu_bwd_kernel<T>),
      dim3(blocks < pl.W ? blocks : pl.W), dim3(kThreads), args, kSmemBytes,
      stream));
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16.  -1 for shapes the kernels do not take.
extern "C" int64_t gn_silu_workspace_floats(int B, int S, int C, int G,
                                            int dtype, int backward) {
  switch (dtype) {
    case 0: return query<float>(B, S, C, G, backward);
    case 1: return query<__nv_bfloat16>(B, S, C, G, backward);
    case 2: return query<__half>(B, S, C, G, backward);
    default: return -1;
  }
}

extern "C" int gn_silu_fwd_f32(const void* x, const void* scale,
                              const void* bias, void* y, void* mean,
                              void* rstd, void* ws, int64_t ws_floats, int B,
                              int S, int C, int G, float eps, void* stream) {
  return launch_fwd<float>(x, scale, bias, y, mean, rstd, ws, ws_floats, B,
                           S, C, G, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int gn_silu_bwd_f32(const void* dy, const void* x,
                              const void* scale, const void* bias,
                              const void* mean, const void* rstd, void* dx,
                              void* dscale, void* dbias, void* ws,
                              int64_t ws_floats, int B, int S, int C, int G,
                              void* stream) {
  return launch_bwd<float>(dy, x, scale, bias, mean, rstd, dx, dscale,
                           dbias, ws, ws_floats, B, S, C, G,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int gn_silu_fwd_bf16(const void* x, const void* scale,
                              const void* bias, void* y, void* mean,
                              void* rstd, void* ws, int64_t ws_floats, int B,
                              int S, int C, int G, float eps, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, scale, bias, y, mean, rstd, ws,
                                   ws_floats, B, S, C, G, eps,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int gn_silu_bwd_bf16(const void* dy, const void* x,
                              const void* scale, const void* bias,
                              const void* mean, const void* rstd, void* dx,
                              void* dscale, void* dbias, void* ws,
                              int64_t ws_floats, int B, int S, int C, int G,
                              void* stream) {
  return launch_bwd<__nv_bfloat16>(dy, x, scale, bias, mean, rstd, dx,
                                   dscale, dbias, ws, ws_floats, B, S, C, G,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int gn_silu_fwd_f16(const void* x, const void* scale,
                              const void* bias, void* y, void* mean,
                              void* rstd, void* ws, int64_t ws_floats, int B,
                              int S, int C, int G, float eps, void* stream) {
  return launch_fwd<__half>(x, scale, bias, y, mean, rstd, ws, ws_floats, B,
                            S, C, G, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int gn_silu_bwd_f16(const void* dy, const void* x,
                              const void* scale, const void* bias,
                              const void* mean, const void* rstd, void* dx,
                              void* dscale, void* dbias, void* ws,
                              int64_t ws_floats, int B, int S, int C, int G,
                              void* stream) {
  return launch_bwd<__half>(dy, x, scale, bias, mean, rstd, dx, dscale,
                            dbias, ws, ws_floats, B, S, C, G,
                            static_cast<cudaStream_t>(stream));
}
