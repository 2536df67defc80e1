// GroupNorm followed by ReLU for Hopper (sm_90a), forward and backward:
// two launches a forward call and two a backward call.
//
//     y = relu(a_c * x + b_c),   a_c = rstd * gamma_c,   b_c = beta_c - mean * a_c
//
// x and y: a contiguous channels-first tensor (N, C, S), S the spatial
// axes folded, in float32 or bfloat16; mean and rstd = 1 / sqrt(var + eps)
// the biased statistics of each (n, group) row of C / G channels, in
// float32. gamma and beta are float32, rounded to bfloat16 first where x is
// bfloat16 (`round_params`), as the port casts a norm's parameters to its
// input's dtype. a_c and b_c are formed as ATen's ComputeFusedParams forms
// them, and y is computed in float32 and rounded once: relu(round(v)) is
// round(relu(v)). ATen's own bfloat16 group_norm on the card rounds mean
// and rstd to bfloat16 before the apply (its native_group_norm keeps them
// in the parameters' dtype); these kernels keep them in float32, as
// ATen's CPU kernel does.
//
// This replaces no TPU kernel: the JAX package's FlatGroupNorm
// (ich_tpu/models/layers.py) is left to XLA, which fuses its reductions and
// its normalise pass with the ReLU. On this card torch runs GroupNorm as a
// statistics kernel with one block per (n, group) row, a params kernel, a
// broadcast apply and a separate ReLU, and its backward as the ReLU's mask
// pass, an internal-gradient pass, a broadcast dx and a gamma/beta
// reduction.
//
// What bounds it on this card: bytes. A forward reads x twice (the
// statistics, then the apply) and writes y once; a backward reads x and dy
// twice (the per-channel sums, then dx) and writes dx once. A few float32
// operations an element sit far under the card's rate at those bytes. The
// design:
//
// - The grid is sized by the tensor, not by N * G: every (n, c) plane of S
//   elements is cut into P segments of `chunk` elements (the wrapper picks
//   `chunk` so that P stays small: ops/group_norm.py), one block a segment.
//   A 64^3 row of 4 M elements spreads over hundreds of blocks of 256
//   threads; a short 8^3 plane fills one block of one warp, since a grid of
//   small planes is bound by the blocks' count and their prologues, not by
//   bytes (256-thread blocks there ran at 5% of the byte bound on an H100).
// - Loads and stores are 16 bytes a thread (`kVec`: 8 bfloat16 or 4
//   float32 elements), four vectors a thread in flight, where S and the
//   pointers allow; else one element at a time.
// - No atomics: each block writes its segment's partials, and a block of
//   the next kernel merges its row's partials in a fixed order in its
//   prologue, so every block of a row forms the same a_c and b_c and a run
//   repeats bit for bit. The statistics are (mean, M2) per segment, merged
//   by Chan's formula: no sum of squares, so no cancellation.
// - The backward saves nothing of y: it recomputes a_c * x + b_c > 0, the
//   ReLU's mask, from x and the saved mean and rstd.
//
// Indices of elements are 64-bit at the segment's start and 32-bit inside
// it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;  // a block's threads: a multiple of 32, at most this
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnroll = 4;  // vectors a thread has in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a bfloat16 pair of a 32-bit word (the first element in the low half) and back
__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// `kVec` elements from p: one 16-byte load, or one element
template <typename T, int kVec>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = to_float(*p);
  } else {
    static_assert(kVec * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same_v<T, float>) {
        v[j] = __uint_as_float(w[j]);
      } else {
        unpack(w[j], v[2 * j], v[2 * j + 1]);
      }
    }
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    *p = from_float<T>(v[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same_v<T, float>) {
        w[j] = __float_as_uint(v[j]);
      } else {
        w[j] = pack(v[2 * j], v[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The ReLU as torch's clamp_min(0): NaN and -0.0 pass through.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

struct Geom {
  int64_t n, c, s;  // batch, channels, folded spatial size
  int64_t groups;
  int64_t chunk;    // elements of a segment
  int64_t p;        // segments a plane: ceil(s / chunk)
  int threads;      // a block's
};

// The segment of block b: its plane n * C + c, its index k in the plane,
// its first element and its length.
struct Segment {
  int64_t plane, k, start;
  int len;
};

__device__ __forceinline__ Segment segment(const Geom& g, int64_t b) {
  const int64_t plane = b / g.p, k = b % g.p;
  const int64_t first = k * g.chunk;
  const int64_t left = g.s - first;
  return Segment{plane, k, plane * g.s + first, static_cast<int>(left < g.chunk ? left : g.chunk)};
}

__device__ __forceinline__ float param(const float* __restrict__ p, int64_t i, bool round) {
  const float v = p[i];
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ---- reductions in a fixed order ------------------------------------------

struct Moments {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2)
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  const float fb = n > 0.0f ? b.n / n : 0.0f;
  const float d = b.mean - a.mean;
  return Moments{n, fmaf(d, fb, a.mean), a.m2 + b.m2 + d * d * a.n * fb};
}

// The block's merge of every thread's moments, in thread order; the result
// is valid in every thread.
__device__ Moments block_merge(Moments m) {
  __shared__ Moments warp_m[kMaxWarps];
  __shared__ Moments total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Moments other{__shfl_down_sync(0xFFFFFFFFu, m.n, o), __shfl_down_sync(0xFFFFFFFFu, m.mean, o),
                  __shfl_down_sync(0xFFFFFFFFu, m.m2, o)};
    m = merge(m, other);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments t = warp_m[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) t = merge(t, warp_m[w]);
    total = t;
  }
  __syncthreads();
  return total;
}

// The block's sum of every thread's pair, in a fixed order; valid in every
// thread.
__device__ float2 block_sum(float2 v) {
  __shared__ float2 warp_v[kMaxWarps];
  __shared__ float2 total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xFFFFFFFFu, v.x, o);
    v.y += __shfl_down_sync(0xFFFFFFFFu, v.y, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_v[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = warp_v[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      t.x += warp_v[w].x;
      t.y += warp_v[w].y;
    }
    total = t;
  }
  __syncthreads();
  return total;
}

// The moments of row (n, grp): its C / G * P segments' partials merged.
__device__ Moments row_moments(const float2* __restrict__ partials, const Geom& g, int64_t n,
                               int64_t grp) {
  const int64_t cpg = g.c / g.groups;
  const int64_t first = (n * g.c + grp * cpg) * g.p;  // the row's planes are contiguous
  const int64_t entries = cpg * g.p;
  Moments m{0.0f, 0.0f, 0.0f};
  for (int64_t e = threadIdx.x; e < entries; e += blockDim.x) {
    const int64_t k = e % g.p;
    const int64_t left = g.s - k * g.chunk;
    const float2 pm = partials[first + e];
    m = merge(m, Moments{static_cast<float>(left < g.chunk ? left : g.chunk), pm.x, pm.y});
  }
  return block_merge(m);
}

// ---- forward --------------------------------------------------------------

// One block a segment: its (mean, M2), from each vector's own exact
// moments merged into the thread's.
template <typename T, int kVec, int kBlock>
__global__ void __launch_bounds__(kMaxThreads)
    stats_kernel(const T* __restrict__ x, float2* __restrict__ partials, Geom g) {
  const Segment seg = segment(g, blockIdx.x);
  const T* xs = x + seg.start;
  const int nvec = seg.len / kVec;
  const int nt = kBlock > 0 ? kBlock : static_cast<int>(blockDim.x);
  Moments m{0.0f, 0.0f, 0.0f};
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kUnroll * nt) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nvec) load<T, kVec>(xs + static_cast<int64_t>(i) * kVec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * nt >= nvec) break;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[u][j];
      const float mu = sum * (1.0f / kVec);
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[u][j] - mu;
        q = fmaf(d, d, q);
      }
      m = merge(m, Moments{static_cast<float>(kVec), mu, q});
    }
  }
  m = block_merge(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(m.mean, m.m2);
}

// One block a segment: the row's statistics merged in the prologue, then
// y = relu(a_c * x + b_c). The row's first block stores its mean and rstd.
template <typename T, int kVec, int kBlock>
__global__ void __launch_bounds__(kMaxThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float2* __restrict__ partials,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out, Geom g, float eps,
                 bool round_params) {
  __shared__ float ab[2];
  const Segment seg = segment(g, blockIdx.x);
  const int64_t cpg = g.c / g.groups;
  const int64_t n = seg.plane / g.c, c = seg.plane % g.c, grp = c / cpg;
  const Moments m = row_moments(partials, g, n, grp);
  if (threadIdx.x == 0) {
    const float var = m.m2 / static_cast<float>(cpg * g.s);
    const float rstd = 1.0f / sqrtf(var + eps);
    const float a = rstd * param(gamma, c, round_params);
    ab[0] = a;
    ab[1] = fmaf(-a, m.mean, param(beta, c, round_params));
    if (c % cpg == 0 && seg.k == 0) {
      mean_out[n * g.groups + grp] = m.mean;
      rstd_out[n * g.groups + grp] = rstd;
    }
  }
  __syncthreads();
  const float a = ab[0], b = ab[1];
  const T* xs = x + seg.start;
  T* ys = y + seg.start;
  const int nvec = seg.len / kVec;
  const int nt = kBlock > 0 ? kBlock : static_cast<int>(blockDim.x);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kUnroll * nt) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nvec) load<T, kVec>(xs + static_cast<int64_t>(i) * kVec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i >= nvec) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[u][j] = relu(fmaf(a, v[u][j], b));
      store<T, kVec>(ys + static_cast<int64_t>(i) * kVec, v[u]);
    }
  }
}

// ---- backward -------------------------------------------------------------

// a_c, b_c of plane (n, c) from the saved statistics, as the forward formed
// them; mean and rstd of its row.
struct PlaneParams {
  float a, b, mean, rstd;
};

__device__ __forceinline__ PlaneParams plane_params(const float* __restrict__ gamma,
                                                    const float* __restrict__ beta,
                                                    const float* __restrict__ mean,
                                                    const float* __restrict__ rstd,
                                                    const Geom& g, int64_t n, int64_t c,
                                                    bool round_params) {
  const int64_t row = n * g.groups + c / (g.c / g.groups);
  const float mu = mean[row], r = rstd[row];
  const float a = r * param(gamma, c, round_params);
  return PlaneParams{a, fmaf(-a, mu, param(beta, c, round_params)), mu, r};
}

// One block a segment: with the ReLU's mask recomputed, g = dy where
// a_c x + b_c > 0, the segment's sums of g and of g * xhat,
// xhat = (x - mean) * rstd.
template <typename T, int kVec, int kBlock>
__global__ void __launch_bounds__(kMaxThreads)
    grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     float2* __restrict__ partials, Geom g, bool round_params) {
  const Segment seg = segment(g, blockIdx.x);
  const PlaneParams pp = plane_params(gamma, beta, mean, rstd, g, seg.plane / g.c,
                                      seg.plane % g.c, round_params);
  const T* xs = x + seg.start;
  const T* ds = dy + seg.start;
  const int nvec = seg.len / kVec;
  const int nt = kBlock > 0 ? kBlock : static_cast<int>(blockDim.x);
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kUnroll * nt) {
    float v[kUnroll][kVec], d[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nvec) {
        load<T, kVec>(xs + static_cast<int64_t>(i) * kVec, v[u]);
        load<T, kVec>(ds + static_cast<int64_t>(i) * kVec, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * nt >= nvec) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float gj = fmaf(pp.a, v[u][j], pp.b) > 0.0f ? d[u][j] : 0.0f;
        acc.x += gj;
        acc.y = fmaf(gj, (v[u][j] - pp.mean) * pp.rstd, acc.y);
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// Blocks below N * C * P: one a segment, dx = a_c g - rstd / L (A + xhat B)
// with A, B the row's sums of gamma_c * sum(g) and gamma_c * sum(g xhat),
// merged from the partials in the prologue, and L the row's length. The C
// blocks above: one a channel, dbeta_c = sum(g) and dgamma_c = sum(g xhat)
// over the batch.
template <typename T, int kVec, int kBlock>
__global__ void __launch_bounds__(kMaxThreads)
    grad_x_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const float2* __restrict__ partials, float* __restrict__ dgamma,
                  float* __restrict__ dbeta, Geom g, bool round_params) {
  const int64_t segments = g.n * g.c * g.p;
  if (blockIdx.x >= segments) {
    const int64_t c = blockIdx.x - segments;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int64_t e = threadIdx.x; e < g.n * g.p; e += blockDim.x) {
      const float2 v = partials[((e / g.p) * g.c + c) * g.p + e % g.p];
      acc.x += v.x;
      acc.y += v.y;
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) {
      dbeta[c] = acc.x;
      dgamma[c] = acc.y;
    }
    return;
  }
  __shared__ float coef[2];
  const Segment seg = segment(g, blockIdx.x);
  const int64_t cpg = g.c / g.groups;
  const int64_t n = seg.plane / g.c, c = seg.plane % g.c, grp = c / cpg;
  const PlaneParams pp = plane_params(gamma, beta, mean, rstd, g, n, c, round_params);
  const int64_t first = (n * g.c + grp * cpg) * g.p;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int64_t e = threadIdx.x; e < cpg * g.p; e += blockDim.x) {
    const float w = param(gamma, grp * cpg + e / g.p, round_params);
    const float2 v = partials[first + e];
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float k = -pp.rstd / static_cast<float>(cpg * g.s);
    coef[0] = k * acc.x;  // the constant term
    coef[1] = k * acc.y;  // xhat's
  }
  __syncthreads();
  const float k0 = coef[0], k1 = coef[1];
  const T* xs = x + seg.start;
  const T* ds = dy + seg.start;
  T* os = dx + seg.start;
  const int nvec = seg.len / kVec;
  const int nt = kBlock > 0 ? kBlock : static_cast<int>(blockDim.x);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kUnroll * nt) {
    float v[kUnroll][kVec], d[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nvec) {
        load<T, kVec>(xs + static_cast<int64_t>(i) * kVec, v[u]);
        load<T, kVec>(ds + static_cast<int64_t>(i) * kVec, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i >= nvec) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float gj = fmaf(pp.a, v[u][j], pp.b) > 0.0f ? d[u][j] : 0.0f;
        const float xh = (v[u][j] - pp.mean) * pp.rstd;
        v[u][j] = fmaf(pp.a, gj, fmaf(k1, xh, k0));
      }
      store<T, kVec>(os + static_cast<int64_t>(i) * kVec, v[u]);
    }
  }
}

// ---- launches -------------------------------------------------------------

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The geometry, or false for arguments the kernels do not take: a vector
// width other than one element or 16 bytes, one that does not divide S or
// the chunk; a block of other than 32 to 256 threads in whole warps; a
// segment count that does not fit the grid.
bool geometry(int dtype, int64_t n, int64_t c, int64_t s, int64_t groups, int64_t chunk, int vec,
              int threads, Geom* g) {
  const int64_t full = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n <= 0 || c <= 0 || s <= 0 || groups <= 0 ||
      c % groups != 0 || chunk <= 0 || (vec != 1 && vec != full) || s % vec != 0 ||
      chunk % vec != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return false;
  const int64_t p = (s + chunk - 1) / chunk;
  if (n * c * p + c >= (1ll << 31) || chunk >= (1ll << 31)) return false;
  *g = Geom{n, c, s, groups, chunk, p, threads};
  return true;
}

template <typename T, int kVec, int kBlock>
int forward_as(const void* x, void* y, const float* gamma, const float* beta, float2* partials,
               float* mean, float* rstd, const Geom& g, float eps, bool round_params,
               cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(g.n * g.c * g.p);
  const T* xt = static_cast<const T*>(x);
  stats_kernel<T, kVec, kBlock><<<blocks, g.threads, 0, st>>>(xt, partials, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<T, kVec, kBlock><<<blocks, g.threads, 0, st>>>(
      xt, static_cast<T*>(y), gamma, beta, partials, mean, rstd, g, eps, round_params);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec, int kBlock>
int backward_as(const void* x, const void* dy, void* dx, const float* gamma, const float* beta,
                const float* mean, const float* rstd, float2* partials, float* dgamma,
                float* dbeta, const Geom& g, bool round_params, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(g.n * g.c * g.p);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  grad_sums_kernel<T, kVec, kBlock><<<blocks, g.threads, 0, st>>>(xt, dyt, gamma, beta, mean,
                                                                   rstd, partials, g, round_params);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_x_kernel<T, kVec, kBlock><<<blocks + static_cast<unsigned>(g.c), g.threads, 0, st>>>(
      xt, dyt, static_cast<T*>(dx), gamma, beta, mean, rstd, partials, dgamma, dbeta, g,
      round_params);
  return static_cast<int>(cudaGetLastError());
}

// The launches with the block's size fixed at compile time where it is the
// largest (the long planes': on an H100 the bf16 backward ran some 13% slower
// with its loops' stride known only at launch), else sized at launch (short
// planes).
template <typename T, int kVec>
int forward(const void* x, void* y, const float* gamma, const float* beta, float2* partials,
            float* mean, float* rstd, const Geom& g, float eps, bool round_params,
            cudaStream_t st) {
  return g.threads == kMaxThreads
             ? forward_as<T, kVec, kMaxThreads>(x, y, gamma, beta, partials, mean, rstd, g, eps,
                                                round_params, st)
             : forward_as<T, kVec, 0>(x, y, gamma, beta, partials, mean, rstd, g, eps,
                                      round_params, st);
}

template <typename T, int kVec>
int backward(const void* x, const void* dy, void* dx, const float* gamma, const float* beta,
             const float* mean, const float* rstd, float2* partials, float* dgamma, float* dbeta,
             const Geom& g, bool round_params, cudaStream_t st) {
  return g.threads == kMaxThreads
             ? backward_as<T, kVec, kMaxThreads>(x, dy, dx, gamma, beta, mean, rstd, partials,
                                                 dgamma, dbeta, g, round_params, st)
             : backward_as<T, kVec, 0>(x, dy, dx, gamma, beta, mean, rstd, partials, dgamma,
                                       dbeta, g, round_params, st);
}

}  // namespace

// relu(group_norm(x)) of x (N, C, S) into y, contiguous, on `stream`: the
// statistics kernel, then the apply. dtype 0 is float32, 1 bfloat16 (gamma
// and beta rounded to it); `chunk` elements a segment, `vec` elements a
// load (1, or 16 bytes' worth), `threads` a block (32 to 256, whole warps:
// short planes take small blocks). `partials` holds N * C * ceil(S / chunk)
// float pairs of scratch; mean and rstd (N * groups floats each) receive
// the statistics. Returns the first non-zero cudaGetLastError() of the two
// launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int group_norm_relu_forward(const void* x, void* y, const float* gamma,
                                       const float* beta, float* partials, float* mean,
                                       float* rstd, int dtype, int64_t n, int64_t c, int64_t s,
                                       int64_t groups, int64_t chunk, int vec, int threads,
                                       float eps, void* stream) {
  Geom g;
  if (!geometry(dtype, n, c, s, groups, chunk, vec, threads, &g) ||
      (vec > 1 && !(aligned(x) && aligned(y))))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* part = reinterpret_cast<float2*>(partials);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    return vec == 1 ? forward<bf16, 1>(x, y, gamma, beta, part, mean, rstd, g, eps, true, st)
                    : forward<bf16, 8>(x, y, gamma, beta, part, mean, rstd, g, eps, true, st);
  }
  return vec == 1 ? forward<float, 1>(x, y, gamma, beta, part, mean, rstd, g, eps, false, st)
                  : forward<float, 4>(x, y, gamma, beta, part, mean, rstd, g, eps, false, st);
}

// The gradients of relu(group_norm(x)) from dy: dx (x's dtype and shape),
// dgamma and dbeta (C floats each), from x and the forward's mean and rstd,
// on `stream`: the per-segment sums, then dx and the per-channel sums.
// Arguments as group_norm_relu_forward's; dy and dx contiguous like x.
extern "C" int group_norm_relu_backward(const void* x, const void* dy, void* dx,
                                        const float* gamma, const float* beta,
                                        const float* mean, const float* rstd, float* partials,
                                        float* dgamma, float* dbeta, int dtype, int64_t n,
                                        int64_t c, int64_t s, int64_t groups, int64_t chunk,
                                        int vec, int threads, void* stream) {
  Geom g;
  if (!geometry(dtype, n, c, s, groups, chunk, vec, threads, &g) ||
      (vec > 1 && !(aligned(x) && aligned(dy) && aligned(dx))))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* part = reinterpret_cast<float2*>(partials);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec == 1 ? backward<__nv_bfloat16, 1>(x, dy, dx, gamma, beta, mean, rstd, part, dgamma,
                                                 dbeta, g, true, st)
                    : backward<__nv_bfloat16, 8>(x, dy, dx, gamma, beta, mean, rstd, part, dgamma,
                                                 dbeta, g, true, st);
  }
  return vec == 1 ? backward<float, 1>(x, dy, dx, gamma, beta, mean, rstd, part, dgamma, dbeta, g,
                                       false, st)
                  : backward<float, 4>(x, dy, dx, gamma, beta, mean, rstd, part, dgamma, dbeta, g,
                                       false, st);
}
