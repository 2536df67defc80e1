// Keyed dropout for Hopper (sm_90a): flax's nn.Dropout with XLA's mask
// stream, fused into one pass.
//
//     y = u < keep ? x / div : 0        x, y: float32 or bfloat16
//
// where u in [0, 1) is the top 23 bits of a word of XLA's Philox4x32-10
// stream (rng_bit_generator's DEFAULT algorithm on XLA's CPU and GPU
// backends, XLA's lib/prng.cc, PhiloxBitGenerator) under the rbg key (k0, k1, k2, k3)
// that flax gives the Dropout: block i encrypts the 128-bit counter C + i,
// C holding the words (k2, k3, k0, k1) from low to high, under the key
// (k0, k1), and the element at channels-last position e takes word e % 4
// of block e / 4. The kernel derives that key itself from the step's
// threefry dropout key (s0, s1) and the Dropout's flax fold word: the JAX
// package's dropout_key is jax.random.bits(key, (4,)) (threefry of the
// counters (0, i), the two output words xored), and flax's fold_in of an
// rbg key is threefry's fold_in (threefry of (0, fold)) on each half. The
// first thread of each block hashes these six counters into shared memory:
// a short serial prologue on the card in place of six Python hashes a
// Dropout on the host, which a host-bound train step would wait for.
// `keep` is 1 - rate in float32; `div` is keep rounded to x's dtype, as
// flax's `x / keep_prob` rounds it. The divide is __fdiv_rn (IEEE, round
// to nearest); bfloat16 divides in float32 and rounds once, which equals
// bfloat16's correctly rounded quotient.
//
// This replaces no TPU kernel: the JAX package leaves the mask to XLA. No
// torch call draws XLA's stream, and its ten rounds in int64 torch ops
// would cost some 150 passes over the step's largest tensors.
//
// What bounds it on this card: bytes. It reads x once and writes y once
// (8 bytes an element in float32); Philox costs about 40 integer
// operations a block of four elements, well under the card's rate at that
// byte count. No mask is stored: the backward pass is this kernel applied
// to the gradient. The design keeps each thread on one Philox block, four
// elements, with a grid-stride loop, and orders the threads so that a
// warp's loads are neighbouring addresses:
//
// - `quad_kernel` (C % 4 == 0 and offset % 4 == 0): a block's four words
//   are four channels of one pixel. In NCHW (spatial stride 1) the
//   threads of a warp take neighbouring pixels of one channel quad; in
//   channels-last, the train step's layout (its convs keep the input's
//   channels-last strides), they take neighbouring quads, each loaded and
//   stored as one 16-byte (float32) or 8-byte (bfloat16) vector: scalar
//   accesses there ran at about 40% of the byte bound in the step, vector
//   ones at about 75%.
// - `stream_kernel` (any C and offset): threads walk the blocks in stream
//   order and place each word by its channels-last position.
//
// The tensor is (B, C, S) with S the spatial axes folded into one stride,
// which holds for a dense NCHW and a dense channels-last tensor alike; x
// and y share the strides. Indices are 32-bit where the tensor allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct RbgKey {
  uint32_t k0, k1, k2, k3;
};

// threefry2x32, 20 rounds, as jax/_src/prng.py's _threefry2x32_lowering
__device__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + i + 1;
  }
  return make_uint2(x0, x1);
}

// flax's key of a Dropout: fold_in(dropout_key(step key), fold)
__device__ RbgKey flax_dropout_key(uint32_t s0, uint32_t s1, uint32_t fold) {
  uint32_t w[4];
#pragma unroll
  for (uint32_t i = 0; i < 4; ++i) {
    const uint2 b = threefry2x32(s0, s1, 0u, i);
    w[i] = b.x ^ b.y;
  }
  const uint2 lo = threefry2x32(w[0], w[1], 0u, fold);
  const uint2 hi = threefry2x32(w[2], w[3], 0u, fold);
  return RbgKey{lo.x, lo.y, hi.x, hi.y};
}

// The block's key in shared memory, hashed by its first thread.
__device__ __forceinline__ RbgKey block_key(uint32_t s0, uint32_t s1, uint32_t fold) {
  __shared__ RbgKey key;
  if (threadIdx.x == 0) key = flax_dropout_key(s0, s1, fold);
  __syncthreads();
  return key;
}

// Philox4x32-10 of block `i` of the key's stream.
__device__ __forceinline__ uint4 philox_block(RbgKey key, uint64_t i) {
  const uint64_t lo = ((static_cast<uint64_t>(key.k3) << 32) | key.k2) + i;
  const uint64_t hi = ((static_cast<uint64_t>(key.k1) << 32) | key.k0) + (lo < i ? 1u : 0u);
  uint32_t c0 = static_cast<uint32_t>(lo), c1 = static_cast<uint32_t>(lo >> 32);
  uint32_t c2 = static_cast<uint32_t>(hi), c3 = static_cast<uint32_t>(hi >> 32);
  uint32_t a = key.k0, b = key.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(c0, kM0), lo0 = c0 * kM0;
    const uint32_t hi1 = __umulhi(c2, kM1), lo1 = c2 * kM1;
    c0 = hi1 ^ c1 ^ a;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ b;
    c3 = lo0;
    a += kW0;
    b += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

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

template <typename T>
__device__ __forceinline__ T drop(T v, uint32_t word, float keep, float div) {
  const float u = __uint_as_float((word >> 9) | 0x3F800000u) - 1.0f;
  return from_float<T>(u < keep ? __fdiv_rn(to_float(v), div) : 0.0f);
}

// four channels of one pixel, side by side in a channels-last tensor: one
// 16-byte (float32) or 8-byte (bfloat16) load and store
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

struct Shape {
  int64_t n, c, s;     // batch, channels, folded spatial size
  int64_t sn, sc, ss;  // their strides, in elements
};

// One thread per Philox block of four channels of one pixel. `s_fastest`:
// neighbouring threads take neighbouring pixels (NCHW), else neighbouring
// channel quads (channels-last). `kVec`: the quad is one aligned vector
// (channels-last with aligned pointers), loaded and stored whole; a warp
// then moves 512 contiguous bytes in float32.
template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads) quad_kernel(const T* __restrict__ x,
                                                        T* __restrict__ y, Shape sh, uint32_t s0,
                                                        uint32_t s1, uint32_t fold,
                                                        uint64_t first, bool s_fastest, float keep,
                                                        float div) {
  const RbgKey key = block_key(s0, s1, fold);
  const I quads = static_cast<I>(sh.c / 4), S = static_cast<I>(sh.s);
  const I total = static_cast<I>(sh.n) * quads * S;
  for (I t = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<I>(gridDim.x) * blockDim.x) {
    I s, q, n;
    if (s_fastest) {
      s = t % S;
      const I r = t / S;
      q = r % quads;
      n = r / quads;
    } else {
      q = t % quads;
      const I r = t / quads;
      s = r % S;
      n = r / S;
    }
    const uint4 w = philox_block(key, first + (static_cast<uint64_t>(n) * S + s) * quads + q);
    const uint64_t a = n * static_cast<uint64_t>(sh.sn) + 4 * q * static_cast<uint64_t>(sh.sc) +
                       s * static_cast<uint64_t>(sh.ss);
    if constexpr (kVec) {
      const Quad<T> in = *reinterpret_cast<const Quad<T>*>(x + a);
      Quad<T> out;
      out.v[0] = drop(in.v[0], w.x, keep, div);
      out.v[1] = drop(in.v[1], w.y, keep, div);
      out.v[2] = drop(in.v[2], w.z, keep, div);
      out.v[3] = drop(in.v[3], w.w, keep, div);
      *reinterpret_cast<Quad<T>*>(y + a) = out;
    } else {
      y[a] = drop(x[a], w.x, keep, div);
      y[a + sh.sc] = drop(x[a + sh.sc], w.y, keep, div);
      y[a + 2 * sh.sc] = drop(x[a + 2 * sh.sc], w.z, keep, div);
      y[a + 3 * sh.sc] = drop(x[a + 3 * sh.sc], w.w, keep, div);
    }
  }
}

// One thread per Philox block in stream order; each of its four words goes
// to the element at its channels-last position, where that lies in
// [offset, offset + numel).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) stream_kernel(const T* __restrict__ x,
                                                          T* __restrict__ y, Shape sh,
                                                          uint32_t s0, uint32_t s1, uint32_t fold,
                                                          uint64_t offset, float keep, float div) {
  const RbgKey key = block_key(s0, s1, fold);
  const I C = static_cast<I>(sh.c), S = static_cast<I>(sh.s);
  const uint64_t numel = static_cast<uint64_t>(sh.n) * sh.c * sh.s;
  const uint64_t first = offset / 4;
  const uint64_t blocks = (offset + numel + 3) / 4 - first;
  for (uint64_t t = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x; t < blocks;
       t += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const uint4 w = philox_block(key, first + t);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t pos = (first + t) * 4 + j;
      if (pos < offset || pos - offset >= numel) continue;
      const I e = static_cast<I>(pos - offset);
      const I c = e % C, p = e / C;
      const I s = p % S, n = p / S;
      const uint64_t a = n * static_cast<uint64_t>(sh.sn) + c * static_cast<uint64_t>(sh.sc) +
                         s * static_cast<uint64_t>(sh.ss);
      y[a] = drop(x[a], words[j], keep, div);
    }
  }
}

int grid_for(uint64_t threads) {
  const uint64_t g = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(g < kMaxBlocks ? g : kMaxBlocks);
}

template <typename T, typename I>
void launch(const void* x, void* y, const Shape& sh, uint32_t s0, uint32_t s1, uint32_t fold,
            uint64_t offset, float keep, float div, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const uint64_t numel = static_cast<uint64_t>(sh.n) * sh.c * sh.s;
  if (sh.c % 4 == 0 && offset % 4 == 0) {
    const bool s_fastest = sh.ss == 1 && sh.s > 1;
    constexpr uintptr_t kAlign = 4 * sizeof(T);
    const bool vec = !s_fastest && sh.sc == 1 && sh.sn % 4 == 0 && sh.ss % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % kAlign == 0 &&
                     reinterpret_cast<uintptr_t>(y) % kAlign == 0;
    if (vec) {
      quad_kernel<T, I, true><<<grid_for(numel / 4), kThreads, 0, stream>>>(
          xt, yt, sh, s0, s1, fold, offset / 4, false, keep, div);
    } else {
      quad_kernel<T, I, false><<<grid_for(numel / 4), kThreads, 0, stream>>>(
          xt, yt, sh, s0, s1, fold, offset / 4, s_fastest, keep, div);
    }
  } else {
    const uint64_t blocks = (offset + numel + 3) / 4 - offset / 4;
    stream_kernel<T, I><<<grid_for(blocks), kThreads, 0, stream>>>(xt, yt, sh, s0, s1, fold,
                                                                  offset, keep, div);
  }
}

}  // namespace

// Keyed dropout of x (B, C, S) into y, both with strides (sn, sc, ss), on
// `stream`, under the Dropout's key that flax derives from the step's
// dropout key (s0, s1) and the fold word; dtype 0 is float32, 1 bfloat16.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int keyed_dropout(const void* x, void* y, int dtype, int64_t n, int64_t c, int64_t s,
                             int64_t sn, int64_t sc, int64_t ss, uint32_t s0, uint32_t s1,
                             uint32_t fold, uint64_t offset, float keep, float div,
                             void* stream) {
  if (n <= 0 || c <= 0 || s <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{n, c, s, sn, sc, ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 32-bit indices where every index and address of the tensor fits
  const uint64_t span = (n - 1) * sn + (c - 1) * sc + (s - 1) * ss + 1;
  const bool narrow = static_cast<uint64_t>(n) * c * s < (1ull << 31) && span < (1ull << 31);
  if (dtype == 0) {
    narrow ? launch<float, uint32_t>(x, y, sh, s0, s1, fold, offset, keep, div, st)
           : launch<float, uint64_t>(x, y, sh, s0, s1, fold, offset, keep, div, st);
  } else {
    narrow ? launch<__nv_bfloat16, uint32_t>(x, y, sh, s0, s1, fold, offset, keep, div, st)
           : launch<__nv_bfloat16, uint64_t>(x, y, sh, s0, s1, fold, offset, keep, div, st);
  }
  return static_cast<int>(cudaGetLastError());
}
