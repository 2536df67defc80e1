// The exact euclidean distance transform for Hopper (sm_90a): two kernels.
//
// Kernel A, `envelope_kernel`: one separable squared-EDT pass over lines
//
//     out[l, x] = min_j g[l, j] + (x - j)^2        g, out: float32
//
// by the lower envelope of parabolas (Felzenszwalb & Huttenlocher 2012),
// O(n) per line. It replaces the Pallas TPU kernel `_minplus_kernel` of
// ich_tpu/ops/pallas_edt.py (launched by `edt_pass_1d` there), which takes
// the min over all n^2 pairs (x, j) with an (n, n) table of (x - j)^2 in
// VMEM. A line is either a row of a contiguous (rows, n) tensor or a column
// of a (b, h, w) tensor; the column layout is the H pass of Kernel B and
// needs no transpose: the threads of a warp own neighbouring columns, so
// they load and store neighbouring addresses.
//
// Kernel B, `mask_rows_kernel` then `envelope_kernel` on columns: the whole
// transform of a (b, h, w) mask, as ich_tpu's `distance_transform_edt_pallas`.
// The W pass forms the cost on load (a site where !(mask > 0)) and, the
// input being binary, takes the nearest site left and right of each pixel
// with one warp per row: a ballot per 32 pixels and a carry from chunk to
// chunk. It writes (x - site)^2, or 1e10 for a row without a site, which is
// what the general pass gives on those costs. The H pass (Kernel A on the
// columns, in place) then writes sqrtf(fminf(d2, 1e10)).
//
// What bounds them on this card. The function's least work is memory: a
// pass reads g once and writes out once, 8 bytes a pixel, 2.5 us for a
// 4096x256 pass at 3.35 TB/s; the envelope's arithmetic is a few tens of
// operations a pixel. But the envelope is a dependent chain: built site by
// site (a push, or a pop of the top), evaluated x by x, each step a
// shared-memory load and a few double-precision operations. There are only
// 4096 lines at the GAN's shape, about 31 an SM, so each line's chain of
// dependent instructions, not bytes, sets the time: measured, the pass runs
// at 4-7% of its byte bound (PERF.md). The design cuts the chains short:
//
// - a block stages its lines in shared memory with coalesced loads (16
//   bytes a thread where the layout allows), precomputing each site's
//   g + j^2 in double, and stores the output back the same way;
// - each line is cut into kSegs segments of sites; kSegs threads build
//   their segments' envelopes at once, in place, one pop or push an
//   iteration (so a warp's lines never wait on each other's pops);
// - each thread then owns one range of x. The segment that holds the
//   minimum never moves left as x grows, so the thread needs only the
//   segments from the one holding the minimum at its range's start to the
//   one holding it at its end: bisection in every segment's envelope at the
//   two ends (all searches in step, their latencies overlapping) finds
//   them and where to start; a segment between them that is worse than the
//   first at the range's end, or than the last at its start, never holds
//   it. The thread walks the rest, most often one, taking the least.
//
// The W pass of Kernel B is a chain of only 2n/32 warp steps.
//
// Shared memory: a block owns `lines` lines of length n, their sites and
// envelopes (28 bytes a site) at an odd stride of n | 1 a line: 32 lines
// up to n = 256, 16 at 512, 2 at 4096. Nothing goes to local memory.
//
// Exactness. Intersections are compared by cross-multiplying in double,
// never divided: parabola b leaves the envelope for q when
// (F(q) - F(b)) (b - a) <= (F(b) - F(a)) (q - b), F(j) = g[j] + j^2. The
// evaluation compares parabolas at x by F - 2 x v (x^2 is common) in double,
// and writes the least over segments of __fadd_rn(g[v], (float)((x - v)^2)).
// Where every g[j] is an integer in [0, 2^34] (the EDT's costs: 0, 1e10,
// the squared distances of a first pass) and n <= 4096, every double above
// is exact, each v is a true minimiser, and as rounding is monotone the output
// is bit-equal to the plain broadcast min (`edt_pass_1d_plain`), a line
// without a site giving 1e10. For other finite costs the double comparisons
// can pick, at a near-tie, a parabola above the minimum by a few units of
// 2^-52 relative: the output is then within one float32 ulp of the plain
// version. Built without --use_fast_math: sqrtf is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxN = 4096;
constexpr int kSegs = 8;                 // segments a line is cut into, one thread each
constexpr int kMaxLines = 32;            // lines per block
constexpr int kMinThreads = 128;         // threads per block, at least, that load and store
constexpr int kMaxThreads = kMaxLines * kSegs > kMinThreads ? kMaxLines * kSegs : kMinThreads;
constexpr int kSmemBudget = 227 * 1024;  // bytes of shared memory a block may take
constexpr int kMaskWarps = 8;            // rows per block in the W pass
constexpr float kInf = 1e10f;            // cost of a non-site pixel

// One parabola of an envelope. Its site is kept as a double and a float
// as well, so the loops convert nothing: on this card a conversion to or
// from double issues at a quarter of the double-precision rate.
struct Parabola {
  double f;  // g[v] + v^2, exact on the EDT's costs
  double v;  // its site
  float g;   // its cost g[v]
  float vf;  // its site
};

__host__ __device__ inline int line_stride(int n) { return n | 1; }

__host__ inline size_t envelope_smem(int lines, int n) {
  return static_cast<size_t>(lines) * line_stride(n) * (sizeof(float) + sizeof(Parabola)) +
         static_cast<size_t>(lines) * kSegs * sizeof(int);
}

__host__ inline int envelope_lines(int n) {
  int lines = kMaxLines;
  while (lines > 1 && envelope_smem(lines, n) > kSmemBudget) lines /= 2;
  return lines;
}

__host__ inline int envelope_threads(int lines) { return std::max(lines * kSegs, kMinThreads); }

__device__ inline Parabola site(float g, int j) {
  const double v = j;
  return Parabola{static_cast<double>(g) + v * v, v, g, static_cast<float>(j)};
}

// The lower envelope of the parabolas of the `len` sites of one segment,
// in place: env[j] holds the segment's site j on entry and the envelope's
// parabola j, j <= top, on return; returns top. The envelope never
// overtakes the sites still to read, so no copy is needed.
//
// The threads of a warp run different segments in lockstep, so the sweep is
// one loop whose every iteration is one step, a pop or a push: a segment's
// pops never hold up the others' pushes. Nested loops (pop while ..., then
// push) would serialise the warp on the segment with the most pops at each
// step: a run of sparse sites pops the non-sites before each site.
__device__ int build_segment(Parabola* env, int len) {
  // k is the top of the envelope, b its parabola and a the one below it;
  // q is the site iq, and the one after it is already on its way.
  int k = 0, iq = 1;
  Parabola a = env[0], b = a;
  Parabola q = env[min(1, len - 1)], next = env[min(2, len - 1)];
  while (iq < len) {
    if (k > 0 && (q.f - b.f) * (b.v - a.v) <= (b.f - a.f) * (q.v - b.v)) {
      --k;  // pop b: q's parabola is below it wherever b was lowest
      b = a;
      if (k > 0) a = env[k - 1];
    } else {
      env[++k] = q;  // push q
      a = b;
      b = q;
      q = next;
      ++iq;
      next = env[min(iq + 1, len - 1)];
    }
  }
  return k;
}

// f(x) of a parabola less x^2, which all share: F - 2 x v, with m2x = -2x.
// The fma is exact wherever F is (the EDT's costs).
__device__ inline double key(const Parabola& p, double m2x) { return fma(m2x, p.v, p.f); }

// Writes cost[x] for x in [x0, x1): the least, over the kSegs segment
// envelopes of the line (segment i at env + i * seg, top tops[i], -1 if
// empty), of each one's minimum at x.
//
// The segment that holds the minimum never moves left as x grows (for two
// segments, the later one is below the earlier one on a half-line to the
// right). So the segments from the first that holds it at x0 to the last
// that holds it at x1 - 1 are the only ones to walk, most often one or two:
// bisection finds them and where their walks start, and each walk then
// steps to its next parabola while it is no worse at x, or writes x.
__device__ void evaluate_range(float* cost, const Parabola* env, const int* tops, int seg,
                               int x0, int x1) {
  const double m2x0 = -2.0 * x0, m2x1 = -2.0 * (x1 - 1);
  // bisection for the minimiser of every segment at x0 and at x1 - 1: all
  // 2 kSegs searches in step and without branches, so that their loads
  // issue together and their latencies overlap. An empty segment searches
  // segment 0 for nothing, to keep its loads in bounds.
  int lo0[kSegs], hi0[kSegs], lo1[kSegs], hi1[kSegs];
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    lo0[i] = lo1[i] = 0;
    hi0[i] = hi1[i] = max(tops[i], 0);
  }
  for (int span = seg; span > 1; span = (span + 1) / 2) {
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      const Parabola* e = env + (tops[i] >= 0 ? i * seg : 0);
      const int mid0 = (lo0[i] + hi0[i]) / 2, mid1 = (lo1[i] + hi1[i]) / 2;
      const int top = max(tops[i], 0);
      const bool right0 = key(e[min(mid0 + 1, top)], m2x0) <= key(e[mid0], m2x0);
      const bool right1 = key(e[min(mid1 + 1, top)], m2x1) <= key(e[mid1], m2x1);
      const bool open0 = lo0[i] < hi0[i], open1 = lo1[i] < hi1[i];
      lo0[i] = open0 && right0 ? mid0 + 1 : lo0[i];
      hi0[i] = open0 && !right0 ? mid0 : hi0[i];
      lo1[i] = open1 && right1 ? mid1 + 1 : lo1[i];
      hi1[i] = open1 && !right1 ? mid1 : hi1[i];
    }
  }
  // each segment's least at x0 and at x1 - 1 (+inf if it is empty); the
  // first segment holding the least at x0, the last at x1 - 1
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  double v0[kSegs], v1[kSegs], best0 = inf, best1 = inf;
  int first = 0, last = 0;
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    const Parabola* e = env + (tops[i] >= 0 ? i * seg : 0);
    v0[i] = tops[i] >= 0 ? key(e[lo0[i]], m2x0) : inf;
    v1[i] = tops[i] >= 0 ? key(e[lo1[i]], m2x1) : inf;
    if (v0[i] < best0) {
      best0 = v0[i];
      first = i;
    }
    if (v1[i] <= best1) {
      best1 = v1[i];
      last = i;
    }
  }
  last = max(last, first);  // equal but for rounding off the exact domain
  // A segment between them that is worse than `first` at x1 - 1 is worse
  // than it all over the range (the later segment is the lower one only on
  // a half-line to the right), and one worse than `last` at x0 likewise:
  // neither is walked.
  double first1 = inf, last0 = inf;
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    first1 = i == first ? v1[i] : first1;
    last0 = i == last ? v0[i] : last0;
  }
  unsigned walk = 0;
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    const bool between = i > first && i < last && v1[i] <= first1 && v0[i] <= last0;
    walk |= (i == first || i == last || between ? 1u : 0u) << i;
  }
  for (int i = first; i <= last; ++i) {
    if (!(walk >> i & 1u)) continue;
    const int top = tops[i];
    if (top < 0) continue;
    const Parabola* e = env + i * seg;
    int k = 0;
#pragma unroll
    for (int j = 0; j < kSegs; ++j) k = j == i ? lo0[j] : k;
    Parabola cur = e[k], nxt = e[min(k + 1, top)];
    int x = x0;
    double m2x = m2x0;
    float xf = static_cast<float>(x0);
    while (x < x1) {
      if (k < top && key(nxt, m2x) <= key(cur, m2x)) {
        cur = nxt;
        ++k;
        nxt = e[min(k + 1, top)];
      } else {
        const float d = xf - cur.vf;  // exact: integers below 2^24
        const float value = __fadd_rn(cur.g, __fmul_rn(d, d));
        cost[x] = i == first ? value : fminf(cost[x], value);
        ++x;
        m2x -= 2.0;
        xf += 1.0f;
      }
    }
  }
}

// Kernel A. kCols = false: `lines` consecutive rows of a contiguous
// (rows, n) tensor, in -> out. kCols = true: `lines` neighbouring columns of
// one image of a (b, n, w) tensor (n = h), in place (in == out), storing
// sqrtf(fminf(d2, 1e10)); block i takes the (i % per_image)-th group of
// columns of image i / per_image. All threads load and store; each line
// is cut into kSegs segments of sites, whose envelopes kSegs threads build
// at once, and the same threads then evaluate one range of x each.
template <bool kCols>
__global__ void __launch_bounds__(kMaxThreads)
envelope_kernel(const float* in, float* out, int total, int n, int w, int lines,
                int per_image) {
  extern __shared__ Parabola smem[];
  const int stride = line_stride(n);
  Parabola* env = smem;                                           // (lines, stride)
  float* cost = reinterpret_cast<float*>(env + lines * stride);  // (lines, stride)
  int* tops = reinterpret_cast<int*>(cost + lines * stride);      // (lines, kSegs)
  const int t = threadIdx.x, threads = blockDim.x;
  // first line of the block, and how many it holds (the last is ragged)
  const int image = kCols ? blockIdx.x / per_image : 0;
  const int line0 = (blockIdx.x - image * per_image) * lines;
  const int nl = min(lines, (kCols ? w : total) - line0);
  const size_t base = kCols ? static_cast<size_t>(image) * n * w + line0
                            : static_cast<size_t>(line0) * n;

  if (kCols) {
    for (int i = t; i < nl * n; i += threads) {
      const int y = i / nl, c = i - y * nl;
      env[c * stride + y] = site(in[base + static_cast<size_t>(y) * w + c], y);
    }
  } else if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(in + base);
    for (int i = t; i < nl * n / 4; i += threads) {
      const float4 v = src[i];
      const int r = (4 * i) / n, j = 4 * i - r * n;
      Parabola* dst = env + r * stride + j;
      dst[0] = site(v.x, j);
      dst[1] = site(v.y, j + 1);
      dst[2] = site(v.z, j + 2);
      dst[3] = site(v.w, j + 3);
    }
  } else {
    for (int i = t; i < nl * n; i += threads) {
      const int r = i / n;
      env[r * stride + i - r * n] = site(in[base + i], i - r * n);
    }
  }
  __syncthreads();

  // thread t works on segment t / lines of line t % lines: the threads of
  // a warp hold different lines, so their shared loads fall in other banks
  const int line = t % lines, part = t / lines;
  const int seg = (n + kSegs - 1) / kSegs;
  const int lo = part * seg, hi = min(lo + seg, n);
  const bool active = line < nl && part < kSegs;
  if (active) {
    tops[line * kSegs + part] = lo < hi ? build_segment(env + line * stride + lo, hi - lo) : -1;
  }
  __syncthreads();
  if (active && lo < hi) {
    evaluate_range(cost + line * stride, env + line * stride, tops + line * kSegs, seg, lo, hi);
  }
  __syncthreads();

  if (kCols) {
    for (int i = t; i < nl * n; i += threads) {
      const int y = i / nl, c = i - y * nl;
      out[base + static_cast<size_t>(y) * w + c] = sqrtf(fminf(cost[c * stride + y], kInf));
    }
  } else if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    float4* dst = reinterpret_cast<float4*>(out + base);
    for (int i = t; i < nl * n / 4; i += threads) {
      const int r = (4 * i) / n, j = 4 * i - r * n;
      const float* src = cost + r * stride + j;
      dst[i] = make_float4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int i = t; i < nl * n; i += threads) {
      const int r = i / n;
      out[base + i] = cost[r * stride + i - r * n];
    }
  }
}

// Kernel B's W pass: one warp per row of a contiguous (rows, n) mask. For
// the pixel x, lane x % 32 of chunk x / 32, the nearest site to the left
// comes from the chunk's ballot below the lane or else the carry of the
// chunks before; the nearest to the right likewise, sweeping back.
__global__ void __launch_bounds__(32 * kMaskWarps)
mask_rows_kernel(const float* __restrict__ mask, float* __restrict__ out, int rows, int n) {
  __shared__ unsigned ballots[kMaskWarps][kMaxN / 32];
  __shared__ int left_carry[kMaskWarps][kMaxN / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMaskWarps + warp;
  if (row >= rows) return;
  const float* m = mask + static_cast<size_t>(row) * n;
  float* o = out + static_cast<size_t>(row) * n;
  const int chunks = (n + 31) / 32;
  const int none = -(1 << 20);  // "no site": farther than any pixel

  int carry = none;  // the last site before this chunk
  for (int c = 0; c < chunks; ++c) {
    const int x = c * 32 + lane;
    const bool site = x < n && !(m[x] > 0.0f);
    const unsigned bal = __ballot_sync(0xffffffffu, site);
    if (lane == 0) {
      ballots[warp][c] = bal;
      left_carry[warp][c] = carry;
    }
    if (bal) carry = c * 32 + 31 - __clz(bal);
  }
  __syncwarp();

  carry = -none;  // the first site after this chunk
  for (int c = chunks - 1; c >= 0; --c) {
    const unsigned bal = ballots[warp][c];
    const int x = c * 32 + lane;
    const unsigned below = bal & (0xffffffffu >> (31 - lane));  // bits 0..lane
    const unsigned above = bal & (0xffffffffu << lane);         // bits lane..31
    const int left = below ? c * 32 + 31 - __clz(below) : left_carry[warp][c];
    const int right = above ? c * 32 + __ffs(above) - 1 : carry;
    const int d = min(x - left, right - x);
    if (x < n) o[x] = d < kMaxN ? static_cast<float>(d * d) : kInf;
    if (bal) carry = c * 32 + __ffs(bal) - 1;
  }
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int edt_max_n() { return kMaxN; }

// Each function below launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take. Buffers are contiguous float32 on the device.

// Kernel A on the rows of g (rows, n) into out.
extern "C" int edt_envelope_rows(const float* g, float* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int lines = envelope_lines(n);
  const size_t smem = envelope_smem(lines, n);
  if (int err = set_smem(envelope_kernel<false>, smem)) return err;
  const dim3 grid((rows + lines - 1) / lines);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  envelope_kernel<false><<<grid, envelope_threads(lines), smem, s>>>(
      g, out, rows, n, n, lines, 1);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B's W pass: squared distance along each row of mask (rows, n) to
// its nearest site, into d2.
extern "C" int edt_mask_rows(const float* mask, float* d2, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kMaskWarps - 1) / kMaskWarps;
  mask_rows_kernel<<<blocks, 32 * kMaskWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      mask, d2, rows, n);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B's H pass: Kernel A down the columns of d2 (b, h, w), in place,
// then sqrtf(fminf(., 1e10)).
extern "C" int edt_envelope_cols_sqrt(float* d2, int b, int h, int w, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (h > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int lines = envelope_lines(h);
  const size_t smem = envelope_smem(lines, h);
  if (int err = set_smem(envelope_kernel<true>, smem)) return err;
  const int per_image = (w + lines - 1) / lines;
  const dim3 grid(per_image * b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  envelope_kernel<true><<<grid, envelope_threads(lines), smem, s>>>(
      d2, d2, 0, h, w, lines, per_image);
  return static_cast<int>(cudaGetLastError());
}
