// Separable squared-EDT pass for Hopper (sm_90a):
//
//     out[r, x] = min_j g[r, j] + (x - j)^2      g, out: (rows, n) float32
//
// Replaces the Pallas TPU kernel `_minplus_kernel` of
// ich_tpu/ops/pallas_edt.py (launched by `edt_pass_1d` there). The TPU
// version keeps an (n, n) table of (x - j)^2 and a (16, n, n) working set in
// VMEM; a block here has at most 227 KB of shared memory, so the table is
// never built: each thread recomputes (x - j)^2 in registers.
//
// What bounds it on this card: every row costs n^2 compare-adds against
// 8n bytes of device traffic (read g, write out), so the pass is
// compute-bound (a 256-wide row is 64 Ki compare-adds for 2 KiB). The design
// therefore stages a tile of kRows rows of g in shared memory once and lets
// every thread reuse each (x - j)^2 across those kRows rows, so one shared
// load (a broadcast: all threads of a warp read the same j) and one add+min
// feed each output. The exact O(n) lower-envelope pass (Felzenszwalb &
// Huttenlocher) would remove the n^2 work and is the later optimisation.
//
// Exactness: x, j are ints, so (x - j)^2 is formed in int and converted to
// float exactly (n <= 4096 keeps it below 2^24); the add is done with
// __fadd_rn so the compiler cannot contract it, and fminf is exact. The result
// is therefore bit-equal to the plain PyTorch broadcast-min, including the
// 1e10 sentinel of cells with no site. Built without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;       // rows of g staged per block
constexpr int kThreads = 256;  // threads per block; each owns x, x+256, ...

__global__ void __launch_bounds__(kThreads)
edt_minplus_kernel(const float* __restrict__ g, float* __restrict__ out,
                   int rows, int n) {
  extern __shared__ float sg[];  // (kRows, n)
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, rows - row0);
  const float* gt = g + static_cast<size_t>(row0) * n;
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) {
    // rows past the end of the input are filled but never stored
    sg[i] = i < nr * n ? gt[i] : 0.0f;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    float best[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) best[r] = __int_as_float(0x7f800000);  // +inf
    for (int j = 0; j < n; ++j) {
      const int d = x - j;
      const float d2 = static_cast<float>(d * d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        best[r] = fminf(best[r], __fadd_rn(sg[r * n + j], d2));
      }
    }
    float* ot = out + static_cast<size_t>(row0) * n + x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) ot[static_cast<size_t>(r) * n] = best[r];
    }
  }
}

}  // namespace

extern "C" int edt_minplus_max_n() { return 4096; }

// Launches one pass on `stream`; returns cudaGetLastError() (0 on success).
// g and out are contiguous (rows, n) float32 device buffers.
extern "C" int edt_minplus_pass(const float* g, float* out, int rows, int n,
                                void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > edt_minplus_max_n()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kRows) * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edt_minplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kRows - 1) / kRows;
  edt_minplus_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(g, out, rows, n);
  return static_cast<int>(cudaGetLastError());
}
