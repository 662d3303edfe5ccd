// Batched dynamic time warping: one anti-diagonal wavefront per pair.
//
// Replaces the TPU kernel deepards_tpu/ops/dtw.py::_dtw_kernel (launched by
// pl.pallas_call in _dtw_pallas_impl).  For each pair (a[p, :la], b[p, :lb])
// it returns the unconstrained DTW cost D[la-1, lb-1], where
//   D[i, j] = |a_i - b_j| + min(D[i-1, j], D[i, j-1], D[i-1, j-1]),
//   D[0, 0] = |a_0 - b_0|,
// with out-of-table neighbours at the f32 sentinel BIG = 8.5e37.
//
// Design (simple first): one block per pair; the cells of anti-diagonal
// d = i + j are independent, so the block's threads stride over them; three
// diagonal buffers (d-2, d-1, d) rotate in dynamic shared memory, indexed by
// the row i, with one __syncthreads() per diagonal.  a and b are staged in
// shared memory once.  Only the cells inside (la, lb) are computed and the
// loop ends at the final cell's diagonal la + lb - 2: cells outside the
// lengths never feed the cells inside them, so the result equals the
// masked full-width recursion of the reference.  The Pallas kernel rolls a
// reversed copy of b because Mosaic cannot roll by a traced shift; here a
// thread reads b[d - i] directly.
//
// Exactness: every cell is one f32 subtraction, abs, two mins and one add,
// the same operations as the plain PyTorch version, built without fast
// math, so results agree bit for bit.
//
// Bound on an H100 SXM (published peaks, 700 W power limit): the
// la + lb - 1 diagonals are dependent steps, each a barrier.  By
// operations, ~5 f32 ops per cell against 67 TFLOP/s outside the tensor
// cores: 65,536 pairs of 224 x 224 are ~16.4 GFLOP, ~0.25 ms at peak,
// against ~118 MB of input, ~0.035 ms at 3.35 TB/s, so the bound is
// operations, and in practice the per-diagonal barrier latency.
// Left for later: several pairs per block for small n, diagonals held in
// registers with the left neighbour taken by warp shuffle.
//
// Shared memory: 5 * n floats (a, b, three diagonals).  Above 48 KB the
// launcher opts in to the larger dynamic limit; dtw_max_width() reports the
// widest n the device takes.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 8.5e37f;
constexpr int kMaxThreads = 512;

__global__ void dtw_wavefront_kernel(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const int* __restrict__ la_ptr,
                                     const int* __restrict__ lb_ptr,
                                     float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + n;
  float* buf0 = sb + n;
  float* buf1 = buf0 + n;
  float* buf2 = buf1 + n;

  const int pair = blockIdx.x;
  const int la = la_ptr[pair];
  const int lb = lb_ptr[pair];
  if (la < 1 || lb < 1 || la > n || lb > n) {  // block-uniform exit
    if (threadIdx.x == 0) out[pair] = nanf("");
    return;
  }
  const float* pa = a + static_cast<size_t>(pair) * n;
  const float* pb = b + static_cast<size_t>(pair) * n;
  for (int i = threadIdx.x; i < la; i += blockDim.x) sa[i] = pa[i];
  for (int j = threadIdx.x; j < lb; j += blockDim.x) sb[j] = pb[j];
  __syncthreads();

  float* prev2 = buf0;  // diagonal d-2
  float* prev = buf1;   // diagonal d-1
  float* cur = buf2;    // diagonal d
  const int last = la + lb - 2;
  for (int d = 0; d <= last; ++d) {
    const int lo = max(0, d - lb + 1);
    const int hi = min(d, la - 1);
    for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
      const int j = d - i;
      const float cost = fabsf(sa[i] - sb[j]);
      float best;
      if (d == 0) {
        best = 0.0f;
      } else {
        const float up = j > 0 ? prev[i] : kBig;               // (i, j-1)
        const float left = i > 0 ? prev[i - 1] : kBig;         // (i-1, j)
        const float diag = (i > 0 && j > 0) ? prev2[i - 1] : kBig;
        best = fminf(fminf(up, left), diag);
      }
      const float v = cost + best;
      cur[i] = v;
      if (d == last) out[pair] = v;  // only cell (la-1, lb-1) is on it
    }
    __syncthreads();
    float* t = prev2;
    prev2 = prev;
    prev = cur;
    cur = t;
  }
}

size_t smem_bytes(int n) { return 5 * static_cast<size_t>(n) * sizeof(float); }

}  // namespace

extern "C" {

// Widest n one block can hold on the current device, or -1 on error.
int dtw_max_width() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin / static_cast<int>(5 * sizeof(float));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// a, b: (batch, n) f32; la, lb: (batch,) int32 in [1, n]; out: (batch,) f32.
int dtw_wavefront(const float* a, const float* b, const int* la,
                  const int* lb, float* out, int batch, int n,
                  void* stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  dtw_wavefront_kernel<<<batch, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a, b, la, lb,
                                                               out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* dtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
