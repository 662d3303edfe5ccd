// Batched dynamic time warping, warp-synchronous: one warp per strip of
// rows, the strip's cells in registers, neighbours by warp shuffle.
//
// Replaces the TPU kernel deepards_tpu/ops/dtw.py::_dtw_kernel (launched by
// pl.pallas_call in _dtw_pallas_impl).  For each pair (a[p, :la], b[p, :lb])
// it returns the unconstrained DTW cost D[la-1, lb-1], where
//   D[i, j] = |a_i - b_j| + min(D[i-1, j], D[i, j-1], D[i-1, j-1]),
//   D[0, 0] = |a_0 - b_0|,
// with out-of-table neighbours at the f32 sentinel BIG = 8.5e37.
//
// Design.  Lane t of a warp owns R consecutive rows [tR, tR + R) of a strip
// of 32R rows and holds their a values and their cells of the current
// column in registers.  At warp step s lane t computes column j = s - t,
// walking down its R rows in place: a cell's left neighbour D[i, j-1] is
// the register it overwrites, the cell above is the one just computed, and
// for the lane's first row the cell above, D[tR-1, j], is lane t-1's last
// row from step s-1, taken by __shfl_up_sync; its diagonal D[tR-1, j-1] is
// the value taken at step s-1.  b[j] flows down the warp the same way:
// lane 0 takes b[s] from a register chunk of 32 values loaded (coalesced)
// one chunk ahead, and lane t takes lane t-1's.  The origin is seeded by
// D[-1, -1] = 0, every other out-of-table neighbour is BIG.  A strip takes
// lb + 31 barrier-free steps instead of la + lb - 1 barriered diagonals.
// Every lane computes at every step (the shuffles need all 32 lanes), with
// no guard: before its column 0 a lane sees only BIG neighbours and b = 0,
// so its cells stay at |a| + BIG >= BIG and never win a min against a
// finite cell of the table; cells right of lb or below la never feed the
// cells inside.
//
//  - n <= 256 (every per-breath score: n = 256 after bucketing): one warp
//    per pair, R = ceil(n / 32) in 1..8 (a template parameter, so the cells
//    stay in registers), kPairWarps pairs per block, no shared memory and
//    no block barrier.  The warp stops at the step where the lane owning row
//    la-1 reaches column lb-1, so short pairs finish early.
//  - n > 256 (n = 4480 from find_patient_similarity, any n from the
//    patient Grad-CAM's pairwise matrix): one block per pair, R = 8, warp w
//    on strip w of 256 rows.  Warp w hands the bottom row of its strip to
//    warp w+1 through a ring of kRing floats in shared memory.  The warps
//    run in lockstep super-steps of 32 steps with one __syncthreads() each,
//    warp w two super-steps behind warp w-1 (its lane 31 finishes column j
//    at step j + 31), so a strip pass costs ceil((lb + 31) / 32) + 2(W - 1)
//    barriers instead of la + lb - 1.  A pair with more strips than the
//    block has warps (n > 32 * 256) walks them in passes; the boundary row
//    between passes goes through a (batch, n) scratch tensor that the
//    wrapper allocates.  b is read in coalesced chunks of 32 through L1, so
//    shared memory is a fixed 16 KB and there is no width limit beyond
//    device memory.  An mbarrier hand-off per pair of neighbouring warps
//    would replace the block barrier; not done.
//
// Exactness: every cell is one f32 subtract, abs, two mins and one add, the
// same operations as the plain PyTorch version, built without fast math.
// All values are finite and >= +0, so a min of three is the same in any
// order and the results agree bit for bit.
//
// Bound on an H100 SXM: a cell is four FP32 instructions in the SASS
// (FADD for a - b, two FMNMX, FADD taking |a - b| as an operand modifier),
// issued at 132 SMs x 128 lanes x the SM clock (~3.35e13/s at 1.98 GHz):
// 65,536 pairs of 224 x 224 need ~0.39 ms.  Their 118 MB of input need
// ~0.035 ms at 3.35 TB/s, so operations bound the kernel.  Beyond the 4R
// cell instructions a warp step issues three shuffles and loop control
// (~36 instructions a step at R = 7, ~40 at R = 8); the wide path adds the
// hand-off's shuffles and selects (~50 at R = 8).  All of a wide pair's
// strips run on one SM, so a few hundred pairs load the 132 SMs unevenly.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 8.5e37f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairWarps = 4;    // pairs (warps) per block, n <= 256
constexpr int kWideR = 8;        // rows per lane, n > 256
constexpr int kStrip = 32 * kWideR;
constexpr int kMaxWarps = 32;    // strips per pass, n > 256
constexpr int kRing = 128;       // columns a hand-off ring holds

// One warp step for lane t: col[r] holds D[tR + r, j - 1] on entry and
// D[tR + r, j] on exit.  above = D[tR - 1, j], above_prev = D[tR - 1, j - 1].
template <int R>
__device__ __forceinline__ void cell_column(float (&col)[R],
                                            const float (&ar)[R], float bj,
                                            float above, float above_prev) {
  float left = above;
  float diag = above_prev;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float up = col[r];
    const float v = fabsf(ar[r] - bj) + fminf(fminf(up, diag), left);
    diag = up;
    left = v;
    col[r] = v;
  }
}

template <int R>
__device__ __forceinline__ float pick(const float (&col)[R], int r) {
  float v = col[0];
#pragma unroll
  for (int k = 1; k < R; ++k)
    if (k == r) v = col[k];
  return v;
}

__device__ __forceinline__ bool bad_lengths(int la, int lb, int n) {
  return la < 1 || lb < 1 || la > n || lb > n;
}

// n <= 32 * R: one warp per pair.
template <int R>
__global__ void __launch_bounds__(kPairWarps * 32)
    dtw_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ la_ptr,
                    const int* __restrict__ lb_ptr, float* __restrict__ out,
                    int batch, int n) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (pair >= batch) return;  // warp-uniform
  const int la = la_ptr[pair];
  const int lb = lb_ptr[pair];
  if (bad_lengths(la, lb, n)) {
    if (lane == 0) out[pair] = nanf("");
    return;
  }
  const float* pa = a + static_cast<size_t>(pair) * n;
  const float* pb = b + static_cast<size_t>(pair) * n;

  float ar[R], col[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane * R + r;
    ar[r] = i < la ? pa[i] : 0.0f;
    col[r] = kBig;
  }
  float bcur = lane < lb ? pb[lane] : 0.0f;
  float bnext = 32 + lane < lb ? pb[32 + lane] : 0.0f;
  float bj = 0.0f;
  float above_prev = lane == 0 ? 0.0f : kBig;  // D[-1, -1] = 0: the origin

  const int tf = (la - 1) / R;  // the lane owning row la-1
  const int steps = lb + tf;     // it reaches column lb-1 at step lb-1+tf
  for (int s0 = 0; s0 < steps; s0 += 32) {
    if (s0 > 0) {
      bcur = bnext;
      bnext = s0 + 32 + lane < lb ? pb[s0 + 32 + lane] : 0.0f;
    }
    const int kend = min(32, steps - s0);
    for (int k = 0; k < kend; ++k) {
      const float b_in = __shfl_sync(kFull, bcur, k);
      const float b_up = __shfl_up_sync(kFull, bj, 1);
      bj = lane == 0 ? b_in : b_up;
      float above = __shfl_up_sync(kFull, col[R - 1], 1);
      if (lane == 0) above = kBig;
      cell_column<R>(col, ar, bj, above, above_prev);
      above_prev = above;
    }
  }
  if (lane == tf) out[pair] = pick<R>(col, (la - 1) % R);
}

// n > 256: one block of W warps per pair, warp w on strip w (+ W per pass).
// edge: (batch, n) scratch for the boundary row between passes, or null
// when one pass covers n.  At most 56 registers a thread, so that an SM
// holds two blocks of 18 warps (n = 4480) where 64 would let it hold one.
__global__ void __maxnreg__(56)
    dtw_strip_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const int* __restrict__ la_ptr,
                     const int* __restrict__ lb_ptr, float* __restrict__ out,
                     float* __restrict__ edge, int n) {
  constexpr int R = kWideR;
  __shared__ float ring[kMaxWarps][kRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int pair = blockIdx.x;
  const int la = la_ptr[pair];
  const int lb = lb_ptr[pair];
  if (bad_lengths(la, lb, n)) {  // block-uniform exit
    if (threadIdx.x == 0) out[pair] = nanf("");
    return;
  }
  const float* pa = a + static_cast<size_t>(pair) * n;
  const float* pb = b + static_cast<size_t>(pair) * n;
  float* pedge = edge ? edge + static_cast<size_t>(pair) * n : nullptr;

  const int strips = (la + kStrip - 1) / kStrip;
  const int passes = (strips + nwarps - 1) / nwarps;
  const int steps = lb + 31;  // lane 31 reaches column lb-1 at step lb+30
  const int chunks = (steps + 31) / 32;
  const int strip_f = (la - 1) / kStrip;  // strip, lane, row of cell la-1
  const int tf = ((la - 1) % kStrip) / R;
  const int rf = (la - 1) % R;

  float result = 0.0f;
  for (int p = 0; p < passes; ++p) {
    const int strip = p * nwarps + warp;
    const int in_pass = min(nwarps, strips - p * nwarps);
    const bool top_from_ring = warp > 0;
    const bool top_from_edge = warp == 0 && p > 0;
    const bool to_ring = warp + 1 < nwarps;
    const bool to_edge = warp + 1 == nwarps && p + 1 < passes;

    float ar[R], col[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = strip * kStrip + lane * R + r;
      ar[r] = i < la ? pa[i] : 0.0f;
      col[r] = kBig;
    }
    float bj = 0.0f;
    float above_prev = strip == 0 && lane == 0 ? 0.0f : kBig;
    float bcur = 0.0f, bnext = 0.0f;
    // the strip holding row la-1 stops when that row reaches column lb-1
    const int my_steps = strip == strip_f ? lb + tf : steps;
    float bottom = kBig;  // lane L: the newest bottom-row cell, column = L

    const int supersteps = chunks + 2 * (in_pass - 1);
    for (int c = 0; c < supersteps; ++c) {
      const int s0 = (c - 2 * warp) * 32;
#ifdef DTW_JITTER  // race hunt (dtw_selfcheck.cu): shift warps in time
      __nanosleep((pair * 7919u + warp * 104729u + c * 1299709u) % 2048u);
#endif
      if (warp < in_pass && s0 >= 0 && s0 < my_steps) {  // warp-uniform
        const int jl = s0 + lane;
        if (s0 == 0) bnext = lane < lb ? pb[lane] : 0.0f;
        bcur = bnext;  // b[s0 + lane], loaded one super-step ahead
        bnext = jl + 32 < lb ? pb[jl + 32] : 0.0f;
        float tcur = kBig;  // D[top - 1, s0 + lane]
        if (top_from_ring)
          tcur = ring[warp - 1][jl & (kRing - 1)];
        else if (top_from_edge && jl < lb)
          tcur = pedge[jl];
        const int kend = min(32, my_steps - s0);
        for (int k = 0; k < kend; ++k) {
          const int s = s0 + k;
          const float b_in = __shfl_sync(kFull, bcur, k);
          const float b_up = __shfl_up_sync(kFull, bj, 1);
          bj = lane == 0 ? b_in : b_up;
          const float t_in = __shfl_sync(kFull, tcur, k);
          float above = __shfl_up_sync(kFull, col[R - 1], 1);
          if (lane == 0) above = t_in;
          cell_column<R>(col, ar, bj, above, above_prev);
          above_prev = above;
          // lane 31's last row is the bottom row at column s - 31
          const float v = __shfl_sync(kFull, col[R - 1], 31);
          if (lane == ((s - 31) & 31)) bottom = v;
        }
        // hand on the bottom-row cells of this super-step, one per lane
        const int newest = s0 + kend - 32;
        const int jb = newest - ((newest - lane) & 31);
        if (jb >= max(0, s0 - 31) && jb < lb) {
          if (to_ring)
            ring[warp][jb & (kRing - 1)] = bottom;
          else if (to_edge)
            pedge[jb] = bottom;
        }
      }
      __syncthreads();
    }
    if (strip == strip_f && lane == tf) result = pick<R>(col, rf);
  }
  if (warp == strip_f % nwarps && lane == tf) out[pair] = result;
}

int strip_passes(int n) {
  const int strips = (n + kStrip - 1) / kStrip;
  return (strips + kMaxWarps - 1) / kMaxWarps;
}

using WarpKernel = void (*)(const float*, const float*, const int*,
                            const int*, float*, int, int);
constexpr WarpKernel kWarpKernels[] = {  // dtw_warp_kernel<R> at [R - 1]
    dtw_warp_kernel<1>, dtw_warp_kernel<2>, dtw_warp_kernel<3>,
    dtw_warp_kernel<4>, dtw_warp_kernel<5>, dtw_warp_kernel<6>,
    dtw_warp_kernel<7>, dtw_warp_kernel<8>};

// Warps per block of the kernel that dtw_wavefront launches at width n.
int block_warps(int n) {
  if (n <= kStrip) return kPairWarps;
  const int passes = strip_passes(n);
  const int strips = (n + kStrip - 1) / kStrip;
  return (strips + passes - 1) / passes;  // balanced passes
}

const void* kernel_for(int n) {
  return n <= kStrip ? reinterpret_cast<const void*>(
                           kWarpKernels[(n + 31) / 32 - 1])
                     : reinterpret_cast<const void*>(dtw_strip_kernel);
}

}  // namespace

extern "C" {

// Floats of scratch per pair that dtw_wavefront needs at width n (0: none).
int dtw_scratch_floats(int n) {
  return n > kStrip && strip_passes(n) > 1 ? n : 0;
}

// Warps of the width-n kernel that one SM holds at once (the CUDA
// occupancy calculator), or -1 on error.
int dtw_resident_warps(int n) {
  if (n < 1) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel_for(n), block_warps(n) * 32, 0) != cudaSuccess)
    return -1;
  return blocks * block_warps(n);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// a, b: (batch, n) f32; la, lb: (batch,) int32 in [1, n]; out: (batch,) f32;
// edge: (batch, dtw_scratch_floats(n)) f32 scratch, or null when that is 0.
int dtw_wavefront(const float* a, const float* b, const int* la,
                  const int* lb, float* out, float* edge, int batch, int n,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_warps(n) * 32;
  if (n <= kStrip) {
    const int blocks = (batch + kPairWarps - 1) / kPairWarps;
    kWarpKernels[(n + 31) / 32 - 1]<<<blocks, threads, 0, st>>>(
        a, b, la, lb, out, batch, n);
  } else {
    if (dtw_scratch_floats(n) > 0 && edge == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    dtw_strip_kernel<<<batch, threads, 0, st>>>(a, b, la, lb, out, edge, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
