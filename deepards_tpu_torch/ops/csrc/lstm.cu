// The LSTM recurrence, persistent: one launch walks all S time steps
// forward, one walks them back.
//
// Replaces no TPU kernel.  The JAX package runs flax's OptimizedLSTMCell
// under nn.RNN (deepards_tpu/models/recurrent.py) and leaves the scan to
// XLA.  On the card the plain version (ops/lstm.py lstm_reference, a
// Python loop of stock ops) costs ~34 kernels a time step, each a launch
// and a round trip through device memory: ~69,000 kernels for the nested
// network's 2,048 windows, forward and backward.
//
// What it computes, per batch row and time step t, in the carry type T
// (float32 under bf16 or float32 compute, float64 in a float64 model):
//   pre   = (W_h h_{t-1} + b_h) + xi[t]     4H gates, rows i, f, g, o
//   i, f, o = sigmoid(.), g = tanh(.)
//   c_t   = f c_{t-1} + i g,   h_t = o tanh(c_t)
// xi = x W_i^T (B, S, 4H) comes in from one matrix product outside, in
// its own type (bf16 or T), converted to T as it is read.  The backward
// kernel gives dgates (the gradient of `pre`, B, S, 4H), dc_0 and dh_0;
// the wrapper turns dgates into dW_h, db_h and dxi with one product or
// sum each over all B * S rows.
//
// Bound.  The work is tiny (the nested shape: 268 MFLOP of recurrent
// products, a few MB of inputs, outputs and saved gates); what bounds the
// kernel is the serial latency of S steps, each an H-long dot, a few
// transcendentals, one hand-off of h_t to every block that needs it and
// one barrier.
//
// Design.  A thread-block cluster of C blocks serves `rows` batch rows.
// Block k owns U = ceil(H / C) hidden units.
//  - Forward: block k keeps its units' four gate rows of W_h (4U x H) in
//    registers, K values a thread: thread (row, unit, gate, part) holds
//    W_h[gate H + unit][k P + part] for k < K (P parts a gate row, K P >=
//    H), so a step reads no weight from memory.  Each step it takes its
//    part of the dot from h_{t-1} in shared memory, sums the P parts by
//    shuffles, adds b_h and xi, applies the gate's function; the four
//    gates of a unit sit in 4P neighbouring lanes of one warp, so every
//    lane of the unit gathers them by shuffle and updates c (kept in
//    registers).  h_t goes straight into every block's shared memory
//    (distributed shared memory, double-buffered by the step's parity)
//    and out to `out`; then one cluster barrier, split: arrive after the
//    hand-off, the stores to device memory (out, the activated gates and
//    c_t for the backward), wait.  xi of the next step is loaded one step
//    ahead.
//  - Backward: block k keeps the columns of W_h of its units (4H x U),
//    thread (row, unit, part) the rows k 4P + part of its unit's column,
//    and takes dh_t[unit] = dout_t + (W_h^T dgates_{t+1})[unit] as a dot
//    over the 4H gate gradients of step t+1 that every block of the
//    cluster handed it (4P parts, shuffles).  From the saved gates and
//    c_t, c_{t-1} (loaded one step ahead) it forms the unit's four gate
//    gradients and carries dc, hands them to every block and writes them
//    out; one cluster barrier a step.
//  - The plan (C, P, rows, K) is ops/lstm.py lstm_plan's, from (B, H, the
//    carry type): the smallest cluster whose blocks' weight slices stay
//    within 64 KB (16 K registers of weights at float32: C = 4 for H = 128,
//    8 in float64), parts so that K = 16 where the block stays within 512
//    threads (else 32, float32 only: the instances built), and batch rows
//    per cluster so that the clusters spread over the SMs.  This file
//    checks the plan it is given and refuses others.
//
// Arithmetic: accurate expf/tanhf (no fast math); the cell's products and
// sums with explicit round-to-nearest operations, not contracted into
// FMAs, as PyTorch's elementwise kernels compute them; the dots in FMAs,
// in another order than a GEMM's.  No atomics: the results repeat bit for
// bit.  The launch allocates nothing and never synchronises: the wrapper
// passes outputs and the stream, and every launch's error comes back.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without opt-in
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Cell;

template <>
struct Cell<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
  }
  static __device__ __forceinline__ float tanh(float x) { return tanhf(x); }
};

template <>
struct Cell<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double sigmoid(double x) {
    return 1.0 / (1.0 + exp(-x));
  }
  static __device__ __forceinline__ double tanh(double x) { return ::tanh(x); }
};

__device__ __forceinline__ float load_as(float, const float* p) { return *p; }
__device__ __forceinline__ float load_as(float, const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double load_as(double, const double* p) {
  return *p;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The sum of `v` over the `parts` neighbouring lanes (a power of two)
// that hold the parts of one dot, left in each of them.
template <typename T>
__device__ __forceinline__ T sum_parts(T v, int parts) {
  for (int o = parts >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Zero a block's shared memory, then the cluster's first barrier: no
// block hands a value to another before that one has cleared its buffers.
template <typename T>
__device__ __forceinline__ void clear(T* buf, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = T(0);
}

// Thread (lb, unit, gate, part) of the forward block; threads past
// rows * 4 U P (the block rounded up to whole warps) and units past H are
// idle: they shuffle with their warp but read and write nothing of theirs.
template <typename T, typename TIn, int K>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_fwd_kernel(const TIn* __restrict__ xi, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ c0,
                    const T* __restrict__ h0, T* __restrict__ out,
                    T* __restrict__ c_last, T* __restrict__ h_last,
                    T* __restrict__ gates, T* __restrict__ cells, int batch,
                    int steps, int hidden, int parts, int rows) {
  using M = Cell<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);  // [2][rows][K * parts]
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int units = (hidden + csize - 1) / csize;
  const int stride = K * parts;
  const int row_threads = 4 * units * parts;
  const int tid = threadIdx.x;
  const int lb = tid / row_threads;
  const int rem = tid % row_threads;
  const int u = rem / (4 * parts);
  const int gate = (rem / parts) & 3;
  const int part = rem % parts;
  const int j = rank * units + u;
  const int b = (blockIdx.x / csize) * rows + lb;
  const bool unit_ok = j < hidden;
  const bool live = lb < rows && unit_ok && b < batch;
  const int lane = tid & 31;
  const int group = lane & ~(4 * parts - 1);  // the unit's first lane
  const int four_h = 4 * hidden;

  T wr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int col = k * parts + part;
    wr[k] = unit_ok && col < hidden
                ? w[static_cast<size_t>(gate * hidden + j) * hidden + col]
                : T(0);
  }
  const T bj = unit_ok ? bias[gate * hidden + j] : T(0);

  const int buf = rows * stride;
  clear(hs, 2 * buf);
  __syncthreads();
  const int row0 = (blockIdx.x / csize) * rows;
  for (int i = tid; i < buf; i += blockDim.x) {
    const int r = i / stride, col = i % stride;
    if (col < hidden && row0 + r < batch)
      hs[i] = h0[static_cast<size_t>(row0 + r) * hidden + col];
  }
  T c = live ? c0[static_cast<size_t>(b) * hidden + j] : T(0);
  T h = T(0);
  const TIn* xrow = xi + static_cast<size_t>(live ? b : 0) * steps * four_h +
                    gate * hidden + (unit_ok ? j : 0);
  T xnext = live ? load_as(T(0), xrow) : T(0);
  const int my = (lb < rows ? lb : rows - 1) * stride;
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < steps; ++t) {
    const T* hb = hs + (t & 1) * buf + my;
    const T x = xnext;
    if (live && t + 1 < steps)
      xnext = load_as(T(0), xrow + static_cast<size_t>(t + 1) * four_h);
    T acc0 = T(0), acc1 = T(0);
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      acc0 = fma(wr[k], hb[k * parts + part], acc0);
      acc1 = fma(wr[k + 1], hb[(k + 1) * parts + part], acc1);
    }
    const T dot = sum_parts(acc0 + acc1, parts);
    const T pre = M::add(M::add(dot, bj), x);
    const T act = gate == 2 ? M::tanh(pre) : M::sigmoid(pre);
    const T gi = __shfl_sync(kFull, act, group);
    const T gf = __shfl_sync(kFull, act, group + parts);
    const T gg = __shfl_sync(kFull, act, group + 2 * parts);
    const T go = __shfl_sync(kFull, act, group + 3 * parts);
    c = M::add(M::mul(gf, c), M::mul(gi, gg));
    h = M::mul(go, M::tanh(c));
    if (live) {  // h_t into every block's next buffer
      T* next = hs + ((t + 1) & 1) * buf + lb * stride + j;
      for (int r = gate * parts + part; r < csize; r += 4 * parts)
        *cluster.map_shared_rank(next, r) = h;
    }
    cluster_arrive();
    if (live && part == 0) {
      const size_t at = static_cast<size_t>(b) * steps + t;
      if (gates != nullptr) gates[at * four_h + gate * hidden + j] = act;
      if (gate == 0) out[at * hidden + j] = h;
      if (gate == 1 && cells != nullptr) cells[at * hidden + j] = c;
    }
    cluster_wait();
  }
  if (live && part == 0 && gate == 0) {
    c_last[static_cast<size_t>(b) * hidden + j] = c;
    h_last[static_cast<size_t>(b) * hidden + j] = h;
  }
}

// Thread (lb, unit, part) of the backward block, with 4P parts a unit.
template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_bwd_kernel(const T* __restrict__ w, const T* __restrict__ gates,
                    const T* __restrict__ cells, const T* __restrict__ c0,
                    const T* __restrict__ dout, const T* __restrict__ dc_last,
                    const T* __restrict__ dh_last, T* __restrict__ dgates,
                    T* __restrict__ dc0, T* __restrict__ dh0, int batch,
                    int steps, int hidden, int parts, int rows) {
  using M = Cell<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);  // [2][rows][K * 4 parts]
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int units = (hidden + csize - 1) / csize;
  const int parts4 = 4 * parts;
  const int stride = K * parts4;
  const int row_threads = units * parts4;
  const int tid = threadIdx.x;
  const int lb = tid / row_threads;
  const int rem = tid % row_threads;
  const int u = rem / parts4;
  const int part = rem % parts4;
  const int j = rank * units + u;
  const int b = (blockIdx.x / csize) * rows + lb;
  const bool unit_ok = j < hidden;
  const bool live = lb < rows && unit_ok && b < batch;
  const int four_h = 4 * hidden;

  T wr[K];  // column j of W_h: rows k 4P + part
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = k * parts4 + part;
    wr[k] = unit_ok && r < four_h ? w[static_cast<size_t>(r) * hidden + j]
                                  : T(0);
  }
  const int buf = rows * stride;
  clear(gs, 2 * buf);
  const int my = (lb < rows ? lb : rows - 1) * stride;

  // this thread's row and unit in (B, H) and its row's first step
  const size_t unit_at =
      static_cast<size_t>(live ? b : 0) * hidden + (unit_ok ? j : 0);
  const size_t step0 = static_cast<size_t>(live ? b : 0) * steps;
  const int jj = unit_ok ? j : 0;
  T dc = live && dc_last != nullptr ? dc_last[unit_at] : T(0);
  const T dh_end = live && dh_last != nullptr ? dh_last[unit_at] : T(0);
  // step t's saved gates, c_t, c_{t-1} and dout_t, loaded a step ahead
  T g[4] = {T(0), T(0), T(0), T(0)}, ct = T(0), cp = T(0), d = T(0);
  auto load = [&](int t) {
    if (!live || t < 0) return;
    const size_t at = step0 + t;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = gates[at * four_h + q * hidden + jj];
    ct = cells[at * hidden + jj];
    cp = t > 0 ? cells[(at - 1) * hidden + jj] : c0[unit_at];
    d = dout[at * hidden + jj];
  };
  load(steps - 1);
  cluster_arrive();
  cluster_wait();

  for (int t = steps - 1; t >= 0; --t) {
    const int it = steps - 1 - t;
    const T* gb = gs + (it & 1) * buf + my;  // dgates of step t+1 (0 at S-1)
    T acc0 = T(0), acc1 = T(0);
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      acc0 = fma(wr[k], gb[k * parts4 + part], acc0);
      acc1 = fma(wr[k + 1], gb[(k + 1) * parts4 + part], acc1);
    }
    const T back = sum_parts(acc0 + acc1, parts4);
    T dh = M::add(d, back);
    if (t == steps - 1) dh = M::add(dh, dh_end);
    const T gi = g[0], gf = g[1], gg = g[2], go = g[3], cur = ct, prev = cp;
    load(t - 1);
    const T one = T(1);
    const T tc = M::tanh(cur);
    // h = o tanh(c): the gradient of o, and of c through tanh
    const T dgo = M::mul(M::mul(M::mul(dh, tc), M::add(one, -go)), go);
    dc = M::add(dc, M::mul(M::mul(dh, go), M::add(one, -M::mul(tc, tc))));
    // c = f c_prev + i g
    const T dgi = M::mul(M::mul(M::mul(dc, gg), M::add(one, -gi)), gi);
    const T dgf = M::mul(M::mul(M::mul(dc, prev), M::add(one, -gf)), gf);
    const T dgg = M::mul(M::mul(dc, gi), M::add(one, -M::mul(gg, gg)));
    dc = M::mul(dc, gf);
    if (live) {  // the four gate gradients into every block's next buffer
      T* next = gs + ((it + 1) & 1) * buf + lb * stride + j;
      for (int q = part; q < 4 * csize; q += parts4) {
        const int gate = q & 3;
        const T v = gate == 0 ? dgi : gate == 1 ? dgf : gate == 2 ? dgg : dgo;
        *cluster.map_shared_rank(next + gate * hidden, q >> 2) = v;
      }
    }
    cluster_arrive();
    if (live && part < 4) {
      const T v = part == 0 ? dgi : part == 1 ? dgf : part == 2 ? dgg : dgo;
      dgates[(step0 + t) * four_h + part * hidden + j] = v;
    }
    cluster_wait();
  }
  if (dh0 != nullptr) {  // dh_0 = W_h^T dgates_0
    const T* gb = gs + (steps & 1) * buf + my;
    T acc0 = T(0), acc1 = T(0);
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      acc0 = fma(wr[k], gb[k * parts4 + part], acc0);
      acc1 = fma(wr[k + 1], gb[(k + 1) * parts4 + part], acc1);
    }
    const T back = sum_parts(acc0 + acc1, parts4);
    if (live && part == 0) dh0[unit_at] = back;
  }
  if (dc0 != nullptr && live && part == 0) dc0[unit_at] = dc;
}

// The floor of a recurrence step: each block hands one value to every
// block of its cluster, passes the cluster barrier and reads what it was
// handed, `steps` times.
__global__ void lstm_barrier_probe_kernel(float* out, int steps) {
  __shared__ float hand[2][8];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x < 16) (&hand[0][0])[threadIdx.x] = 0.0f;
  cluster.sync();
  float v = 0.0f;
  for (int t = 0; t < steps; ++t) {
    if (static_cast<int>(threadIdx.x) < csize)
      *cluster.map_shared_rank(&hand[(t + 1) & 1][rank], threadIdx.x) =
          v + 1.0f;
    cluster_arrive();
    cluster_wait();
    v = hand[(t + 1) & 1][(rank + 1) % csize];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

struct Plan {
  int threads, blocks;
  size_t fwd_smem, bwd_smem;
};

// The plan's launch shape, or false when the kernels do not take it.
bool make_plan(int batch, int steps, int hidden, int cluster, int parts,
               int rows, int k, size_t elem, Plan* p) {
  if (batch < 1 || steps < 1 || hidden < 1 || rows < 1) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  if (parts != 1 && parts != 2 && parts != 4 && parts != 8) return false;
  if (k != 16 && (k != 32 || elem != 4)) return false;
  if (k * parts < hidden) return false;
  const int units = (hidden + cluster - 1) / cluster;
  const int used = rows * 4 * units * parts;
  p->threads = (used + 31) / 32 * 32;
  if (p->threads > kMaxThreads) return false;
  p->blocks = (batch + rows - 1) / rows * cluster;
  p->fwd_smem = 2 * static_cast<size_t>(rows) * k * parts * elem;
  p->bwd_smem = 4 * p->fwd_smem;
  return p->bwd_smem <= kMaxSmem;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Plan& p, int cluster, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T, typename TIn>
using FwdKernel = void (*)(const TIn*, const T*, const T*, const T*,
                           const T*, T*, T*, T*, T*, T*, int, int, int, int,
                           int);

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                           const T*, const T*, T*, T*, T*, int, int, int, int,
                           int);

// K = 16 or 32 at float32, 16 at float64 (make_plan): the instances
// built, as few as the users' plans need, since each one adds to the build
template <typename T, typename TIn>
FwdKernel<T, TIn> fwd_kernel(int k) {
  if constexpr (sizeof(T) == 8) return lstm_fwd_kernel<T, TIn, 16>;
  else
    return k == 16 ? lstm_fwd_kernel<T, TIn, 16> : lstm_fwd_kernel<T, TIn, 32>;
}

template <typename T>
BwdKernel<T> bwd_kernel(int k) {
  if constexpr (sizeof(T) == 8) return lstm_bwd_kernel<T, 16>;
  else return k == 16 ? lstm_bwd_kernel<T, 16> : lstm_bwd_kernel<T, 32>;
}

template <typename T, typename TIn>
int forward_as(const Plan& p, int cluster, int k, cudaStream_t st,
               const void* xi, const void* w, const void* bias,
               const void* c0, const void* h0, void* out, void* c_last,
               void* h_last, void* gates, void* cells, int batch, int steps,
               int hidden, int parts, int rows) {
  return launch(fwd_kernel<T, TIn>(k), p, cluster, p.fwd_smem, st,
                static_cast<const TIn*>(xi), static_cast<const T*>(w),
                static_cast<const T*>(bias), static_cast<const T*>(c0),
                static_cast<const T*>(h0), static_cast<T*>(out),
                static_cast<T*>(c_last), static_cast<T*>(h_last),
                static_cast<T*>(gates), static_cast<T*>(cells), batch, steps,
                hidden, parts, rows);
}

template <typename T>
int backward_as(const Plan& p, int cluster, int k, cudaStream_t st,
                const void* w, const void* gates, const void* cells,
                const void* c0, const void* dout, const void* dc_last,
                const void* dh_last, void* dgates, void* dc0, void* dh0,
                int batch, int steps, int hidden, int parts, int rows) {
  return launch(bwd_kernel<T>(k), p, cluster, p.bwd_smem, st,
                static_cast<const T*>(w), static_cast<const T*>(gates),
                static_cast<const T*>(cells), static_cast<const T*>(c0),
                static_cast<const T*>(dout), static_cast<const T*>(dc_last),
                static_cast<const T*>(dh_last), static_cast<T*>(dgates),
                static_cast<T*>(dc0), static_cast<T*>(dh0), batch, steps,
                hidden, parts, rows);
}

}  // namespace

extern "C" {

// Launch the forward on `stream`; returns the launch's error (0 = ok).
// xi (B, S, 4H); w (4H, H); bias (4H); c0, h0 (B, H); out (B, S, H);
// c_last, h_last (B, H); gates (B, S, 4H) and cells (B, S, H), the
// activated gates and c_t kept for the backward, or both null.
int lstm_forward(int carry, int xi_bf16, const void* xi, const void* w,
                 const void* bias, const void* c0, const void* h0, void* out,
                 void* c_last, void* h_last, void* gates, void* cells,
                 int batch, int steps, int hidden, int cluster, int parts,
                 int rows, int k, void* stream) {
  Plan p;
  const size_t elem = carry == 1 ? 8 : 4;
  if (carry < 0 || carry > 1 || (carry == 1 && xi_bf16) ||
      !make_plan(batch, steps, hidden, cluster, parts, rows, k, elem, &p) ||
      (gates == nullptr) != (cells == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (carry == 1)
    return forward_as<double, double>(p, cluster, k, st, xi, w, bias, c0, h0,
                                      out, c_last, h_last, gates, cells,
                                      batch, steps, hidden, parts, rows);
  if (xi_bf16)
    return forward_as<float, __nv_bfloat16>(
        p, cluster, k, st, xi, w, bias, c0, h0, out, c_last, h_last, gates,
        cells, batch, steps, hidden, parts, rows);
  return forward_as<float, float>(p, cluster, k, st, xi, w, bias, c0, h0,
                                  out, c_last, h_last, gates, cells, batch,
                                  steps, hidden, parts, rows);
}

// Launch the backward on `stream`; returns the launch's error (0 = ok).
// gates, cells: the forward's; dout (B, S, H); dc_last, dh_last (B, H),
// or null for zeros; dgates (B, S, 4H); dc0, dh0 (B, H) or null.
int lstm_backward(int carry, const void* w, const void* gates,
                  const void* cells, const void* c0, const void* dout,
                  const void* dc_last, const void* dh_last, void* dgates,
                  void* dc0, void* dh0, int batch, int steps, int hidden,
                  int cluster, int parts, int rows, int k, void* stream) {
  Plan p;
  const size_t elem = carry == 1 ? 8 : 4;
  if (carry < 0 || carry > 1 ||
      !make_plan(batch, steps, hidden, cluster, parts, rows, k, elem, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (carry == 1)
    return backward_as<double>(p, cluster, k, st, w, gates, cells, c0, dout,
                               dc_last, dh_last, dgates, dc0, dh0, batch,
                               steps, hidden, parts, rows);
  return backward_as<float>(p, cluster, k, st, w, gates, cells, c0, dout,
                            dc_last, dh_last, dgates, dc0, dh0, batch, steps,
                            hidden, parts, rows);
}

// Launch `blocks` blocks of `threads` in clusters of `cluster` that pass
// `steps` hand-offs and cluster barriers (lstm_barrier_probe_kernel); out
// holds `blocks` floats.
int lstm_barrier_probe(int cluster, int blocks, int threads, int steps,
                       float* out, void* stream) {
  if (cluster < 1 || cluster > 8 || blocks % cluster != 0 || threads < 32 ||
      threads > 1024 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{threads, blocks, 0, 0};
  return launch(lstm_barrier_probe_kernel, p, cluster, 0,
                static_cast<cudaStream_t>(stream), out, steps);
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
