// Standalone check of the DTW kernel (dtw.cu) without PyTorch:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o dtw_selfcheck deepards_tpu_torch/ops/csrc/dtw_selfcheck.cu
//   ./dtw_selfcheck
//   compute-sanitizer --tool racecheck ./dtw_selfcheck   # and memcheck
//
// Built with -DDTW_JITTER, the strip kernel sleeps each warp for a
// pseudo-random time every super-step, so the strip hand-off runs under
// other interleavings of the warps; a race shows as a mismatch.
//
// Ragged random pairs at n = 200 (one warp per pair), n = 1000 (a block of
// four strip warps per pair handing rows through shared memory) and
// n = 8448 (33 strips: two passes through the scratch row) go through
// dtw_wavefront, kRepeats launches each, and through a host DP with the
// same f32 operations; every launch must agree with it bit for bit.  Exits
// 1 on a mismatch or a CUDA error.
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "dtw.cu"

namespace {

constexpr int kRepeats = 10;

float host_dtw(const float* a, int la, const float* b, int lb) {
  std::vector<float> prev(lb), cur(lb);
  for (int i = 0; i < la; ++i) {
    for (int j = 0; j < lb; ++j) {
      float best = kBig;
      if (i == 0 && j == 0) best = 0.0f;
      if (i > 0) best = fminf(best, prev[j]);
      if (j > 0) best = fminf(best, cur[j - 1]);
      if (i > 0 && j > 0) best = fminf(best, prev[j - 1]);
      cur[j] = fabsf(a[i] - b[j]) + best;
    }
    std::swap(prev, cur);
  }
  return prev[lb - 1];
}

bool ok(cudaError_t err, const char* what) {
  if (err == cudaSuccess) return true;
  std::printf("dtw_selfcheck: %s: %s\n", what, cudaGetErrorString(err));
  return false;
}

// Returns 0 when every pair matches, 1 otherwise.
int check(int batch, int n, std::mt19937* rng) {
  std::normal_distribution<float> normal;
  std::uniform_int_distribution<int> length(1, n);
  std::vector<float> a(static_cast<size_t>(batch) * n, 0.0f);
  std::vector<float> b(a.size(), 0.0f);
  std::vector<int> la(batch), lb(batch);
  for (int p = 0; p < batch; ++p) {
    la[p] = p == 0 ? n : length(*rng);
    lb[p] = p == 0 ? n : length(*rng);
    float* pa = &a[static_cast<size_t>(p) * n];
    float* pb = &b[static_cast<size_t>(p) * n];
    for (int i = 0; i < la[p]; ++i) pa[i] = normal(*rng);
    for (int j = 0; j < lb[p]; ++j) pb[j] = normal(*rng);
  }
  const size_t bytes = a.size() * sizeof(float);
  const size_t edge_floats =
      static_cast<size_t>(batch) * dtw_scratch_floats(n);
  float *da, *db, *dout, *dedge = nullptr;
  int *dla, *dlb;
  if (!ok(cudaMalloc(&da, bytes), "malloc") ||
      !ok(cudaMalloc(&db, bytes), "malloc") ||
      !ok(cudaMalloc(&dla, batch * sizeof(int)), "malloc") ||
      !ok(cudaMalloc(&dlb, batch * sizeof(int)), "malloc") ||
      !ok(cudaMalloc(&dout, batch * sizeof(float)), "malloc") ||
      (edge_floats &&
       !ok(cudaMalloc(&dedge, edge_floats * sizeof(float)), "malloc")))
    return 1;
  cudaMemcpy(da, a.data(), bytes, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), bytes, cudaMemcpyHostToDevice);
  cudaMemcpy(dla, la.data(), batch * sizeof(int), cudaMemcpyHostToDevice);
  cudaMemcpy(dlb, lb.data(), batch * sizeof(int), cudaMemcpyHostToDevice);
  std::vector<float> want(batch), got(batch);
  for (int p = 0; p < batch; ++p)
    want[p] = host_dtw(&a[static_cast<size_t>(p) * n], la[p],
                       &b[static_cast<size_t>(p) * n], lb[p]);
  int bad = 0;
  for (int rep = 0; rep < kRepeats; ++rep) {
    const int launch =
        dtw_wavefront(da, db, dla, dlb, dout, dedge, batch, n, nullptr);
    if (!ok(static_cast<cudaError_t>(launch), "launch") ||
        !ok(cudaDeviceSynchronize(), "run"))
      return 1;
    cudaMemcpy(got.data(), dout, batch * sizeof(float),
               cudaMemcpyDeviceToHost);
    for (int p = 0; p < batch; ++p)
      if (std::memcmp(&got[p], &want[p], sizeof(float)) != 0) ++bad;
  }
  std::printf("dtw_selfcheck n=%d B=%d x%d launches: %s (%d pair results "
              "differ)\n", n, batch, kRepeats, bad ? "MISMATCH" : "exact",
              bad);
  cudaFree(da);
  cudaFree(db);
  cudaFree(dla);
  cudaFree(dlb);
  cudaFree(dout);
  cudaFree(dedge);
  return bad ? 1 : 0;
}

}  // namespace

int main() {
  std::mt19937 rng(0);
  int failed = 0;
  failed |= check(8, 200, &rng);
  failed |= check(64, 1000, &rng);
  failed |= check(2, 8448, &rng);
  return failed;
}
