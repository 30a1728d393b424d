// Card entry-point fixture for the ABI cross-check tests (never compiled:
// parsed by reporter_tpu_torch/analysis/abi.py).
#include <cstdint>

__global__ void kernel(const float* x, float* y, int n) {}

extern "C" int fixture_decode(const void* dist, const void* valid, int B,
                              int T, float sigma, void* paths,
                              void* stream) {
  return 0;
}

// a typed out-pointer and a multi-line signature
extern "C" int fixture_occupancy(int N, int C,
                                 int* clusters) {
  return 0;
}
