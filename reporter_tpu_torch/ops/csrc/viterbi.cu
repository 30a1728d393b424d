// Fused batched HMM Viterbi decode for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// reporter_tpu/ops/pallas_viterbi.py `_forward_kernel` (launched by
// `_forward_pallas`, wrapped by `viterbi_pallas_batch`) together with the
// XLA code around it: emission/transition scoring before it and the
// backtrace after it. One launch computes, per trace b,
//
//   em[t, j]    = valid ? -0.5 * (d/sigma) * (d/sigma) : NEG_INF  (0 on SKIP)
//   tr[t, i, j] = route < 0.5e9 ? -|route - gc| / beta : NEG_INF
//                 (identity on SKIP, zeros on RESTART)
//   s[t+1, j]   = max_i(s[t, i] + tr[t, i, j]) + em[t+1, j]
//   bp[t, j]    = argmax_i(...)        (first maximal index)
//
// then the final argmax and the backtrace, writing paths (B, T) int32 and
// scores (B,) f32. Inputs are the matcher's wire tensors as they arrive:
// dist (B, T, K), valid (B, T, K) bool, route (B, Tr, K, K) and gc (B, Tr)
// with Tr = T-1 or T (a dead trailing step), all f16 or all f32, and case
// (B, T) int32. The (B, T-1, K, K) score tensor is never written.
//
// Bound. Per launch the kernel must read every input once and write the
// paths and scores: at B=512, T=64, K=8 on the f16 wire about 5.2 MB
// (route 4.1 MB), 1.6 us at 3.35 TB/s. Its arithmetic is ~10 f32 ops per
// (t, i, j), far below the card's rate. What bounds it in practice is the
// dependence chain: T-1 serial steps, each a K-long max/argmax over the
// previous step's scores, then a T-long backtrace.
//
// Design. One warp per trace; lane j owns candidate j (lane-strided over j
// when K > 32). The running scores live in shared memory (double-buffered,
// 2*K floats per warp), so every lane reads every s[t, i] as a broadcast.
// Scoring is fused into the step: route values are read straight from the
// wire tensor (upcast in registers), so the bytes moved are the inputs'
// own. Traces are independent, so B warps run with no cross-block
// communication and many traces' chains overlap on the card; each chain
// is still T-1 serial steps. Backpointers go to a global scratch
// (B, T-1, K) that lane 0 walks back after a __syncwarp. This is the
// simple, exact design; keeping backpointers in shared memory, packing
// several traces into one warp at K=8 and hoisting the route loads off
// the chain are the known ways to shorten it.
//
// Numerics. Every float op is an IEEE round-to-nearest f32 op in the
// reference's order (the __f*_rn intrinsics cannot contract into FMA;
// the build also passes --fmad=false), ties break to the lowest index with
// a strict '>' scan in ascending i, and sentinels are selected, never
// multiplied in. So the results match the plain PyTorch scan bit for bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float UNREACHABLE_THRESHOLD = 0.5e9f;
constexpr int RESTART = 1;
constexpr int SKIP = 2;
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__half v) { return __half2float(v); }

__device__ __forceinline__ float emission(float d, uint8_t valid, int c,
                                          float sigma) {
  const float z = __fdiv_rn(d, sigma);
  const float s = valid ? __fmul_rn(__fmul_rn(-0.5f, z), z) : NEG_INF;
  return c == SKIP ? 0.0f : s;
}

template <typename F>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
viterbi_kernel(const F* __restrict__ dist, const uint8_t* __restrict__ valid,
               const F* __restrict__ route, const F* __restrict__ gc,
               const int32_t* __restrict__ cases, int B, int T, int Tr,
               int K, float sigma, float beta, int32_t* __restrict__ bps,
               int32_t* __restrict__ paths, float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp leaves together

  float* cur = smem + (size_t)warp * 2 * K;
  float* nxt = cur + K;
  const long long TK = (long long)T * K;
  const F* dist_b = dist + b * TK;
  const uint8_t* valid_b = valid + b * TK;
  const int32_t* case_b = cases + (long long)b * T;
  const F* route_b = route + (long long)b * Tr * K * K;
  const F* gc_b = gc + (long long)b * Tr;
  int32_t* bps_b = bps + (long long)b * (T - 1) * K;

  const int c0 = case_b[0];
  for (int j = lane; j < K; j += 32)
    cur[j] = emission(upcast(dist_b[j]), valid_b[j], c0, sigma);
  __syncwarp();

  for (int t = 0; t < T - 1; ++t) {
    const int ct = case_b[t + 1];
    const float g = upcast(gc_b[t]);
    const F* rt = route_b + (long long)t * K * K;
    for (int j = lane; j < K; j += 32) {
      float best = 0.0f;
      int arg = 0;
#pragma unroll 8
      for (int i = 0; i < K; ++i) {
        const float p = cur[i];
        float c;
        if (ct == RESTART) {
          // a zero transition row: score max(prev) + em, backpointer
          // argmax(prev) for every j
          c = p;
        } else if (ct == SKIP) {
          c = __fadd_rn(p, i == j ? 0.0f : NEG_INF);
        } else {
          const float r = upcast(rt[(long long)i * K + j]);
          const float dev = fabsf(__fsub_rn(r, g));
          const float tr = r < UNREACHABLE_THRESHOLD ? __fdiv_rn(-dev, beta)
                                                     : NEG_INF;
          c = __fadd_rn(p, tr);
        }
        if (i == 0 || c > best) {
          best = c;
          arg = i;
        }
      }
      const long long e = (long long)(t + 1) * K + j;
      nxt[j] = __fadd_rn(best, emission(upcast(dist_b[e]), valid_b[e], ct,
                                        sigma));
      bps_b[(long long)t * K + j] = arg;
    }
    __syncwarp();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (lane == 0) {
    float best = cur[0];
    int arg = 0;
    for (int j = 1; j < K; ++j) {
      if (cur[j] > best) {
        best = cur[j];
        arg = j;
      }
    }
    scores[b] = best;
    int32_t* path_b = paths + (long long)b * T;
    path_b[T - 1] = arg;
    for (int t = T - 2; t >= 0; --t) {
      arg = bps_b[(long long)t * K + arg];
      path_b[t] = arg;
    }
  }
}

template <typename F>
cudaError_t launch(const void* dist, const void* valid, const void* route,
                   const void* gc, const void* cases, int B, int T, int Tr,
                   int K, float sigma, float beta, void* bps, void* paths,
                   void* scores, cudaStream_t stream) {
  // fewer traces per block when K is large, so one block's scores fit
  int warps = WARPS_PER_BLOCK;
  size_t smem = (size_t)warps * 2 * K * sizeof(float);
  while (warps > 1 && smem > 48 * 1024) {
    warps /= 2;
    smem = (size_t)warps * 2 * K * sizeof(float);
  }
  auto kernel = viterbi_kernel<F>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + warps - 1) / warps);
  const dim3 block(32 * warps);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const F*>(dist), static_cast<const uint8_t*>(valid),
      static_cast<const F*>(route), static_cast<const F*>(gc),
      static_cast<const int32_t*>(cases), B, T, Tr, K, sigma, beta,
      static_cast<int32_t*>(bps), static_cast<int32_t*>(paths),
      static_cast<float*>(scores));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller allocates every buffer; the launch is
// asynchronous on `stream`.
extern "C" int viterbi_decode(const void* dist, const void* valid,
                              const void* route, const void* gc,
                              const void* cases, int B, int T, int Tr, int K,
                              int is_f16, float sigma, float beta, void* bps,
                              void* paths, void* scores, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_f16 ? launch<__half>(dist, valid, route, gc, cases, B, T, Tr, K,
                              sigma, beta, bps, paths, scores, s)
             : launch<float>(dist, valid, route, gc, cases, B, T, Tr, K, sigma,
                             beta, bps, paths, scores, s);
  return (int)err;
}
