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
// (B, T) int32.
//
// Bound. Per launch the kernel must read every input once and write the
// paths and scores: at B=512, T=64, K=8 on the f16 wire 5,243,904 bytes
// (route 4.1 MB), 1.6 us at 3.35 TB/s. Its arithmetic is ~10 f32 ops per
// (t, i, j), far below the card's rate. What bounds it in practice is one
// trace's dependence chain: T-1 serial steps, each a K-wide max/argmax
// over the previous step's scores, then a T-1 step backtrace. Traces are
// independent, so a launch takes about as long as its slowest trace.
//
// What held the first design back (one warp per trace, scoring fused into
// the step; ~3,500 SM cycles per step on the H100):
//  - global loads at the top of every step: the case code and gc, then the
//    route values behind the branch on the case code, then dist/valid, two
//    or more dependent global round trips per serial step;
//  - an IEEE division per (i, j) and per j inside the step, computed before
//    the reachability select (so +inf reached the division);
//  - at K=8 only 8 of 32 lanes busy, a shared-memory round trip and a
//    __syncwarp per step;
//  - int32 backpointers in a global scratch, walked back by lane 0 with
//    T-1 dependent global loads;
//  - 40 registers and a stack frame with spills.
//
// This design, per item:
//  - Warp roles. A block of 128 threads decodes one trace. Warp 0 runs its
//    chain; warps 1-3 (the producers) stage and score. Named barriers hand
//    scored chunks over (FULL + slot) and back (EMPTY + slot). A whole warp
//    per trace, though K=8 needs 8 lanes: packing four traces into warp 0
//    (and a quarter of the blocks) took 1.85x as long at B=512, T=64 on the
//    H100 (PERF.md).
//  - Staging. The producers copy the trace's wire slices (route, gc, case,
//    dist, valid) into shared memory with cp.async 16-byte copies, a chunk
//    of C steps at a time, and start chunk c+1's copies as soon as chunk c
//    is scored. A slice need not start on 16 bytes (K=5, odd T): the copy
//    takes the 16-byte granules that cover it and the reader adds the
//    slice's offset in its first granule. The wrapper takes only tensors
//    whose data starts on 16 bytes, so no granule starts before its
//    tensor. A slice is followed by more of its tensor except in the last
//    chunk of the last trace; there, on a branch of its own, the last
//    granule reads only up to the slice's end (cp.async's src-size; the
//    rest is zero-filled), so no byte past a tensor is read. At T=1024 the
//    chain waits on the producers, so their copy loop stays as lean as it
//    can be: clamping inside it cost 5% there on the H100 (PERF.md).
//  - Scoring off the chain. The producers compute tr[t, i, j] and em[t, j]
//    as f32 into shared memory. At K <= 32 there are two scored slots, so
//    chunk c+1 is scored while the chain runs chunk c, and a slot holds the
//    transitions transposed (row j = tr[t, 0..G-1, j], pads NEG_INF) so a
//    lane reads its row with 16-byte loads. Above 32 one slot holds them as
//    the route is laid out, and the f32 route is scored in place (so T=1024
//    at K=128 fits a block); there the chain waits for each chunk. The
//    reachability select comes before the division, and the division is
//    div_rn below (one f64 multiply, no ptxas division sequence). RESTART
//    folds in as tr = -0.0, the one value whose add leaves every f32
//    unchanged, so a restart step gives the reference's max(prev) + em bit
//    for bit; SKIP is the identity row.
//  - The chain step. G = 8, 16 or 32 (the least of these >= K; a template
//    parameter, K itself is a run-time argument). At K <= 32 lane j keeps
//    s[t, j] in a register: the step is G shuffles of the previous scores,
//    G independent adds, a max/argmax tree of log2(G) levels and one add
//    of em (loaded before the tree). Above 32 the scores go through shared memory and lanes stride
//    over candidates, one tile of 32 previous candidates at a time. The
//    tree orders (value, index) pairs by larger value, then lower index,
//    with pads (-inf, i >= K); that reduction is associative, so it gives
//    what the reference's ascending strict '>' scan gives.
//  - Backpointers as uint8 in shared memory, T-1 rows of K bytes (padded
//    to bp_row(K) at K <= 32). At K <= 32 the backtrace runs in parallel
//    over segments of the rows (see the end of the kernel): about
//    2*(T-1)/32 + 32 dependent shared loads in place of T-1; above, lane 0
//    walks them. Each step's choice goes over its consumed row, and the
//    lanes store the path from there.
//  - The launch plan (chunk steps, shared bytes, grid) is made in Python
//    (ops/viterbi.py `launch_plan`); the entry point refuses shared bytes
//    that differ from `layout` below and launches what it is given.
//
// The file's second entry point, `incremental_step` (end of the file), is
// one step of this decode for N carried traces: the incremental streaming
// decode's kernel (ops/incremental.py).
//
// Numerics. Every float op gives the IEEE round-to-nearest f32 result in
// the reference's order (the __f*_rn intrinsics cannot contract into FMA,
// the build also passes --fmad=false, and div_rn rounds as division does),
// ties break to the lowest index and sentinels are selected, never
// multiplied in. So the results match the plain PyTorch scan bit for bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float UNREACHABLE_THRESHOLD = 0.5e9f;
constexpr int RESTART = 1;
constexpr int SKIP = 2;
constexpr int THREADS = 128;
constexpr int SMEM_MAX = 232448;
constexpr int PRODUCER_THREADS = THREADS - 32;  // warps 1-3
constexpr unsigned ALL_LANES = 0xffffffffu;
// K <= SMALL_K: one tile of G candidates, transposed transition rows
constexpr int SMALL_K = 32;

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__half v) { return __half2float(v); }

// -inf: pads of the max/argmax, below every real score (NEG_INF included)
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__host__ __device__ constexpr int group_width(int K) {
  return K <= 8 ? 8 : (K <= 16 ? 16 : 32);
}

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Bytes per backpointer row: K above SMALL_K; at or below, the least
// multiple of 4 >= K whose quarter is odd, so that the parallel
// backtrace's lanes (an odd number of rows apart) read different banks.
__host__ __device__ inline int bp_row(int K) {
  if (K > SMALL_K) return K;
  const int q = (K + 3) / 4;
  return 4 * (q | 1);
}

// Byte offsets of a block's regions in shared memory, one trace's
// (ops/viterbi.py `trace_bytes` computes the same total). Staging regions carry 16 bytes of
// slack for a slice that starts inside its first granule. At K <= SMALL_K
// the transitions are stored transposed, row j holding tr[t, 0..G-1, j],
// and the route is staged apart from them; above, they are stored as the
// route is (row i), and the f32 route is scored in place.
struct Layout {
  int bp, bps, scores, em, tr, route, gc, cs, dist, valid, bytes;
  int slots, em_slot, tr_slot;  // scored chunks in flight, bytes of each
};

__host__ __device__ inline Layout layout(int T, int K, int C) {
  const int G = group_width(K);
  const int KP = (K + G - 1) / G * G;
  const bool small = K <= SMALL_K;
  Layout o;
  int at = 0;
  o.bps = bp_row(K);
  o.bp = at;     at += round16((T - 1) * o.bps);
  o.scores = at; at += 2 * KP * 4;
  // two scored slots at K <= SMALL_K (the producers score chunk c+1 while
  // the chain reads chunk c), one above
  o.slots = small ? 2 : 1;
  o.em_slot = round16(C * (small ? G : K) * 4);
  o.tr_slot = small ? C * G * G * 4 : round16(C * K * K * 4) + 16;
  o.em = at;     at += o.slots * o.em_slot;
  o.tr = at;     at += o.slots * o.tr_slot;
  o.route = at;  at += round16(C * K * K * (small ? 4 : 2)) + 16;
  o.gc = at;     at += round16(C * 4) + 16;
  o.cs = at;     at += round16(C * 4) + 16;
  o.dist = at;   at += round16(C * K * 4) + 16;
  o.valid = at;  at += round16(C * K) + 16;
  o.bytes = at;
  return o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copy a 16-byte granule, reading its first `bytes` (1..15) from global
// memory and zero-filling the rest: a slice's partial last granule.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src,
                                                int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset of a slice inside its first 16-byte granule.
__device__ __forceinline__ int granule_offset(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Producer threads: copy the 16-byte granules covering [src, src + n) to
// dst; with TO_END, read nothing past src + n (the granules wholly inside,
// then one thread copies the partial last granule).
template <bool TO_END>
__device__ __forceinline__ void stage(uint8_t* dst, const void* src, int n) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(src) + (uintptr_t)n;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;
  const int granules = (int)((((end + 15) & ~(uintptr_t)15) - a0) >> 4);
  const int whole = TO_END ? (int)((end - a0) >> 4) : granules;
  for (int g = threadIdx.x - 32; g < whole; g += PRODUCER_THREADS)
    cp_async16(dst + 16 * g, reinterpret_cast<const void*>(a0 + 16 * g));
  if (TO_END && whole < granules && threadIdx.x == 32)
    cp_async16_part(dst + 16 * whole,
                    reinterpret_cast<const void*>(a0 + 16 * whole),
                    (int)(end - (a0 + 16 * whole)));
}

// a / b rounded to f32 as IEEE division rounds it, given inv = 1/b rounded
// to f64. a * inv in f64 is within 2^-52 (relative) of a / b. If a / b is
// a float, that rounds to it; if not, a / b (a 24-bit integer over another,
// scaled) lies at least 2^-49 (relative) from every point halfway between
// two floats, so a * inv rounds to the same float as a / b. One f64
// multiply and two conversions, where div.rn.f32 is a dozen instructions
// and a branch.
__device__ __forceinline__ float div_rn(float a, double inv) {
  return __double2float_rn(__dmul_rn((double)a, inv));
}

__device__ __forceinline__ float emission(float d, bool valid, int c,
                                          double inv_sigma) {
  if (c == SKIP) return 0.0f;
  if (!valid) return NEG_INF;
  const float z = div_rn(d, inv_sigma);
  return __fmul_rn(__fmul_rn(-0.5f, z), z);
}

// The transition score of a reachability-checked route value: the division
// sees the route only when it is below the threshold (+inf never does).
__device__ __forceinline__ float transition(float r, float g, int c,
                                            bool diag, double inv_beta) {
  const bool reach = r < UNREACHABLE_THRESHOLD;
  const float q = div_rn(-fabsf(__fsub_rn(reach ? r : g, g)), inv_beta);
  return c == RESTART ? -0.0f  // x + -0.0 == x for every f32 x
         : c == SKIP  ? (diag ? 0.0f : NEG_INF)
         : reach      ? q
                      : NEG_INF;
}

// (value, index) max over v[0..G-1], indices ascending: the larger value
// wins, the lower index on ties. Leaves the result in v[0], ix[0].
template <int G>
__device__ __forceinline__ void argmax_tree(float (&v)[G], int (&ix)[G]) {
#pragma unroll
  for (int w = 1; w < G; w *= 2) {
#pragma unroll
    for (int u = 0; u < G; u += 2 * w) {
      const bool right = v[u + w] > v[u];
      v[u] = right ? v[u + w] : v[u];
      ix[u] = right ? ix[u + w] : ix[u];
    }
  }
}

// Where one trace's chunk lives in global memory.
template <typename F>
struct Slices {
  const F* route;
  const F* gc;
  const int32_t* cs;
  const F* dist;
  const uint8_t* valid;
};

template <typename F>
__device__ __forceinline__ Slices<F> slices(const F* dist,
                                            const uint8_t* valid,
                                            const F* route, const F* gc,
                                            const int32_t* cases, int b,
                                            int T, int Tr, int K, int s0) {
  const long long KK = (long long)K * K;
  Slices<F> s;
  s.route = route + ((long long)b * Tr + s0) * KK;
  s.gc = gc + (long long)b * Tr + s0;
  s.cs = cases + (long long)b * T + s0 + 1;
  s.dist = dist + ((long long)b * T + s0 + 1) * K;
  s.valid = valid + ((long long)b * T + s0 + 1) * K;
  return s;
}

// Producer threads: start the copies of the slices `g` of one chunk (the
// points' and/or the route) and commit them as one group.
template <typename F, bool TO_END>
__device__ __forceinline__ void stage_chunk(uint8_t* smem, Layout lay,
                                            const Slices<F>& g, int K, int ns,
                                            bool points, bool rt,
                                            bool in_place) {
  if (rt)
    stage<TO_END>(smem + (in_place ? lay.tr : lay.route), g.route,
                  ns * K * K * (int)sizeof(F));
  if (points) {
    stage<TO_END>(smem + lay.gc, g.gc, ns * (int)sizeof(F));
    stage<TO_END>(smem + lay.cs, g.cs, ns * 4);
    stage<TO_END>(smem + lay.dist, g.dist, ns * K * (int)sizeof(F));
    stage<TO_END>(smem + lay.valid, g.valid, ns * K);
  }
  cp_async_commit();
}

// Producer threads: start the copies of chunk c of the block's trace.
template <typename F>
__device__ __forceinline__ void issue(uint8_t* smem, Layout lay,
                                      const F* dist, const uint8_t* valid,
                                      const F* route, const F* gc,
                                      const int32_t* cases, int T, int Tr,
                                      int K, int C, int c, bool points,
                                      bool rt, bool in_place) {
  const int s0 = c * C;
  const int ns = min(C, T - 1 - s0);
  const Slices<F> g =
      slices(dist, valid, route, gc, cases, blockIdx.x, T, Tr, K, s0);
  // only the last trace's last chunk can reach the end of a tensor
  if (blockIdx.x == gridDim.x - 1 && s0 + ns == T - 1)
    stage_chunk<F, true>(smem, lay, g, K, ns, points, rt, in_place);
  else
    stage_chunk<F, false>(smem, lay, g, K, ns, points, rt, in_place);
}

// Named barriers between the producer warps (1-3) and the chain warp (0):
// PRODUCERS among the producers alone; FULL + slot when a slot's chunk is
// scored, EMPTY + slot when the chain has left it.
constexpr int PRODUCERS = 1, FULL = 2, EMPTY = 4;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Producers: score chunk c (steps s0..s0+ns-1) of the block's trace from
// the staged slices into transition/emission slot `slot`.
template <typename F, int G>
__device__ __forceinline__ void score(uint8_t* smem, Layout lay,
                                      const F* dist, const uint8_t* valid,
                                      const F* route, const F* gc,
                                      const int32_t* cases, int T, int Tr,
                                      int K, int s0, int ns, int slot,
                                      bool in_place, double inv_sigma,
                                      double inv_beta) {
  constexpr int GG = G * G;
  const int p = threadIdx.x - 32;
  const int KK = K * K;
  const Slices<F> g =
      slices(dist, valid, route, gc, cases, blockIdx.x, T, Tr, K, s0);
  const int o_rt = granule_offset(g.route);
  const F* gcs =
      reinterpret_cast<const F*>(smem + lay.gc + granule_offset(g.gc));
  const int32_t* css =
      reinterpret_cast<const int32_t*>(smem + lay.cs + granule_offset(g.cs));
  const F* dst =
      reinterpret_cast<const F*>(smem + lay.dist + granule_offset(g.dist));
  const uint8_t* vs = smem + lay.valid + granule_offset(g.valid);
  if (G < 32 || K <= SMALL_K) {  // G < 32: K <= 16, known at compile time
    // transposed, padded to G x G: n = (s, j, i); pads are NEG_INF
    const F* rr = reinterpret_cast<const F*>(smem + lay.route + o_rt);
    float* trp = reinterpret_cast<float*>(smem + lay.tr + slot * lay.tr_slot);
    float* em = reinterpret_cast<float*>(smem + lay.em + slot * lay.em_slot);
#pragma unroll 4
    for (int n = p; n < ns * GG; n += PRODUCER_THREADS) {
      const int s = n / GG, j = n % GG / G, i = n % G;
      const bool real = i < K && j < K;
      const float v = transition(upcast(rr[s * KK + (real ? i * K + j : 0)]),
                                 upcast(gcs[s]), css[s], i == j, inv_beta);
      trp[n] = real ? v : NEG_INF;
    }
#pragma unroll 4
    for (int n = p; n < ns * G; n += PRODUCER_THREADS) {
      const int s = n / G, j = n % G, jc = j < K ? j : 0;
      em[n] = emission(upcast(dst[s * K + jc]), vs[s * K + jc] != 0, css[s],
                       inv_sigma);
    }
  } else {
    // as the route is laid out, one slot; the f32 route in place
    float* trp =
        reinterpret_cast<float*>(smem + lay.tr + (in_place ? o_rt : 0));
    const F* rr = reinterpret_cast<const F*>(
        in_place ? smem + lay.tr + o_rt : smem + lay.route + o_rt);
    float* em = reinterpret_cast<float*>(smem + lay.em);
    // n = (s, i, j) walks by PRODUCER_THREADS = (st_s, st_i, st_j) with
    // carries, so the loop does no integer division
    const int st_s = PRODUCER_THREADS / KK, st_i = PRODUCER_THREADS % KK / K,
              st_j = PRODUCER_THREADS % K;
    int s = p / KK, i = p % KK / K, j = p % K;
    for (int n = p; n < ns * KK; n += PRODUCER_THREADS) {
      trp[n] = transition(upcast(rr[n]), upcast(gcs[s]), css[s], i == j,
                          inv_beta);
      j += st_j;
      i += st_i + (j >= K);
      j -= j >= K ? K : 0;
      s += st_s + (i >= K);
      i -= i >= K ? K : 0;
    }
    for (int n = p; n < ns * K; n += PRODUCER_THREADS)
      em[n] = emission(upcast(dst[n]), vs[n] != 0, css[n / K], inv_sigma);
  }
}

template <typename F, int G>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_kernel(const F* __restrict__ dist, const uint8_t* __restrict__ valid,
               const F* __restrict__ route, const F* __restrict__ gc,
               const int32_t* __restrict__ cases, int B, int T, int Tr,
               int K, double inv_sigma, double inv_beta, int C,
               int32_t* __restrict__ paths, float* __restrict__ scores) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int GG = G * G;
  const int b = blockIdx.x;  // one trace per block
  if (b >= B) return;
  const Layout lay = layout(T, K, C);
  // then one tile: NS == 1. G < 32 means K <= 16, so the instantiations
  // for G = 8 and 16 hold no code for K > SMALL_K
  const bool small = G < 32 || K <= SMALL_K;
  const bool in_place = sizeof(F) == 4 && !small;
  const int slots = lay.slots;
  const int NS = (K + G - 1) / G;   // candidate slots per lane = i tiles
  const int KP = NS * G;
  const int steps = T - 1;
  const int chunks = (steps + C - 1) / C;

  if (threadIdx.x >= 32) {
    // Producers: stage chunk c+1 while the chain runs chunk c, score each
    // chunk into a free slot, hand it over.
    if (chunks > 0)
      issue<F>(smem, lay, dist, valid, route, gc, cases, T, Tr, K, C, 0, true,
               !in_place, in_place);
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % slots;
      if (c >= slots) bar_sync(EMPTY + slot, THREADS);
      if (in_place)  // the route lands where the chain read chunk c-1
        issue<F>(smem, lay, dist, valid, route, gc, cases, T, Tr, K, C, c,
                 false, true, true);
      cp_async_wait_all();
      bar_sync(PRODUCERS, PRODUCER_THREADS);
      score<F, G>(smem, lay, dist, valid, route, gc, cases, T, Tr, K, c * C,
                  min(C, steps - c * C), slot, in_place, inv_sigma, inv_beta);
      bar_sync(PRODUCERS, PRODUCER_THREADS);
      if (c + 1 < chunks)
        issue<F>(smem, lay, dist, valid, route, gc, cases, T, Tr, K, C,
                 c + 1, true, !in_place, in_place);
      bar_arrive(FULL + slot, THREADS);
    }
    return;
  }

  // The chain: warp 0, shared memory and registers only.
  const int l = threadIdx.x;
  float* cur = reinterpret_cast<float*>(smem + lay.scores);
  float* nxt = cur + KP;
  uint8_t* const bp = smem + lay.bp;
  const int BPS = lay.bps;

  // Running scores start at point 0's emissions; pads are -inf forever.
  const int c0 = cases[(long long)b * T];
  const long long e0 = (long long)b * T * K;
  for (int j = l; j < KP; j += 32) {
    cur[j] = j < K ? emission(upcast(dist[e0 + j]), valid[e0 + j] != 0, c0,
                              inv_sigma)
                   : minus_inf();
    nxt[j] = minus_inf();
  }
  // K <= SMALL_K: lane l's running score, -inf past K
  float sc = l < K ? cur[l] : minus_inf();

  for (int c = 0; c < chunks; ++c) {
    const int slot = c % slots;
    const int s0 = c * C;
    const int ns = min(C, steps - s0);
    bar_sync(FULL + slot, THREADS);
    if (small) {
      // lane l owns candidate j = l and keeps its score in a register;
      // its transition row is contiguous
      const int jr = min(l, K - 1);
      const float* row = reinterpret_cast<const float*>(
                             smem + lay.tr + slot * lay.tr_slot) + jr * G;
      const float* emr = reinterpret_cast<const float*>(
                             smem + lay.em + slot * lay.em_slot) + jr;
      for (int s = 0; s < ns; ++s) {
        const float* rs = row + s * GG;
        const float e = emr[s * G];  // loaded early: off the chain
        float v[G];
        int ix[G];
#pragma unroll
        for (int u = 0; u < G; u += 4) {
          const float4 t = *reinterpret_cast<const float4*>(rs + u);
          v[u] = __fadd_rn(__shfl_sync(ALL_LANES, sc, u), t.x);
          v[u + 1] = __fadd_rn(__shfl_sync(ALL_LANES, sc, u + 1), t.y);
          v[u + 2] = __fadd_rn(__shfl_sync(ALL_LANES, sc, u + 2), t.z);
          v[u + 3] = __fadd_rn(__shfl_sync(ALL_LANES, sc, u + 3), t.w);
          ix[u] = u;
          ix[u + 1] = u + 1;
          ix[u + 2] = u + 2;
          ix[u + 3] = u + 3;
        }
        argmax_tree<G>(v, ix);
        if (l < K) bp[(s0 + s) * BPS + l] = (uint8_t)ix[0];
        sc = l < K ? __fadd_rn(v[0], e) : minus_inf();
      }
    } else {
      // K > 32: lane l owns j = l + 32m; tiles of G previous candidates
      // combine in ascending order
      const Slices<F> g =
          slices(dist, valid, route, gc, cases, b, T, Tr, K, s0);
      const float* trc = reinterpret_cast<const float*>(
          smem + lay.tr + (in_place ? granule_offset(g.route) : 0));
      const float* emc = reinterpret_cast<const float*>(smem + lay.em);
      const int KK = K * K;
      for (int s = 0; s < ns; ++s) {
        const float* trs = trc + s * KK;
#pragma unroll 1
        for (int m = 0; m < NS; ++m) {
          const int j = l + G * m;
          const int jr = min(j, K - 1);
          float best = 0.0f;
          int arg = 0;
#pragma unroll 1
          for (int q = 0; q < NS; ++q) {
            float v[G];
            int ix[G];
#pragma unroll
            for (int u = 0; u < G; ++u) {
              const int i = q * G + u;
              v[u] = __fadd_rn(cur[i], trs[min(i, K - 1) * K + jr]);
              ix[u] = i;
            }
            argmax_tree<G>(v, ix);
            if (q == 0 || v[0] > best) {
              best = v[0];
              arg = ix[0];
            }
          }
          if (j < K) {
            nxt[j] = __fadd_rn(best, emc[s * K + jr]);
            bp[(s0 + s) * BPS + j] = (uint8_t)arg;
          }
        }
        __syncwarp();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
    if (c + slots < chunks) bar_arrive(EMPTY + slot, THREADS);
  }

  // Final argmax (lane 0), then the backtrace over the shared backpointers.
  if (small && l < K) cur[l] = sc;
  __syncwarp();
  int arg = 0;
  if (l == 0) {
    float best = cur[0];
    for (int j = 1; j < K; ++j) {
      if (cur[j] > best) {
        best = cur[j];
        arg = j;
      }
    }
    scores[b] = best;
    paths[(long long)b * T + T - 1] = arg;
  }
  int32_t* path_b = paths + (long long)b * T;
  if (small) {
    // In parallel: the T-1 rows split into 32 segments. Each lane maps every
    // state at the top of its segment to the state at its bottom (G walks
    // side by side), lane 0 chains the maps from the final argmax down,
    // and each lane walks its segment again from its entry state, storing
    // the path. The maps go where the scored slots were.
    uint8_t* maps = smem + lay.tr;  // 32 x K states, then 32 entry states
    uint8_t* entry = maps + 32 * K;
    const int seg = (steps + 31) / 32 | 1;  // odd: see bp_row
    const int lo = min(l * seg, steps), hi = min(lo + seg, steps);
    int x[G];
#pragma unroll
    for (int k = 0; k < G; ++k) x[k] = min(k, K - 1);
    for (int t = hi - 1; t >= lo; --t) {
      const uint8_t* row = bp + t * BPS;
#pragma unroll
      for (int k = 0; k < G; ++k) x[k] = row[x[k]];
    }
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < K) maps[l * K + k] = (uint8_t)x[k];
    __syncwarp();
    if (l == 0) {
      for (int q = 31; q >= 0; --q) {
        entry[q] = (uint8_t)arg;
        arg = maps[q * K + arg];
      }
    }
    __syncwarp();
    int y = entry[l];
    for (int t = hi - 1; t >= lo; --t) {
      y = bp[t * BPS + y];
      bp[t * BPS] = (uint8_t)y;  // over row t, consumed
    }
  } else if (l == 0) {
    // lane 0 walks, writing step t's choice over row t (consumed)
    for (int t = T - 2; t >= 0; --t) {
      arg = bp[t * BPS + arg];
      bp[t * BPS] = (uint8_t)arg;
    }
  }
  __syncwarp();
  for (int t = l; t < T - 1; t += 32)  // the lanes store the path, coalesced
    path_b[t] = bp[t * BPS];
}

template <typename F, int G>
cudaError_t launch(const void* dist, const void* valid, const void* route,
                   const void* gc, const void* cases, int B, int T, int Tr,
                   int K, float sigma, float beta, int chunk, int smem,
                   int grid, void* paths, void* scores, cudaStream_t stream) {
  auto kernel = viterbi_kernel<F, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const F*>(dist), static_cast<const uint8_t*>(valid),
      static_cast<const F*>(route), static_cast<const F*>(gc),
      static_cast<const int32_t*>(cases), B, T, Tr, K, 1.0 / (double)sigma,
      1.0 / (double)beta, chunk, static_cast<int32_t*>(paths),
      static_cast<float*>(scores));
  return cudaGetLastError();
}

template <typename F>
cudaError_t launch_g(int G, const void* dist, const void* valid,
                     const void* route, const void* gc, const void* cases,
                     int B, int T, int Tr, int K, float sigma, float beta,
                     int chunk, int smem, int grid, void* paths, void* scores,
                     cudaStream_t s) {
  switch (G) {
    case 8:
      return launch<F, 8>(dist, valid, route, gc, cases, B, T, Tr, K, sigma,
                          beta, chunk, smem, grid, paths, scores, s);
    case 16:
      return launch<F, 16>(dist, valid, route, gc, cases, B, T, Tr, K, sigma,
                           beta, chunk, smem, grid, paths, scores, s);
    default:
      return launch<F, 32>(dist, valid, route, gc, cases, B, T, Tr, K, sigma,
                           beta, chunk, smem, grid, paths, scores, s);
  }
}

// ---- incremental_step ------------------------------------------------------
//
// Replaces the JAX package's XLA program
// reporter_tpu/ops/incremental.py `incremental_step_batch` (:50): one step
// of the decode above for N carried traces, each advanced by the one kept
// point appended to it. Per row n, for candidates i (previous point) and j
// (appended point):
//
//   cand[i, j]    = prev[i] + tr[i, j]
//   bp[j]         = argmax_i cand[i, j]        (first maximal index)
//   new_scores[j] = case == RESTART ? max(prev) + em[j]
//                                   : max_i cand[i, j] + em[j]
//   prev_best     = argmax_i prev[i]           (first maximal index)
//
// with em and tr scored by `emission` and `transition` above. The maxima
// are the JAX step's, which the plain version (ops/incremental.py)
// repeats: its reduction keeps the later of equal values, which shows only
// in a zero's sign (an on-edge point scores em == -0.0, so carried scores
// hold signed zeros). Inputs are f32: the host has already round-tripped
// the wire values through f16.
//
// Rounds. One launch runs R rounds of one parameter group: the operands
// stacked (R, N, ...), a step count per row (n_steps, read clamped to
// 0..R; none: R each), the scores carried from round to round in
// registers. Round r's outputs go to new_scores/bp (R, N, K) and
// prev_best (R, N); a row's rounds at and past its step count are written
// as zeros. The host replays the rounds in its own order
// (matcher/incremental.py `_run_rounds`), so one call of the streaming
// decode is one launch a parameter group and slab of rounds (the host
// bounds a slab's bytes).
//
// Bound. A row's round reads K*K*4 + K*9 + 8 bytes and writes K*8 + 4, the
// carried scores K*4 once: at N=512, K=8, R=1, 172,032 bytes in and 34,816
// out, 0.062 us at 3.35 TB/s. The operations (about 6 f32 ops per (i, j))
// bound nothing. What a launch costs is the launch itself and one round's
// dependent chain: the loads, then K shuffles and maxima.
//
// Design. For K <= 32 (`incremental_packed`), a row takes a segment of W
// lanes, K rounded up to a power of two, and a warp packs 32/W rows (four
// warps a block). Lane j keeps prev[j] in a register; prev[i] comes to it
// by __shfl_sync within the segment, so there is no shared memory and no
// barrier. A lane starts every load of a round (case, gc, its dist and
// valid, its K route values: column j, coalesced with its neighbours)
// before the chain, and round r+1's while round r computes. The walk over
// i is ascending with `max_step`, so first maximal indices and the
// signed-zero rule hold. For K > 32 (up to 128, `incremental_rows`), a
// block of K threads (rounded up to a warp) per row, prev in two shared
// buffers that alternate by round, one barrier a round. Past 128 the
// wrapper refuses.

// m = max(m, v) with i its first maximal index, as the JAX step reduces:
// an equal v takes m's place but not its index (+0.0 == -0.0, so only a
// zero's sign can change).
__device__ __forceinline__ void max_step(float v, int i, float& m, int& arg) {
  if (v > m) arg = i;
  if (v >= m) m = v;
}

constexpr int STEP_THREADS = 128;
constexpr int STEP_MAX_K = 128;

struct StepIn {
  const float* dist;     // (R, N, K)
  const uint8_t* valid;  // (R, N, K)
  const float* route;    // (R, N, K, K)
  const float* gc;       // (R, N)
  const int32_t* cases;  // (R, N)
  const float* prev;     // (N, K): the scores before round 0
  const int32_t* steps;  // (N,) rounds of each row, or null: R each
  int R, N, K;
  double inv_sigma, inv_beta;
};

struct StepOut {
  float* scores;        // (R, N, K)
  int32_t* bp;          // (R, N, K)
  int32_t* prev_best;   // (R, N)
};

// Row n's rounds: its step count clamped to 0..R (as the plain version's
// `n_steps > r` over r < R reads it), R each without counts.
__device__ __forceinline__ int row_steps(const StepIn& in, int n) {
  return in.steps ? min(max(in.steps[n], 0), in.R) : in.R;
}

// A lane's operands of one round: its dist and valid, the row's case and
// gc, and its route column (W values, K of them real).
template <int W>
struct LaneOps {
  float d, g;
  int c;
  bool v;
  float r[W];
};

template <int W>
__device__ __forceinline__ void load_lane(const StepIn& in, int r, int n,
                                          int j, bool on, LaneOps<W>& o) {
  o.d = 0.0f;
  o.g = 0.0f;
  o.c = 0;
  o.v = false;
#pragma unroll
  for (int i = 0; i < W; ++i) o.r[i] = 0.0f;
  if (!on) return;
  const long long rn = (long long)r * in.N + n;
  o.c = in.cases[rn];
  o.g = in.gc[rn];
  o.d = in.dist[rn * in.K + j];
  o.v = in.valid[rn * in.K + j] != 0;
  const float* col = in.route + rn * in.K * in.K + j;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < in.K) o.r[i] = col[(long long)i * in.K];
}

template <int W>
__global__ void __launch_bounds__(STEP_THREADS)
    incremental_packed(const StepIn in, const StepOut out) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (W - 1);  // the candidate of this lane's row
  const int n = (blockIdx.x * STEP_THREADS + threadIdx.x) / W;
  const bool live = n < in.N;
  const bool mine = live && j < in.K;  // a real (row, candidate) lane
  const int steps = live ? row_steps(in, n) : 0;
  float p = mine ? in.prev[(long long)n * in.K + j] : 0.0f;
  LaneOps<W> cur, nxt;
  load_lane<W>(in, 0, n, j, mine && steps > 0, cur);
  // every lane runs every round: the shuffles need the whole warp
  for (int r = 0; r < in.R; ++r) {
    load_lane<W>(in, r + 1, n, j, mine && r + 1 < steps, nxt);
    float pi = __shfl_sync(ALL_LANES, p, 0, W);
    float best = __fadd_rn(pi, transition(cur.r[0], cur.g, cur.c, j == 0,
                                          in.inv_beta));
    int arg = 0;
    float mp = pi;
    int pb = 0;
#pragma unroll
    for (int i = 1; i < W; ++i) {
      pi = __shfl_sync(ALL_LANES, p, i, W);
      if (i < in.K) {
        max_step(__fadd_rn(pi, transition(cur.r[i], cur.g, cur.c, i == j,
                                          in.inv_beta)),
                 i, best, arg);
        max_step(pi, i, mp, pb);
      }
    }
    const float e = emission(cur.d, cur.v, cur.c, in.inv_sigma);
    const float s = __fadd_rn(cur.c == RESTART ? mp : best, e);
    const bool act = r < steps;
    const long long rn = (long long)r * in.N + n;
    if (mine) {
      out.scores[rn * in.K + j] = act ? s : 0.0f;
      out.bp[rn * in.K + j] = act ? arg : 0;
      if (j == 0) out.prev_best[rn] = act ? pb : 0;
    }
    p = s;
    cur = nxt;
  }
}

__global__ void __launch_bounds__(STEP_MAX_K)
    incremental_rows(const StepIn in, const StepOut out) {
  __shared__ float sp[2][STEP_MAX_K];  // prev, alternating by round
  const int n = blockIdx.x;
  const int j = threadIdx.x;
  const int K = in.K;
  const int steps = row_steps(in, n);
  if (j < K) sp[0][j] = in.prev[(long long)n * K + j];
  for (int r = 0; r < in.R; ++r) {
    __syncthreads();
    if (j >= K) continue;
    const long long rn = (long long)r * in.N + n;
    if (r >= steps) {
      out.scores[rn * K + j] = 0.0f;
      out.bp[rn * K + j] = 0;
      if (j == 0) out.prev_best[rn] = 0;
      continue;
    }
    const float* prev = sp[r & 1];
    const int c = in.cases[rn];
    const float g = in.gc[rn];
    const float e = emission(in.dist[rn * K + j], in.valid[rn * K + j] != 0,
                             c, in.inv_sigma);
    const float* col = in.route + rn * K * K + j;
    float best = __fadd_rn(prev[0], transition(col[0], g, c, j == 0,
                                               in.inv_beta));
    int arg = 0;
    float mp = prev[0];
    int pb = 0;
    for (int i = 1; i < K; ++i) {
      max_step(__fadd_rn(prev[i], transition(col[(long long)i * K], g, c,
                                             i == j, in.inv_beta)),
               i, best, arg);
      max_step(prev[i], i, mp, pb);
    }
    const float s = __fadd_rn(c == RESTART ? mp : best, e);
    out.scores[rn * K + j] = s;
    out.bp[rn * K + j] = arg;
    if (j == 0) out.prev_best[rn] = pb;
    sp[(r + 1) & 1][j] = s;
  }
}

template <int W>
cudaError_t launch_packed(const StepIn& in, const StepOut& out,
                          cudaStream_t s) {
  const long long lanes = (long long)in.N * W;
  const unsigned grid =
      static_cast<unsigned>((lanes + STEP_THREADS - 1) / STEP_THREADS);
  incremental_packed<W><<<grid, STEP_THREADS, 0, s>>>(in, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches the plan it is given
// (chunk steps, dynamic shared bytes, a grid of one block per trace),
// refusing shared bytes that differ from this file's layout, and returns
// the cudaError_t of the launch (0 on success). The caller allocates
// every buffer; the launch is asynchronous on `stream`. Non-null
// `ev_start`/`ev_end` (cudaEvent_t) are recorded on `stream` right
// before and after the launch, with no host code between them: their
// elapsed time is the launch latency (on an idle stream the start event
// completes while the launch is still being submitted).
extern "C" int viterbi_decode(const void* dist, const void* valid,
                              const void* route, const void* gc,
                              const void* cases, int B, int T, int Tr, int K,
                              int is_f16, float sigma, float beta, int chunk,
                              int smem, int grid, void* paths, void* scores,
                              void* stream, void* ev_start, void* ev_end) {
  if (B <= 0) return 0;
  // the first two bounds keep `layout`'s int arithmetic from overflowing
  if (T <= 0 || K <= 0 || K > 255 || (Tr != T - 1 && Tr != T) ||
      (long long)(T - 1) * K > SMEM_MAX ||
      (long long)chunk * K * K * 4 > SMEM_MAX || chunk < 1 ||
      smem > SMEM_MAX || layout(T, K, chunk).bytes != smem || grid != B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_width(K);
  if (ev_start) {
    cudaError_t e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t err =
      is_f16 ? launch_g<__half>(G, dist, valid, route, gc, cases, B, T, Tr, K,
                                sigma, beta, chunk, smem, grid, paths, scores,
                                s)
             : launch_g<float>(G, dist, valid, route, gc, cases, B, T, Tr, K,
                               sigma, beta, chunk, smem, grid, paths, scores,
                               s);
  if (err == cudaSuccess && ev_end)
    err = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s);
  return (int)err;
}

// Plain C entry point of the incremental step, loaded with ctypes: R
// rounds for N rows in one launch on `stream` (`n_steps` (N,) int32 each
// row's rounds, or null for R each), the caller's buffers, the cudaError_t
// of the launch returned (0 on success). K is 1..128.
extern "C" int incremental_steps(const void* dist, const void* valid,
                                 const void* route, const void* gc,
                                 const void* cases, const void* prev,
                                 const void* n_steps, int R, int N, int K,
                                 float sigma, float beta, void* new_scores,
                                 void* bp, void* prev_best, void* stream) {
  if (N <= 0 || R <= 0) return 0;
  if (K <= 0 || K > STEP_MAX_K) return (int)cudaErrorInvalidValue;
  const StepIn in{static_cast<const float*>(dist),
                  static_cast<const uint8_t*>(valid),
                  static_cast<const float*>(route),
                  static_cast<const float*>(gc),
                  static_cast<const int32_t*>(cases),
                  static_cast<const float*>(prev),
                  static_cast<const int32_t*>(n_steps),
                  R,
                  N,
                  K,
                  1.0 / (double)sigma,
                  1.0 / (double)beta};
  const StepOut out{static_cast<float*>(new_scores),
                    static_cast<int32_t*>(bp),
                    static_cast<int32_t*>(prev_best)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 1) return (int)launch_packed<1>(in, out, s);
  if (K <= 2) return (int)launch_packed<2>(in, out, s);
  if (K <= 4) return (int)launch_packed<4>(in, out, s);
  if (K <= 8) return (int)launch_packed<8>(in, out, s);
  if (K <= 16) return (int)launch_packed<16>(in, out, s);
  if (K <= 32) return (int)launch_packed<32>(in, out, s);
  incremental_rows<<<N, (K + 31) / 32 * 32, 0, s>>>(in, out);
  return (int)cudaGetLastError();
}
