// Device route costs for Hopper (sm_90a): the bounded multi-source
// relaxation (`relax`, one launch; `relax_sweep`, one launch per sweep, for
// graphs past the shared-memory limit), and the pair-cost assembly.
//
// Replaces two jitted XLA programs of the JAX package that ran on the TPU:
//   reporter_tpu/ops/route_relax.py `relax_csr` (:61), the while_loop of
//     Jacobi sweeps, by `relax` (every sweep of every source row in one
//     launch) or, where a row's state does not fit shared memory,
//     `relax_sweep` (the host loop in ops/route_relax.py
//     `relax_sweep_cuda` stops on the first quiet sweep);
//   reporter_tpu/ops/route_relax.py `pair_costs` (:120) with its packed
//     entry `pair_costs_packed` (:190), by `pair_costs`.
// All give the bits of the plain PyTorch versions in ops/route_relax.py,
// which follow the JAX programs step for step: IEEE f32 in the same
// order, built with --fmad=false, every add, multiply and division
// rounded on its own (the __f*_rn intrinsics say so where it matters).
//
// The packed state. The state of node n in source row s is one 64-bit
// word, (float_bits(dist) << 32) | float_bits(time). Distances and times
// are >= 0 or +inf, so their bits order as their values, and an integer
// compare of two words is the lexicographic (dist, time) order. One JAX
// sweep sets each node to the lexicographic minimum of its old pair and
// every admitted arc (d + len, t + secs) into it, all from the old state
// (a node whose distance drops takes the least time among the arcs that
// reach the new distance; one whose distance holds keeps its old time
// unless a tying arc is faster): a 64-bit atomicMin of each candidate
// word into a copy of the old state. The state is double-buffered:
// reading and writing one buffer would be Gauss-Seidel, which converges
// in other sweep counts and can settle ties to other times.
//
// relax. One block per source row. The row's two buffers live in dynamic
// shared memory, 16*N bytes (N <= 14,528 in the 232,448 bytes a Hopper
// block may take), and the block runs its own sweeps, separated by
// barriers, until one lowers no word or the cap. Rows are independent, so
// a row that is quiet stays quiet: the JAX loop's `iters` is the largest
// row's count (one atomicMax) and it converged iff every row had a quiet
// sweep within the cap (a count of rows that did not). A sweep relaxes
// only the out-arcs of its frontier, the nodes whose word fell in the
// sweep before (the source in the first), read in CSR order (arcs
// grouped by start node). That is exact: an arc whose start word did not
// change gives the candidate it gave a sweep earlier, which is already
// min'd into its end, so skipping it changes no bit and no sweep count.
// The frontier is found without a list: before a sweep the write buffer
// holds the state two sweeps back, so it differs from the read buffer
// exactly at the frontier; each thread copies the words that differ into
// the write buffer and keeps a bit per owned node in a register (a
// thread owns at most 64 nodes; ops/route_relax.py `relax_threads` sizes
// the block). Bound: the S*N dist and time planes written once (8*S*N
// bytes) dominate; the CSR arcs (12 bytes each) are read from L2 by every
// row. At S=512, N=400 that is 1.6 MB, 0.5 us at 3.35 TB/s; at S=2048,
// N=10,000, 164 MB, 49 us. The host reads iters and converged once per
// relaxation, not once per sweep.
//
// relax_sweep. One sweep: copy old into new (S*N words), zero the changed
// flag, then one thread per (source row, edge): read the old word at the
// edge's start, drop the arc unless d + len <= bound (NaN-safe:
// !(cd <= b)), and atomicMin the candidate word into new at the edge's
// end; an atomicMin that lowers a word sets the flag. Bound: 16*S*N +
// 16*E bytes a sweep. A read of the new word first skips the atomic for
// an arc that cannot win (the word only falls within a sweep, so a stale
// read errs towards trying).
//
// pair_costs. One block per tile of G consecutive (b, t) steps of the
// (B, T-1, K, K) route tensor (G*K*K about 1,024 outputs), 32-bit
// indexing. The block first loads each step's 2K candidates once into
// shared memory with what every partner of a candidate shares: for the
// from side (point t) edge, offset, remaining = len - offset, remaining /
// v, the node-kernel row of the edge's end node, v and the heading; for
// the to side (point t+1) edge, offset, offset / v, the edge's start node
// and the heading; and each step's bound, cap and liveness. Then its
// threads walk the tile's outputs in memory order (coalesced stores),
// each one gather of the node kernels (dist/time rows: S sources or, with
// the node-kernel cache, all N nodes) at (row(i), start(j)). The emit
// ladder, in the JAX program's order:
//   remaining = len[ea] - oa; via = remaining + ob; via_dn = via + dn
//   bad  = via > bound | row < 0 | !isfinite(dn) | via_dn > bound
//        | (cap >= 0 & (remaining/v[ea] + ob/v[eb]) + tn > cap)
//   pen  = (tpf * 0.5) * (1 - (hx[ea]*hx[eb] + hy[ea]*hy[eb]))
//   gen  = bad ? UNREACH : (tpf > 0 ? via_dn + pen : via_dn)
//   same edge, ob >= oa: ob - oa, UNREACH if cap >= 0 & (ob-oa)/v > cap
//   same edge, 0 < oa - ob <= backward_tol: 0
//   pad candidate (edge < 0) or t >= nk[b] - 1: UNREACH.
// max_finite, the largest value below UNREACH (0 when none), is a max over
// the float bits as signed ints: values >= 0 order as their bits, and
// negatives (negative ints) lose to the zero the slot starts from, which
// is the JAX reduction's initial=0. Each block reduces first, so one
// atomicMax per block reaches L2. Bound: B*(T-1)*K*K*4 bytes written and
// the blobs read, about 2.7 MB at (128, 64, 8): 0.8 us at 3.35 TB/s; the
// gathers of edge columns and kernel rows stay in L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kUnreachable = 1.0e9f;
constexpr unsigned long long kUnreached = 0x7F8000007F800000ull;
// dynamic shared memory one block may take on Hopper (227 KB)
constexpr int kMaxSmem = 232448;
constexpr int kRelaxMaxThreads = 1024;
// pair_costs: outputs a block aims at, and its shared words a candidate
// and a step
constexpr int kTileOutputs = 1024;
constexpr int kCandWords = 14;
constexpr int kStepWords = 3;

__device__ __forceinline__ float dist_of(unsigned long long w) {
  return __uint_as_float(static_cast<uint32_t>(w >> 32));
}

__device__ __forceinline__ float time_of(unsigned long long w) {
  return __uint_as_float(static_cast<uint32_t>(w));
}

__device__ __forceinline__ unsigned long long pack(float d, float t) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         __float_as_uint(t);
}

__global__ void __launch_bounds__(kRelaxMaxThreads)
    relax_kernel(const int32_t* __restrict__ src_nodes,
                 const int32_t* __restrict__ csr_off,
                 const int32_t* __restrict__ csr_end,
                 const float* __restrict__ csr_len,
                 const float* __restrict__ csr_secs, int N, float bound,
                 int max_iters, float* __restrict__ dist,
                 float* __restrict__ time, int32_t* __restrict__ info) {
  extern __shared__ unsigned long long state[];
  unsigned long long* cur = state;      // the sweep reads this buffer
  unsigned long long* nxt = state + N;  // and writes this one
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  for (int n = tid; n < N; n += step) {
    cur[n] = kUnreached;
    nxt[n] = kUnreached;
  }
  __syncthreads();
  const int src = src_nodes[blockIdx.x];
  const bool src_ok = src >= 0 && src < N;
  if (tid == 0 && src_ok) cur[src] = 0ull;  // (0, 0) at the source
  __syncthreads();
  int iters = 0;
  bool quiet = false;
  while (iters < max_iters) {
    // the frontier: where cur differs from the state a sweep before it,
    // copied into nxt, one bit per owned node
    unsigned long long mine = 0ull;
    for (int n = tid, b = 0; n < N; n += step, ++b) {
      const unsigned long long w = cur[n];
      if (w != nxt[n]) {
        nxt[n] = w;
        mine |= 1ull << b;
      }
    }
    __syncthreads();
    int lowered = 0;
    while (mine) {
      const int b = __ffsll(static_cast<long long>(mine)) - 1;
      mine &= mine - 1;
      const int n = tid + b * step;
      const unsigned long long w = cur[n];
      const float d = dist_of(w);
      const float t = time_of(w);
      const int end = csr_off[n + 1];
      for (int a = csr_off[n]; a < end; ++a) {
        const float cd = __fadd_rn(d, csr_len[a]);
        if (!(cd <= bound)) continue;  // the admission rule
        const unsigned long long cand = pack(cd, __fadd_rn(t, csr_secs[a]));
        unsigned long long* dst = nxt + csr_end[a];
        if (cand < *reinterpret_cast<volatile unsigned long long*>(dst) &&
            atomicMin(dst, cand) > cand)
          lowered = 1;
      }
    }
    ++iters;
    if (!__syncthreads_or(lowered)) {
      quiet = true;  // nxt == cur: the state is final
      break;
    }
    unsigned long long* swap = cur;
    cur = nxt;
    nxt = swap;
  }
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  for (int n = tid; n < N; n += step) {
    const unsigned long long w = cur[n];
    dist[row + n] = dist_of(w);
    time[row + n] = time_of(w);
  }
  if (tid == 0) {
    atomicMax(info, iters);
    if (!quiet) atomicAdd(info + 1, 1);
    if (!src_ok) atomicAdd(info + 2, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    relax_sweep_kernel(const unsigned long long* __restrict__ old_state,
                       unsigned long long* __restrict__ new_state,
                       const int32_t* __restrict__ e_start,
                       const int32_t* __restrict__ e_end,
                       const float* __restrict__ e_len,
                       const float* __restrict__ e_secs, int N, int E,
                       long long total, float bound,
                       int32_t* __restrict__ changed) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long s = idx / E;
  const int e = static_cast<int>(idx - s * E);
  const unsigned long long word = old_state[s * N + e_start[e]];
  const float cd = __fadd_rn(dist_of(word), e_len[e]);
  if (!(cd <= bound)) return;  // the admission rule; +inf never passes
  const unsigned long long cand = pack(cd, __fadd_rn(time_of(word), e_secs[e]));
  unsigned long long* dst = new_state + s * N + e_end[e];
  if (cand < *reinterpret_cast<volatile unsigned long long*>(dst) &&
      atomicMin(dst, cand) > cand)
    *changed = 1;
}

// pair_costs' shared memory: G*K candidate slots of each array, then G
// step slots of each
struct Tile {
  int* ea;
  float* oa;
  float* rem;
  float* rem_s;
  int* row;
  float* va;
  float* hxa;
  float* hya;
  int* eb;
  float* ob;
  float* ob_s;
  int* start;
  float* hxb;
  float* hyb;
  float* bound;
  float* cap;
  int* live;
};

__device__ Tile carve(uint32_t* smem, int GK, int G) {
  Tile s;
  s.ea = reinterpret_cast<int*>(smem);
  s.oa = reinterpret_cast<float*>(smem + GK);
  s.rem = reinterpret_cast<float*>(smem + 2 * GK);
  s.rem_s = reinterpret_cast<float*>(smem + 3 * GK);
  s.row = reinterpret_cast<int*>(smem + 4 * GK);
  s.va = reinterpret_cast<float*>(smem + 5 * GK);
  s.hxa = reinterpret_cast<float*>(smem + 6 * GK);
  s.hya = reinterpret_cast<float*>(smem + 7 * GK);
  s.eb = reinterpret_cast<int*>(smem + 8 * GK);
  s.ob = reinterpret_cast<float*>(smem + 9 * GK);
  s.ob_s = reinterpret_cast<float*>(smem + 10 * GK);
  s.start = reinterpret_cast<int*>(smem + 11 * GK);
  s.hxb = reinterpret_cast<float*>(smem + 12 * GK);
  s.hyb = reinterpret_cast<float*>(smem + 13 * GK);
  uint32_t* steps = smem + kCandWords * GK;
  s.bound = reinterpret_cast<float*>(steps);
  s.cap = reinterpret_cast<float*>(steps + G);
  s.live = reinterpret_cast<int*>(steps + 2 * G);
  return s;
}

__global__ void __launch_bounds__(kThreads)
    pair_costs_kernel(const int32_t* __restrict__ ints,
                      const float* __restrict__ f32s,
                      const float* __restrict__ dist_sn,
                      const float* __restrict__ time_sn,
                      const int32_t* __restrict__ e_start,
                      const int32_t* __restrict__ e_end,
                      const float* __restrict__ e_len,
                      const float* __restrict__ e_v,
                      const float* __restrict__ head_x,
                      const float* __restrict__ head_y, int B, int T, int K,
                      int N, int G, float* __restrict__ route,
                      int32_t* __restrict__ max_bits) {
  extern __shared__ uint32_t smem[];
  __shared__ int32_t warp_max[kThreads / 32];
  const int T1 = T - 1;
  const int BT1 = B * T1;
  const int KK = K * K;
  const int GK = G * K;
  const int bt0 = blockIdx.x * G;
  const int steps = min(G, BT1 - bt0);
  const Tile s = carve(smem, GK, G);
  const int32_t* nk = ints + B * T * K;
  const int32_t* node_row = nk + B;
  const float* bounds = f32s + B * T * K;
  const float* caps = bounds + BT1;
  const float btol = caps[BT1];
  const float tpf = caps[BT1 + 1];

  for (int c = threadIdx.x; c < steps * K; c += kThreads) {
    const int g = c / K;
    const int k = c - g * K;
    const int bt = bt0 + g;
    const int b = bt / T1;
    const int a_at = (b * T + (bt - b * T1)) * K + k;  // point t, slot k
    const int b_at = a_at + K;                         // point t + 1
    const int ea = ints[a_at];
    const float oa = f32s[a_at];
    s.ea[c] = ea;
    s.oa[c] = oa;
    if (ea >= 0) {
      const float va = e_v[ea];
      const float remaining = __fsub_rn(e_len[ea], oa);
      s.rem[c] = remaining;
      s.rem_s[c] = __fdiv_rn(remaining, va);
      s.row[c] = node_row[e_end[ea]];
      s.va[c] = va;
      s.hxa[c] = head_x[ea];
      s.hya[c] = head_y[ea];
    }
    const int eb = ints[b_at];
    const float ob = f32s[b_at];
    s.eb[c] = eb;
    s.ob[c] = ob;
    if (eb >= 0) {
      s.ob_s[c] = __fdiv_rn(ob, e_v[eb]);
      s.start[c] = e_start[eb];
      s.hxb[c] = head_x[eb];
      s.hyb[c] = head_y[eb];
    }
  }
  for (int g = threadIdx.x; g < steps; g += kThreads) {
    const int bt = bt0 + g;
    const int b = bt / T1;
    s.bound[g] = bounds[bt];
    s.cap[g] = caps[bt];
    s.live[g] = (bt - b * T1) < nk[b] - 1;
  }
  __syncthreads();

  int32_t bits = 0;  // this thread's share of max_finite
  float* out_tile = route + static_cast<size_t>(bt0) * KK;
  for (int o = threadIdx.x; o < steps * KK; o += kThreads) {
    const int g = o / KK;
    const int r = o - g * KK;
    const int i = r / K;
    const int ia = g * K + i;           // from-side slot
    const int jb = g * K + (r - i * K);  // to-side slot
    const int ea = s.ea[ia];
    const int eb = s.eb[jb];
    float out = kUnreachable;
    if (ea >= 0 && eb >= 0 && s.live[g]) {
      const float oa = s.oa[ia];
      const float ob = s.ob[jb];
      const float cap = s.cap[g];
      if (ea == eb && ob >= oa) {
        // same edge, forward: the along-edge meters, time-capped
        const float d_fwd = __fsub_rn(ob, oa);
        out = (cap >= 0.0f && __fdiv_rn(d_fwd, s.va[ia]) > cap)
                  ? kUnreachable
                  : d_fwd;
      } else if (ea == eb && __fsub_rn(oa, ob) <= btol) {
        out = 0.0f;  // same edge, backward within the tolerance
      } else {
        const float bound = s.bound[g];
        const float via = __fadd_rn(s.rem[ia], ob);
        const int row = s.row[ia];
        const size_t at =
            static_cast<size_t>(row > 0 ? row : 0) * N + s.start[jb];
        const float dn = dist_sn[at];
        const float tn = time_sn[at];
        const float via_dn = __fadd_rn(via, dn);
        bool bad = via > bound || row < 0 || !isfinite(dn) || via_dn > bound;
        const float secs = __fadd_rn(__fadd_rn(s.rem_s[ia], s.ob_s[jb]), tn);
        bad = bad || (cap >= 0.0f && secs > cap);
        if (!bad) {
          out = via_dn;
          if (tpf > 0.0f) {
            const float cos_th = __fadd_rn(__fmul_rn(s.hxa[ia], s.hxb[jb]),
                                           __fmul_rn(s.hya[ia], s.hyb[jb]));
            out = __fadd_rn(via_dn, __fmul_rn(__fmul_rn(tpf, 0.5f),
                                              __fsub_rn(1.0f, cos_th)));
          }
        }
      }
    }
    out_tile[o] = out;
    if (out < kUnreachable && __float_as_int(out) > bits)
      bits = __float_as_int(out);
  }
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) bits = max(bits, warp_max[w]);
    if (bits > 0) atomicMax(max_bits, bits);
  }
}

unsigned blocks(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// pair_costs' tile: steps a block takes, about kTileOutputs outputs
int tile_steps(int K) {
  const int g = kTileOutputs / (K * K);
  return g > 1 ? g : 1;
}

}  // namespace

// The whole relaxation on `stream`: one block of `threads` per source row,
// every sweep up to `max_iters`; writes the (S, N) dist and time planes
// and info = [iters, rows that did not converge, sources outside 0..N-1]
// (three zeroed int32). Returns a CUDA error.
extern "C" int relax(const void* src_nodes, int S, const void* csr_off,
                     const void* csr_end, const void* csr_len,
                     const void* csr_secs, int N, float bound, int max_iters,
                     int threads, void* dist, void* time, void* info,
                     void* stream) {
  const long long smem = 16ll * N;
  if (S < 1 || N < 1 || max_iters < 0 || smem > kMaxSmem || threads < 32 ||
      threads > kRelaxMaxThreads || threads % 32 ||
      (N + threads - 1) / threads > 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  relax_kernel<<<S, threads, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_nodes),
      static_cast<const int32_t*>(csr_off),
      static_cast<const int32_t*>(csr_end),
      static_cast<const float*>(csr_len), static_cast<const float*>(csr_secs),
      N, bound, max_iters, static_cast<float*>(dist),
      static_cast<float*>(time), static_cast<int32_t*>(info));
  return (int)cudaGetLastError();
}

// One sweep on `stream`: copy old_state into new_state (S*N words), zero
// the changed flag, relax every (source row, edge). Returns a CUDA error.
extern "C" int relax_sweep(const void* old_state, void* new_state,
                           const void* e_start, const void* e_end,
                           const void* e_len, const void* e_secs, int S,
                           int N, int E, float bound, void* changed,
                           void* stream) {
  if (S < 0 || N < 0 || E < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = static_cast<size_t>(S) * N;
  cudaError_t err =
      cudaMemcpyAsync(new_state, old_state, words * sizeof(unsigned long long),
                      cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(changed, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const long long total = static_cast<long long>(S) * E;
  if (total == 0 || N == 0) return 0;
  relax_sweep_kernel<<<blocks(total), kThreads, 0, st>>>(
      static_cast<const unsigned long long*>(old_state),
      static_cast<unsigned long long*>(new_state),
      static_cast<const int32_t*>(e_start), static_cast<const int32_t*>(e_end),
      static_cast<const float*>(e_len), static_cast<const float*>(e_secs), N,
      E, total, bound, static_cast<int32_t*>(changed));
  return (int)cudaGetLastError();
}

// The (B, T-1, K, K) route tensor and the finite max's bits (a zeroed
// int32 slot) on `stream`. `rows` is the node kernels' row count (S or N).
extern "C" int pair_costs(const void* ints, const void* f32s,
                          const void* dist_sn, const void* time_sn, int rows,
                          const void* e_start, const void* e_end,
                          const void* e_len, const void* e_v,
                          const void* head_x, const void* head_y, int B,
                          int T, int K, int N, void* route, void* max_bits,
                          void* stream) {
  if (B < 1 || T < 2 || K < 1 || N < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  // 32-bit indexing: the blobs and every tile's outputs
  const long long BT1 = static_cast<long long>(B) * (T - 1);
  if (static_cast<long long>(B) * T * K + B + N > INT32_MAX ||
      BT1 * K * K > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = tile_steps(K);
  const size_t smem =
      sizeof(uint32_t) * (static_cast<size_t>(kCandWords) * G * K +
                          static_cast<size_t>(kStepWords) * G);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((BT1 + G - 1) / G);
  pair_costs_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ints), static_cast<const float*>(f32s),
      static_cast<const float*>(dist_sn), static_cast<const float*>(time_sn),
      static_cast<const int32_t*>(e_start), static_cast<const int32_t*>(e_end),
      static_cast<const float*>(e_len), static_cast<const float*>(e_v),
      static_cast<const float*>(head_x), static_cast<const float*>(head_y), B,
      T, K, N, G, static_cast<float*>(route),
      static_cast<int32_t*>(max_bits));
  return (int)cudaGetLastError();
}
