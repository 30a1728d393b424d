// Device route costs for Hopper (sm_90a): one sweep of the bounded
// multi-source relaxation, and the pair-cost assembly.
//
// Replaces two jitted XLA programs of the JAX package that ran on the TPU:
//   reporter_tpu/ops/route_relax.py `relax_csr` (:61), the while_loop of
//     Jacobi sweeps, by `relax_sweep` (one launch per sweep; the host loop
//     in ops/route_relax.py `relax_cuda` stops on the first quiet sweep);
//   reporter_tpu/ops/route_relax.py `pair_costs` (:120) with its packed
//     entry `pair_costs_packed` (:190), by `pair_costs`.
// Both give the bits of the plain PyTorch versions in ops/route_relax.py,
// which follow the JAX programs step for step: IEEE f32 in the same
// order, built with --fmad=false, every add, multiply and division
// rounded on its own (the __f*_rn intrinsics say so where it matters).
//
// relax_sweep. The state of node n in source row s is packed into one
// 64-bit word, (float_bits(dist) << 32) | float_bits(time). Distances and
// times are >= 0 or +inf, so their bits order as their values, and an
// integer compare of two words is the lexicographic (dist, time) order.
// One JAX sweep sets each node to the lexicographic minimum of its old
// pair and every admitted arc (d + len, t + secs) into it, all from the
// old state (a node whose distance drops takes the least time among the
// arcs that reach the new distance; one whose distance holds keeps its
// old time unless a tying arc is faster). So a sweep here is:
//   1. copy old into new (the state is double-buffered; reading and
//      writing one buffer would be Gauss-Seidel, which converges in other
//      sweep counts and can settle ties to other times);
//   2. one thread per (source row, edge): read the old word at the edge's
//      start, drop the arc unless d + len <= bound (NaN-safe: !(cd <= b)),
//      and atomicMin the candidate word into new at the edge's end;
//   3. an atomicMin that lowers a word sets the changed flag: new differs
//      from old exactly where some candidate was below the old word.
// Bound: a sweep reads the S*N old words and E edge columns and writes
// the S*N new words (the copy), 16*S*N + 16*E bytes: at S=512, N=400,
// E=1,520 that is 3.3 MB, about 1 us at 3.35 TB/s. The gathers of the old
// state fall in one row per source, which stays in L2 (50 MB); the
// atomics land in L2 too. Threads of a warp take consecutive edges, so
// the edge columns are read coalesced. A read of the new word first skips
// the atomic for an arc that cannot win (the word only falls within a
// sweep, so a stale read errs towards trying), which takes most atomics
// off the later sweeps, where few arcs improve.
//
// pair_costs. One thread per (b, t, i, j) of the (B, T-1, K, K) route
// tensor, in its row-major order, so the stores are coalesced. It reads
// the two packed blobs in place (layouts in ops/route_relax.py
// `unpack_blobs`) and gathers the node kernels (dist/time rows: S sources
// or, with the node-kernel cache, all N nodes) at node_row[end(ea)],
// start(eb). The emit ladder, in the JAX program's order:
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
// is the JAX reduction's initial=0. Each warp reduces first, so one
// atomicMax per warp reaches L2. Bound: B*(T-1)*K*K*4 bytes written and
// the blobs read, about 2.2 MB at (128, 64, 8): 0.7 us at 3.35 TB/s; the
// gathers of edge columns and kernel rows stay in L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kUnreachable = 1.0e9f;

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
  const float d = __uint_as_float(static_cast<uint32_t>(word >> 32));
  const float cd = __fadd_rn(d, e_len[e]);
  if (!(cd <= bound)) return;  // the admission rule; +inf never passes
  const float t = __uint_as_float(static_cast<uint32_t>(word));
  const float ct = __fadd_rn(t, e_secs[e]);
  const unsigned long long cand =
      (static_cast<unsigned long long>(__float_as_uint(cd)) << 32) |
      __float_as_uint(ct);
  unsigned long long* dst = new_state + s * N + e_end[e];
  if (cand < *reinterpret_cast<volatile unsigned long long*>(dst) &&
      atomicMin(dst, cand) > cand)
    *changed = 1;
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
                      int N, long long total, float* __restrict__ route,
                      int32_t* __restrict__ max_bits) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int32_t bits = 0;  // this thread's contribution to max_finite
  if (idx < total) {
    const int j = static_cast<int>(idx % K);
    const int i = static_cast<int>((idx / K) % K);
    const long long bt = idx / (static_cast<long long>(K) * K);  // b*(T-1)+t
    const int t = static_cast<int>(bt % (T - 1));
    const int b = static_cast<int>(bt / (T - 1));
    const long long btk = static_cast<long long>(B) * T * K;
    const long long bt1 = static_cast<long long>(B) * (T - 1);
    const int32_t* nk = ints + btk;
    const int32_t* node_row = nk + B;
    const float* bounds = f32s + btk;
    const float* caps = bounds + bt1;
    const long long a_at = (static_cast<long long>(b) * T + t) * K + i;
    const long long b_at = (static_cast<long long>(b) * T + t + 1) * K + j;
    const int ea = ints[a_at];
    const int eb = ints[b_at];
    float out = kUnreachable;
    if (ea >= 0 && eb >= 0 && t < nk[b] - 1) {
      const float oa = f32s[a_at];
      const float ob = f32s[b_at];
      const float cap = caps[bt];
      if (ea == eb && ob >= oa) {
        // same edge, forward: the along-edge meters, time-capped
        const float d_fwd = __fsub_rn(ob, oa);
        out = (cap >= 0.0f && __fdiv_rn(d_fwd, e_v[ea]) > cap) ? kUnreachable
                                                                 : d_fwd;
      } else if (ea == eb && __fsub_rn(oa, ob) <= caps[bt1]) {
        out = 0.0f;  // same edge, backward within the tolerance
      } else {
        const float bound = bounds[bt];
        const float tpf = caps[bt1 + 1];
        const float remaining = __fsub_rn(e_len[ea], oa);
        const float via = __fadd_rn(remaining, ob);
        const int row = node_row[e_end[ea]];
        const long long at =
            static_cast<long long>(row > 0 ? row : 0) * N + e_start[eb];
        const float dn = dist_sn[at];
        const float tn = time_sn[at];
        const float via_dn = __fadd_rn(via, dn);
        bool bad = via > bound || row < 0 || !isfinite(dn) || via_dn > bound;
        const float secs = __fadd_rn(
            __fadd_rn(__fdiv_rn(remaining, e_v[ea]), __fdiv_rn(ob, e_v[eb])),
            tn);
        bad = bad || (cap >= 0.0f && secs > cap);
        if (!bad) {
          out = via_dn;
          if (tpf > 0.0f) {
            const float cos_th = __fadd_rn(__fmul_rn(head_x[ea], head_x[eb]),
                                           __fmul_rn(head_y[ea], head_y[eb]));
            out = __fadd_rn(via_dn, __fmul_rn(__fmul_rn(tpf, 0.5f),
                                              __fsub_rn(1.0f, cos_th)));
          }
        }
      }
    }
    route[idx] = out;
    if (out < kUnreachable) bits = __float_as_int(out);
  }
  bits = __reduce_max_sync(0xffffffffu, bits > 0 ? bits : 0);
  if ((threadIdx.x & 31) == 0 && bits > 0) atomicMax(max_bits, bits);
}

unsigned blocks(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

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
  const long long total = static_cast<long long>(B) * (T - 1) * K * K;
  pair_costs_kernel<<<blocks(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ints), static_cast<const float*>(f32s),
      static_cast<const float*>(dist_sn), static_cast<const float*>(time_sn),
      static_cast<const int32_t*>(e_start), static_cast<const int32_t*>(e_end),
      static_cast<const float*>(e_len), static_cast<const float*>(e_v),
      static_cast<const float*>(head_x), static_cast<const float*>(head_y), B,
      T, K, N, total, static_cast<float*>(route),
      static_cast<int32_t*>(max_bits));
  return (int)cudaGetLastError();
}
