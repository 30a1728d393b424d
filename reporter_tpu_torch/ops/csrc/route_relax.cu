// Device route costs for Hopper (sm_90a): the bounded multi-source
// relaxation (`relax`, one launch, a block a source row; `relax_cluster`,
// one launch, a thread-block cluster a source row, for graphs past one
// block's shared memory; `relax_global`, one launch, a block a source row
// with its state in global memory, for graphs past a cluster's), and the
// pair-cost assembly.
//
// Replaces two jitted XLA programs of the JAX package that ran on the TPU:
//   reporter_tpu/ops/route_relax.py `relax_csr` (:61), the while_loop of
//     Jacobi sweeps, by `relax` (every sweep of every source row in one
//     launch), where a row's state does not fit one block's shared memory
//     by `relax_cluster` (the same, the row's state split over a cluster
//     of 2 to 8 blocks), and past that by `relax_global` (the same, the
//     row's state in global memory and its frontier a list); the choice
//     is by N alone (ops/route_relax.py `relax_kernel_for`);
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
// relax_cluster. `relax` past 14,528 nodes: a cluster of C blocks (2 to 8,
// ops/route_relax.py `cluster_width`: the fewest whose slices fit) per
// source row, launched with cudaLaunchKernelEx and the cluster-dimension
// attribute. Block r of the cluster owns the nodes [r*L, (r+1)*L), L =
// ceil(N/C), and keeps their two packed buffers in its dynamic shared
// memory (16*L bytes, then 16 bytes of flags): one launch takes N up to
// 8 * 14,527 = 116,216 nodes. A sweep is `relax`'s: each block finds its
// slice's frontier (the words where cur differs from nxt, copied into
// nxt, a bit per owned node), then relaxes its frontier's out-arcs in CSR
// order with the same admission rule, and the candidate word is min'd
// into the nxt of the block that owns the arc's end: in the block's own
// slice by `relax`'s 64-bit atomicMin, in a neighbour's through
// distributed shared memory (`cluster.map_shared_rank`) by a 64-bit
// atomicCAS loop. (A 64-bit atomic min on a distributed shared memory
// address is not atomic on the H100, whether the generic ATOM.E.MIN.64
// that atomicMin on a mapped pointer compiles to or the PTX
// atom.shared::cluster.min.u64: analysis/dsmem_atomics.py loses minima
// with it at every cluster width, even on a block's own words reached
// through their mapped address, and none with this mix, the own slice's
// atomicMin (ATOMS.CAST.SPIN.64) beside the remote CAS loop
// (ATOM.E.CAS.64), nor with CAS loops alone. PERF.md.) Two
// cluster.sync()s a sweep: one after the frontier copy, so that no block
// relaxes into a slice another block is still copying, and one after the
// relaxation. Whether any block lowered a word
// is one flag in rank 0's shared memory, one per sweep parity: rank 0
// clears the other parity's flag after the first sync of a sweep, when
// every block has read it, so a clear never races a read. Every block
// reads the same flag after the second sync and so takes the same
// branch: the syncs are never in a branch some blocks skip. The buffers
// are sliced, not changed: each candidate, each min's outcome and each
// sweep count are `relax`'s, so the bits are too. At the end each block
// writes its slice of the dist and time planes, rank 0 alone the row's
// info, and a last cluster.sync() keeps rank 0's flags alive until every
// block has read them. Before the first launch of a (width, block, shared
// bytes) the wrapper asks cudaOccupancyMaxActiveClusters and raises if no
// cluster fits. Bound: `relax`'s, the 8*S*N planes written; at S=1,024,
// N=15,625 (the 125x125 city's chunk, C=2), 128 MB, 38 us at 3.35 TB/s.
//
// relax_global. `relax` past 116,216 nodes, in one launch: G blocks
// stride over the S source rows (block b takes rows b, b + G, ...), each
// with one slot of a global scratch for the row it is on: two packed
// buffers and three node lists, 16*N + 12*N bytes (ops/route_relax.py
// `GlobalScratch`, one a device, kept between relaxations). G =
// ops/route_relax.py `global_blocks(S, N)`: S where the G slots fit
// GLOBAL_SCRATCH_BYTES (1 GiB), fewer past it, so the scratch is bounded
// whatever S. The frontier is a list, not a scan over N: a sweep (1)
// copies the words of the frontier's nodes from cur into nxt (before it
// the buffers differ exactly there, so after it they are equal), (2)
// relaxes the frontier's out-arcs in CSR order with `relax`'s admission
// rule and 64-bit atomicMin (in global memory, where it is atomic; it was
// DSMEM where the H100 lost minima), and appends an arc's end to the next
// frontier when its atomicMin lowered the word the node had at the
// sweep's start (cur's, which no one writes during the sweep): only a
// node's first lowering in a sweep sees that word, so a node enters a
// frontier once, and a list of N entries always holds it. An empty next
// frontier is the quiet sweep. A node whose atomicMin returned the
// unreached word enters the reached list, once in the row. Sweeps are
// separated by __syncthreads(), and the frontier counts (one per sweep
// parity) live in shared memory: a count is zeroed two sweeps after it
// was read. Words and lists are read with ld.global.cg, at L2, as the
// atomics act. The block writes its row of the dist and time planes at
// +inf first (16-byte stores), then after the sweeps the words of the
// source and the reached nodes into them, and resets exactly those words
// of both buffers to unreached: every word of a slot is unreached before
// and after each row, so the next row of the block (and the next
// relaxation) finds it ready, and the scratch is filled once, when
// allocated (16*G*N bytes), not per relaxation. Bound: the 8*S*N planes
// written, the sources read, and the CSR offsets and arcs of the nodes
// some row reaches read once (a bounded relaxation reads no other arc):
// at the 341x341 city's first chunk (S = 128, N = 116,281) the planes
// alone are 119,071,744 bytes, 0.0355 ms at 3.35 TB/s (chip_smoke.py
// `relax_bound` adds the rest); the kernel moves those plus the frontier's
// words, arcs and lists, which a bounded row keeps small and in the 50 MB
// L2. One block a row leaves SMs idle when S < 132.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kUnreachable = 1.0e9f;
constexpr unsigned long long kUnreached = 0x7F8000007F800000ull;
// dynamic shared memory one block may take on Hopper (227 KB)
constexpr int kMaxSmem = 232448;
constexpr int kRelaxMaxThreads = 1024;
// relax_cluster: the most blocks of a portable cluster, and the bytes of
// rank 0's two per-parity flags after each block's slice (16 keep the
// next word aligned)
constexpr int kMaxCluster = 8;
constexpr int kClusterFlagBytes = 16;
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

// One cluster of C blocks per source row (cluster k = blocks [k*C,
// (k+1)*C) = source row k); block r owns nodes [r*L, r*L + own). One
// block an SM (its shared memory), so all 64K registers are its own.
__global__ void __launch_bounds__(kRelaxMaxThreads, 1)
    relax_cluster_kernel(const int32_t* __restrict__ src_nodes,
                         const int32_t* __restrict__ csr_off,
                         const int32_t* __restrict__ csr_end,
                         const float* __restrict__ csr_len,
                         const float* __restrict__ csr_secs, int N, int L,
                         float bound, int max_iters, float* __restrict__ dist,
                         float* __restrict__ time,
                         int32_t* __restrict__ info) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned long long state[];
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int lo = rank * L;
  const int own = max(0, min(L, N - lo));
  unsigned long long* cur = state;      // this block's slice, read
  unsigned long long* nxt = state + L;  // and written
  int* flags = reinterpret_cast<int*>(state + 2 * L);
  // rank 0's flags: flag[p] is set by any block that lowers a word in a
  // sweep of parity p
  volatile int* flag0 = cluster.map_shared_rank(flags, 0);
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  for (int n = tid; n < own; n += step) {
    cur[n] = kUnreached;
    nxt[n] = kUnreached;
  }
  if (rank == 0 && tid == 0) {
    flags[0] = 0;
    flags[1] = 0;
  }
  __syncthreads();
  const int row = blockIdx.x / C;
  const int src = src_nodes[row];
  const bool src_ok = src >= 0 && src < N;
  if (tid == 0 && src_ok && src >= lo && src < lo + own)
    cur[src - lo] = 0ull;  // (0, 0) at the source, in its owner's slice
  __syncthreads();
  int iters = 0;
  int parity = 0;
  bool quiet = false;
  while (iters < max_iters) {
    unsigned long long mine = 0ull;
    for (int n = tid, b = 0; n < own; n += step, ++b) {
      const unsigned long long w = cur[n];
      if (w != nxt[n]) {
        nxt[n] = w;
        mine |= 1ull << b;
      }
    }
    // every slice's frontier copied before any block relaxes into it
    cluster.sync();
    // every block read the other parity's flag before this sync
    if (rank == 0 && tid == 0) flags[parity ^ 1] = 0;
    int lowered = 0;
    while (mine) {
      const int b = __ffsll(static_cast<long long>(mine)) - 1;
      mine &= mine - 1;
      const int n = tid + b * step;
      const unsigned long long w = cur[n];
      const float d = dist_of(w);
      const float t = time_of(w);
      const int end = csr_off[lo + n + 1];
      for (int a = csr_off[lo + n]; a < end; ++a) {
        const float cd = __fadd_rn(d, csr_len[a]);
        if (!(cd <= bound)) continue;  // the admission rule
        const unsigned long long cand = pack(cd, __fadd_rn(t, csr_secs[a]));
        const int v = csr_end[a];
        const int owner = v / L;
        if (owner == rank) {  // this block's slice: as relax
          unsigned long long* dst = nxt + (v - lo);
          if (cand < *reinterpret_cast<volatile unsigned long long*>(dst) &&
              atomicMin(dst, cand) > cand)
            lowered = 1;
          continue;
        }
        // a neighbour's slice: a 64-bit CAS loop, the guess unreached
        // (every word is at most that, every candidate below it)
        unsigned long long* dst =
            cluster.map_shared_rank(nxt, owner) + (v - owner * L);
        unsigned long long old = kUnreached;
        while (cand < old) {
          const unsigned long long seen = atomicCAS(dst, old, cand);
          if (seen == old) {
            lowered = 1;
            break;
          }
          old = seen;
        }
      }
    }
    if (__any_sync(0xffffffffu, lowered) && (tid & 31) == 0)
      flag0[parity] = 1;
    cluster.sync();  // every relaxation of the sweep done
    ++iters;
    if (!flag0[parity]) {  // the same value in every block
      quiet = true;        // nxt == cur: the state is final
      break;
    }
    unsigned long long* swap = cur;
    cur = nxt;
    nxt = swap;
    parity ^= 1;
  }
  const size_t at = static_cast<size_t>(row) * N + lo;
  for (int n = tid; n < own; n += step) {
    const unsigned long long w = cur[n];
    dist[at + n] = dist_of(w);
    time[at + n] = time_of(w);
  }
  if (rank == 0 && tid == 0) {
    atomicMax(info, iters);
    if (!quiet) atomicAdd(info + 1, 1);
    if (!src_ok) atomicAdd(info + 2, 1);
  }
  cluster.sync();  // rank 0's flags stay until every block has read them
}

// `n` floats from `p` (4-byte aligned) set to +inf by the block: a
// scalar head to 16 bytes, 16-byte stores, a scalar tail.
__device__ __forceinline__ void fill_inf(float* p, int n) {
  const float inf = __uint_as_float(0x7F800000u);
  const int head = min(
      n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) / 4) &
                          3));
  const int quads = (n - head) >> 2;
  float4* body = reinterpret_cast<float4*>(p + head);
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = inf;
  for (int i = threadIdx.x; i < quads; i += blockDim.x)
    body[i] = make_float4(inf, inf, inf, inf);
  for (int i = head + 4 * quads + threadIdx.x; i < n; i += blockDim.x)
    p[i] = inf;
}

// Blocks stride over the source rows: block b relaxes rows b, b + G, ...
// (G = gridDim.x <= S) in its own slot of the scratch: buffers
// words[2bN, 2bN + 2N), lists lists[3bN, 3bN + 3N) (two frontiers, then the
// reached nodes). Every word is unreached when a row starts and again when
// it ends, so the next row of the block finds its slot ready.
__global__ void __launch_bounds__(kRelaxMaxThreads)
    relax_global_kernel(const int32_t* __restrict__ src_nodes, int S,
                        const int32_t* __restrict__ csr_off,
                        const int32_t* __restrict__ csr_end,
                        const float* __restrict__ csr_len,
                        const float* __restrict__ csr_secs, int N, float bound,
                        int max_iters, unsigned long long* words,
                        int32_t* lists, float* __restrict__ dist,
                        float* __restrict__ time, int32_t* __restrict__ info) {
  __shared__ int count[2];  // the next frontier's length, by sweep parity
  __shared__ int n_reached;
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  unsigned long long* const buf0 = words + size_t(blockIdx.x) * 2 * N;
  int32_t* const list0 = lists + size_t(blockIdx.x) * 3 * N;
  for (size_t row = blockIdx.x; row < size_t(S); row += gridDim.x) {
    unsigned long long* cur = buf0;     // the sweep reads this
    unsigned long long* nxt = buf0 + N; // and writes this
    int32_t* front = list0;             // this sweep's frontier
    int32_t* next = list0 + N;          // and the next one
    int32_t* const reached = list0 + 2 * N;
    float* dist_row = dist + row * N;
    float* time_row = time + row * N;
    fill_inf(dist_row, N);
    fill_inf(time_row, N);
    const int src = src_nodes[row];
    const bool src_ok = src >= 0 && src < N;
    if (tid == 0) {
      n_reached = 0;
      if (src_ok) {  // (0, 0) at the source, its first frontier
        __stcg(cur + src, 0ull);
        __stcg(front, src);
      }
    }
    int nf = src_ok ? 1 : 0;
    int iters = 0;
    int parity = 0;
    bool quiet = false;
    __syncthreads();
    while (iters < max_iters) {
      for (int i = tid; i < nf; i += step) {
        const int n = __ldcg(front + i);
        __stcg(nxt + n, __ldcg(cur + n));
      }
      // read two sweeps ago, before the syncs of the sweep between
      if (tid == 0) count[parity] = 0;
      __syncthreads();
      for (int i = tid; i < nf; i += step) {
        const int n = __ldcg(front + i);
        const unsigned long long w = __ldcg(cur + n);
        const float d = dist_of(w);
        const float t = time_of(w);
        const int end = csr_off[n + 1];
        for (int a = csr_off[n]; a < end; ++a) {
          const float cd = __fadd_rn(d, csr_len[a]);
          if (!(cd <= bound)) continue;  // the admission rule
          const unsigned long long cand =
              pack(cd, __fadd_rn(t, csr_secs[a]));
          const int v = csr_end[a];
          if (!(cand < __ldcg(nxt + v))) continue;
          const unsigned long long old = atomicMin(nxt + v, cand);
          if (old <= cand || old != __ldcg(cur + v)) continue;
          // v's first lowering this sweep; its first ever if unreached
          __stcg(next + atomicAdd(&count[parity], 1), v);
          if (old == kUnreached) __stcg(reached + atomicAdd(&n_reached, 1), v);
        }
      }
      __syncthreads();
      ++iters;
      const int lowered = count[parity];
      if (!lowered) {
        quiet = true;  // nxt == cur: the state is final
        break;
      }
      unsigned long long* swap = cur;
      cur = nxt;
      nxt = swap;
      int32_t* swap_list = front;
      front = next;
      next = swap_list;
      nf = lowered;
      parity ^= 1;
    }
    // the final words of the source and the reached nodes into the planes,
    // then those words of both buffers back to unreached; no other word of
    // the slot was written
    const int nr = n_reached;
    for (int i = tid; i < nr; i += step) {
      const int v = __ldcg(reached + i);
      const unsigned long long w = __ldcg(cur + v);
      dist_row[v] = dist_of(w);
      time_row[v] = time_of(w);
      __stcg(cur + v, kUnreached);
      __stcg(nxt + v, kUnreached);
    }
    if (tid == 0) {
      if (src_ok) {
        const unsigned long long w = __ldcg(cur + src);
        dist_row[src] = dist_of(w);
        time_row[src] = time_of(w);
        __stcg(cur + src, kUnreached);
        __stcg(nxt + src, kUnreached);
      }
      atomicMax(info, iters);
      if (!quiet) atomicAdd(info + 1, 1);
      if (!src_ok) atomicAdd(info + 2, 1);
    }
    __syncthreads();  // the slot is unreached and n_reached read: next row
  }
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

// relax_cluster's launch configuration: S clusters of C blocks of
// `threads`, each block's slice of L = ceil(N/C) nodes and the flags in
// its dynamic shared memory. Returns cudaErrorInvalidValue for a plan the
// kernel does not take (a thread owns at most 64 nodes).
static cudaError_t cluster_config(int S, int N, int C, int threads,
                                  cudaStream_t stream, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr, int* L) {
  if (S < 1 || N < 1 || C < 1 || C > kMaxCluster || threads < 32 ||
      threads > kRelaxMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  *L = (N + C - 1) / C;
  const long long smem = 16ll * *L + kClusterFlagBytes;
  if (smem > kMaxSmem || (*L + threads - 1) / threads > 64 ||
      static_cast<long long>(S) * C > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      relax_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(S * C));
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of relax_cluster's plan (C blocks of `threads`, the
// shared bytes of N nodes) the card can hold at once, in *clusters; 0
// means the launch could never run. Returns a CUDA error.
extern "C" int relax_cluster_occupancy(int N, int C, int threads,
                                       int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int L;
  cudaError_t err = cluster_config(1, N, C, threads, nullptr, &cfg, &attr, &L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, relax_cluster_kernel,
                                             &cfg);
}

// The whole relaxation on `stream`: a cluster of C blocks of `threads` per
// source row, every sweep up to `max_iters`; writes the (S, N) dist and
// time planes and info = [iters, rows that did not converge, sources
// outside 0..N-1] (three zeroed int32). Returns a CUDA error.
extern "C" int relax_cluster(const void* src_nodes, int S,
                             const void* csr_off, const void* csr_end,
                             const void* csr_len, const void* csr_secs, int N,
                             int C, float bound, int max_iters, int threads,
                             void* dist, void* time, void* info,
                             void* stream) {
  if (max_iters < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int L;
  cudaError_t err = cluster_config(S, N, C, threads,
                                   static_cast<cudaStream_t>(stream), &cfg,
                                   &attr, &L);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(
      &cfg, relax_cluster_kernel, static_cast<const int32_t*>(src_nodes),
      static_cast<const int32_t*>(csr_off),
      static_cast<const int32_t*>(csr_end),
      static_cast<const float*>(csr_len), static_cast<const float*>(csr_secs),
      N, L, bound, max_iters, static_cast<float*>(dist),
      static_cast<float*>(time), static_cast<int32_t*>(info));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The whole relaxation on `stream`: `blocks` blocks of `threads` (1 <=
// blocks <= S) striding over the S source rows, every sweep up to
// `max_iters`, each block's rows in its slot of `words` (2*blocks*N words,
// every one unreached, and left so) and `lists` (3*blocks*N int32); writes
// the (S, N) dist and time planes and info = [iters, rows that did not
// converge, sources outside 0..N-1] (three zeroed int32). Returns a CUDA
// error.
extern "C" int relax_global(const void* src_nodes, int S, const void* csr_off,
                            const void* csr_end, const void* csr_len,
                            const void* csr_secs, int N, float bound,
                            int max_iters, int blocks, int threads,
                            void* words, void* lists, void* dist, void* time,
                            void* info, void* stream) {
  if (S < 1 || N < 1 || max_iters < 0 || blocks < 1 || blocks > S ||
      threads < 32 || threads > kRelaxMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  relax_global_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_nodes), S,
      static_cast<const int32_t*>(csr_off),
      static_cast<const int32_t*>(csr_end),
      static_cast<const float*>(csr_len), static_cast<const float*>(csr_secs),
      N, bound, max_iters, static_cast<unsigned long long*>(words),
      static_cast<int32_t*>(lists), static_cast<float*>(dist),
      static_cast<float*>(time), static_cast<int32_t*>(info));
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
