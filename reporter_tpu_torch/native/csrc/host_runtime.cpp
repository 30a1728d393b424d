// Native host runtime for reporter_tpu: spatial candidate lookup and
// bounded-Dijkstra route-distance matrices.
//
// This is the framework's replacement for the native layer the reference
// gets from Valhalla (reference: SURVEY.md §2.3 — tile reading, candidate
// search and route distances all live in external C++ behind the `valhalla`
// python module). Here the same responsibilities sit behind a flat C ABI
// consumed via ctypes (no pybind11 in the image), emitting the fixed-width
// tensors the JAX matcher wants.
//
// Graph model: directed edges between projected-meter node coordinates,
// straight-segment geometry (matching reporter_tpu.graph.network). All
// arrays are borrowed from numpy; the handle owns only its derived
// structures (CSR, grid, caches).
//
// reporter_tpu_torch's copy of reporter_tpu/native/src/host_runtime.cpp
// (ABI 14, plus one entry point: ABI 15). It reads no environment
// variable; the original's three reads are gone, and everything else is
// the original's code:
//   - prep threads: `default_prep_threads` (original :116-127) takes
//     hardware_concurrency() whenever a caller passes n_threads <= 0;
//   - route-pair memo capacity (original :445-452): the original's
//     default, 1 << 18 pairs, which `rt_route_memo_set_capacity` (the
//     one addition) sets per handle, as the original's environment
//     setting does per process;
//   - prep timings (original :1231-1234, :1502-1509): the stderr line is
//     dropped; `out_phase_ns` still exports the phase split.
// Comments that named those settings are reworded to match.

#include <algorithm>
#include <array>
#include <atomic>
#include <cfenv>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

#ifdef __F16C__
#include <immintrin.h>
#endif

namespace {

constexpr float kUnreachable = 1.0e9f;
constexpr int32_t kPadEdge = -1;
constexpr float kPadDist = 1.0e9f;

// Persistent worker pool, one per Graph handle. rt_prepare_batch used to
// spawn-and-join fresh std::threads every call; at service chunk sizes
// that is two thread births per worker per chunk (candidate sweep +
// trace phase) of pure overhead. Pool threads park on a condvar between
// calls. run() is serialised (run_mu): concurrent rt_prepare_batch
// callers on one handle queue up rather than corrupt the epoch state.
class WorkerPool {
 public:
  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Run fn on `extra` pool threads plus the calling thread; fn must be an
  // atomic-cursor loop (every participant pulls items until exhausted),
  // so output never depends on which thread ran what. Blocks until all
  // participants return.
  void run(int extra, const std::function<void()>& fn) {
    std::lock_guard<std::mutex> outer(run_mu_);
    if (extra <= 0) {
      fn();
      return;
    }
    {
      std::unique_lock<std::mutex> lk(mu_);
      while (static_cast<int>(threads_.size()) < extra)
        threads_.emplace_back([this] { worker_main(); });
      job_ = &fn;
      wanted_ = extra;
      claimed_ = 0;
      pending_ = extra;
      ++epoch_;
    }
    cv_work_.notify_all();
    fn();  // the caller is a participant too
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void worker_main() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_work_.wait(lk, [&] { return stop_ || epoch_ != seen; });
      if (stop_) return;
      seen = epoch_;
      if (claimed_ >= wanted_) continue;  // over quota for this epoch
      ++claimed_;
      const std::function<void()>* fn = job_;
      lk.unlock();
      (*fn)();
      lk.lock();
      if (--pending_ == 0) cv_done_.notify_all();
    }
  }

  std::mutex run_mu_;  // serialises whole run() calls
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::vector<std::thread> threads_;
  const std::function<void()>* job_ = nullptr;
  uint64_t epoch_ = 0;
  int wanted_ = 0, claimed_ = 0, pending_ = 0;
  bool stop_ = false;
};

// Worker count when the caller passes n_threads<=0 (the ctypes binding
// passes its own resolved count).
int default_prep_threads() {
  const unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 1;
}

// ---- route-pair memo ----------------------------------------------------
// The (edge_from, edge_to) node-route kernel — distance and travel time
// from edge_from's end node to edge_to's start node along the
// shortest-DISTANCE path — is bound-independent once found: a bounded
// Dijkstra settles exact shortest distances for every node it returns
// (relaxation never inserts past the bound), so a finite cached value is
// reusable at ANY query bound, and an unreachable verdict is reusable at
// any bound its search already covered. Offsets, turn penalties and the
// time-admissibility check are reapplied per query — mirroring the
// Python RouteCache pair level (graph/route.py), whose key deliberately
// carries no dt. Consecutive trace steps and co-located traces repeat
// the same candidate-edge pairs constantly; a memo hit skips the stripe
// lock and the whole Dijkstra-map probe.
struct PairVal {
  float d;      // node distance m; >= kUnreachable means "not reachable"
  float t;      // node travel seconds (valid when d finite)
  float bound;  // search bound the verdict is proven to (unreachable case)
};

// In-call memo, one per worker thread per native call: keyed by the
// FROM edge, holding that edge's known (to-edge -> kernel) pairs as two
// small parallel vectors. A route block row shares one ea across all K
// targets, so the row does ONE hash probe and then K linear scans of a
// vector that is 1-2 cache lines hot — measured faster than a flat
// pair-keyed table, whose per-(i,j) probes each took a cold cache miss
// on a table that grows with the whole chunk's pair set.
struct EaMemo {
  std::vector<int32_t> ebs;
  std::vector<PairVal> vals;

  int find(int32_t eb) const {
    const size_t n = ebs.size();
    for (size_t i = 0; i < n; ++i)
      if (ebs[i] == eb) return static_cast<int>(i);
    return -1;
  }

  void push(int32_t eb, const PairVal& v) {
    ebs.push_back(eb);
    vals.push_back(v);
  }
};

struct PairLocal {
  // node-based map: EaMemo references stay valid across other inserts
  std::unordered_map<int32_t, EaMemo> by_ea;
  int64_t n_pairs = 0;

  EaMemo& row(int32_t ea) { return by_ea[ea]; }

  void clear() {
    by_ea.clear();
    n_pairs = 0;
  }
};

// Bounded cross-call route-pair memo, lock-striped by the FROM edge —
// the C++ analog of the Python pair cache (a fixed 1 << 18 entries
// across all stripes). Pairs are stored as per-ea
// rows of (eb, kernel) parallel vectors: a route block row shares one
// ea across its K targets, so route_step batches the whole row's
// lookups (and later its inserts) under ONE stripe lock and scans a
// vector that is a cache line or two hot. Recency is clock/second-
// chance per row (a `hot` flag set on lookup, no per-get list splicing
// — the splice writes were measured as cross-thread cache-line
// ping-pong costing more than the memo saved); eviction drops whole
// cold rows. Hit/miss/eviction counters feed rt_route_memo_stats.
class PairMemo {
 public:
  static constexpr int kStripes = 64;

  // same row representation (and linear scan) as the in-call EaMemo,
  // plus the clock bit
  struct Row : EaMemo {
    bool hot = false;
  };

  struct Stripe {
    std::mutex mu;
    std::unordered_map<int32_t, Row> rows;
    std::vector<int32_t> ring;  // clock ring of row keys
    size_t hand = 0;
    int64_t pairs = 0, hits = 0, misses = 0, evictions = 0;
  };

  explicit PairMemo(int64_t capacity) {
    cap_per_stripe_ = per_stripe(capacity);
  }

  bool enabled() const { return cap_per_stripe_.load() > 0; }

  int64_t capacity() const { return cap_per_stripe_.load() * kStripes; }

  // A new bound (0 disables the memo); every stripe is evicted down to
  // its share of it at once.
  void set_capacity(int64_t capacity) {
    cap_per_stripe_ = per_stripe(capacity);
    for (auto& s : stripes_) {
      std::lock_guard<std::mutex> lk(s.mu);
      evict_locked(s);
    }
  }

  Stripe& stripe(int32_t ea) {
    return stripes_[static_cast<uint32_t>(ea) % kStripes];
  }

  // Insert/update `n` kernels of one ea row; caller holds stripe.mu.
  void put_row_locked(Stripe& s, int32_t ea, size_t n, const int32_t* ebs,
                      const PairVal* vals) {
    auto it = s.rows.find(ea);
    if (it == s.rows.end()) {
      it = s.rows.emplace(ea, Row{}).first;
      s.ring.push_back(ea);
    }
    Row& r = it->second;
    for (size_t i = 0; i < n; ++i) {
      const int pos = r.find(ebs[i]);
      if (pos >= 0) {
        r.vals[pos] = vals[i];  // deepened verdict replaces the stale one
      } else {
        r.ebs.push_back(ebs[i]);
        r.vals.push_back(vals[i]);
        ++s.pairs;
      }
    }
    r.hot = true;
    evict_locked(s);
  }

  // Clock eviction: sweep the ring, demoting hot rows, dropping cold
  // ones, until the stripe fits its share of the bound; caller holds
  // stripe.mu.
  void evict_locked(Stripe& s) {
    const int64_t cap = cap_per_stripe_.load();
    while (s.pairs > cap && !s.ring.empty()) {
      if (s.hand >= s.ring.size()) s.hand = 0;
      const int32_t key = s.ring[s.hand];
      auto vit = s.rows.find(key);
      if (vit == s.rows.end()) {  // stale ring slot
        s.ring[s.hand] = s.ring.back();
        s.ring.pop_back();
        continue;
      }
      if (vit->second.hot) {
        vit->second.hot = false;
        ++s.hand;
        continue;
      }
      s.pairs -= static_cast<int64_t>(vit->second.ebs.size());
      s.evictions += static_cast<int64_t>(vit->second.ebs.size());
      s.rows.erase(vit);
      s.ring[s.hand] = s.ring.back();
      s.ring.pop_back();
    }
  }

  void clear() {
    for (auto& s : stripes_) {
      std::lock_guard<std::mutex> lk(s.mu);
      s.rows.clear();
      s.ring.clear();
      s.hand = 0;
      s.pairs = 0;
    }
  }

  // Dump up to `cap` resident (edge_from, edge_to) pairs, stripe
  // order; returns the count written. The clock eviction keeps the
  // memo's residents biased hot, so a post-replay dump IS the city's
  // top route pairs — the per-city profile artifact the serving tier
  // pre-warms a freshly loaded city from (datastore/profile.py).
  int64_t export_pairs(int64_t cap, int32_t* ea_out, int32_t* eb_out) {
    int64_t n = 0;
    for (auto& s : stripes_) {
      std::lock_guard<std::mutex> lk(s.mu);
      for (auto& kv : s.rows) {
        for (size_t i = 0; i < kv.second.ebs.size(); ++i) {
          if (n >= cap) return n;
          ea_out[n] = kv.first;
          eb_out[n] = kv.second.ebs[i];
          ++n;
        }
      }
    }
    return n;
  }

  // out[4] = {hits, misses, size, evictions}
  void stats(int64_t out[4]) {
    out[0] = out[1] = out[2] = out[3] = 0;
    for (auto& s : stripes_) {
      std::lock_guard<std::mutex> lk(s.mu);
      out[0] += s.hits;
      out[1] += s.misses;
      out[2] += s.pairs;
      out[3] += s.evictions;
    }
  }

 private:
  static int64_t per_stripe(int64_t capacity) {
    return capacity > 0 ? (capacity + kStripes - 1) / kStripes : 0;
  }

  std::array<Stripe, kStripes> stripes_;
  std::atomic<int64_t> cap_per_stripe_{0};
};

// per-worker route scratch: the local pair memo plus per-row work lists
// (reused so no per-row allocation). rt_prepare_batch keeps one of
// these per worker SLOT on the graph handle, persistent across calls —
// the pipeline preps in 128-trace chunks, and rebuilding a ~30k-pair
// local memo (plus its allocations and the re-consults of the shared
// store) four times per 512 traces measured as the whole memo win given
// back. The slot's memo is cleared when it outgrows the configured
// bound, or every call when the shared memo is disabled (capacity 0).
struct RouteScratch {
  PairLocal local;
  std::vector<int32_t> miss;      // js awaiting the shared memo / search
  std::vector<int32_t> hit_js;    // shared-memo hits, emitted post-lock
  std::vector<PairVal> hit_vals;
  std::vector<int32_t> put_ebs;   // freshly computed kernels to publish
  std::vector<PairVal> put_vals;
};

struct Graph {
  int64_t n_nodes = 0;
  int64_t n_edges = 0;
  std::vector<double> node_x, node_y;
  std::vector<int32_t> edge_start, edge_end;
  std::vector<float> edge_len;
  std::vector<float> edge_speed;       // kph; for route travel time
  std::vector<float> head_x, head_y;   // unit heading per edge; turn costs
  // SoA segment geometry for the candidate projection hot loop: one
  // contiguous stream per operand instead of two node-table indirections
  // per endpoint per edge per probe point. e_len2 keeps the DIVIDE
  // (f = dot / len2) — a precomputed reciprocal would drift a ulp from
  // the numpy path (graph/spatial.py) and flip distance ties.
  std::vector<double> e_ax, e_ay, e_dx, e_dy, e_len2;

  // CSR out-adjacency
  std::vector<int64_t> csr_off;
  std::vector<int32_t> csr_edge;

  // uniform spatial grid over projected meters
  double cell = 250.0;
  std::unordered_map<int64_t, std::vector<int32_t>> cells;

  // travel seconds along edge e for `meters` of it
  float edge_secs(int32_t e, float meters) const {
    const float v = std::max(edge_speed[e], 1.0f) * (1.0f / 3.6f);  // m/s
    return meters / v;
  }

  // per-source-node bounded dijkstra cache: node -> (bound, dists).
  // Lock-STRIPED: ctypes releases the GIL, so many Python threads
  // prepare traces through one handle concurrently; a whole-cache mutex
  // would serialise them (it did, round 1). A search from src touches
  // only src's entry, so striping by src keeps contention to threads
  // racing on the same source node — where waiting is the right call
  // anyway (the winner's cache entry saves the loser the search).
  static constexpr int kStripes = 64;
  // per-target (network distance m, travel time s) along the
  // shortest-DISTANCE path — time rides along for the
  // max_route_time_factor admissibility bound, it does not drive the
  // search (matching Meili: the matcher routes by distance, then bounds
  // the route's travel time against the probes' elapsed time)
  struct DistTime {
    float d, t;
  };
  // open-addressing node->DistTime map (linear probing, pow2 capacity,
  // key -1 = empty; node ids are >= 0). The K*K admissibility lookups per
  // step — millions per batch — were bound on std::unordered_map's
  // bucket-chain finds; a flat probe sequence is one cache line most of
  // the time.
  struct FlatMap {
    std::vector<int32_t> keys;
    std::vector<DistTime> vals;
    size_t mask = 0, count = 0;

    explicit FlatMap(size_t cap_pow2 = 16) { init(cap_pow2); }

    void init(size_t cap_pow2) {
      keys.assign(cap_pow2, -1);
      vals.resize(cap_pow2);
      mask = cap_pow2 - 1;
      count = 0;
    }

    static size_t slot_hash(int32_t k) {
      return static_cast<size_t>(static_cast<uint32_t>(k) * 2654435761u);
    }

    const DistTime* find(int32_t k) const {
      size_t i = slot_hash(k) & mask;
      for (;;) {
        if (keys[i] == k) return &vals[i];
        if (keys[i] == -1) return nullptr;
        i = (i + 1) & mask;
      }
    }

    DistTime& slot_for(int32_t k) {
      size_t i = slot_hash(k) & mask;
      while (keys[i] != -1 && keys[i] != k) i = (i + 1) & mask;
      if (keys[i] == -1) {
        keys[i] = k;
        ++count;
      }
      return vals[i];
    }

    DistTime& insert(int32_t k) {
      if ((count + 1) * 10 >= (mask + 1) * 7) {  // load factor 0.7
        FlatMap bigger((mask + 1) * 2);
        for (size_t i = 0; i <= mask; ++i)
          if (keys[i] != -1) bigger.slot_for(keys[i]) = vals[i];
        *this = std::move(bigger);
      }
      return slot_for(k);
    }
  };
  struct CacheStripe {
    std::unordered_map<int32_t, std::pair<float, FlatMap>> map;
    std::mutex mu;
  };
  std::array<CacheStripe, kStripes> route_stripes;

  CacheStripe& stripe_for(int32_t src) {
    return route_stripes[static_cast<uint32_t>(src) % kStripes];
  }

  // cross-call (edge_from, edge_to) route-pair memo + the persistent
  // prep worker pool (both per handle; see the class docs above)
  PairMemo pair_memo{static_cast<int64_t>(1) << 18};  // ~260k pairs
  WorkerPool pool;

  // rt_prepare_batch state, serialised by prep_mu (the matcher preps
  // from one thread; concurrent direct callers queue): per-worker-slot
  // route scratches (see RouteScratch) and the whole-batch candidate
  // staging buffers, both reused across calls so a 128-trace pipeline
  // chunk doesn't pay fresh multi-MB allocations per call.
  std::mutex prep_mu;
  std::vector<std::unique_ptr<RouteScratch>> prep_slots;
  std::vector<double> sc_px, sc_py;
  std::vector<int32_t> sc_edge;
  std::vector<float> sc_dist, sc_off;

  static int64_t cell_key(int64_t i, int64_t j) {
    // shift on the unsigned representation: << on negative values is UB
    return static_cast<int64_t>((static_cast<uint64_t>(i) << 32) ^
                                (static_cast<uint64_t>(j) & 0xffffffffULL));
  }

  void build(double cell_m) {
    cell = cell_m;
    // unit headings (straight-segment geometry) + SoA projection columns
    head_x.resize(n_edges);
    head_y.resize(n_edges);
    e_ax.resize(n_edges);
    e_ay.resize(n_edges);
    e_dx.resize(n_edges);
    e_dy.resize(n_edges);
    e_len2.resize(n_edges);
    for (int64_t e = 0; e < n_edges; ++e) {
      const double dx = node_x[edge_end[e]] - node_x[edge_start[e]];
      const double dy = node_y[edge_end[e]] - node_y[edge_start[e]];
      const double n = std::max(std::hypot(dx, dy), 1e-9);
      head_x[e] = static_cast<float>(dx / n);
      head_y[e] = static_cast<float>(dy / n);
      e_ax[e] = node_x[edge_start[e]];
      e_ay[e] = node_y[edge_start[e]];
      e_dx[e] = dx;
      e_dy[e] = dy;
      e_len2[e] = std::max(dx * dx + dy * dy, 1e-9);
    }
    // CSR
    csr_off.assign(n_nodes + 1, 0);
    for (int64_t e = 0; e < n_edges; ++e) csr_off[edge_start[e] + 1]++;
    for (int64_t v = 0; v < n_nodes; ++v) csr_off[v + 1] += csr_off[v];
    csr_edge.assign(n_edges, 0);
    std::vector<int64_t> fill(csr_off.begin(), csr_off.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e)
      csr_edge[fill[edge_start[e]]++] = static_cast<int32_t>(e);
    // grid: every cell an edge's bbox touches
    for (int64_t e = 0; e < n_edges; ++e) {
      double ax = node_x[edge_start[e]], ay = node_y[edge_start[e]];
      double bx = node_x[edge_end[e]], by = node_y[edge_end[e]];
      int64_t i0 = static_cast<int64_t>(std::floor(std::min(ax, bx) / cell));
      int64_t i1 = static_cast<int64_t>(std::floor(std::max(ax, bx) / cell));
      int64_t j0 = static_cast<int64_t>(std::floor(std::min(ay, by) / cell));
      int64_t j1 = static_cast<int64_t>(std::floor(std::max(ay, by) / cell));
      for (int64_t i = i0; i <= i1; ++i)
        for (int64_t j = j0; j <= j1; ++j)
          cells[cell_key(i, j)].push_back(static_cast<int32_t>(e));
    }
  }

  // bounded single-source dijkstra over nodes; reuses/extends cache
  // entries. Caller must hold stripe_for(src).mu for the whole call AND
  // for as long as it reads the returned map (an extension to a larger
  // bound move-assigns the mapped value, invalidating concurrent reads).
  // ``covered`` (optional) reports the bound the returned map actually
  // covers — a cached entry may have been searched at a larger bound
  // than requested, which makes its absence-verdicts proven further out
  // (the pair memo records that so future queries reuse them).
  const FlatMap& dists_from(int32_t src, float bound,
                            float* covered = nullptr) {
    auto& route_cache = stripe_for(src).map;
    auto it = route_cache.find(src);
    if (it != route_cache.end() && it->second.first >= bound) {
      if (covered) *covered = it->second.first;
      return it->second.second;
    }
    if (covered) *covered = bound;
    // pre-size from the entry being extended (if any): a bound extension
    // revisits at least as many nodes as the cached search found
    size_t cap = 16;
    if (it != route_cache.end())
      while (cap * 7 <= it->second.second.count * 10) cap *= 2;
    FlatMap dist(cap);
    using QE = std::pair<float, int32_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
    dist.insert(src) = {0.0f, 0.0f};
    heap.push({0.0f, src});
    while (!heap.empty()) {
      auto [d, u] = heap.top();
      heap.pop();
      const DistTime* du = dist.find(u);
      if (du != nullptr && d > du->d) continue;
      if (d > bound) break;
      const float tu = du != nullptr ? du->t : 0.0f;
      for (int64_t k = csr_off[u]; k < csr_off[u + 1]; ++k) {
        int32_t e = csr_edge[k];
        int32_t v = edge_end[e];
        float nd = d + edge_len[e];
        if (nd > bound) continue;
        const DistTime* dv = dist.find(v);
        if (dv == nullptr || nd < dv->d) {
          dist.insert(v) = {nd, tu + edge_secs(e, edge_len[e])};
          heap.push({nd, v});
        }
      }
    }
    auto& slot = route_cache[src];
    slot.first = bound;
    slot.second = std::move(dist);
    return route_cache[src].second;
  }
};

// ---- shared per-point / per-step helpers --------------------------------
// The single-call APIs (rt_candidates, rt_route_matrices) and the batched
// rt_prepare_batch funnel through these so semantics cannot drift.

struct Cand {
  double d;  // double so tie-ordering matches the numpy float64 sort
  int32_t e;
  float off, qx, qy;
};

// per-thread scratch for candidate search (seen is n_edges bytes; reused
// across points so the clear is O(|touched|), not O(E)). The deduped
// neighborhood is cached until the centre cell (or reach) changes AND
// gathered into compact SoA columns, so the per-point distance loop runs
// contiguous and branch-light (auto-vectorisable) instead of chasing
// per-edge indices through the graph tables. Points arrive sorted into
// grid-cell order (candidates_batch below), so the neighborhood rebuild
// amortises over every point of a cell, not just consecutive ones.
struct CandScratch {
  std::vector<Cand> cands;
  std::vector<char> seen;
  std::vector<int32_t> nbr_edges;  // deduped; doubles as the seen-clear list
  // gathered neighborhood columns (one entry per nbr edge)
  std::vector<double> nbr_ax, nbr_ay, nbr_dx, nbr_dy, nbr_len2;
  std::vector<float> nbr_len;
  std::vector<double> sc_f, sc_d2;  // per-point projection scratch
  int64_t nbr_ci = INT64_MIN, nbr_cj = INT64_MIN, nbr_reach = -1;
  explicit CandScratch(int64_t n_edges) : seen(n_edges, 0) {}
};

// K nearest edges within radius of projected point (x, y); writes one
// (K,) row of each output, padded with kPadEdge / kPadDist / 0.
void candidates_for_point(const Graph* g, double x, double y, int32_t k,
                          double radius, CandScratch& s, int32_t* out_edge,
                          float* out_dist, float* out_off, float* out_px,
                          float* out_py) {
  const double cell = g->cell;
  const int64_t reach = static_cast<int64_t>(std::ceil(radius / cell));
  s.cands.clear();
  const int64_t ci = static_cast<int64_t>(std::floor(x / cell));
  const int64_t cj = static_cast<int64_t>(std::floor(y / cell));
  if (ci != s.nbr_ci || cj != s.nbr_cj || reach != s.nbr_reach) {
    // rebuild the deduped neighborhood edge list for this centre cell
    s.nbr_ci = ci;
    s.nbr_cj = cj;
    s.nbr_reach = reach;
    for (int32_t e : s.nbr_edges) s.seen[e] = 0;
    s.nbr_edges.clear();
    for (int64_t i = ci - reach; i <= ci + reach; ++i) {
      for (int64_t j = cj - reach; j <= cj + reach; ++j) {
        auto it = g->cells.find(Graph::cell_key(i, j));
        if (it == g->cells.end()) continue;
        for (int32_t e : it->second) {
          if (s.seen[e]) continue;
          s.seen[e] = 1;
          s.nbr_edges.push_back(e);
        }
      }
    }
    // gather the neighborhood's SoA columns once; every point in this
    // cell then runs a contiguous distance loop over them
    const size_t m = s.nbr_edges.size();
    s.nbr_ax.resize(m);
    s.nbr_ay.resize(m);
    s.nbr_dx.resize(m);
    s.nbr_dy.resize(m);
    s.nbr_len2.resize(m);
    s.nbr_len.resize(m);
    for (size_t i = 0; i < m; ++i) {
      const int32_t e = s.nbr_edges[i];
      s.nbr_ax[i] = g->e_ax[e];
      s.nbr_ay[i] = g->e_ay[e];
      s.nbr_dx[i] = g->e_dx[e];
      s.nbr_dy[i] = g->e_dy[e];
      s.nbr_len2[i] = g->e_len2[e];
      s.nbr_len[i] = g->edge_len[e];
    }
  }
  const size_t m = s.nbr_edges.size();
  s.sc_f.resize(m);
  s.sc_d2.resize(m);
  // pass 1: branch-free projection + squared distance over contiguous
  // columns (the compiler vectorises this; same double math as the
  // numpy path, so tie-order parity holds)
  for (size_t i = 0; i < m; ++i) {
    double f = ((x - s.nbr_ax[i]) * s.nbr_dx[i] +
                (y - s.nbr_ay[i]) * s.nbr_dy[i]) / s.nbr_len2[i];
    f = std::min(1.0, std::max(0.0, f));
    const double ex = x - (s.nbr_ax[i] + f * s.nbr_dx[i]);
    const double ey = y - (s.nbr_ay[i] + f * s.nbr_dy[i]);
    s.sc_f[i] = f;
    s.sc_d2[i] = ex * ex + ey * ey;
  }
  // pass 2: the exact but slow hypot — which must match numpy's np.hypot
  // for tie-order parity (graph/spatial.py:125) — only for edges the
  // squared-distance prefilter (with ulp slack) kept
  const double lim = radius * radius * 1.0000001;
  for (size_t i = 0; i < m; ++i) {
    if (s.sc_d2[i] > lim) continue;
    const double f = s.sc_f[i];
    const double qx = s.nbr_ax[i] + f * s.nbr_dx[i];
    const double qy = s.nbr_ay[i] + f * s.nbr_dy[i];
    const double d = std::hypot(x - qx, y - qy);
    if (d <= radius) {
      s.cands.push_back({d, s.nbr_edges[i],
                         static_cast<float>(f * s.nbr_len[i]),
                         static_cast<float>(qx), static_cast<float>(qy)});
    }
  }
  const int32_t n = static_cast<int32_t>(
      std::min<size_t>(s.cands.size(), static_cast<size_t>(k)));
  // top-K by distance, ties by edge id (matches numpy stable sort over
  // edge-id-ordered input; plain sort is safe — (d, e) pairs are unique
  // since each edge appears once — and does not allocate)
  std::sort(s.cands.begin(), s.cands.end(),
            [](const Cand& a, const Cand& b) {
              return a.d < b.d || (a.d == b.d && a.e < b.e);
            });
  for (int32_t q = 0; q < k; ++q) {
    if (q < n) {
      out_edge[q] = s.cands[q].e;
      out_dist[q] = static_cast<float>(s.cands[q].d);
      out_off[q] = s.cands[q].off;
      if (out_px) out_px[q] = s.cands[q].qx;
      if (out_py) out_py[q] = s.cands[q].qy;
    } else {
      out_edge[q] = kPadEdge;
      out_dist[q] = kPadDist;
      out_off[q] = 0.0f;
      if (out_px) out_px[q] = 0.0f;
      if (out_py) out_py[q] = 0.0f;
    }
  }
}

// Batch-sorted candidate sweep over points [lo, hi): sort the span into
// grid-cell order, sweep it (a cell's neighborhood is built +
// SoA-gathered once per run of points that landed in it — CandScratch's
// cache), and scatter each point's (K,) result rows back by original
// index — output is identical to a per-point scan, position for
// position, regardless of how callers span the points. ``order`` is
// caller scratch, reused across spans. This is THE candidate kernel:
// rt_candidates chunks flat queries through it, and rt_prepare_batch's
// span workers run it per trace span before routing those traces.
// Spans stay cache-sized and small: a serial whole-batch sort measured
// as long as the sweep it was meant to help, and under the device lanes
// a coarse span turns into a straggler tail on a descheduled worker.
constexpr int64_t kCandChunk = 1024;

void sweep_span(const Graph* g, int64_t lo, int64_t hi, const double* px,
                const double* py, int32_t k, double radius,
                CandScratch& scratch,
                std::vector<std::pair<int64_t, int64_t>>& order,
                int32_t* out_edge, float* out_dist, float* out_off,
                float* out_px, float* out_py) {
  const double cell = g->cell;
  order.clear();
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t ci = static_cast<int64_t>(std::floor(px[p] / cell));
    const int64_t cj = static_cast<int64_t>(std::floor(py[p] / cell));
    order.emplace_back(Graph::cell_key(ci, cj), p);
  }
  std::sort(order.begin(), order.end());
  for (const auto& kp : order) {
    const int64_t idx = kp.second;
    const int64_t o = idx * k;
    candidates_for_point(g, px[idx], py[idx], k, radius, scratch,
                         out_edge + o, out_dist + o, out_off + o,
                         out_px ? out_px + o : nullptr,
                         out_py ? out_py + o : nullptr);
  }
}

void candidates_batch(const Graph* g, int64_t n_pts, const double* px,
                      const double* py, int32_t k, double radius,
                      int32_t* out_edge, float* out_dist, float* out_off,
                      float* out_px, float* out_py) {
  CandScratch scratch(g->n_edges);
  std::vector<std::pair<int64_t, int64_t>> order;
  order.reserve(static_cast<size_t>(std::min(n_pts, kCandChunk)));
  for (int64_t lo = 0; lo < n_pts; lo += kCandChunk)
    sweep_span(g, lo, std::min(lo + kCandChunk, n_pts), px, py, k, radius,
               scratch, order, out_edge, out_dist, out_off, out_px,
               out_py);
}

// One (K, K) route-distance block between consecutive candidate rows.
// Admissibility mirrors Meili's two bounds (reference: Dockerfile:14-17):
// distance — route fits within max(min_bound, factor * gc);
// time     — the route's travel time at edge speeds fits within
//            max(min_time_bound, time_factor * dt) (skipped unless
//            have_dt && time_factor > 0 && dt > 0).
// turn_penalty_factor adds meters for the heading change between the two
// candidate edges: factor * 0.5 * (1 - cos(theta)).
//
// Each general (ea, eb) pair consults the in-call table, then the shared
// cross-call LRU; only rows with memo misses take the stripe lock and
// probe the Dijkstra map. Admissibility is reapplied per query from the
// cached node kernel, so a memo hit is bit-identical to a recompute.
//
// Returns the largest finite distance written (0 when none): the wire-
// dtype decision needs the batch max, and computing it here — while the
// values are in registers — replaces a second cold pass over the 16 MB
// route tensor per chunk.
float route_step(Graph* g, const int32_t* ea_row, const float* oa_row,
                 const int32_t* eb_row, const float* ob_row, int32_t K,
                 float gc_t, double dt_t, bool have_dt, double factor,
                 double min_bound, double backward_tol, double time_factor,
                 double min_time_bound, double turn_penalty_factor,
                 RouteScratch& rs, float* out) {
  const float bound = static_cast<float>(
      std::max(min_bound, factor * static_cast<double>(gc_t)));
  // min_time_bound floors the cap the way min_bound floors the distance
  // bound: at 1 Hz sampling factor*dt is ~2 s, which GPS noise alone
  // overruns — without the floor the time bound prunes honest
  // transitions instead of absurd detours.
  const float time_cap =
      (have_dt && time_factor > 0 && dt_t > 0)
          ? static_cast<float>(std::max(min_time_bound, time_factor * dt_t))
          : -1.0f;  // no bound
  float mx = 0.0f;
  for (int32_t i = 0; i < K; ++i) {
    const int32_t ea = ea_row[i];
    float* row = out + static_cast<int64_t>(i) * K;
    if (ea == kPadEdge) {
      for (int32_t j = 0; j < K; ++j) row[j] = kUnreachable;
      continue;
    }
    const float oa = oa_row[i];
    const float remaining = g->edge_len[ea] - oa;
    const int32_t src = g->edge_end[ea];

    // one admissibility emitter shared by the memo-hit and recompute
    // paths so the two cannot drift: dn/tn are the node kernel
    // (dn >= kUnreachable: not reachable within a bound >= bound - via)
    auto emit = [&](int32_t j, int32_t eb, float ob, float via, float dn,
                    float tn) {
      // reachable only if the whole route fits inside the bound, matching
      // the python fallback's max_dist semantics (graph/route.py)
      if (dn >= kUnreachable || via + dn > bound) {
        row[j] = kUnreachable;
        return;
      }
      if (time_cap >= 0) {
        const float secs = g->edge_secs(ea, remaining) +
                           g->edge_secs(eb, ob) + tn;
        if (secs > time_cap) {
          row[j] = kUnreachable;
          return;
        }
      }
      float d = via + dn;
      if (turn_penalty_factor > 0) {
        const float cos_th =
            g->head_x[ea] * g->head_x[eb] + g->head_y[ea] * g->head_y[eb];
        d += static_cast<float>(turn_penalty_factor) * 0.5f * (1.0f - cos_th);
      }
      row[j] = d;
      if (d > mx) mx = d;
    };

    // ONE in-call memo probe per row: every target j of this row shares
    // ea, so the row's known kernels live in one small hot vector
    EaMemo& em = rs.local.row(ea);
    rs.miss.clear();
    for (int32_t j = 0; j < K; ++j) {
      const int32_t eb = eb_row[j];
      if (eb == kPadEdge) {
        row[j] = kUnreachable;
        continue;
      }
      const float ob = ob_row[j];
      if (eb == ea && ob >= oa) {
        if (time_cap >= 0 && g->edge_secs(ea, ob - oa) > time_cap) {
          row[j] = kUnreachable;
        } else {
          row[j] = ob - oa;
          if (ob - oa > mx) mx = ob - oa;
        }
        continue;
      }
      // forgive small apparent backward movement on the same directed
      // edge (along-track GPS noise) — see graph/route.py route_distance
      if (eb == ea && oa - ob <= backward_tol) {
        row[j] = 0.0f;
        continue;
      }
      const float via = remaining + ob;
      if (via > bound) {
        row[j] = kUnreachable;
        continue;
      }
      // a finite kernel is exact at any bound; an unreachable verdict
      // only proves depths its search covered (bound - via needed here)
      const int pos = em.find(eb);
      if (pos >= 0 && (em.vals[pos].d < kUnreachable ||
                       em.vals[pos].bound >= bound - via)) {
        emit(j, eb, ob, via, em.vals[pos].d, em.vals[pos].t);
        continue;
      }
      rs.miss.push_back(j);
    }
    if (rs.miss.empty()) continue;

    // shared memo consult for the whole row under ONE stripe(ea) lock;
    // hits are copied out and emitted after the lock drops
    if (g->pair_memo.enabled()) {
      rs.hit_js.clear();
      rs.hit_vals.clear();
      size_t w = 0;
      {
        auto& sp = g->pair_memo.stripe(ea);
        std::lock_guard<std::mutex> lk(sp.mu);
        auto it = sp.rows.find(ea);
        PairMemo::Row* rp = it != sp.rows.end() ? &it->second : nullptr;
        if (rp != nullptr) rp->hot = true;
        for (const int32_t j : rs.miss) {
          const int32_t eb = eb_row[j];
          const float via = remaining + ob_row[j];
          const int pos = rp != nullptr ? rp->find(eb) : -1;
          if (pos >= 0 && (rp->vals[pos].d < kUnreachable ||
                           rp->vals[pos].bound >= bound - via)) {
            ++sp.hits;
            rs.hit_js.push_back(j);
            rs.hit_vals.push_back(rp->vals[pos]);
          } else {
            ++sp.misses;
            rs.miss[w++] = j;  // compact: still needs the search
          }
        }
      }
      rs.miss.resize(w);
      for (size_t i = 0; i < rs.hit_js.size(); ++i) {
        const int32_t j = rs.hit_js[i];
        const int32_t eb = eb_row[j];
        const PairVal& pv = rs.hit_vals[i];
        const int lp = em.find(eb);
        if (lp >= 0) {
          em.vals[lp] = pv;
        } else {
          em.push(eb, pv);
          ++rs.local.n_pairs;
        }
        emit(j, eb, ob_row[j], remaining + ob_row[j], pv.d, pv.t);
      }
      if (rs.miss.empty()) continue;
    }

    rs.put_ebs.clear();
    rs.put_vals.clear();
    {
      // one bounded search from ea's end node covers every missed j.
      // The stripe lock is held across compute AND the fills below: a
      // concurrent bound-extension on the same src move-assigns the
      // cached map, so reads must stay inside the critical section.
      std::lock_guard<std::mutex> lock(g->stripe_for(src).mu);
      float covered = bound;
      const auto& dist = g->dists_from(src, bound, &covered);
      for (const int32_t j : rs.miss) {
        const int32_t eb = eb_row[j];
        const float ob = ob_row[j];
        const float via = remaining + ob;
        const Graph::DistTime* it = dist.find(g->edge_start[eb]);
        // every map entry is a settled exact shortest distance (the
        // relaxation never inserts past the search bound), so a find
        // miss proves dist(dst) > covered and a hit is final — both
        // cacheable
        const PairVal pv = it == nullptr
                               ? PairVal{kUnreachable, 0.0f, covered}
                               : PairVal{it->d, it->t, covered};
        const int pos = em.find(eb);
        if (pos >= 0) {
          em.vals[pos] = pv;  // deepen a stale unreachable verdict
        } else {
          em.push(eb, pv);
          ++rs.local.n_pairs;
        }
        rs.put_ebs.push_back(eb);
        rs.put_vals.push_back(pv);
        emit(j, eb, ob, via, pv.d, pv.t);
      }
    }
    // publish the freshly computed kernels in one batched insert
    if (g->pair_memo.enabled() && !rs.put_ebs.empty()) {
      auto& sp = g->pair_memo.stripe(ea);
      std::lock_guard<std::mutex> lk(sp.mu);
      g->pair_memo.put_row_locked(sp, ea, rs.put_ebs.size(),
                                  rs.put_ebs.data(), rs.put_vals.data());
    }
  }
  return mx;
}

// equirectangular distance in meters, matching core/geo.py exactly
// (double math; per-pair midpoint cosine — NOT the projection's fixed
// anchor cosine, so kept-selection parity with the numpy path holds)
constexpr double kMetersPerDeg = 20037581.187 / 180.0;
constexpr double kRadPerDeg = 3.14159265358979323846 / 180.0;

double equirect_m(double lat_a, double lon_a, double lat_b, double lon_b) {
  const double x =
      (lon_a - lon_b) * kMetersPerDeg * std::cos(0.5 * (lat_a + lat_b) *
                                                 kRadPerDeg);
  const double y = (lat_a - lat_b) * kMetersPerDeg;
  // sqrt(x*x + y*y), NOT hypot: geo.py computes np.sqrt(x*x + y*y), and
  // this value feeds strict threshold compares (interpolation_distance,
  // breakage_distance) where a last-ulp divergence flips a decision
  return std::sqrt(x * x + y * y);
}

}  // namespace

extern "C" {

// ABI handshake: the ctypes loader (native/__init__.py) refuses to use a
// library whose version differs from its expectation, raising instead of
// calling through a stale signature. BUMP
// THIS on ANY change to the signatures below, in the same commit as the
// Python-side constant.
int32_t rt_abi_version(void) { return 15; }

void* rt_graph_create(int64_t n_nodes, int64_t n_edges,
                      const double* node_x, const double* node_y,
                      const int32_t* edge_start, const int32_t* edge_end,
                      const float* edge_len, const float* edge_speed_kph,
                      double cell_m) {
  auto* g = new Graph();
  g->n_nodes = n_nodes;
  g->n_edges = n_edges;
  g->node_x.assign(node_x, node_x + n_nodes);
  g->node_y.assign(node_y, node_y + n_nodes);
  g->edge_start.assign(edge_start, edge_start + n_edges);
  g->edge_end.assign(edge_end, edge_end + n_edges);
  g->edge_len.assign(edge_len, edge_len + n_edges);
  g->edge_speed.assign(edge_speed_kph, edge_speed_kph + n_edges);
  g->build(cell_m);
  return g;
}

void rt_graph_destroy(void* handle) { delete static_cast<Graph*>(handle); }

void rt_cache_clear(void* handle) {
  auto* g = static_cast<Graph*>(handle);
  for (auto& s : g->route_stripes) {
    std::lock_guard<std::mutex> lock(s.mu);
    s.map.clear();
  }
  g->pair_memo.clear();
  std::lock_guard<std::mutex> lock(g->prep_mu);
  for (auto& slot : g->prep_slots) slot->local.clear();
}

// {hits, misses, size, evictions} of the cross-call route-pair memo
void rt_route_memo_stats(void* handle, int64_t* out4) {
  static_cast<Graph*>(handle)->pair_memo.stats(out4);
}

// Bound the cross-call route-pair memo to `capacity` pairs (0 disables
// it); residents past the new bound are evicted now.
void rt_route_memo_set_capacity(void* handle, int64_t capacity) {
  static_cast<Graph*>(handle)->pair_memo.set_capacity(capacity);
}

// Dump up to `cap` resident route-memo pairs into ea/eb (profile
// export); returns the count written.
int64_t rt_route_memo_export(void* handle, int64_t cap, int32_t* ea_out,
                             int32_t* eb_out) {
  return static_cast<Graph*>(handle)->pair_memo.export_pairs(cap, ea_out,
                                                             eb_out);
}

// Pre-warm the cross-call route-pair memo from a profile artifact's
// (edge_from, edge_to) pairs: each pair's node kernel is computed
// exactly like route_step's miss path — a bounded Dijkstra from
// edge_from's end node under the same stripe lock — so a warmed entry
// is bit-identical to what the serving path would compute and cache on
// first contact. Consecutive same-ea pairs (the export order) share
// one search and one batched memo insert. Out-of-range edge ids (a
// profile from a different graph build) are skipped, not fatal.
// Returns pairs inserted; 0 when the memo is disabled.
int64_t rt_route_memo_warm(void* handle, int64_t n, const int32_t* ea,
                           const int32_t* eb, double bound_m) {
  auto* g = static_cast<Graph*>(handle);
  if (!g->pair_memo.enabled()) return 0;
  const float bound = static_cast<float>(bound_m);
  int64_t warmed = 0;
  int64_t i = 0;
  std::vector<int32_t> ebs;
  std::vector<PairVal> vals;
  while (i < n) {
    const int32_t a = ea[i];
    if (a < 0 || a >= g->n_edges) {
      ++i;
      continue;
    }
    ebs.clear();
    vals.clear();
    const int32_t src = g->edge_end[a];
    {
      // lock held across compute AND reads of the returned map — same
      // contract as route_step's miss path (a concurrent bound
      // extension move-assigns the cached map)
      std::lock_guard<std::mutex> lock(g->stripe_for(src).mu);
      float covered = bound;
      const auto& dist = g->dists_from(src, bound, &covered);
      for (; i < n && ea[i] == a; ++i) {
        const int32_t b = eb[i];
        if (b < 0 || b >= g->n_edges) continue;
        const Graph::DistTime* it = dist.find(g->edge_start[b]);
        vals.push_back(it == nullptr
                           ? PairVal{kUnreachable, 0.0f, covered}
                           : PairVal{it->d, it->t, covered});
        ebs.push_back(b);
      }
    }
    if (!ebs.empty()) {
      auto& sp = g->pair_memo.stripe(a);
      std::lock_guard<std::mutex> lk(sp.mu);
      g->pair_memo.put_row_locked(sp, a, ebs.size(), ebs.data(),
                                  vals.data());
      warmed += static_cast<int64_t>(ebs.size());
    }
  }
  return warmed;
}

int64_t rt_cache_size(void* handle) {
  auto* g = static_cast<Graph*>(handle);
  int64_t n = 0;
  for (auto& s : g->route_stripes) {
    std::lock_guard<std::mutex> lock(s.mu);
    n += static_cast<int64_t>(s.map.size());
  }
  return n;
}

// K nearest edges within radius for each of T projected points.
// Outputs are (T, K) row-major, padded with kPadEdge / kPadDist / 0.
void rt_candidates(void* handle, int64_t n_points, const double* px,
                   const double* py, int32_t k, double radius,
                   int32_t* out_edge, float* out_dist, float* out_off,
                   float* out_px, float* out_py) {
  auto* g = static_cast<Graph*>(handle);
  candidates_batch(g, n_points, px, py, k, radius, out_edge, out_dist,
                   out_off, out_px, out_py);
}

// (T-1, K, K) route-distance tensor between consecutive candidate sets.
// edge_ids/offsets are (T, K) row-major; gc is (T-1); dt is (T-1) probe
// time deltas in seconds (may be null: no time bound).
//
// Admissibility mirrors Meili's two bounds (reference: Dockerfile:14-17):
// distance — route fits within max(min_bound, factor * gc);
// time     — the route's travel time at edge speeds fits within
//            time_factor * dt (skipped when either is <= 0).
// turn_penalty_factor adds meters for the heading change between the two
// candidate edges: factor * 0.5 * (1 - cos(theta)) — 0 when straight,
// `factor` for a full U-turn — the penalised route distance Meili feeds
// its transition cost.
void rt_route_matrices(void* handle, int64_t T, int32_t K,
                       const int32_t* edge_ids, const float* offsets,
                       const float* gc, const double* dt, double factor,
                       double min_bound, double backward_tol,
                       double time_factor, double min_time_bound,
                       double turn_penalty_factor, float* out) {
  auto* g = static_cast<Graph*>(handle);
  RouteScratch rs;
  for (int64_t t = 0; t + 1 < T; ++t) {
    route_step(g, edge_ids + t * K, offsets + t * K, edge_ids + (t + 1) * K,
               offsets + (t + 1) * K, K, gc[t], dt ? dt[t] : 0.0,
               dt != nullptr, factor, min_bound, backward_tol, time_factor,
               min_time_bound, turn_penalty_factor, rs,
               out + t * static_cast<int64_t>(K) * K);
  }
}

// Whole-batch trace preparation: projection, candidate search, jitter/
// no-candidate point selection, case codes, and route matrices for B
// traces in ONE call, writing rows straight into the caller's padded
// (B, T, ...) batch tensors. This is the framework's answer to the
// reference's one-C++-Match-per-trace architecture
// (reference: py/reporter_service.py:240) — per-trace Python and
// per-trace ctypes round-trips were the measured end-to-end ceiling
// (BENCH_r03: device decode ~4% of the leg).
//
// Inputs: flat per-point lat/lon/times (degrees / epoch secs) with
// pt_off (B+1) trace offsets; (lat0, lon0) is the network projection
// anchor (graph/network.py projection()). Semantics per trace mirror
// matcher/batchpad.py prepare_trace exactly: points with no candidates
// and points within interpolation_distance of the last kept point are
// excluded; kept sequences cap at T (bucket truncation); case codes are
// RESTART at t=0 and after breakage-sized gaps, NORMAL otherwise, SKIP
// in the padding tail (pre-filled by the caller); route matrices and
// time/turn bounds via route_step above. dt derives from times over
// kept points when time_factor > 0.
//
// This call writes EVERY row of its n_traces traces — live prefixes and
// pad sentinels (SKIP case, kPadEdge, kPadDist, kUnreachable, kept=-1)
// — so the caller may hand in uninitialised (np.empty) tensors; only
// filler rows beyond n_traces (mesh/pow2 batch padding) remain the
// caller's to fill. out_dwell gets the trailing jitter dwell
// (batchpad.py:109-123 semantics). n_threads <= 0 falls back to
// hardware_concurrency; work fans out
// over the handle's persistent WorkerPool in two phases — the batch-
// sorted candidate sweep (cell-granular) then the per-trace
// select/route phase (trace-granular) — with deterministic output
// either way (the route cache is lock-striped and the pair memo stores
// exact kernels; ctypes releases the GIL for the whole call).
// ``out_phase_ns`` (nullable, 3 slots) reports the phase split:
// {candidates, select_pack, routes} in nanoseconds, each summed across
// worker threads, so a caller can attribute prep time without a
// profiler.
//
// ABI 14 additions for the device route kernel (graph/route_device.py):
// ``out_dt`` (B, T) doubles gets the kept-point probe time deltas the
// route stage would bound against — dt_b[t] = times[kept[t+1]] -
// times[kept[t]] for t < n-1 when the time bound is armed, -1.0
// everywhere else — always written, so a skip_routes caller can apply
// the identical time cap off-host. ``skip_routes`` != 0 skips ONLY the
// route_step loop (candidates, selection, gc, case codes, dt and the
// tail fill are unchanged; route rows [0, n-1) are then the caller's to
// write — the device kernel fills every one of them). ``prune_margin``
// > 0 arms FLASH-style candidate pruning after selection: each kept
// row's candidates (sorted ascending by projection distance) are cut
// where dist > dist[0] + prune_margin, shrinking K before any route is
// requested; the best candidate always survives.
void rt_prepare_batch(void* handle, int64_t n_traces, const int64_t* pt_off,
                      const double* lat, const double* lon,
                      const double* times, double lat0, double lon0,
                      int32_t T, int32_t K, double search_radius,
                      double interpolation_distance,
                      double breakage_distance, double factor,
                      double min_bound, double backward_tol,
                      double time_factor, double min_time_bound,
                      double turn_penalty_factor, double prune_margin,
                      int32_t skip_routes, int32_t n_threads,
                      int32_t* out_edge, float* out_dist, float* out_off,
                      float* out_route, float* out_gc, int32_t* out_case,
                      int32_t* out_kept, int32_t* out_num_kept,
                      float* out_dwell, uint8_t* out_has_cands,
                      float* out_max_finite, int64_t* out_phase_ns,
                      double* out_dt) {
  auto* g = static_cast<Graph*>(handle);
  // one prepare call at a time per handle: the per-slot scratches and
  // candidate staging buffers below are reused across calls
  std::lock_guard<std::mutex> prep_lock(g->prep_mu);
  const double coslat0 = std::cos(lat0 * kRadPerDeg);
  const int64_t TK = static_cast<int64_t>(T) * K;
  // route/gc rows are T per trace (not T-1): the final row is a dead
  // step the caller pre-fills, so the (B, T, K, K) tensor shards along
  // the seq mesh axis with no host-side pad copy (parallel/sharded.py)
  const int64_t TKK = static_cast<int64_t>(T) * K * K;
  const int64_t n_pts = n_traces > 0 ? pt_off[n_traces] : 0;

  // running max of every finite distance written (candidate dists, gc,
  // reachable route entries) — the wire-dtype decision (f16 iff the max
  // fits) used to re-scan the 10x-larger tensors in numpy
  std::atomic<float> max_finite{0.0f};
  auto bump_max = [&max_finite](float v) {
    float cur = max_finite.load(std::memory_order_relaxed);
    while (v > cur &&
           !max_finite.compare_exchange_weak(cur, v,
                                             std::memory_order_relaxed)) {
    }
  };

  using clk = std::chrono::steady_clock;
  std::atomic<int64_t> ns_cand{0}, ns_select{0}, ns_route{0};

  int workers = n_threads > 0 ? n_threads : default_prep_threads();
  workers = std::max(1, std::min<int>(
                            workers, static_cast<int>(
                                         std::max<int64_t>(n_traces, 1))));

  // Flat (n_pts, K) candidate staging buffers, persistent on the handle
  // — a 128-trace pipeline chunk must not pay multi-MB allocations per
  // call. Every trace reads its rows out of them by point index, so
  // per-trace copies of the raw candidate rows are gone.
  g->sc_px.resize(n_pts);
  g->sc_py.resize(n_pts);
  double* px = g->sc_px.data();
  double* py = g->sc_py.data();
  for (int64_t p = 0; p < n_pts; ++p) {
    px[p] = (lon[p] - lon0) * kMetersPerDeg * coslat0;
    py[p] = (lat[p] - lat0) * kMetersPerDeg;
  }
  g->sc_edge.resize(n_pts * K);
  g->sc_dist.resize(n_pts * K);
  g->sc_off.resize(n_pts * K);
  int32_t* edge_all = g->sc_edge.data();
  float* dist_all = g->sc_dist.data();
  float* off_all = g->sc_off.data();

  // ---- per-trace selection, packing and route matrices -----------------
  auto prepare_one = [&](int64_t b, RouteScratch& rscratch,
                         std::vector<int32_t>& kept) {
    float local_max = 0.0f;
    const int64_t p0 = pt_off[b], p1 = pt_off[b + 1];
    const int64_t n_raw = p1 - p0;
    const int32_t* edge_raw = edge_all + p0 * K;
    const float* dist_raw = dist_all + p0 * K;
    const float* off_raw = off_all + p0 * K;
    int32_t* edge_b = out_edge + b * TK;
    float* dist_b = out_dist + b * TK;
    float* off_b = out_off + b * TK;
    float* route_b = out_route + b * TKK;
    float* gc_b = out_gc + b * T;
    int32_t* case_b = out_case + b * T;
    int32_t* kept_b = out_kept + b * T;
    double* dt_b = out_dt + b * T;
    out_num_kept[b] = 0;
    out_dwell[b] = 0.0f;
    // pad sentinels for rows beyond the live prefix — written HERE (in
    // the worker threads, one pass, only the dead region) instead of a
    // caller-side np.full over the whole 8-16 MB batch that the live
    // rows immediately overwrite
    auto fill_tail = [&](int32_t live_t, int32_t live_route) {
      for (int32_t t = live_t; t < T; ++t) {
        int32_t* er = edge_b + static_cast<int64_t>(t) * K;
        float* dr = dist_b + static_cast<int64_t>(t) * K;
        float* fr = off_b + static_cast<int64_t>(t) * K;
        for (int32_t q = 0; q < K; ++q) {
          er[q] = kPadEdge;
          dr[q] = kPadDist;
          fr[q] = 0.0f;
        }
        case_b[t] = 2;  // SKIP
        kept_b[t] = -1;
      }
      std::fill_n(route_b + static_cast<int64_t>(live_route) * K * K,
                  static_cast<int64_t>(T - live_route) * K * K,
                  kUnreachable);
      std::fill_n(gc_b + live_route, T - live_route, 0.0f);
      std::fill_n(dt_b + live_route, T - live_route, -1.0);
    };
    if (n_raw <= 0) {
      fill_tail(0, 0);
      return;
    }

    clk::time_point tp;
    if (out_phase_ns) tp = clk::now();

    // kept selection: drop candidate-less points and jitter points within
    // interpolation_distance of the last kept point (batchpad._select_kept)
    kept.clear();
    for (int64_t p = 0; p < n_raw; ++p) {
      bool has = false;
      for (int32_t q = 0; q < K; ++q)
        if (edge_raw[p * K + q] != kPadEdge) {
          has = true;
          break;
        }
      out_has_cands[p0 + p] = has ? 1 : 0;
      if (!has) continue;
      if (!kept.empty()) {
        const int64_t lk = kept.back();
        if (equirect_m(lat[p0 + lk], lon[p0 + lk], lat[p0 + p],
                       lon[p0 + p]) < interpolation_distance)
          continue;
      }
      kept.push_back(static_cast<int32_t>(p));
    }
    const bool truncated = kept.size() > static_cast<size_t>(T);
    const int32_t n =
        static_cast<int32_t>(std::min<size_t>(kept.size(), T));
    out_num_kept[b] = n;
    if (n == 0) {
      fill_tail(0, 0);
      return;
    }

    // trailing jitter dwell: every raw point after the last kept one has
    // candidates and sits within interpolation_distance of it — the
    // vehicle verifiably stayed put (batchpad.py:109-123)
    if (!truncated && kept[n - 1] < n_raw - 1) {
      const int64_t lk = kept[n - 1];
      bool all_jitter = true;
      for (int64_t p = lk + 1; p < n_raw && all_jitter; ++p) {
        bool has = false;
        for (int32_t q = 0; q < K; ++q)
          if (edge_raw[p * K + q] != kPadEdge) {
            has = true;
            break;
          }
        if (!has ||
            equirect_m(lat[p0 + lk], lon[p0 + lk], lat[p0 + p],
                       lon[p0 + p]) >= interpolation_distance)
          all_jitter = false;
      }
      if (all_jitter)
        out_dwell[b] =
            static_cast<float>(times[p1 - 1] - times[p0 + lk]);
    }

    // gather kept rows into the padded outputs; gc + case codes
    for (int32_t t = 0; t < n; ++t) {
      const int64_t p = kept[t];
      std::memcpy(edge_b + t * K, edge_raw + p * K, K * sizeof(int32_t));
      std::memcpy(dist_b + t * K, dist_raw + p * K, K * sizeof(float));
      std::memcpy(off_b + t * K, off_raw + p * K, K * sizeof(float));
      for (int32_t q = 0; q < K; ++q) {
        const float d = dist_b[t * K + q];
        if (d < kUnreachable / 2 && d > local_max) local_max = d;
      }
      kept_b[t] = static_cast<int32_t>(p);
      if (t > 0) {
        const int64_t pp = kept[t - 1];
        const double gc = equirect_m(lat[p0 + pp], lon[p0 + pp],
                                     lat[p0 + p], lon[p0 + p]);
        gc_b[t - 1] = static_cast<float>(gc);
        if (gc_b[t - 1] > local_max) local_max = gc_b[t - 1];
        // compare the FLOAT32 gc, as batchpad.prepare_trace does (it
        // casts gc to f32 before the breakage test) — a gap within one
        // f32 ulp of the threshold must split identically on both paths
        case_b[t] = static_cast<double>(gc_b[t - 1]) > breakage_distance
                        ? 1 /*RESTART*/
                        : 0 /*NORMAL*/;
      } else {
        case_b[t] = 1;  // RESTART at the first kept point
      }
    }

    // FLASH-style candidate pruning: each kept row is sorted ascending
    // by projection distance (candidates_for_point), so cutting the
    // suffix past dist[0] + margin keeps the emission-dominant
    // candidates and shrinks K before any route is requested. Row 0's
    // best candidate always survives, so selection is unchanged.
    if (prune_margin > 0) {
      for (int32_t t = 0; t < n; ++t) {
        int32_t* er = edge_b + static_cast<int64_t>(t) * K;
        float* dr = dist_b + static_cast<int64_t>(t) * K;
        float* fr = off_b + static_cast<int64_t>(t) * K;
        if (er[0] == kPadEdge) continue;
        const float cut = dr[0] + static_cast<float>(prune_margin);
        for (int32_t q = 1; q < K; ++q) {
          if (er[q] == kPadEdge) break;
          if (dr[q] > cut) {
            for (int32_t w = q; w < K && er[w] != kPadEdge; ++w) {
              er[w] = kPadEdge;
              dr[w] = kPadDist;
              fr[w] = 0.0f;
            }
            break;
          }
        }
      }
    }

    if (out_phase_ns) {
      const auto t2 = clk::now();
      ns_select += (t2 - tp).count();
      tp = t2;
    }
    // kept-point probe time deltas: always recorded (the device route
    // kernel applies the identical time cap from them); -1 marks steps
    // the time bound must not arm on
    const bool have_dt = time_factor > 0 && n > 1;
    for (int32_t t = 0; t + 1 < n; ++t)
      dt_b[t] = have_dt
                    ? times[p0 + kept[t + 1]] - times[p0 + kept[t]]
                    : -1.0;
    // route matrices between consecutive kept candidate rows; dt feeds
    // the time-admissibility bound. skip_routes leaves rows [0, n-1)
    // for the device kernel (the tail fill below still covers the rest)
    if (!skip_routes) {
      for (int32_t t = 0; t + 1 < n; ++t) {
        const double dt_t = have_dt ? dt_b[t] : 0.0;
        const float step_max = route_step(
            g, edge_b + t * K, off_b + t * K, edge_b + (t + 1) * K,
            off_b + (t + 1) * K, K, gc_b[t], dt_t, have_dt, factor,
            min_bound, backward_tol, time_factor, min_time_bound,
            turn_penalty_factor, rscratch,
            route_b + static_cast<int64_t>(t) * K * K);
        if (step_max > local_max) local_max = step_max;
      }
    }
    fill_tail(n, n - 1);
    bump_max(local_max);
    if (out_phase_ns) ns_route += (clk::now() - tp).count();
  };

  // per-worker-slot route scratches, persistent across calls: the
  // slot's local pair memo survives between pipeline chunks (cleared
  // when it outgrows the shared memo's configured bound, or every call
  // when a capacity of 0 disables cross-call memoisation)
  while (g->prep_slots.size() < static_cast<size_t>(workers))
    g->prep_slots.emplace_back(new RouteScratch());
  // Work unit: a SPAN of consecutive traces. The worker first runs the
  // batch-sorted candidate kernel over the span's points (sort into
  // grid-cell order, sweep with the gathered-SoA loops, scatter by
  // index), then immediately selects/packs/routes those traces — no
  // barrier between the candidate and route phases. The two-phase
  // variant (whole-batch candidate pass, then traces) measured badly
  // under the device lanes: with decode/assemble threads contending for
  // the same cores, every barrier waited out a descheduled straggler.
  constexpr int64_t kSpanTraces = 8;
  const int64_t n_units = (n_traces + kSpanTraces - 1) / kSpanTraces;
  const bool memo_on = g->pair_memo.enabled();
  const int64_t local_cap = g->pair_memo.capacity();
  std::atomic<int> slot{0};
  std::atomic<int64_t> next{0};
  auto span_worker = [&]() {
    RouteScratch& rscratch = *g->prep_slots[slot.fetch_add(1)];
    if (!memo_on || rscratch.local.n_pairs > local_cap)
      rscratch.local.clear();
    CandScratch cscratch(g->n_edges);
    std::vector<std::pair<int64_t, int64_t>> order;
    std::vector<int32_t> kept;
    for (;;) {
      const int64_t u = next.fetch_add(1);
      if (u >= n_units) return;
      const int64_t b0 = u * kSpanTraces;
      const int64_t b1 = std::min(b0 + kSpanTraces, n_traces);
      clk::time_point tp;
      if (out_phase_ns) tp = clk::now();
      sweep_span(g, pt_off[b0], pt_off[b1], px, py, K, search_radius,
                 cscratch, order, edge_all, dist_all, off_all, nullptr,
                 nullptr);
      if (out_phase_ns)
        ns_cand += (clk::now() - tp).count();
      for (int64_t b = b0; b < b1; ++b) prepare_one(b, rscratch, kept);
    }
  };
  g->pool.run(static_cast<int>(std::min<int64_t>(workers - 1,
                                                 n_units - 1)),
              span_worker);
  *out_max_finite = max_finite.load();
  if (out_phase_ns) {
    out_phase_ns[0] = ns_cand.load();
    out_phase_ns[1] = ns_select.load();
    out_phase_ns[2] = ns_route.load();
  }
}

// f32 -> f16 (IEEE half) bulk conversion for the wire tensors
// (matcher/batchpad.py). Round-to-nearest-even with overflow to +/-inf —
// bit-identical to numpy.astype(float16). The numpy cast was the single
// largest host cost after batching (BENCH round-4 profile: ~43% of
// match_many); with F16C this is one instruction per 8 floats.
void rt_f32_to_f16(const float* src, uint16_t* dst, int64_t n) {
  int64_t i = 0;
#ifdef __F16C__
  for (; i + 8 <= n; i += 8) {
    __m256 v = _mm256_loadu_ps(src + i);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT));
  }
#endif
  for (; i < n; ++i) {
    // scalar fallback: round-to-nearest-even via float bit manipulation
    uint32_t x;
    std::memcpy(&x, src + i, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    x &= 0x7fffffffu;
    uint16_t h;
    if (x >= 0x47800000u) {                  // overflow / inf / nan
      h = x > 0x7f800000u ? 0x7e00u : 0x7c00u;
    } else if (x < 0x38800000u) {            // subnormal / zero
      const float f = std::fabs(src[i]) * 0x1.0p+24f;  // scale into int range
      uint32_t m = static_cast<uint32_t>(f);
      const float r = f - static_cast<float>(m);
      m += (r > 0.5f || (r == 0.5f && (m & 1u))) ? 1u : 0u;
      h = static_cast<uint16_t>(m);
    } else {
      const uint32_t mant = x & 0xfffu;
      x += 0xfffu + ((x >> 13) & 1u);        // round to nearest even
      (void)mant;
      h = static_cast<uint16_t>(((x - 0x38000000u) >> 13) & 0x7fffu);
    }
    dst[i] = h | sign;
  }
}

}  // extern "C"

// ---- batched segment assembly (matcher/assemble.py in C++) --------------
// The decoded (B, T) candidate indices -> per-trace OSMLR segment runs,
// walked entirely in native code; Python only formats the run records
// into the reference-schema dicts (reference: py/reporter_service.py:103-162
// consumes them). Semantics mirror matcher/assemble.py line for line; the
// parity is pinned by tests (native batch vs pure-python assemble).

namespace {

constexpr double kBoundaryEps = 1.0;          // assemble.py _BOUNDARY_EPS
constexpr double kQueueEndProximity = 100.0;  // _QUEUE_END_PROXIMITY_M
constexpr int32_t kCaseRestart = 1;

double interp_time(double pos, double pos_a, double pos_b, double ta,
                   double tb) {
  if (pos_b <= pos_a) return ta;
  double frac = (pos - pos_a) / (pos_b - pos_a);
  frac = std::min(std::max(frac, 0.0), 1.0);
  return ta + frac * (tb - ta);
}

// segment length lookup over the sorted (seg_ids, seg_lens) columns;
// returns fallback when absent (assemble.py uses .get(id, 0.0) for
// interpolation and .get(id, -1.0) for output)
double seg_len_of(const int64_t* ids, const double* lens, int64_t n,
                  int64_t key, double fallback) {
  const int64_t* it = std::lower_bound(ids, ids + n, key);
  if (it != ids + n && *it == key) return lens[it - ids];
  return fallback;
}

struct Run {
  int64_t segment_id;  // -1 = unassociated stretch
  bool internal;
  int32_t first_idx, last_idx;
  double first_pos, last_pos;
  double first_time, last_time;
  double first_cum, last_cum;
  double start_time = -1.0, end_time = -1.0;
  double queue_start;  // NaN while traffic is moving
  bool has_queue_start = false;
  std::vector<int64_t> edges;
};

}  // namespace

extern "C" {

// Returns total runs written (<= cap), or -1 if cap would overflow (the
// caller sizes cap = sum(num_kept), which is a strict upper bound — each
// chain element starts at most one run — so -1 indicates a caller bug).
// Outputs: run_off (B+1) per-trace run ranges; per-run columns; way_off
// (cap+1) + out_ways flat way-id lists (capacity also sum(num_kept)).
int64_t rt_assemble_batch(
    void* handle, int64_t B, int32_t T, int32_t K, const int32_t* path,
    const int32_t* edge_ids, const float* offset_m, const float* route_m,
    const int32_t* case_codes, const int32_t* kept_idx,
    const int32_t* num_kept, const float* dwell, const int64_t* pt_off,
    const double* times, const uint8_t* has_cands, const int64_t* edge_seg_id,
    const float* edge_seg_off, const uint8_t* edge_internal,
    const int64_t* seg_ids_sorted, const double* seg_lens_sorted,
    int64_t n_segs, double queue_threshold_kph,
    double interpolation_distance_m, double backward_tolerance_m,
    double turn_penalty_factor, int64_t cap, int64_t* run_off,
    int64_t* out_seg_id, uint8_t* out_internal, double* out_start,
    double* out_end, int32_t* out_length, int32_t* out_queue,
    int32_t* out_begin_idx, int32_t* out_end_idx, int64_t* way_off,
    int64_t* out_ways) {
  const auto* g = static_cast<const Graph*>(handle);
  const int64_t TK = static_cast<int64_t>(T) * K;
  // route rows are T per trace (dead trailing step) — see rt_prepare_batch
  const int64_t TKK = static_cast<int64_t>(T) * K * K;
  int64_t r_total = 0;  // runs written
  int64_t w_total = 0;  // way ids written
  way_off[0] = 0;
  std::vector<Run> runs;
  // chain element: (orig_idx, edge, seg_id, seg_pos, time, cum, internal)
  struct Elem {
    int32_t idx;
    int64_t edge, seg_id;
    double seg_pos, time, cum;
    bool internal;
  };
  std::vector<Elem> chain;

  for (int64_t b = 0; b < B; ++b) {
    run_off[b] = r_total;
    const int32_t n = num_kept[b];
    if (n == 0) continue;
    const int32_t* path_b = path + b * T;
    const int32_t* edge_b_rows = edge_ids + b * TK;
    const float* off_b = offset_m + b * TK;
    const float* route_b = route_m + b * TKK;
    const int32_t* case_b = case_codes + b * T;
    const int32_t* kept_b = kept_idx + b * T;
    const double* times_b = times + pt_off[b];
    const double trailing_dwell = dwell[b];

    runs.clear();
    chain.clear();

    // emit the accumulated chain as runs (assemble.py _chain_to_segments)
    auto flush_chain = [&](bool final_flush) {
      if (chain.empty()) return;
      const size_t first_run = runs.size();
      // re-entry splits a run, but backward movement within the
      // matcher's backward tolerance is along-track GPS noise, not a
      // loop (matcher/assemble.py _chain_to_segments has the rationale)
      const double reentry_tol =
          std::max(kBoundaryEps, backward_tolerance_m);
      for (const Elem& e : chain) {
        const int64_t sid = e.seg_id >= 0 ? e.seg_id : -1;
        bool same = false;
        if (runs.size() > first_run) {
          Run& last = runs.back();
          same = last.segment_id == sid && last.internal == e.internal &&
                 !(sid >= 0 && e.seg_pos < last.last_pos - reentry_tol);
        }
        if (same) {
          Run& r = runs.back();
          const double dt = e.time - r.last_time;
          if (dt > 0.0) {
            const double speed_kph = (e.seg_pos - r.last_pos) / dt * 3.6;
            if (speed_kph < queue_threshold_kph) {
              if (!r.has_queue_start) {
                r.queue_start = r.last_pos;
                r.has_queue_start = true;
              }
            } else {
              r.has_queue_start = false;
            }
          }
          r.last_idx = e.idx;
          r.last_pos = e.seg_pos;
          r.last_time = e.time;
          r.last_cum = e.cum;
          if (r.edges.back() != e.edge) r.edges.push_back(e.edge);
        } else {
          Run r;
          r.segment_id = sid;
          r.internal = e.internal;
          r.first_idx = r.last_idx = e.idx;
          r.first_pos = r.last_pos = e.seg_pos;
          r.first_time = r.last_time = e.time;
          r.first_cum = r.last_cum = e.cum;
          r.edges.push_back(e.edge);
          runs.push_back(std::move(r));
        }
      }
      // trailing raw-point dwell: the dropped tail stayed within
      // interpolation_distance for dwell seconds — if even the
      // upper-bound speed (disc diameter / dwell) is below the queue
      // threshold, the vehicle is queued at its last decoded position
      if (final_flush && trailing_dwell > 0.0 && runs.size() > first_run) {
        Run& last = runs.back();
        const double bound_kph =
            2.0 * interpolation_distance_m / trailing_dwell * 3.6;
        if (bound_kph < queue_threshold_kph && !last.has_queue_start) {
          last.queue_start = last.last_pos;
          last.has_queue_start = true;
        }
      }
      // interpolate boundary times between adjacent runs of this chain.
      // The crossing must lie ON the route between the straddling probes
      // (matcher/assemble.py has the full rationale: a clamped interp
      // would read a one-point intersection flicker as a complete
      // traversal of the crossing segment) — unobserved exits/entries
      // keep their -1 sentinel.
      for (size_t ri = first_run; ri + 1 < runs.size(); ++ri) {
        Run& a = runs[ri];
        Run& b2 = runs[ri + 1];
        const double pos_a = a.last_cum, pos_b = b2.first_cum;
        const double ta = a.last_time, tb = b2.first_time;
        if (a.segment_id >= 0) {
          const double seg_len = seg_len_of(seg_ids_sorted, seg_lens_sorted,
                                            n_segs, a.segment_id, 0.0);
          const double exit_cum =
              a.last_cum + std::max(seg_len - a.last_pos, 0.0);
          if (exit_cum <= pos_b + kBoundaryEps)
            a.end_time = interp_time(exit_cum, pos_a, pos_b, ta, tb);
          // else: exit unobserved; end_time stays -1
        } else {
          a.end_time = ta;
        }
        if (b2.segment_id >= 0) {
          const double entry_cum = b2.first_cum - b2.first_pos;
          if (entry_cum >= pos_a - kBoundaryEps)
            b2.start_time = interp_time(entry_cum, pos_a, pos_b, ta, tb);
          // else: entry unobserved; start_time stays -1
        } else {
          b2.start_time = tb;
        }
      }
      // chain endpoints: partial entry/exit => -1 sentinels. Boundary
      // proximity tolerates one interpolation distance of GPS noise
      // (matcher/assemble.py has the rationale)
      const double end_tol =
          std::max(kBoundaryEps, 3.0 * interpolation_distance_m);
      if (runs.size() > first_run) {
        // a single-point run that is BOTH chain endpoints gets no
        // grants — one probe cannot witness a traversal
        // (matcher/assemble.py has the window-boundary rationale)
        const bool lone_point =
            runs.size() == first_run + 1 &&
            runs[first_run].first_idx == runs[first_run].last_idx;
        Run& first = runs[first_run];
        if (first.segment_id >= 0) {
          if (first.first_pos <= end_tol && !lone_point)
            first.start_time = first.first_time;
          // else stays -1 (got on mid-segment)
        } else {
          first.start_time = first.first_time;
        }
        Run& last = runs.back();
        if (last.segment_id >= 0) {
          const double seg_len = seg_len_of(seg_ids_sorted, seg_lens_sorted,
                                            n_segs, last.segment_id, 0.0);
          if (last.last_pos >= seg_len - end_tol && !lone_point)
            last.end_time = last.last_time;
          // else stays -1 (still on the segment when the trace ended)
        } else {
          last.end_time = last.last_time;
        }
      }
      chain.clear();
    };

    double cum = 0.0;
    bool prev_ok = false;
    for (int32_t t = 0; t < n; ++t) {
      if (case_b[t] == kCaseRestart) {
        flush_chain(false);
        cum = 0.0;
        prev_ok = false;
      }
      const int32_t k = path_b[t];
      const int64_t e = edge_b_rows[t * K + k];
      if (e == kPadEdge) {
        flush_chain(false);
        prev_ok = false;
        continue;
      }
      if (prev_ok) {
        float step =
            route_b[static_cast<int64_t>(t - 1) * K * K +
                    static_cast<int64_t>(path_b[t - 1]) * K + k];
        if (step >= kUnreachable / 2) {
          // decoder was forced through an unroutable pair; break here
          flush_chain(false);
          cum = 0.0;
        } else {
          if (turn_penalty_factor > 0) {
            // strip the ranking-only turn penalty: cumulative route
            // positions must be geometric meters, not penalty meters
            // (matcher/assemble.py has the rationale)
            const int64_t e_prev =
                edge_b_rows[static_cast<int64_t>(t - 1) * K +
                            path_b[t - 1]];
            const float cos_th = g->head_x[e_prev] * g->head_x[e] +
                                 g->head_y[e_prev] * g->head_y[e];
            step = std::max(
                step - static_cast<float>(turn_penalty_factor) * 0.5f *
                           (1.0f - cos_th),
                0.0f);
          }
          cum += static_cast<double>(step);
        }
      }
      chain.push_back(Elem{
          kept_b[t], e, edge_seg_id[e],
          static_cast<double>(edge_seg_off[e]) +
              static_cast<double>(off_b[t * K + k]),
          times_b[kept_b[t]], cum, edge_internal[e] != 0});
      prev_ok = true;
    }
    flush_chain(true);

    // attribute HMM-excluded points: jitter gap points between runs
    // join the FOLLOWING run — but only back to the last candidate-less
    // (off-network) point, which stays unattributed along with anything
    // before it (spans are contiguous ranges and cannot hole-punch) —
    // and a verifiably-jitter trailing tail joins the final run
    // (matcher/assemble.py has the contract rationale)
    for (size_t ri = 1; ri < runs.size(); ++ri) {
      const int32_t lo = runs[ri - 1].last_idx + 1;
      const int32_t hi = runs[ri].first_idx;
      int32_t start = lo;
      for (int32_t j = hi - 1; j >= lo; --j)
        if (!has_cands[pt_off[b] + j]) {
          start = j + 1;
          break;
        }
      runs[ri].first_idx = start;
    }
    if (!runs.empty() && trailing_dwell > 0.0)
      runs.back().last_idx =
          static_cast<int32_t>(pt_off[b + 1] - pt_off[b]) - 1;

    // write this trace's runs to the flat outputs
    if (r_total + static_cast<int64_t>(runs.size()) > cap) return -1;
    std::fesetround(FE_TONEAREST);
    for (const Run& r : runs) {
      const bool complete =
          r.segment_id >= 0 && r.start_time != -1.0 && r.end_time != -1.0;
      const double seg_len =
          r.segment_id >= 0
              ? seg_len_of(seg_ids_sorted, seg_lens_sorted, n_segs,
                           r.segment_id, -1.0)
              : -1.0;
      out_seg_id[r_total] = r.segment_id;
      out_internal[r_total] = r.internal ? 1 : 0;
      out_start[r_total] = r.start_time;
      out_end[r_total] = r.end_time;
      // rint (round-half-even) matches python round()
      out_length[r_total] =
          complete ? static_cast<int32_t>(std::rint(seg_len)) : -1;
      int32_t q = 0;
      if (r.segment_id >= 0 && r.has_queue_start) {
        const double sl = std::max(seg_len, 0.0);
        // only extrapolate to the segment end when the queue was actually
        // observed near it (assemble.py _Run.queue_length)
        if (sl > 0.0 && sl - r.last_pos <= kQueueEndProximity)
          q = static_cast<int32_t>(
              std::rint(std::max(sl - r.queue_start, 0.0)));
      }
      out_queue[r_total] = q;
      out_begin_idx[r_total] = r.first_idx;
      out_end_idx[r_total] = r.last_idx;
      if (w_total + static_cast<int64_t>(r.edges.size()) > cap) return -1;
      for (int64_t e : r.edges) out_ways[w_total++] = e;
      way_off[r_total + 1] = w_total;
      ++r_total;
    }
  }
  run_off[B] = r_total;
  return r_total;
}

}  // extern "C"

// ---- columnar /report wire writer (ABI 12) -------------------------------
// Emits the whole /report UTF-8 JSON response for one trace's run-column
// slice [lo, hi) into a single caller-owned buffer — the native twin of
// service/report.py's Python columnar writer, pinned byte-identical to it
// (and therefore to json.dumps over the legacy dict path) by
// tests/test_report_writer.py. Pure functions over borrowed numpy columns:
// no handle, no allocation, no shared state — concurrent calls from many
// GIL-released request threads are trivially safe (TSan leg drives them).

namespace jsonwire {

inline char* put_u64_dec(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

inline char* put_i64_dec(char* p, int64_t v) {
  uint64_t u = static_cast<uint64_t>(v);
  if (v < 0) {
    *p++ = '-';
    u = 0ull - u;
  }
  return put_u64_dec(p, u);
}

// CPython round(x, 3): correctly-rounded DECIMAL rounding with ties to
// even — NOT rint(x*1000)/1000 (that is numpy's np.round, which the
// Python side applies to the start/end columns before they reach this
// writer). glibc's printf is correctly rounded with the same tie rule,
// so %.3f + strtod reproduces the builtin bit-for-bit. Magnitudes past
// 1e13 are already coarser than 1e-3 (ulp > 2e-3): round() returns the
// input there, and the guard also bounds the %.3f output length.
inline double py_round3(double x) {
  if (!std::isfinite(x) || std::fabs(x) >= 1e13) return x;
  char buf[64];
  snprintf(buf, sizeof buf, "%.3f", x);
  return strtod(buf, nullptr);
}

// Python float-repr formatting over extracted digits: dig[0..p) with the
// first digit worth 10^e. Mirrors CPython's format_float_short: fixed
// notation for -4 <= e < 16 (integer values gain ".0"), scientific
// otherwise with a sign and >= 2 exponent digits.
inline int format_repr(bool neg, const char* dig, int p, int e,
                       char* out) {
  char* q = out;
  if (neg) *q++ = '-';
  if (-4 <= e && e < 16) {
    if (e >= p - 1) {
      std::memcpy(q, dig, p);
      q += p;
      for (int i = 0; i < e - (p - 1); ++i) *q++ = '0';
      *q++ = '.';
      *q++ = '0';
    } else if (e >= 0) {
      std::memcpy(q, dig, e + 1);
      q += e + 1;
      *q++ = '.';
      std::memcpy(q, dig + e + 1, p - e - 1);
      q += p - e - 1;
    } else {
      *q++ = '0';
      *q++ = '.';
      for (int i = 0; i < -e - 1; ++i) *q++ = '0';
      std::memcpy(q, dig, p);
      q += p;
    }
  } else {
    *q++ = dig[0];
    if (p > 1) {
      *q++ = '.';
      std::memcpy(q, dig + 1, p - 1);
      q += p - 1;
    }
    *q++ = 'e';
    *q++ = e < 0 ? '-' : '+';
    int a = e < 0 ? -e : e;
    if (a < 10) *q++ = '0';  // repr pads the exponent to two digits
    q = put_u64_dec(q, static_cast<uint64_t>(a));
  }
  return static_cast<int>(q - out);
}

// repr(float) bytes, CPython-identical, with json.dumps's Infinity/NaN
// spellings (matcher._jnum). `out` must hold >= 32 bytes. Two fast
// paths cover every value this wire actually carries (integer-valued
// doubles and 3-decimal-rounded times/kms below 1e12, where a
// round-tripping stripped "%.3f" is provably the shortest repr); the
// general path finds the smallest precision whose correctly-rounded
// "%.*e" round-trips — the grisu-style shortest-digits contract,
// delegated to glibc's correctly-rounded conversions.
inline int json_double(double v, char* out) {
  if (std::isnan(v)) {
    std::memcpy(out, "NaN", 3);
    return 3;
  }
  if (std::isinf(v)) {
    if (v < 0) {
      std::memcpy(out, "-Infinity", 9);
      return 9;
    }
    std::memcpy(out, "Infinity", 8);
    return 8;
  }
  const bool neg = std::signbit(v);
  const double a = neg ? -v : v;
  char* q = out;
  if (a == 0.0) {
    if (neg) *q++ = '-';
    *q++ = '0';
    *q++ = '.';
    *q++ = '0';
    return static_cast<int>(q - out);
  }
  if (a < 1e16 && a == std::floor(a)) {
    if (neg) *q++ = '-';
    q = put_u64_dec(q, static_cast<uint64_t>(a));
    *q++ = '.';
    *q++ = '0';
    return static_cast<int>(q - out);
  }
  char buf[40];
  if (a < 1e12) {
    // 3-decimal fast path: below 1e12 a double's half-ulp is < 5e-4,
    // so at most one 3-decimal string round-trips and no shorter
    // string can (beyond trailing-zero stripping) — if the 3-decimal
    // form round-trips, it IS repr. All in integer math: m is the
    // correctly-rounded (ties-even, llrint) milli-value, and
    // double(m)/1000.0 — one exact int64->double conversion, one
    // correctly-rounded division — equals strtod of the 3-decimal
    // string by IEEE-754, so the snprintf/strtod pair this path used
    // to lean on (~2 us per float, most of the writer's wall) is
    // byte-for-byte replaced by a division and a compare.
    const int64_t m = std::llrint(a * 1000.0);
    if (m > 0 && static_cast<double>(m) / 1000.0 == a) {
      if (neg) *q++ = '-';
      q = put_u64_dec(q, static_cast<uint64_t>(m / 1000));
      // m % 1000 > 0: an integer-valued a took the floor path above
      const int frac = static_cast<int>(m % 1000);
      const char d2 = static_cast<char>('0' + frac / 100);
      const char d1 = static_cast<char>('0' + (frac / 10) % 10);
      const char d0 = static_cast<char>('0' + frac % 10);
      *q++ = '.';
      *q++ = d2;
      if (d1 != '0' || d0 != '0') *q++ = d1;
      if (d0 != '0') *q++ = d0;
      return static_cast<int>(q - out);
    }
  }
  // general path (rare on this wire): smallest p in 1..17 whose
  // correctly-rounded p-digit form round-trips = shortest repr digits
  int p = 17;
  for (int t = 1; t <= 17; ++t) {
    snprintf(buf, sizeof buf, "%.*e", t - 1, a);
    if (strtod(buf, nullptr) == a) {
      p = t;
      break;
    }
  }
  snprintf(buf, sizeof buf, "%.*e", p - 1, a);
  char dig[20];
  int np = 0;
  const char* s = buf;
  dig[np++] = *s++;
  // collect mantissa digits up to 'e', skipping the radix mark
  // WHATEVER the host process's LC_NUMERIC renders it as (an embedding
  // application may have setlocale'd to a comma — or multibyte —
  // decimal point; the strtod round-trip checks above formatted and
  // parsed under that same locale, so they stay self-consistent, and
  // the emitted JSON gets its '.' from format_repr, never from here)
  while (*s != 'e') {
    if (*s >= '0' && *s <= '9') dig[np++] = *s;
    ++s;
  }
  ++s;  // 'e'
  const int esign = (*s++ == '-') ? -1 : 1;
  int e = 0;
  while (*s) e = e * 10 + (*s++ - '0');
  e *= esign;
  while (np > 1 && dig[np - 1] == '0') --np;  // belt + braces
  return format_repr(neg, dig, np, e, out);
}

// Bounds-checked append buffer: overflow latches `of` and stops writing;
// the caller grows its buffer and retries (returns -1 at the ABI edge).
struct JBuf {
  char* p;
  int64_t cap;
  int64_t n = 0;
  bool of = false;
  void raw(const void* s, int64_t k) {
    if (of || n + k > cap) {
      of = true;
      return;
    }
    std::memcpy(p + n, s, k);
    n += k;
  }
  template <size_t N>
  void lit(const char (&s)[N]) {
    raw(s, static_cast<int64_t>(N - 1));
  }
  void ch(char c) {
    if (of || n + 1 > cap) {
      of = true;
      return;
    }
    p[n++] = c;
  }
  void i64(int64_t v) {
    char t[24];
    raw(t, put_i64_dec(t, v) - t);
  }
  void f(double v) {
    char t[40];
    raw(t, json_double(v, t));
  }
};

// matcher.render_segments_json: the reference-schema
// {"segments":[...],"mode":...} block straight from run columns.
inline void render_segments(JBuf& b, const int64_t* seg_id,
                            const uint8_t* internal, const double* start,
                            const double* end_, const int32_t* length,
                            const int32_t* queue, const int32_t* begin_idx,
                            const int32_t* end_idx, const int64_t* way_off,
                            const int64_t* ways, int64_t lo, int64_t hi,
                            const char* mode_json, int64_t mode_len) {
  b.lit("{\"segments\":[");
  for (int64_t r = lo; r < hi; ++r) {
    if (r > lo) b.ch(',');
    b.lit("{\"way_ids\":[");
    for (int64_t w = way_off[r]; w < way_off[r + 1]; ++w) {
      if (w > way_off[r]) b.ch(',');
      b.i64(ways[w]);
    }
    b.lit("],\"start_time\":");
    b.f(start[r]);
    b.lit(",\"end_time\":");
    b.f(end_[r]);
    b.lit(",\"length\":");
    b.i64(length[r]);
    b.lit(",\"queue_length\":");
    b.i64(queue[r]);
    b.lit(",\"internal\":");
    if (internal[r])
      b.lit("true");
    else
      b.lit("false");
    b.lit(",\"begin_shape_index\":");
    b.i64(begin_idx[r]);
    b.lit(",\"end_shape_index\":");
    b.i64(end_idx[r]);
    if (seg_id[r] >= 0) {
      b.lit(",\"segment_id\":");
      b.i64(seg_id[r]);
    }
    b.ch('}');
  }
  b.lit("],\"mode\":");
  b.raw(mode_json, mode_len);
  b.ch('}');
}

struct ScanStats {
  int64_t successful = 0, unreported = 0;
  double successful_km = 0.0, unreported_km = 0.0;
  int64_t discontinuities = 0, invalid_times = 0, invalid_speeds = 0,
          unassociated = 0;
  int64_t last_idx = -1;    // relative to lo
  int64_t shape_used = -1;  // -1 = None (omitted)
};

// The reference's pairwise emission state machine — a line-for-line
// port of service/report.py _scan_segments over the ROUNDED columns
// (the Python side applies np.round(.., 3) before handing them over,
// so holdback comparisons and emitted bytes see identical doubles).
// With `emit` set, report objects stream into it; the machine runs
// twice per response — once to size the stats block that precedes the
// reports, once to emit — so the caller must hand the second pass a
// throwaway ScanStats (the km sums accumulate per pass).
inline void scan_segments(const int64_t* seg_id, const uint8_t* internal,
                          const double* start, const double* end_,
                          const int32_t* length, const int32_t* queue,
                          const int32_t* begin_idx, const int32_t* end_idx,
                          int64_t lo, int64_t hi, double trace_end,
                          double threshold_sec, uint32_t report_mask,
                          uint32_t transition_mask, ScanStats* st,
                          JBuf* emit) {
  const int64_t n = hi - lo;
  int64_t last = n - 1;
  while (last >= 0 && trace_end - start[lo + last] < threshold_sec) --last;
  st->last_idx = last;
  if (last > 0)
    st->shape_used = end_idx[lo + last - 1];
  else if (last == 0)
    st->shape_used = std::max<int64_t>(
        static_cast<int64_t>(begin_idx[lo]) - 1, 0);
  bool have_pending = false, first = true, emitted_any = false;
  bool p_has_sid = false;
  int64_t p_sid = 0;
  double p_start = 0.0, p_end = 0.0;
  int32_t p_len = 0, p_queue = 0;
  int p_level = -1;
  for (int64_t i = 0; i <= last; ++i) {
    const int64_t sid = seg_id[lo + i];
    const bool has_sid = sid >= 0;  // -1 = column sentinel for no id
    const bool intern = internal[lo + i] != 0;
    const double start_time = start[lo + i];
    if (i > 0 && start_time == -1.0 && end_[lo + i - 1] == -1.0)
      ++st->discontinuities;
    const int level = has_sid ? static_cast<int>(sid & 7) : -1;
    if (have_pending && p_has_sid && p_len > 0 && !intern) {
      if (p_level >= 0 && ((report_mask >> p_level) & 1u)) {
        const bool trans =
            level >= 0 && ((transition_mask >> level) & 1u);
        const double t1 = trans ? start_time : p_end;
        const double dt = t1 - p_start;
        if (dt <= 0.0 || std::isinf(dt) || std::isnan(dt)) {
          ++st->invalid_times;
        } else if ((static_cast<double>(p_len) / dt) * 3.6 > 160.0) {
          ++st->invalid_speeds;
        } else {
          ++st->successful;
          // == py_round3(p_len * 0.001): for integer meters the
          // 3-decimal rounding of len*0.001 is exactly the correctly-
          // rounded division len/1000 (validated exhaustively against
          // CPython round() in the parity tests) — no snprintf here
          st->successful_km += static_cast<double>(p_len) / 1000.0;
          if (emit) {
            if (emitted_any) emit->ch(',');
            emitted_any = true;
            emit->lit("{\"id\":");
            emit->i64(p_sid);
            emit->lit(",\"t0\":");
            emit->f(p_start);
            emit->lit(",\"t1\":");
            emit->f(t1);
            emit->lit(",\"length\":");
            emit->i64(p_len);
            emit->lit(",\"queue_length\":");
            emit->i64(p_queue);
            if (trans && has_sid) {
              emit->lit(",\"next_id\":");
              emit->i64(sid);
            }
            emit->ch('}');
          }
        }
      } else {
        ++st->unreported;
        st->unreported_km += static_cast<double>(p_len) / 1000.0;
      }
    }
    if (!(intern && !first)) {
      p_has_sid = has_sid;
      p_sid = sid;
      p_start = start_time;
      p_end = end_[lo + i];
      p_len = length[lo + i];
      p_queue = queue[lo + i];
      p_level = level;
      have_pending = true;
    }
    first = false;
    if (!has_sid && !intern) ++st->unassociated;
  }
}

// One trace's column set, unpacked from the packed base-address array
// the Python side caches per CHUNK (native._writer_args). Order is the
// wire contract with _WRITER_COLS/_WIRE_DTYPES: [0]=seg_id(i64)
// [1]=internal(u8) [2]=start(f64) [3]=end(f64) [4]=length(i32)
// [5]=queue(i32) [6]=begin_idx(i32) [7]=end_idx(i32) [8]=way_off(i64)
// [9]=ways(i64). Ten separate pointer params would be marshalled by
// ctypes on EVERY per-trace call — measured at more than the
// serialisation itself — so the addresses travel as one array whose
// storage the caller owns for the duration of the call.
struct WireCols {
  const int64_t* seg_id;
  const uint8_t* internal;
  const double* start;
  const double* end_;
  const int32_t* length;
  const int32_t* queue;
  const int32_t* begin_idx;
  const int32_t* end_idx;
  const int64_t* way_off;
  const int64_t* ways;
};

inline WireCols unpack_cols(const int64_t* a) {
  return WireCols{reinterpret_cast<const int64_t*>(a[0]),
                  reinterpret_cast<const uint8_t*>(a[1]),
                  reinterpret_cast<const double*>(a[2]),
                  reinterpret_cast<const double*>(a[3]),
                  reinterpret_cast<const int32_t*>(a[4]),
                  reinterpret_cast<const int32_t*>(a[5]),
                  reinterpret_cast<const int32_t*>(a[6]),
                  reinterpret_cast<const int32_t*>(a[7]),
                  reinterpret_cast<const int64_t*>(a[8]),
                  reinterpret_cast<const int64_t*>(a[9])};
}

}  // namespace jsonwire

extern "C" {

// repr(float) bytes into out (>= 32 bytes); returns the length. The
// formatting-parity unit-test surface for the two writers below.
int64_t rt_json_double(double v, uint8_t* out) {
  return jsonwire::json_double(v, reinterpret_cast<char*>(out));
}

// {"segments":[...],"mode":<mode_json>} for run columns [lo, hi).
// Returns bytes written, or -1 when cap is too small (caller grows and
// retries). mode_json is the pre-encoded JSON token for the mode value.
int64_t rt_render_segments_json(
    const void* col_addrs, int64_t lo, int64_t hi,
    const char* mode_json, int64_t mode_len, void* out, int64_t cap) {
  const jsonwire::WireCols c = jsonwire::unpack_cols(
      static_cast<const int64_t*>(col_addrs));
  jsonwire::JBuf b{reinterpret_cast<char*>(out), cap};
  jsonwire::render_segments(b, c.seg_id, c.internal, c.start, c.end_,
                            c.length, c.queue, c.begin_idx, c.end_idx,
                            c.way_off, c.ways, lo, hi, mode_json,
                            mode_len);
  return b.of ? -1 : b.n;
}

}  // extern "C"

namespace jsonwire {

// One trace's whole /report response body for run columns [lo, hi):
// stats + optional shape_used + segment_matcher echo + datastore
// reports, in service/report.py report_json's exact byte layout —
// shared by the per-trace ABI call and the whole-chunk batch call.
inline void emit_report(JBuf& b, const WireCols& c, int64_t lo,
                        int64_t hi, double trace_end,
                        double threshold_sec, uint32_t report_mask,
                        uint32_t transition_mask) {
  const int64_t* seg_id = c.seg_id;
  const uint8_t* internal = c.internal;
  const double* start = c.start;
  const double* end_ = c.end_;
  const int32_t* length = c.length;
  const int32_t* queue = c.queue;
  const int32_t* begin_idx = c.begin_idx;
  const int32_t* end_idx = c.end_idx;
  const int64_t* way_off = c.way_off;
  const int64_t* ways = c.ways;
  ScanStats st;
  scan_segments(seg_id, internal, start, end_, length, queue,
                begin_idx, end_idx, lo, hi, trace_end, threshold_sec,
                report_mask, transition_mask, &st, nullptr);
  b.lit("{\"stats\":{\"successful_matches\":{\"count\":");
  b.i64(st.successful);
  b.lit(",\"length\":");
  b.f(jsonwire::py_round3(st.successful_km));
  b.lit("},\"unreported_matches\":{\"count\":");
  b.i64(st.unreported);
  b.lit(",\"length\":");
  b.f(jsonwire::py_round3(st.unreported_km));
  b.lit("},\"match_errors\":{\"discontinuities\":");
  b.i64(st.discontinuities);
  b.lit(",\"invalid_speeds\":");
  b.i64(st.invalid_speeds);
  b.lit(",\"invalid_times\":");
  b.i64(st.invalid_times);
  b.lit("},\"unassociated_segments\":");
  b.i64(st.unassociated);
  b.ch('}');
  if (st.shape_used > 0) {  // falsy-omitted, like report() (index 0 too)
    b.lit(",\"shape_used\":");
    b.i64(st.shape_used);
  }
  b.lit(",\"segment_matcher\":");
  render_segments(b, seg_id, internal, start, end_, length, queue,
                  begin_idx, end_idx, way_off, ways, lo, hi,
                  "\"auto\"", 6);
  b.lit(",\"datastore\":{\"mode\":\"auto\",\"reports\":[");
  ScanStats st2;
  scan_segments(seg_id, internal, start, end_, length, queue, begin_idx,
                end_idx, lo, hi, trace_end, threshold_sec, report_mask,
                transition_mask, &st2, &b);
  b.lit("]}}");
}

}  // namespace jsonwire

extern "C" {

// One trace's /report body for run columns [lo, hi). Returns bytes
// written, or -1 when cap is too small (caller grows and retries).
// report/transition masks carry levels 0..7 as bits (level =
// segment_id & 7).
int64_t rt_report_json(
    const void* col_addrs, int64_t lo, int64_t hi,
    double trace_end, double threshold_sec, int32_t report_mask,
    int32_t transition_mask, void* out, int64_t cap) {
  const jsonwire::WireCols c = jsonwire::unpack_cols(
      static_cast<const int64_t*>(col_addrs));
  jsonwire::JBuf b{reinterpret_cast<char*>(out), cap};
  jsonwire::emit_report(b, c, lo, hi, trace_end, threshold_sec,
                        static_cast<uint32_t>(report_mask),
                        static_cast<uint32_t>(transition_mask));
  return b.of ? -1 : b.n;
}

// The whole CHUNK's /report bodies in one call and one contiguous
// buffer: trace t (of n_traces, in run_off order) covers run columns
// [run_off[t], run_off[t+1]) with its own trace_ends[t]; its body is
// out[offsets[t], offsets[t+1]) — the per-trace slices the service
// hands to sockets zero-copy (service/wire.py memoises the buffer per
// chunk, so concurrent requests batched into one decode also share
// ONE serialisation call). Returns total bytes, or -1 when cap is too
// small (offsets[] contents are then unspecified; caller retries).
int64_t rt_report_json_batch(
    const void* col_addrs, const void* run_off_p,
    const void* trace_ends_p, int64_t n_traces, double threshold_sec,
    int32_t report_mask, int32_t transition_mask, void* out,
    int64_t cap, void* offsets_p) {
  const jsonwire::WireCols c = jsonwire::unpack_cols(
      static_cast<const int64_t*>(col_addrs));
  const int64_t* run_off = static_cast<const int64_t*>(run_off_p);
  const double* trace_ends = static_cast<const double*>(trace_ends_p);
  int64_t* offsets = static_cast<int64_t*>(offsets_p);
  jsonwire::JBuf b{reinterpret_cast<char*>(out), cap};
  for (int64_t t = 0; t < n_traces; ++t) {
    offsets[t] = b.n;
    jsonwire::emit_report(b, c, run_off[t], run_off[t + 1],
                          trace_ends[t], threshold_sec,
                          static_cast<uint32_t>(report_mask),
                          static_cast<uint32_t>(transition_mask));
    if (b.of) return -1;
  }
  offsets[n_traces] = b.n;
  return b.n;
}

}  // extern "C"

// ---- RGT1 graph-tile parser (reporter_tpu/graph/tilestore.py layout) ----
// The native analog of the reference's C++ tile reader (SURVEY.md §2.3):
// header "RGT1" + u32 version + i64 n_nodes/n_edges/n_segments, then the
// column arrays little-endian in declaration order.

namespace {
constexpr int64_t kRgtHeaderSize = 4 + 4 + 3 * 8;

template <typename T>
bool rgt_copy(const uint8_t* buf, int64_t len, int64_t& off, T* out,
              int64_t count) {
  const int64_t bytes = count * static_cast<int64_t>(sizeof(T));
  if (off + bytes > len) return false;
  std::memcpy(out, buf + off, bytes);
  off += bytes;
  return true;
}
}  // namespace

extern "C" {

// Fills counts from the header. Returns 0 on success, nonzero on a
// malformed tile. Counts are validated against the blob length so a
// corrupt header can neither drive huge allocations in the caller nor
// overflow the per-column size math below.
int32_t rt_tile_counts(const uint8_t* buf, int64_t len, int64_t* n_nodes,
                       int64_t* n_edges, int64_t* n_segs) {
  if (len < kRgtHeaderSize || std::memcmp(buf, "RGT1", 4) != 0) return 1;
  uint32_t version;
  std::memcpy(&version, buf + 4, 4);
  if (version != 1) return 2;
  std::memcpy(n_nodes, buf + 8, 8);
  std::memcpy(n_edges, buf + 16, 8);
  std::memcpy(n_segs, buf + 24, 8);
  if (*n_nodes < 0 || *n_edges < 0 || *n_segs < 0) return 3;
  // each count also fits in the blob on its own, so the exact-size sum
  // below cannot overflow int64
  if (*n_nodes > len || *n_edges > len || *n_segs > len) return 3;
  const int64_t expect = kRgtHeaderSize + *n_nodes * (8 + 8 + 8) +
                         *n_edges * (4 + 4 + 4 + 4 + 8 + 4 + 1) +
                         *n_segs * (8 + 4);
  if (expect != len) return 3;
  return 0;
}

// Copies every column into caller-allocated arrays sized from
// rt_tile_counts. Returns 0 on success, nonzero on truncation/trailing
// bytes.
int32_t rt_tile_parse(const uint8_t* buf, int64_t len, int64_t* node_gid,
                      double* node_lat, double* node_lon,
                      int32_t* edge_start, int32_t* edge_end,
                      float* edge_length_m, float* edge_speed_kph,
                      int64_t* edge_segment_id, float* edge_segment_offset_m,
                      uint8_t* edge_internal, int64_t* seg_ids,
                      float* seg_lens) {
  int64_t N, E, S;
  const int32_t rc = rt_tile_counts(buf, len, &N, &E, &S);
  if (rc != 0) return rc;
  int64_t off = kRgtHeaderSize;
  if (!rgt_copy(buf, len, off, node_gid, N)) return 4;
  if (!rgt_copy(buf, len, off, node_lat, N)) return 4;
  if (!rgt_copy(buf, len, off, node_lon, N)) return 4;
  if (!rgt_copy(buf, len, off, edge_start, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_end, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_length_m, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_speed_kph, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_segment_id, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_segment_offset_m, E)) return 4;
  if (!rgt_copy(buf, len, off, edge_internal, E)) return 4;
  if (!rgt_copy(buf, len, off, seg_ids, S)) return 4;
  if (!rgt_copy(buf, len, off, seg_lens, S)) return 4;
  return off == len ? 0 : 5;
}

}  // extern "C"
