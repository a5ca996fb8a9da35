// Native list-scheduling engine.
//
// Implements the memory-constrained list-scheduling state machine and all
// nine placement policies (roundrobin / dfs / greedy / critical / mru /
// heft / pipeline / pack / refine — see POLICY_IDS in __init__.py) over
// a flattened, integer-indexed task graph.  Semantics are an exact mirror of
// the Python policies in ../sched/{base,policies,heft}.py — which themselves
// mirror the reference's observed behavior (reference schedulers.py:31-525) —
// so the Python suite's parity tests can assert identical schedules.  The
// engine exists because scheduling wall-time is a first-class reported metric
// (reference simulation.py:327-333); on multi-thousand-task DAGs
// (microbatched Llama-3 graphs) the O(rounds x ready x nodes x params) loops
// dominate in Python and drop ~20-100x here.
//
// C ABI only (called via ctypes): one entry point, flat arrays in, flat
// arrays out.  No allocation sharing with Python; no exceptions cross the
// boundary.  Determinism contract: every sort is stable, every arg-max/min
// keeps the first best, dependents lists are built in task-index order, and
// parameter ids are assigned by sorted name on the Python side so id order ==
// name order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <queue>
#include <utility>
#include <vector>

namespace {

struct Graph {
  int n_tasks, n_params, n_nodes;
  const double* task_mem;    // [n_tasks] activation GB
  const double* task_time;   // [n_tasks] compute seconds at speed 1.0
  const double* out_gb;      // [n_tasks] consumer-visible output GB
                             // (TaskGraph.output_gb: out_bytes when known,
                             // else the activation footprint)
  const int32_t* dep_off;    // [n_tasks+1] CSR offsets into dep_ids
  const int32_t* dep_ids;    // dependencies, task indices
  const int32_t* par_off;    // [n_tasks+1] CSR offsets into par_ids
  const int32_t* par_ids;    // params needed, ascending (== name order)
  const double* param_gb;    // [n_params]
  const double* node_mem;    // [n_nodes] total GB
  const double* node_speed;  // [n_nodes]

  // derived
  std::vector<int32_t> dpt_off, dpt_ids;  // dependents CSR, built like Python

  int ndeps(int t) const { return dep_off[t + 1] - dep_off[t]; }
  int nparams(int t) const { return par_off[t + 1] - par_off[t]; }

  void build_dependents() {
    // mirror TaskGraph.freeze(): for t in insertion order, for d in t.deps:
    // dependents[d].append(t) — CSR via counting sort keeps that order.
    std::vector<int32_t> cnt(n_tasks, 0);
    for (int t = 0; t < n_tasks; ++t)
      for (int k = dep_off[t]; k < dep_off[t + 1]; ++k) cnt[dep_ids[k]]++;
    dpt_off.assign(n_tasks + 1, 0);
    for (int t = 0; t < n_tasks; ++t) dpt_off[t + 1] = dpt_off[t] + cnt[t];
    dpt_ids.assign(dpt_off[n_tasks], 0);
    std::vector<int32_t> cur(dpt_off.begin(), dpt_off.end() - 1);
    for (int t = 0; t < n_tasks; ++t)
      for (int k = dep_off[t]; k < dep_off[t + 1]; ++k)
        dpt_ids[cur[dep_ids[k]]++] = t;
  }

  // Kahn's algorithm, stable w.r.t. task index (== insertion) order; mirrors
  // TaskGraph._toposort.  Graph is pre-validated on the Python side.
  std::vector<int32_t> toposort() const {
    std::vector<int32_t> indeg(n_tasks), order;
    order.reserve(n_tasks);
    for (int t = 0; t < n_tasks; ++t) indeg[t] = ndeps(t);
    for (int t = 0; t < n_tasks; ++t)
      if (indeg[t] == 0) order.push_back(t);
    for (size_t i = 0; i < order.size(); ++i) {
      int tid = order[i];
      for (int k = dpt_off[tid]; k < dpt_off[tid + 1]; ++k)
        if (--indeg[dpt_ids[k]] == 0) order.push_back(dpt_ids[k]);
    }
    return order;
  }
};

// Mutable run state: mirrors SchedulerRun + DeviceState fields the policies
// read.  Param residency is a dense bitmap (node-major) — the Python sets'
// semantics with O(1) membership.
struct Run {
  const Graph& g;
  std::vector<double> avail;          // [n_nodes] available GB
  std::vector<uint8_t> cached;        // [n_nodes * n_params]
  std::vector<int32_t> completed_on;  // [n_nodes] completed-task count
  std::vector<double> busy;           // [n_nodes] compute backlog seconds
  std::vector<int32_t> pset_id;       // [n_tasks] param-set identity
  int n_psets = 0;
  std::vector<int32_t> colocated;     // [n_nodes * n_psets] same-set count
  std::vector<uint8_t> pending, completed, failed;  // [n_tasks]
  std::vector<int32_t> assign;        // [n_tasks] node or -1
  std::vector<int32_t> order;         // assignment order (task ids)
  int n_pending;

  explicit Run(const Graph& graph) : g(graph) {
    avail.assign(g.node_mem, g.node_mem + g.n_nodes);
    cached.assign((size_t)g.n_nodes * g.n_params, 0);
    completed_on.assign(g.n_nodes, 0);
    busy.assign(g.n_nodes, 0.0);
    // param-set identity: tasks with the same sorted param-id sequence
    // share an id (SchedulerRun.sorted_params keys; par ids are already
    // in name order on the wire)
    pset_id.assign(g.n_tasks, -1);
    {
      std::map<std::vector<int32_t>, int32_t> ids;
      for (int t = 0; t < g.n_tasks; ++t) {
        std::vector<int32_t> key(g.par_ids + g.par_off[t],
                                 g.par_ids + g.par_off[t + 1]);
        auto it = ids.find(key);
        if (it == ids.end())
          it = ids.emplace(std::move(key), (int32_t)ids.size()).first;
        pset_id[t] = it->second;
      }
      n_psets = (int)ids.size();
    }
    colocated.assign((size_t)g.n_nodes * n_psets, 0);
    pending.assign(g.n_tasks, 1);
    completed.assign(g.n_tasks, 0);
    failed.assign(g.n_tasks, 0);
    assign.assign(g.n_tasks, -1);
    order.reserve(g.n_tasks);
    n_pending = g.n_tasks;
  }

  uint8_t& is_cached(int node, int param) {
    return cached[(size_t)node * g.n_params + param];
  }

  bool ready(int t) const {
    for (int k = g.dep_off[t]; k < g.dep_off[t + 1]; ++k)
      if (!completed[g.dep_ids[k]]) return false;
    return true;
  }

  // BaseScheduler.memory_requirement: activation + uncached param GB.
  double mem_requirement(int t, int node) {
    double need = g.task_mem[t];
    for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k)
      if (!is_cached(node, g.par_ids[k])) need += g.param_gb[g.par_ids[k]];
    return need;
  }

  bool can_fit(int t, int node) {
    return mem_requirement(t, node) <= avail[node] + 1e-9;
  }

  // BaseScheduler.assign + complete: load params (permanent debit until
  // eviction), debit-then-credit the activation, mark completed.
  void do_assign(int t, int node) {
    for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k) {
      int p = g.par_ids[k];
      if (!is_cached(node, p)) {
        is_cached(node, p) = 1;
        avail[node] -= g.param_gb[p];
      }
    }
    avail[node] -= g.task_mem[t];
    order.push_back(t);
    pending[t] = 0;
    --n_pending;
    busy[node] += g.task_time[t] / g.node_speed[node];
    colocated[(size_t)node * n_psets + pset_id[t]]++;
    // complete_task
    avail[node] += g.task_mem[t];
    completed[t] = 1;
    completed_on[node]++;
    assign[t] = node;
  }

  void do_fail(int t) {
    pending[t] = 0;
    --n_pending;
    failed[t] = 1;
  }

  void fail_all_pending() {
    for (int t = 0; t < g.n_tasks; ++t)
      if (pending[t]) do_fail(t);
  }
};

// ---------------------------------------------------------------------------
// Round-loop policies (BaseScheduler._round_loop skeleton).  OrderFn sorts the
// ready list in place; PickFn returns the chosen node or -1 (and may mutate
// run state — MRU eviction).  `ordered` is this round's list; picks consult it
// with pending flags (the Python ready_ids recompute).
// ---------------------------------------------------------------------------

template <typename OrderFn, typename PickFn>
void round_loop(Run& run, OrderFn order_fn, PickFn pick_fn) {
  const Graph& g = run.g;
  int max_rounds = 2 * g.n_tasks, rounds = 0;
  std::vector<int32_t> ready;
  while (run.n_pending > 0 && rounds < max_rounds) {
    ++rounds;
    ready.clear();
    for (int t = 0; t < g.n_tasks; ++t)  // insertion-order scan
      if (run.pending[t] && run.ready(t)) ready.push_back(t);
    if (ready.empty()) {
      run.fail_all_pending();
      break;
    }
    bool progressed = false;
    order_fn(run, ready);
    for (int t : ready) {
      int node = pick_fn(run, t, ready);
      if (node < 0) {
        run.do_fail(t);
      } else {
        run.do_assign(t, node);
        progressed = true;
      }
    }
    if (!progressed && run.n_pending > 0) {
      run.fail_all_pending();
      break;
    }
  }
}

// Load-band eligibility (BaseScheduler.load_band): among fitting candidates,
// only nodes with busy <= min_fitting_busy + FACTOR * task_time + 1e-12 may
// be picked.  Returns +inf (everything eligible) when the task has no
// compute time — mirroring the Python early return — or when nothing fits.
constexpr double LOAD_BAND_FACTOR = 2.0;

constexpr double LOAD_BAND_FULL_HIT_FACTOR = 4.0;
constexpr int LOAD_BAND_FULL_HIT_SIBLINGS = 2;
// GreedyScheduler.LOAD_BAND_FACTOR: greedy's min-to-load key always takes
// the most-cached in-band node, so its base band is tighter
constexpr double GREEDY_LOAD_BAND_FACTOR = 1.0;

// Fill `fit` with can_fit per node (one scan, shared between the band
// threshold and the selection loop in dfs/greedy/critical).
void fit_mask(Run& r, int t, std::vector<uint8_t>& fit) {
  fit.resize(r.g.n_nodes);
  for (int node = 0; node < r.g.n_nodes; ++node)
    fit[node] = r.can_fit(t, node);
}

// Per-node band eligibility (BaseScheduler.load_band), one copy of the
// formula over a caller-supplied candidate mask (can_fit for dfs/greedy/
// critical, eviction-feasibility for MRU).  `base`/`hit` are the two
// busy thresholds: `hit` (wider) applies only to nodes that already
// cache every param the task needs — zero load bytes, so locality is
// worth more there (expert-locality; see base.py).
struct Band {
  double base, hit;
};

Band band_thresholds_masked(const Run& r, int t,
                            const std::vector<uint8_t>& candidate,
                            double base_factor = LOAD_BAND_FACTOR) {
  constexpr double INF = std::numeric_limits<double>::infinity();
  if (r.g.task_time[t] <= 0.0) return {INF, INF};
  double min_busy = INF;
  for (int node = 0; node < r.g.n_nodes; ++node)
    if (candidate[node]) min_busy = std::min(min_busy, r.busy[node]);
  if (!std::isfinite(min_busy)) return {min_busy, min_busy};
  return {min_busy + base_factor * r.g.task_time[t] + 1e-12,
          min_busy + LOAD_BAND_FULL_HIT_FACTOR * r.g.task_time[t] + 1e-12};
}

bool full_hit(Run& r, int t, int node) {
  for (int k = r.g.par_off[t]; k < r.g.par_off[t + 1]; ++k)
    if (!r.is_cached(node, r.g.par_ids[k])) return false;
  return true;
}

// The wider full-hit band is capped at SIBLINGS same-param-set tasks per
// node (SchedulerRun.colocated on the Python side); param-less tasks save
// no bytes and never qualify (BaseScheduler.load_band).
bool band_eligible(Run& r, int t, int node, const Band& band,
                   int known_full_hit = -1) {
  if (r.busy[node] <= band.base) return true;
  if (r.busy[node] > band.hit) return false;
  if (r.g.par_off[t] == r.g.par_off[t + 1]) return false;
  // callers that already counted uncached params (greedy's to_load,
  // MRU's overlap) pass the verdict in rather than re-scanning
  bool fh = known_full_hit >= 0 ? (known_full_hit != 0)
                                : full_hit(r, t, node);
  if (!fh) return false;
  return r.colocated[(size_t)node * r.n_psets + r.pset_id[t]] <
         LOAD_BAND_FULL_HIT_SIBLINGS;
}

void run_roundrobin(Run& run) {
  int cursor = 0;  // persists across rounds, like the Python closure
  round_loop(
      run, [](Run&, std::vector<int32_t>&) {},
      [&cursor](Run& r, int t, const std::vector<int32_t>&) -> int {
        int n = r.g.n_nodes;
        for (int i = 0; i < n; ++i) {
          int node = (cursor + i) % n;
          if (r.can_fit(t, node)) {
            cursor = (cursor + i + 1) % n;
            return node;
          }
        }
        return -1;
      });
}

void run_dfs(Run& run) {
  // DAG depth from roots, one topo pass (TaskGraph.depths)
  const Graph& g = run.g;
  std::vector<int32_t> depth(g.n_tasks, 0);
  for (int tid : g.toposort()) {
    int d = 0;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      d = std::max(d, depth[g.dep_ids[k]] + 1);
    depth[tid] = g.ndeps(tid) ? d : 0;
  }
  round_loop(
      run,
      [&depth](Run&, std::vector<int32_t>& ready) {
        std::stable_sort(ready.begin(), ready.end(),
                         [&](int a, int b) { return depth[a] > depth[b]; });
      },
      [](Run& r, int t, const std::vector<int32_t>&) -> int {
        static thread_local std::vector<uint8_t> fit;
        fit_mask(r, t, fit);
        Band band = band_thresholds_masked(r, t, fit);
        int best = -1;  // most available memory; first max kept on ties
        for (int node = 0; node < r.g.n_nodes; ++node)
          if (fit[node] && band_eligible(r, t, node, band) &&
              (best < 0 || r.avail[node] > r.avail[best]))
            best = node;
        return best;
      });
}

void run_greedy(Run& run) {
  round_loop(
      run, [](Run&, std::vector<int32_t>&) {},
      [](Run& r, int t, const std::vector<int32_t>&) -> int {
        // min (params-to-load, -available); first best kept on ties
        static thread_local std::vector<uint8_t> fit;
        fit_mask(r, t, fit);
        Band band = band_thresholds_masked(r, t, fit,
                                           GREEDY_LOAD_BAND_FACTOR);
        int best = -1, best_load = 0;
        for (int node = 0; node < r.g.n_nodes; ++node) {
          if (!fit[node]) continue;
          int to_load = 0;
          for (int k = r.g.par_off[t]; k < r.g.par_off[t + 1]; ++k)
            if (!r.is_cached(node, r.g.par_ids[k])) ++to_load;
          if (!band_eligible(r, t, node, band,
                             /*known_full_hit=*/to_load == 0 ? 1 : 0))
            continue;
          if (best < 0 || to_load < best_load ||
              (to_load == best_load && r.avail[node] > r.avail[best])) {
            best = node;
            best_load = to_load;
          }
        }
        return best;
      });
}

void run_critical(Run& run) {
  // downstream critical-path length, reverse topo
  // (TaskGraph.critical_path_lengths)
  const Graph& g = run.g;
  std::vector<double> cpl(g.n_tasks, 0.0);
  std::vector<int32_t> topo = g.toposort();
  for (auto it = topo.rbegin(); it != topo.rend(); ++it) {
    int tid = *it;
    double down = 0.0;
    for (int k = g.dpt_off[tid]; k < g.dpt_off[tid + 1]; ++k)
      down = std::max(down, cpl[g.dpt_ids[k]]);
    cpl[tid] = g.task_time[tid] + down;
  }
  round_loop(
      run,
      [&cpl](Run&, std::vector<int32_t>& ready) {
        std::stable_sort(ready.begin(), ready.end(),
                         [&](int a, int b) { return cpl[a] > cpl[b]; });
      },
      [](Run& r, int t, const std::vector<int32_t>&) -> int {
        // fastest fitting node, tie-broken by available memory; first max
        static thread_local std::vector<uint8_t> fit;
        fit_mask(r, t, fit);
        Band band = band_thresholds_masked(r, t, fit);
        int best = -1;
        for (int node = 0; node < r.g.n_nodes; ++node) {
          if (!fit[node] || !band_eligible(r, t, node, band)) continue;
          if (best < 0 || r.g.node_speed[node] > r.g.node_speed[best] ||
              (r.g.node_speed[node] == r.g.node_speed[best] &&
               r.avail[node] > r.avail[best]))
            best = node;
        }
        return best;
      });
}

// MRU scoring weights, verbatim from the reference (SURVEY.md §2 #7).
constexpr double W_FREQ = 10.0, W_RECENCY = 100.0, W_NEEDED = 1000.0;
constexpr double W_OVERLAP = 20.0, W_FITS_AFTER_EVICT = 5.0;
constexpr double W_LOAD_PENALTY = 0.5;

void run_mru(Run& run) {
  const Graph& g = run.g;
  std::vector<int32_t> usage_count(g.n_params, 0);
  std::vector<int32_t> last_used(g.n_params, INT32_MIN);  // sentinel: unseen
  int clock = 0;
  // param -> needed by any still-pending task in this round's ordered list;
  // recomputed lazily per pick (the ready_ids scan in Python)
  std::vector<uint8_t> in_task(g.n_params, 0);

  auto eviction_score = [&](int p, const std::vector<int32_t>& ordered,
                            Run& r) -> double {
    double score = W_FREQ * usage_count[p];
    int last = last_used[p] == INT32_MIN ? -clock : last_used[p];
    score += W_RECENCY / ((clock - last) + 1.0);
    for (int tid : ordered) {
      if (!r.pending[tid]) continue;
      for (int k = g.par_off[tid]; k < g.par_off[tid + 1]; ++k)
        if (g.par_ids[k] == p) {
          return score + W_NEEDED;
        }
    }
    return score;
  };

  // Lowest-score-first eviction plan so `t` fits on `node`; empty if it
  // already fits, nullopt (ok=false) if impossible.  Pure (MRUScheduler
  // .eviction_plan — the reference's evict-during-scoring bug is fixed the
  // same way on both sides).
  struct Plan {
    bool ok;
    std::vector<int32_t> evict;
  };
  auto eviction_plan = [&](Run& r, int t, int node,
                           const std::vector<int32_t>& ordered) -> Plan {
    double need = r.mem_requirement(t, node);
    double deficit = need - r.avail[node];
    if (deficit <= 1e-9) return {true, {}};
    for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k)
      in_task[g.par_ids[k]] = 1;
    std::vector<int32_t> cand;  // id order == name order
    for (int p = 0; p < g.n_params; ++p)
      if (r.is_cached(node, p) && !in_task[p]) cand.push_back(p);
    for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k)
      in_task[g.par_ids[k]] = 0;
    std::vector<double> score(cand.size());
    for (size_t i = 0; i < cand.size(); ++i)
      score[i] = eviction_score(cand[i], ordered, r);
    std::vector<int32_t> idx(cand.size());
    for (size_t i = 0; i < idx.size(); ++i) idx[i] = (int32_t)i;
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int a, int b) { return score[a] < score[b]; });
    Plan plan{false, {}};
    double freed = 0.0;
    for (int i : idx) {
      plan.evict.push_back(cand[i]);
      freed += g.param_gb[cand[i]];
      if (freed >= deficit - 1e-9) {
        plan.ok = true;
        return plan;
      }
    }
    return {false, {}};
  };

  round_loop(
      run,
      [&g](Run& r, std::vector<int32_t>& ready) {
        // order by number of still-pending dependents, descending
        std::vector<int32_t> key(g.n_tasks, 0);
        for (int t : ready) {
          int c = 0;
          for (int k = g.dpt_off[t]; k < g.dpt_off[t + 1]; ++k)
            if (r.pending[g.dpt_ids[k]]) ++c;
          key[t] = c;
        }
        std::stable_sort(ready.begin(), ready.end(),
                         [&](int a, int b) { return key[a] > key[b]; });
      },
      [&](Run& r, int t, const std::vector<int32_t>& ordered) -> int {
        // candidates = eviction-feasible nodes; the load band applies on
        // top (MRUScheduler.pick: plans for all nodes first, then the
        // band filter, then scoring — plans are pure, so precomputing
        // them is behavior-identical)
        std::vector<Plan> plans(g.n_nodes);
        std::vector<uint8_t> feasible(g.n_nodes);
        for (int node = 0; node < g.n_nodes; ++node) {
          plans[node] = eviction_plan(r, t, node, ordered);
          feasible[node] = plans[node].ok;
        }
        Band band = band_thresholds_masked(r, t, feasible);
        int best = -1;
        double best_score = 0.0;
        Plan best_plan{false, {}};
        for (int node = 0; node < g.n_nodes; ++node) {
          Plan& plan = plans[node];
          if (!plan.ok) continue;
          int overlap = 0;
          for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k)
            if (r.is_cached(node, g.par_ids[k])) ++overlap;
          int n_par = g.par_off[t + 1] - g.par_off[t];
          if (!band_eligible(r, t, node, band,
                             /*known_full_hit=*/overlap == n_par ? 1 : 0))
            continue;
          // Reference conditional scoring: available memory only when the
          // task fits without eviction, the flat bonus only when eviction
          // is needed (mirrors policies.py MRU pick).
          double score = W_OVERLAP * overlap +
                         (plan.evict.empty() ? r.avail[node]
                                             : W_FITS_AFTER_EVICT) -
                         W_LOAD_PENALTY * r.completed_on[node];
          if (best < 0 || score > best_score) {
            best = node;
            best_score = score;
            best_plan = std::move(plan);
          }
        }
        if (best < 0) return -1;
        for (int p : best_plan.evict) {
          r.is_cached(best, p) = 0;
          r.avail[best] += g.param_gb[p];
        }
        for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k) {
          usage_count[g.par_ids[k]]++;
          last_used[g.par_ids[k]] = clock;
        }
        ++clock;
        return best;
      });
}

// ---------------------------------------------------------------------------
// HEFT (sched/heft.py): upward ranks with mean communication, insertion-based
// earliest-finish-time node choice, per-node host-link parameter load queues.
// link[0]=param_load_gbps (<=0 means free), link[1]=interconnect_gbps,
// link[2]=latency_s.
// ---------------------------------------------------------------------------

void run_heft(Run& run, const double* link) {
  const Graph& g = run.g;
  const double load_gbps = link[0], ici_gbps = link[1], lat = link[2];
  auto param_load_time = [&](double gb) {
    return load_gbps <= 0 ? 0.0 : lat + gb / load_gbps;
  };
  auto transfer_time = [&](double gb) {
    return ici_gbps <= 0 ? 0.0 : lat + gb / ici_gbps;
  };

  double cross_frac = g.n_nodes > 1 ? (g.n_nodes - 1.0) / g.n_nodes : 0.0;
  double mean_speed = 0.0;
  for (int n = 0; n < g.n_nodes; ++n) mean_speed += g.node_speed[n];
  mean_speed /= g.n_nodes;

  std::vector<int32_t> topo = g.toposort();
  std::vector<double> rank(g.n_tasks, 0.0);
  for (auto it = topo.rbegin(); it != topo.rend(); ++it) {
    int tid = *it;
    double w = g.task_time[tid] / mean_speed;
    double comm = cross_frac * transfer_time(g.out_gb[tid]);
    double best_child = 0.0;
    for (int k = g.dpt_off[tid]; k < g.dpt_off[tid + 1]; ++k)
      best_child = std::max(best_child, comm + rank[g.dpt_ids[k]]);
    rank[tid] = w + best_child;
  }

  std::vector<int32_t> order(g.n_tasks);
  for (int t = 0; t < g.n_tasks; ++t) order[t] = t;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return rank[a] > rank[b]; });

  std::vector<std::vector<std::pair<double, double>>> busy(g.n_nodes);
  std::vector<double> load_queue_end(g.n_nodes, 0.0);
  std::vector<double> param_ready_at((size_t)g.n_nodes * g.n_params, 0.0);
  std::vector<double> finish(g.n_tasks, 0.0), start_at(g.n_tasks, 0.0);

  auto earliest_slot = [](const std::vector<std::pair<double, double>>& iv,
                          double ready, double dur) {
    double t = ready;
    for (const auto& se : iv) {
      if (t + dur <= se.first) return t;
      t = std::max(t, se.second);
    }
    return t;
  };

  for (int tid : order) {
    bool dep_failed = false;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      if (run.failed[g.dep_ids[k]]) dep_failed = true;
    if (dep_failed) {
      run.do_fail(tid);
      continue;
    }
    int best = -1;
    double best_eft = 0.0, best_start = 0.0;
    for (int node = 0; node < g.n_nodes; ++node) {
      if (!run.can_fit(tid, node)) continue;
      double q_end = load_queue_end[node];
      double ready = 0.0;
      for (int k = g.par_off[tid]; k < g.par_off[tid + 1]; ++k) {
        int p = g.par_ids[k];
        if (run.is_cached(node, p)) {
          ready =
              std::max(ready, param_ready_at[(size_t)node * g.n_params + p]);
        } else {
          q_end += param_load_time(g.param_gb[p]);
          ready = std::max(ready, q_end);
        }
      }
      for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k) {
        int d = g.dep_ids[k];
        double arrive = finish[d];
        if (run.assign[d] != node) arrive += transfer_time(g.out_gb[d]);
        ready = std::max(ready, arrive);
      }
      double dur = g.task_time[tid] / g.node_speed[node];
      double start = earliest_slot(busy[node], ready, dur);
      if (best < 0 || start + dur < best_eft) {
        best = node;
        best_eft = start + dur;
        best_start = start;
      }
    }
    if (best < 0) {
      run.do_fail(tid);
      continue;
    }
    for (int k = g.par_off[tid]; k < g.par_off[tid + 1]; ++k) {
      int p = g.par_ids[k];
      if (!run.is_cached(best, p)) {
        load_queue_end[best] += param_load_time(g.param_gb[p]);
        param_ready_at[(size_t)best * g.n_params + p] = load_queue_end[best];
      }
    }
    run.do_assign(tid, best);
    busy[best].emplace_back(best_start, best_eft);
    std::sort(busy[best].begin(), busy[best].end());
    finish[tid] = best_eft;
    start_at[tid] = best_start;
  }

  // global order by intended start time (stable: rank-order kept on ties),
  // so a sequential per-node replay realizes the inserted interleaving
  std::stable_sort(
      run.order.begin(), run.order.end(),
      [&](int a, int b) { return start_at[a] < start_at[b]; });
}

// ---------------------------------------------------------------------------
// Pipeline stage policy (sched/pipeline.py) + dependency-aware event-ordered
// dispatch (sched/eventsim.py).  group_ids: per-task group index assigned by
// first appearance in topo order on the Python side (singleton groups for
// ungrouped tasks), so group index order == the Python group order.
// ---------------------------------------------------------------------------

struct EventOrder {
  std::vector<int32_t> order;      // task ids by simulated start
  double makespan = 0.0;           // max finish over placed tasks
  std::vector<double> node_finish; // [n_nodes] last finish (0 if absent)
  std::vector<uint8_t> node_used;  // [n_nodes] node appears in placement
};

// dependency_aware_order / simulate_placement (sched/eventsim.py):
// deepest-arrived-first per node (1F1B), else earliest arrival; parameter
// prefetch queues per node in first-use order.  Takes the assignment
// vector directly (node index or -1 per task) so the refine policy can
// score CANDIDATE placements without touching the Run.
EventOrder event_order(const Graph& g, const std::vector<int32_t>& assign,
                       const std::vector<int32_t>& topo,
                       const double* link3) {
  const double load_gbps = link3[0], ici_gbps = link3[1], lat = link3[2];
  auto param_load_time = [&](double gb) {
    return load_gbps <= 0 ? 0.0 : lat + gb / load_gbps;
  };
  auto transfer_time = [&](double gb) {
    return ici_gbps <= 0 ? 0.0 : lat + gb / ici_gbps;
  };

  std::vector<int32_t> topo_pos(g.n_tasks, 0);
  for (size_t i = 0; i < topo.size(); ++i) topo_pos[topo[i]] = (int32_t)i;
  // depth from roots (TaskGraph.depths)
  std::vector<int32_t> depth(g.n_tasks, 0);
  for (int tid : topo) {
    int d = 0;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      d = std::max(d, depth[g.dep_ids[k]] + 1);
    depth[tid] = g.ndeps(tid) ? d : 0;
  }

  struct ReadyItem { int32_t tid; double arrival; };
  std::vector<std::vector<ReadyItem>> ready(g.n_nodes);
  std::vector<double> node_free(g.n_nodes, 0.0);
  std::vector<double> load_queue_end(g.n_nodes, 0.0);
  std::vector<uint8_t> cached((size_t)g.n_nodes * g.n_params, 0);
  std::vector<int32_t> missing(g.n_tasks, -1);
  std::vector<double> arrival(g.n_tasks, 0.0), finish(g.n_tasks, 0.0);
  std::vector<double> start_at(g.n_tasks, 0.0);

  for (int tid : topo) {
    if (assign[tid] < 0) continue;
    int m = 0;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      if (assign[g.dep_ids[k]] >= 0) ++m;
    missing[tid] = m;
    if (m == 0) ready[assign[tid]].push_back({tid, 0.0});
  }

  // completion events: min-heap on (finish, topo_pos)
  using Ev = std::pair<double, int32_t>;  // (finish, topo_pos); tid via topo
  std::priority_queue<Ev, std::vector<Ev>, std::greater<Ev>> events;
  constexpr double EPS = 1e-12;

  auto dispatch = [&](int nid) {
    auto& lst = ready[nid];
    if (lst.empty()) return;
    double now = node_free[nid];
    // deepest among arrived (ties: max (depth, -topo_pos) like the Python
    // max over (depth, -topo_pos, i) tuples), else earliest arrival with
    // topo tie-break
    int best = -1;
    for (size_t i = 0; i < lst.size(); ++i) {
      if (lst[i].arrival <= now + EPS) {
        if (best < 0 ||
            depth[lst[i].tid] > depth[lst[best].tid] ||
            (depth[lst[i].tid] == depth[lst[best].tid] &&
             topo_pos[lst[i].tid] < topo_pos[lst[best].tid]))
          best = (int)i;
      }
    }
    if (best < 0) {
      for (size_t i = 0; i < lst.size(); ++i) {
        if (best < 0 || lst[i].arrival < lst[best].arrival ||
            (lst[i].arrival == lst[best].arrival &&
             topo_pos[lst[i].tid] < topo_pos[lst[best].tid]))
          best = (int)i;
      }
    }
    int tid = lst[best].tid;
    double dep_ready = lst[best].arrival;
    lst.erase(lst.begin() + best);
    double params_ready = 0.0;
    for (int k = g.par_off[tid]; k < g.par_off[tid + 1]; ++k) {
      int p = g.par_ids[k];
      if (!cached[(size_t)nid * g.n_params + p]) {
        cached[(size_t)nid * g.n_params + p] = 1;
        load_queue_end[nid] += param_load_time(g.param_gb[p]);
        params_ready = std::max(params_ready, load_queue_end[nid]);
      }
    }
    double start = std::max(now, std::max(dep_ready, params_ready));
    double dur = g.task_time[tid] / g.node_speed[nid];
    start_at[tid] = start;
    finish[tid] = start + dur;
    node_free[nid] = start + dur;
    events.push({start + dur, topo_pos[tid]});
  };

  for (int n = 0; n < g.n_nodes; ++n) dispatch(n);

  std::vector<int32_t> by_pos(g.n_tasks, -1);
  for (int t = 0; t < g.n_tasks; ++t) by_pos[topo_pos[t]] = t;
  while (!events.empty()) {
    auto ev = events.top();
    events.pop();
    int tid = by_pos[ev.second];
    int nid = assign[tid];
    for (int k = g.dpt_off[tid]; k < g.dpt_off[tid + 1]; ++k) {
      int dep = g.dpt_ids[k];
      if (assign[dep] < 0 || missing[dep] < 0) continue;
      int dep_nid = assign[dep];
      double arr = finish[tid];
      if (dep_nid != nid) arr += transfer_time(g.out_gb[tid]);
      arrival[dep] = std::max(arrival[dep], arr);
      if (--missing[dep] == 0) {
        ready[dep_nid].push_back({dep, arrival[dep]});
        if (node_free[dep_nid] <= arrival[dep]) dispatch(dep_nid);
      }
    }
    dispatch(nid);
  }
  for (int n = 0; n < g.n_nodes; ++n)
    while (!ready[n].empty()) dispatch(n);

  EventOrder out;
  for (int tid : topo)
    if (assign[tid] >= 0) out.order.push_back(tid);
  std::stable_sort(out.order.begin(), out.order.end(), [&](int a, int b) {
    return start_at[a] < start_at[b] ||
           (start_at[a] == start_at[b] && topo_pos[a] < topo_pos[b]);
  });
  // cost estimates (simulate_placement's exposed outputs): node_finish
  // only over nodes that appear in the placement, like the Python dict
  out.node_finish.assign(g.n_nodes, 0.0);
  out.node_used.assign(g.n_nodes, 0);
  for (int tid : out.order) {
    int nid = assign[tid];
    out.node_used[nid] = 1;
    out.node_finish[nid] = std::max(out.node_finish[nid], finish[tid]);
  }
  for (int n = 0; n < g.n_nodes; ++n)
    out.makespan = std::max(out.makespan, out.node_finish[n]);
  return out;
}

// Group statistics in first-appearance (== group id) order, shared by the
// pipeline and pack policies (mirrors sched/pipeline.py _group_stats).
struct GroupStats {
  int n_groups = 0;
  std::vector<double> compute, activ, pg_of;
  std::vector<std::vector<int32_t>> gparams;  // sorted, unique
  std::vector<uint8_t> has_root;
};

GroupStats group_stats(const Graph& g, const int32_t* group_ids) {
  GroupStats st;
  for (int t = 0; t < g.n_tasks; ++t)
    st.n_groups = std::max(st.n_groups, group_ids[t] + 1);
  st.compute.assign(st.n_groups, 0.0);
  st.activ.assign(st.n_groups, 0.0);
  st.gparams.resize(st.n_groups);
  st.has_root.assign(st.n_groups, 0);
  for (int t = 0; t < g.n_tasks; ++t) {  // insertion order, like Python
    int gi = group_ids[t];
    st.compute[gi] += g.task_time[t];
    st.activ[gi] = std::max(st.activ[gi], g.task_mem[t]);
    if (g.ndeps(t) == 0) st.has_root[gi] = 1;
  }
  for (int t = 0; t < g.n_tasks; ++t)  // one pass, not per-group rescans
    for (int k = g.par_off[t]; k < g.par_off[t + 1]; ++k)
      st.gparams[group_ids[t]].push_back(g.par_ids[k]);
  st.pg_of.assign(st.n_groups, 0.0);
  for (int gi = 0; gi < st.n_groups; ++gi) {
    std::vector<int32_t>& ps = st.gparams[gi];
    std::sort(ps.begin(), ps.end());
    ps.erase(std::unique(ps.begin(), ps.end()), ps.end());
    for (int p : ps) st.pg_of[gi] += g.param_gb[p];  // asc == name order
  }
  return st;
}

void run_pipeline(Run& run, const double* link3, const int32_t* group_ids) {
  const Graph& g = run.g;
  int n_dev = g.n_nodes;
  std::vector<int32_t> topo = g.toposort();

  GroupStats st = group_stats(g, group_ids);
  int n_groups = st.n_groups;
  std::vector<double>& compute = st.compute;
  std::vector<double>& activ = st.activ;
  std::vector<double>& pg_of = st.pg_of;
  std::vector<std::vector<int32_t>>& gparams = st.gparams;
  std::vector<uint8_t>& has_root = st.has_root;

  std::vector<double> reserved(n_dev, 0.0);
  std::vector<int32_t> stage_of_group(n_groups, -1);
  std::vector<int32_t> remaining;
  for (int gi = 0; gi < n_groups; ++gi) remaining.push_back(gi);
  std::vector<int32_t> parked_placed;
  bool tail_parked = false;

  if (n_groups > n_dev) {
    // park root-bearing groups, largest params first (stable ties)
    std::vector<int32_t> parked;
    for (int gi : remaining)
      if (has_root[gi]) parked.push_back(gi);
    std::stable_sort(parked.begin(), parked.end(), [&](int a, int b) {
      return pg_of[a] > pg_of[b];
    });
    for (int gi : parked) {
      double pg = pg_of[gi];
      double need = pg + activ[gi];
      // least-reserved device, ties by index
      std::vector<int32_t> devs(n_dev);
      for (int d = 0; d < n_dev; ++d) devs[d] = d;
      std::stable_sort(devs.begin(), devs.end(), [&](int a, int b) {
        return reserved[a] < reserved[b];
      });
      for (int d : devs) {
        if (reserved[d] + need <= g.node_mem[d] + 1e-9) {
          stage_of_group[gi] = d;
          reserved[d] += pg;
          remaining.erase(
              std::find(remaining.begin(), remaining.end(), gi));
          parked_placed.push_back(gi);
          break;
        }
      }
    }
    // weight-tied tail onto the parked device sharing its params
    if (!remaining.empty()) {
      int ti = remaining.back();
      std::vector<std::vector<uint8_t>> parked_on(
          n_dev, std::vector<uint8_t>(g.n_params, 0));
      for (int gi = 0; gi < n_groups; ++gi)
        if (stage_of_group[gi] >= 0)
          for (int p : gparams[gi]) parked_on[stage_of_group[gi]][p] = 1;
      int tied_dev = -1;
      for (int d = 0; d < n_dev && tied_dev < 0; ++d)
        for (int p : gparams[ti])
          if (parked_on[d][p]) {
            tied_dev = d;
            break;
          }
      if (tied_dev >= 0) {
        double extra = 0.0;
        for (int p : gparams[ti])  // ascending == sorted(name) order
          if (!parked_on[tied_dev][p]) extra += g.param_gb[p];
        if (reserved[tied_dev] + extra + activ[ti] <=
            g.node_mem[tied_dev] + 1e-9) {
          stage_of_group[ti] = tied_dev;
          reserved[tied_dev] += extra;
          remaining.pop_back();
          tail_parked = true;
        }
      }
    }
  }

  // contiguous-stage DP over remaining groups (plan_stages): lexicographic
  // (bottleneck stage cost, stages at that bottleneck), stage cost =
  // max(compute, param-load time) — mirrors sched/pipeline.py exactly.
  // Stage s draws device (s-1) % n_dev's budget: with a virtual-stage
  // factor v > 1 (the Megatron-style interleave sweep below) stages wrap
  // cyclically over the devices, exactly like the Python side's
  // devices * v list repetition.
  int n = (int)remaining.size();
  if (n > 0) {
    std::vector<double> prefix(n + 1, 0.0);
    for (int i = 0; i < n; ++i)
      prefix[i + 1] = prefix[i] + compute[remaining[i]];
    const double INF = 1e300;
    // host rate: <=0 means "free" (Python: None -> inf -> load time 0)
    double host = link3[0] > 0
                      ? link3[0]
                      : std::numeric_limits<double>::infinity();
    using Cost = std::pair<double, int32_t>;
    std::vector<uint8_t> inparams(g.n_params, 0);
    // bounds for a given stage budget, or empty when infeasible
    auto plan = [&](int kmax) -> std::vector<int32_t> {
      std::vector<std::vector<Cost>> best(
          n + 1, std::vector<Cost>(kmax + 1, {INF, 0}));
      std::vector<std::vector<int32_t>> choice(
          n + 1, std::vector<int32_t>(kmax + 1, -1));
      best[0][0] = {0.0, 0};
      for (int s = 1; s <= kmax; ++s) {
        int cd = (s - 1) % n_dev;
        double cap = g.node_mem[cd] - reserved[cd];
        for (int j = s; j <= n; ++j) {
          std::fill(inparams.begin(), inparams.end(), 0);
          double pg = 0.0, act = 0.0;
          for (int i = j - 1; i >= s - 1; --i) {
            for (int p : gparams[remaining[i]])
              if (!inparams[p]) {
                inparams[p] = 1;
                pg += g.param_gb[p];
              }
            act = std::max(act, activ[remaining[i]]);
            if (pg + act > cap + 1e-9) break;
            if (best[i][s - 1].first >= INF) continue;
            double cost = std::max(prefix[j] - prefix[i], pg / host);
            Cost cand;
            if (cost > best[i][s - 1].first) {
              cand = {cost, 1};
            } else if (cost == best[i][s - 1].first) {
              cand = {best[i][s - 1].first, best[i][s - 1].second + 1};
            } else {
              cand = best[i][s - 1];
            }
            if (cand < best[j][s]) {
              best[j][s] = cand;
              choice[j][s] = i;
            }
          }
        }
      }
      int s_best = -1;
      for (int s = 1; s <= kmax; ++s)
        if (best[n][s].first < INF &&
            (s_best < 0 || best[n][s] < best[n][s_best]))
          s_best = s;
      if (s_best <= 0) return {};
      std::vector<int32_t> bounds(s_best + 1, 0);
      bounds[s_best] = n;
      int j = n;
      for (int t = s_best; t > 0; --t) {
        j = choice[j][t];
        bounds[t - 1] = j;
      }
      return bounds;
    };

    // virtual-stage sweep (PipelineStageScheduler.run_policy): cost every
    // interleave depth with the event simulation, keep the best (strictly
    // lower makespan; ties prefer the shallower, more contiguous plan)
    int vmax = std::max(1, std::min(4, (n + n_dev - 1) / n_dev));
    std::vector<std::vector<int32_t>> candidates;
    for (int v = 1; v <= vmax; ++v) {
      std::vector<int32_t> bounds = plan(std::min(n, v * n_dev));
      if (bounds.empty()) continue;
      std::vector<int32_t> cand = stage_of_group;  // parked entries kept
      int s_cnt = (int)bounds.size() - 1;
      for (int s = 0; s < s_cnt; ++s)
        for (int i = bounds[s]; i < bounds[s + 1]; ++i)
          cand[remaining[i]] = s % n_dev;
      if (v > 1) {
        // per-device union feasibility (_fits_per_device): the DP checks
        // stages in isolation; v stages sharing a device must fit jointly
        std::vector<std::vector<uint8_t>> u(
            n_dev, std::vector<uint8_t>(g.n_params, 0));
        std::vector<double> act(n_dev, 0.0);
        for (int gi = 0; gi < n_groups; ++gi) {
          int d = cand[gi];
          if (d < 0) continue;
          for (int p : gparams[gi]) u[d][p] = 1;
          act[d] = std::max(act[d], activ[gi]);
        }
        bool ok = true;
        for (int d = 0; d < n_dev && ok; ++d) {
          double pg = 0.0;  // ascending id == sorted-name order (parity)
          for (int p = 0; p < g.n_params; ++p)
            if (u[d][p]) pg += g.param_gb[p];
          if (pg + act[d] > g.node_mem[d] + 1e-9) ok = false;
        }
        if (!ok) continue;
      }
      candidates.push_back(std::move(cand));
    }
    if (!candidates.empty()) {
      if (candidates.size() == 1) {
        stage_of_group = candidates[0];  // nothing to compare; skip the sim
      } else {
        double best_cost = 0.0;
        int best_i = -1;
        for (size_t ci = 0; ci < candidates.size(); ++ci) {
          std::vector<int32_t> cassign(g.n_tasks, -1);
          for (int t = 0; t < g.n_tasks; ++t)
            cassign[t] = candidates[ci][group_ids[t]];
          EventOrder eo = event_order(g, cassign, topo, link3);
          if (best_i < 0 || eo.makespan < best_cost) {
            best_i = (int)ci;
            best_cost = eo.makespan;
          }
        }
        stage_of_group = candidates[best_i];
      }
      // load-aware repack of parked groups (sched/pipeline.py
      // _rebalance_parked): greedily move them onto devices minimizing
      // the resulting param-union load, adopt only on strict improvement
      if (!parked_placed.empty() && !tail_parked) {
        std::vector<std::vector<uint8_t>> base(
            n_dev, std::vector<uint8_t>(g.n_params, 0));
        std::vector<double> bact(n_dev, 0.0);
        std::vector<uint8_t> is_parked(n_groups, 0);
        for (int gi : parked_placed) is_parked[gi] = 1;
        for (int gi = 0; gi < n_groups; ++gi) {
          if (is_parked[gi] || stage_of_group[gi] < 0) continue;
          int d = stage_of_group[gi];
          for (int p : gparams[gi]) base[d][p] = 1;
          bact[d] = std::max(bact[d], activ[gi]);
        }
        auto union_gb = [&](const std::vector<uint8_t>& m) {
          double sum = 0.0;  // ascending id == sorted-name order (parity)
          for (int p = 0; p < g.n_params; ++p)
            if (m[p]) sum += g.param_gb[p];
          return sum;
        };
        auto max_load = [&](const std::vector<int32_t>& assign) {
          std::vector<std::vector<uint8_t>> u = base;
          for (int gi : parked_placed)
            for (int p : gparams[gi]) u[assign[gi]][p] = 1;
          double m = 0.0;
          for (int d = 0; d < n_dev; ++d) m = std::max(m, union_gb(u[d]));
          return m;
        };
        std::vector<int32_t> orig(n_groups, -1), repack(n_groups, -1);
        for (int gi : parked_placed) orig[gi] = stage_of_group[gi];
        std::vector<int32_t> order2 = parked_placed;
        std::sort(order2.begin(), order2.end(), [&](int a, int b) {
          if (pg_of[a] != pg_of[b]) return pg_of[a] > pg_of[b];
          return a < b;  // Python's explicit (.., gi) tie-break
        });
        std::vector<std::vector<uint8_t>> acc = base;
        std::vector<double> aact = bact;
        bool ok = true;
        for (int gi : order2) {
          int best_d = -1;
          double best_lg = 0.0;
          for (int d = 0; d < n_dev; ++d) {
            std::vector<uint8_t> u = acc[d];
            for (int p : gparams[gi]) u[p] = 1;
            double lg = union_gb(u);
            if (lg + std::max(aact[d], activ[gi]) > g.node_mem[d] + 1e-9)
              continue;
            // ties prefer the LATER device (pipeline.py: lg <= best_load)
            // so parked loads don't queue ahead of early-stage weights
            if (best_d < 0 || lg <= best_lg) {
              best_d = d;
              best_lg = lg;
            }
          }
          if (best_d < 0) {
            ok = false;  // can't fit somewhere: keep the original parking
            break;
          }
          repack[gi] = best_d;
          for (int p : gparams[gi]) acc[best_d][p] = 1;
          aact[best_d] = std::max(aact[best_d], activ[gi]);
        }
        if (ok && max_load(repack) < max_load(orig) - 1e-12) {
          for (int gi : parked_placed) stage_of_group[gi] = repack[gi];
        }
      }
    } else {
      // greedy sequential fill with reserved-aware budgets
      int dev = 0;
      std::vector<uint8_t> held(g.n_params, 0);
      for (int idx = 0; idx < n; ++idx) {
        int gi = remaining[idx];
        while (dev < n_dev) {
          // union held | group params, summed in ascending (name) order
          double need = 0.0;
          std::vector<uint8_t> u = held;
          for (int p : gparams[gi]) u[p] = 1;
          for (int p = 0; p < g.n_params; ++p)
            if (u[p]) need += g.param_gb[p];
          double cap = g.node_mem[dev] - reserved[dev];
          if (need + activ[gi] <= cap + 1e-9) {
            held = u;
            break;
          }
          ++dev;
          std::fill(held.begin(), held.end(), 0);
        }
        stage_of_group[gi] = std::min(dev, n_dev - 1);
      }
    }
  }

  // assign in topo order; fail tasks whose deps failed or that don't fit
  for (int tid : topo) {
    if (!run.pending[tid]) continue;
    bool dep_failed = false;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      if (run.failed[g.dep_ids[k]]) dep_failed = true;
    if (dep_failed) {
      run.do_fail(tid);
      continue;
    }
    int node = stage_of_group[group_ids[tid]];
    if (node >= 0 && run.can_fit(tid, node)) {
      run.do_assign(tid, node);
    } else {
      run.do_fail(tid);
    }
  }

  // re-order for execution (sched/eventsim.py semantics)
  EventOrder eo = event_order(g, run.assign, topo, link3);
  run.order = std::move(eo.order);
}

// Group-pack planning (sched/pack.py GroupPackScheduler.plan): LPT packing
// of groups onto devices by resulting param-union load.  `placed` maps
// group -> device (-1: fits nowhere); `plan_order` lists the PLACED groups
// in placement order — the Python dict's insertion order, which the refine
// search's iteration order depends on.
struct PackPlan {
  std::vector<int32_t> placed;
  std::vector<int32_t> plan_order;
};

PackPlan pack_plan(const Graph& g, const GroupStats& st) {
  int n_dev = g.n_nodes;
  PackPlan plan;
  plan.placed.assign(st.n_groups, -1);

  std::vector<std::vector<uint8_t>> dev_params(
      n_dev, std::vector<uint8_t>(g.n_params, 0));
  std::vector<double> dev_act(n_dev, 0.0);

  auto union_gb = [&](const std::vector<uint8_t>& m) {
    double sum = 0.0;  // ascending id == sorted-name order (parity)
    for (int p = 0; p < g.n_params; ++p)
      if (m[p]) sum += g.param_gb[p];
    return sum;
  };

  // largest parameter footprint first (LPT), ties by group order
  std::vector<int32_t> order(st.n_groups);
  for (int gi = 0; gi < st.n_groups; ++gi) order[gi] = gi;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    if (st.pg_of[a] != st.pg_of[b]) return st.pg_of[a] > st.pg_of[b];
    return a < b;
  });
  for (int gi : order) {
    int best_d = -1;
    double best_load = 0.0;
    for (int d = 0; d < n_dev; ++d) {
      std::vector<uint8_t> u = dev_params[d];
      for (int p : st.gparams[gi]) u[p] = 1;
      double lg = union_gb(u);
      if (lg + std::max(dev_act[d], st.activ[gi]) > g.node_mem[d] + 1e-9)
        continue;
      if (best_d < 0 || lg < best_load) {
        best_d = d;
        best_load = lg;
      }
    }
    if (best_d < 0) continue;  // group fits nowhere: its tasks fail below
    plan.placed[gi] = best_d;
    plan.plan_order.push_back(gi);
    for (int p : st.gparams[gi]) dev_params[best_d][p] = 1;
    dev_act[best_d] = std::max(dev_act[best_d], st.activ[gi]);
  }
  return plan;
}

// GroupPackScheduler.commit: assign per group placement in topo order with
// the state machine's memory checks, then event-order the execution.
void pack_commit(Run& run, const std::vector<int32_t>& placed,
                 const int32_t* group_ids, const double* link3,
                 const std::vector<int32_t>& topo) {
  const Graph& g = run.g;
  for (int tid : topo) {
    if (!run.pending[tid]) continue;
    bool dep_failed = false;
    for (int k = g.dep_off[tid]; k < g.dep_off[tid + 1]; ++k)
      if (run.failed[g.dep_ids[k]]) dep_failed = true;
    if (dep_failed) {
      run.do_fail(tid);
      continue;
    }
    int node = placed[group_ids[tid]];
    if (node >= 0 && run.can_fit(tid, node)) {
      run.do_assign(tid, node);
      continue;
    }
    // spill (sched/pack.py spill_pick): a task whose group fit nowhere
    // whole degrades to singleton placement — min new-param-bytes device
    // that fits, ties to the lower index (strict < over ascending scan)
    int best = -1;
    double best_req = 0.0;
    for (int d = 0; d < g.n_nodes; ++d) {
      double req = run.mem_requirement(tid, d);
      if (req > run.avail[d] + 1e-9) continue;
      if (best < 0 || req < best_req) {
        best = d;
        best_req = req;
      }
    }
    if (best >= 0) {
      run.do_assign(tid, best);
    } else {
      run.do_fail(tid);
    }
  }
  EventOrder eo = event_order(g, run.assign, topo, link3);
  run.order = std::move(eo.order);
}

// Group-pack policy (sched/pack.py): non-contiguous LPT packing of groups
// onto devices by resulting param-union load, then event-ordered execution.
void run_pack(Run& run, const double* link3, const int32_t* group_ids) {
  const Graph& g = run.g;
  std::vector<int32_t> topo = g.toposort();
  GroupStats st = group_stats(g, group_ids);
  PackPlan plan = pack_plan(g, st);
  pack_commit(run, plan.placed, group_ids, link3, topo);
}

// ---------------------------------------------------------------------------
// CPython-compatible Mersenne Twister.  The refine policy's basin hopping
// uses random.Random(0) (sched/refine.py) — bit-identical parity requires
// reproducing CPython's MT19937 exactly: init_by_array seeding over the
// seed int's 32-bit digits, getrandbits(k) = genrand() >> (32-k), and
// _randbelow's rejection sampling.  Reference implementation per
// Matsumoto & Nishimura (the same code CPython vendors).
// ---------------------------------------------------------------------------

struct PyMT {
  static constexpr int N = 624, M = 397;
  uint32_t mt[N];
  int mti = N + 1;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < N; mti++)
      mt[mti] = 1812433253U * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + mti;
  }

  // CPython random_seed(int n): key = |n|'s little-endian 32-bit digits
  // (key [0] for n == 0), then init_by_array
  explicit PyMT(uint32_t seed_int) {
    uint32_t key[1] = {seed_int};  // seeds < 2^32 are a single digit
    init_genrand(19650218U);
    int i = 1, j = 0;
    int k = N > 1 ? N : 1;
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525U)) +
              key[j] + j;
      i++; j++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
      if (j >= 1) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941U)) - i;
      i++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
    }
    mt[0] = 0x80000000U;
    mti = N;
  }

  uint32_t genrand() {
    uint32_t y;
    if (mti >= N) {
      static const uint32_t mag01[2] = {0U, 0x9908b0dfU};
      int kk;
      for (kk = 0; kk < N - M; kk++) {
        y = (mt[kk] & 0x80000000U) | (mt[kk + 1] & 0x7fffffffU);
        mt[kk] = mt[kk + M] ^ (y >> 1) ^ mag01[y & 1U];
      }
      for (; kk < N - 1; kk++) {
        y = (mt[kk] & 0x80000000U) | (mt[kk + 1] & 0x7fffffffU);
        mt[kk] = mt[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 1U];
      }
      y = (mt[N - 1] & 0x80000000U) | (mt[0] & 0x7fffffffU);
      mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ mag01[y & 1U];
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680U;
    y ^= (y << 15) & 0xefc60000U;
    y ^= (y >> 18);
    return y;
  }

  uint32_t getrandbits(int k) { return genrand() >> (32 - k); }

  // Random._randbelow_with_getrandbits: rejection-sample k-bit draws
  uint32_t randbelow(uint32_t n) {
    int k = 0;
    for (uint32_t v = n; v; v >>= 1) ++k;  // n.bit_length()
    uint32_t r = getrandbits(k);
    while (r >= n) r = getrandbits(k);
    return r;
  }
};

// ---------------------------------------------------------------------------
// Refine policy (sched/refine.py RefinedPackScheduler): hill-climbed group
// placement — pack's LPT plan as the seed, the event simulation as the
// objective, first-improvement moves/swaps off the bottleneck device, then
// seeded basin hopping with the remaining evaluation budget.
// node_rank / group_rank: lexicographic ranks of node ids and group names
// (the Python tie-breaks compare the STRINGS; the flattened graph only has
// indices, so the ranks cross the ABI).
// ---------------------------------------------------------------------------

void run_refine(Run& run, const double* link3, const int32_t* group_ids,
                const int32_t* node_rank, const int32_t* group_rank) {
  const Graph& g = run.g;
  const int n_dev = g.n_nodes;
  constexpr int MAX_EVALS = 400;   // RefinedPackScheduler defaults
  constexpr double TOL = 1e-9;
  std::vector<int32_t> topo = g.toposort();
  GroupStats st = group_stats(g, group_ids);
  PackPlan plan = pack_plan(g, st);

  if (plan.plan_order.empty() || n_dev <= 1) {
    pack_commit(run, plan.placed, group_ids, link3, topo);
    return;
  }

  auto union_of_group = [&](int gi) { return st.pg_of[gi]; };

  // fits(assign, d): union of member groups' params + max member
  // activation within the device budget (sorted-name == ascending-id sum)
  std::vector<uint8_t> pmask(g.n_params);
  auto fits = [&](const std::vector<int32_t>& assign, int d) {
    std::fill(pmask.begin(), pmask.end(), 0);
    double act = 0.0;
    for (int gi : plan.plan_order) {
      if (assign[gi] != d) continue;
      for (int p : st.gparams[gi]) pmask[p] = 1;
      act = std::max(act, st.activ[gi]);
    }
    double sum = 0.0;
    for (int p = 0; p < g.n_params; ++p)
      if (pmask[p]) sum += g.param_gb[p];
    return sum + act <= g.node_mem[d] + 1e-9;
  };

  std::vector<int32_t> task_assign(g.n_tasks);
  auto evaluate = [&](const std::vector<int32_t>& assign) {
    for (int t = 0; t < g.n_tasks; ++t) {
      int gi = group_ids[t];
      task_assign[t] = plan.placed[gi] >= 0 ? assign[gi] : -1;
    }
    return event_order(g, task_assign, topo, link3);
  };

  int evals = 0;

  // First-improvement hill climbing from one placement (refine.py climb)
  auto climb = [&](std::vector<int32_t> cur, double cur_m,
                   EventOrder nf) {
    bool improved = true;
    while (improved && evals < MAX_EVALS) {
      improved = false;
      // bottleneck device: max (finish, node_id) — rank breaks ties
      int b_idx = -1;
      for (int d = 0; d < n_dev; ++d) {
        if (!nf.node_used[d]) continue;
        if (b_idx < 0 || nf.node_finish[d] > nf.node_finish[b_idx] ||
            (nf.node_finish[d] == nf.node_finish[b_idx] &&
             node_rank[d] > node_rank[b_idx]))
          b_idx = d;
      }
      if (b_idx < 0) break;  // nothing placed (cannot happen: plan known)
      // groups on the bottleneck, heaviest param union first; stable ties
      // keep plan-insertion order (Python dict iteration)
      std::vector<int32_t> hot;
      for (int gi : plan.plan_order)
        if (cur[gi] == b_idx) hot.push_back(gi);
      std::stable_sort(hot.begin(), hot.end(), [&](int a, int b) {
        return union_of_group(a) > union_of_group(b);
      });
      // lighter devices first as destinations; stable ties keep index
      std::vector<int32_t> dests(n_dev);
      for (int d = 0; d < n_dev; ++d) dests[d] = d;
      std::stable_sort(dests.begin(), dests.end(), [&](int a, int b) {
        double fa = nf.node_used[a] ? nf.node_finish[a] : 0.0;
        double fb = nf.node_used[b] ? nf.node_finish[b] : 0.0;
        return fa < fb;
      });
      for (int gi : hot) {
        if (evals >= MAX_EVALS || improved) break;
        for (int d : dests) {
          if (d == b_idx) continue;
          // move gi -> d
          std::vector<int32_t> cand = cur;
          cand[gi] = d;
          if (fits(cand, d)) {
            EventOrder r = evaluate(cand);
            ++evals;
            if (r.makespan < cur_m - TOL) {
              cur = std::move(cand);
              cur_m = r.makespan;
              nf = std::move(r);
              improved = true;
              break;
            }
            if (evals >= MAX_EVALS) break;
          }
          // swap gi <-> lightest group on d (first minimal in plan order)
          int g2 = -1;
          for (int gj : plan.plan_order) {
            if (cur[gj] != d) continue;
            if (g2 < 0 || union_of_group(gj) < union_of_group(g2)) g2 = gj;
          }
          if (g2 < 0) continue;
          std::vector<int32_t> swp = cur;
          swp[gi] = d;
          swp[g2] = b_idx;
          if (fits(swp, d) && fits(swp, b_idx)) {
            EventOrder r = evaluate(swp);
            ++evals;
            if (r.makespan < cur_m - TOL) {
              cur = std::move(swp);
              cur_m = r.makespan;
              nf = std::move(r);
              improved = true;
              break;
            }
            if (evals >= MAX_EVALS) break;
          }
        }
      }
    }
    struct { std::vector<int32_t> a; double m; } out{std::move(cur), cur_m};
    return out;
  };

  EventOrder seed_r = evaluate(plan.placed);
  ++evals;
  auto best0 = climb(plan.placed, seed_r.makespan, std::move(seed_r));
  std::vector<int32_t> best = std::move(best0.a);
  double best_m = best0.m;

  // basin hopping (refine.py): perturb by up to 3 random feasible group
  // moves under random.Random(0), re-climb, keep the global best
  PyMT rng(0);
  // glist = sorted(best): placed group names in lexicographic order
  std::vector<int32_t> glist(plan.plan_order);
  std::stable_sort(glist.begin(), glist.end(), [&](int a, int b) {
    return group_rank[a] < group_rank[b];
  });
  int stale = 0;
  while (evals + 2 < MAX_EVALS && !glist.empty() && stale < 10) {
    std::vector<int32_t> cand = best;
    for (int step = 0; step < 3; ++step) {
      int gi = glist[rng.randbelow((uint32_t)glist.size())];
      int d = (int)rng.randbelow((uint32_t)n_dev);
      if (d != cand[gi]) {
        std::vector<int32_t> moved = cand;
        moved[gi] = d;
        if (fits(moved, d)) cand = std::move(moved);
      }
    }
    if (cand == best) {
      ++stale;  // every proposed move was infeasible
      continue;
    }
    stale = 0;
    EventOrder r = evaluate(cand);
    ++evals;
    auto res = climb(std::move(cand), r.makespan, std::move(r));
    if (res.m < best_m - TOL) {
      best = std::move(res.a);
      best_m = res.m;
    }
  }

  pack_commit(run, best, group_ids, link3, topo);
}

}  // namespace

extern "C" {

// Returns 0 on success; -1 on bad policy id; -2 if a group policy
// (pipeline/pack/refine) is called without group_ids; -3 if refine lacks
// node_rank/group_rank.  out_assign[t] = node index or -1 (failed);
// out_order = task indices in final global assignment order, length via
// *out_n_assigned.  group_ids: per-task group index (first-appearance order
// over the topo sort), required for the group policies, NULL otherwise.
// out_gb: per-task consumer-visible output GB (TaskGraph.output_gb) for
// cross-node transfer charges; NULL falls back to task_mem.  node_rank /
// group_rank: lexicographic ranks of node ids / group names (refine's
// string tie-breaks), NULL except for refine.
int dls_schedule(int policy, int n_tasks, int n_params, int n_nodes,
                 const double* task_mem, const double* task_time,
                 const double* out_gb,
                 const int32_t* dep_off, const int32_t* dep_ids,
                 const int32_t* par_off, const int32_t* par_ids,
                 const double* param_gb, const double* node_mem,
                 const double* node_speed, const double* link3,
                 const int32_t* group_ids,
                 const int32_t* node_rank, const int32_t* group_rank,
                 int32_t* out_assign, int32_t* out_order,
                 int32_t* out_n_assigned) {
  Graph g;
  g.n_tasks = n_tasks;
  g.n_params = n_params;
  g.n_nodes = n_nodes;
  g.task_mem = task_mem;
  g.task_time = task_time;
  g.out_gb = out_gb != nullptr ? out_gb : task_mem;
  g.dep_off = dep_off;
  g.dep_ids = dep_ids;
  g.par_off = par_off;
  g.par_ids = par_ids;
  g.param_gb = param_gb;
  g.node_mem = node_mem;
  g.node_speed = node_speed;
  g.build_dependents();

  Run run(g);
  switch (policy) {
    case 0: run_roundrobin(run); break;
    case 1: run_dfs(run); break;
    case 2: run_greedy(run); break;
    case 3: run_critical(run); break;
    case 4: run_mru(run); break;
    case 5: run_heft(run, link3); break;
    case 6:
      if (group_ids == nullptr) return -2;
      run_pipeline(run, link3, group_ids);
      break;
    case 7:
      if (group_ids == nullptr) return -2;
      run_pack(run, link3, group_ids);
      break;
    case 8:
      if (group_ids == nullptr) return -2;
      if (node_rank == nullptr || group_rank == nullptr) return -3;
      run_refine(run, link3, group_ids, node_rank, group_rank);
      break;
    default: return -1;
  }
  std::memcpy(out_assign, run.assign.data(), sizeof(int32_t) * n_tasks);
  *out_n_assigned = (int32_t)run.order.size();
  std::memcpy(out_order, run.order.data(),
              sizeof(int32_t) * run.order.size());
  return 0;
}

int dls_abi_version() { return 3; }

}  // extern "C"
