// Native host-side graph planner of the PyTorch port: the port's own copy of
// the JAX package's csrc/graph_planner.cpp, with the same four entry points,
// semantics and ABI version (1).
//
// The serving hot loop interleaves device scoring with host association /
// decode planning (trackmpnn_tpu_torch/graph/engine.py, the behavioural spec
// mirroring the reference's utils/graph.py).  The per-detection loops there
// are the host's cost, and the numpy decode walks every detection of the
// sequence at each decode; this library runs them natively:
//
//   * greedy association (nearest-future-frame, highest-probability edge)
//   * per-frame Hungarian association with a built-in O(n^3)
//     shortest-augmenting-path LSA solver (replaces scipy)
//   * teacher-forced association (training)
//   * decode: track chain-walking + prefix-deletion/retention planning
//
// Exposed as a C ABI consumed via ctypes (trackmpnn_tpu_torch/graph/
// native.py, which builds it with g++ into build/torch_kernels/); the numpy
// engine stays the reference (TM_NATIVE=0 selects it), and the tests fuzz
// both for exact agreement.
//
// Row conventions (identical to engine.py): ts[i] == -1 marks an
// association ("edge") row; edges carry past/fut row indices of their
// detection endpoints; rows are in reference append order, so an edge's
// "frame" is ts[fut[e]] and candidate edges of one frame form contiguous
// blocks in row order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kBigCost = 100.0;

// Dense square LSA: shortest augmenting path (Jonker-Volgenant style).
// cost is n x n row-major. Returns assignment row -> col in match_row.
void solve_lsa(int n, const std::vector<double>& cost, std::vector<int>& match_row) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else { minv[j] -= delta; }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
  }
  match_row.assign(n, -1);
  for (int j = 1; j <= n; ++j)
    if (p[j] > 0) match_row[p[j] - 1] = j - 1;
}

struct Adjacency {
  // edges grouped by past endpoint, in row order
  std::vector<std::vector<int64_t>> fut_edges_of;
  std::vector<std::vector<int64_t>> past_edges_of;  // grouped by future endpoint
};

Adjacency build_adjacency(int64_t n, const int64_t* ts, const int64_t* past,
                          const int64_t* fut) {
  Adjacency a;
  a.fut_edges_of.resize(n);
  a.past_edges_of.resize(n);
  for (int64_t e = 0; e < n; ++e) {
    if (ts[e] != -1) continue;
    if (past[e] >= 0) a.fut_edges_of[past[e]].push_back(e);
    if (fut[e] >= 0) a.past_edges_of[fut[e]].push_back(e);
  }
  return a;
}

}  // namespace

extern "C" {

// Greedy prediction-driven association (engine.associate_greedy;
// ref graph.py:251-268).  p: per-row positive probability.  ass_id is
// overwritten (-1 everywhere first).
void tm_associate_greedy(int64_t n, const int64_t* ts, const int64_t* det_id,
                         const int64_t* past, const int64_t* fut,
                         const float* p, int64_t* ass_id) {
  Adjacency adj = build_adjacency(n, ts, past, fut);
  for (int64_t i = 0; i < n; ++i) ass_id[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (ts[i] == -1 || p[i] < 0.5f) continue;
    int64_t nearest = -1;
    int64_t best = -1;
    float best_p = -1.0f;
    for (int64_t e : adj.fut_edges_of[i]) {
      if (p[e] < 0.5f || p[fut[e]] < 0.5f) continue;
      int64_t frame = ts[fut[e]];
      if (nearest == -1) nearest = frame;           // lowest row = nearest
      if (frame != nearest) continue;
      if (p[e] > best_p) { best_p = p[e]; best = e; }  // ties: lowest row
    }
    if (best >= 0) ass_id[i] = det_id[fut[best]];
  }
}

// Teacher-forced association (engine.associate_teacher_forced;
// ref graph.py:229-245).  Returns 0 on success, -1 on the "more than one
// GT edge" invariant violation.
int tm_associate_teacher(int64_t n, const int64_t* ts, const int64_t* det_id,
                         const int64_t* past, const int64_t* fut,
                         const int64_t* label, int64_t* ass_id) {
  Adjacency adj = build_adjacency(n, ts, past, fut);
  for (int64_t i = 0; i < n; ++i) ass_id[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (ts[i] == -1) continue;
    if (label[i] == 1) {
      int64_t pos = -1;
      for (int64_t e : adj.fut_edges_of[i]) {
        if (label[e] == 1) {
          if (pos >= 0) return -1;
          pos = e;
        }
      }
      if (pos >= 0) ass_id[i] = det_id[fut[pos]];
    } else {
      ass_id[i] = det_id[i];
    }
  }
  return 0;
}

// Frame-by-frame Hungarian association (engine.associate_hungarian;
// ref graph.py:33-93, 247-249).  p0: per-row cost column (1 - p).
void tm_associate_hungarian(int64_t n, const int64_t* ts, const int64_t* det_id,
                            const int64_t* past, const int64_t* fut,
                            const float* p0, int64_t* ass_id,
                            double threshold) {
  Adjacency adj = build_adjacency(n, ts, past, fut);
  for (int64_t i = 0; i < n; ++i) ass_id[i] = -1;
  if (n == 0) return;
  int64_t t_lo = ts[0], t_hi = ts[n - 1];
  for (int64_t t = t_lo; t <= t_hi; ++t) {
    std::vector<int64_t> idx_t;
    for (int64_t i = 0; i < n; ++i)
      if (ts[i] == t) idx_t.push_back(i);
    if (idx_t.empty()) continue;
    // unassociated past endpoints connected into frame t, unique by row
    std::vector<int64_t> idx_prev;
    {
      std::vector<char> seen(n, 0);
      for (int64_t d : idx_t)
        for (int64_t e : adj.past_edges_of[d]) {
          int64_t pr = past[e];
          if (pr >= 0 && !seen[pr]) { seen[pr] = 1; idx_prev.push_back(pr); }
        }
      std::sort(idx_prev.begin(), idx_prev.end());
      idx_prev.erase(
          std::remove_if(idx_prev.begin(), idx_prev.end(),
                         [&](int64_t r) { return ass_id[r] != -1; }),
          idx_prev.end());
    }
    if (idx_prev.empty()) continue;

    int R = (int)idx_prev.size(), C = (int)idx_t.size();
    int N = std::max(R, C);
    std::vector<double> cost((size_t)N * N, kBigCost);
    std::vector<int> col_of(n, -1), row_of(n, -1);
    for (int j = 0; j < C; ++j) col_of[idx_t[j]] = j;
    for (int i = 0; i < R; ++i) row_of[idx_prev[i]] = i;
    for (int64_t d : idx_t)
      for (int64_t e : adj.past_edges_of[d]) {
        int i = past[e] >= 0 ? row_of[past[e]] : -1;
        if (i >= 0) cost[(size_t)i * N + col_of[d]] = (double)p0[e];
      }
    std::vector<int> match;
    solve_lsa(N, cost, match);
    for (int i = 0; i < R; ++i) {
      int j = match[i];
      if (j < 0 || j >= C) continue;
      if (cost[(size_t)i * N + j] > threshold) continue;
      ass_id[idx_prev[i]] = det_id[idx_t[j]];
    }
  }
}

// Decode planning (engine.decode_tracks after association;
// ref graph.py:456-520): walk association chains assigning track ids into
// y_out[:, 1], then compute the kept-row list.
//
// y_out: [num_dets, 2] row-major (frame, track).  keep_out: caller buffer
// of capacity n; returns number of kept rows.
int64_t tm_decode_plan(int64_t n, const int64_t* ts, const int64_t* det_id,
                       const int64_t* ass_id, const int64_t* past,
                       const int64_t* fut, const float* p,
                       int64_t num_dets, int64_t* y_out,
                       int64_t t_upto, int64_t ret_win, int64_t* keep_out) {
  // det_id -> row map
  std::vector<int64_t> row_of(num_dets, -1);
  for (int64_t i = 0; i < n; ++i)
    if (ts[i] != -1 && det_id[i] >= 0 && det_id[i] < num_dets) row_of[det_id[i]] = i;

  int64_t next_track = 0;
  for (int64_t d = 0; d < num_dets; ++d)
    next_track = std::max(next_track, y_out[2 * d + 1] + 1);

  std::vector<char> visited(num_dets, 0);
  for (int64_t start = 0; start < num_dets; ++start) {
    int64_t d = start;
    int64_t node = row_of[d];
    if (node < 0) { visited[d] = 1; continue; }
    if (ts[node] >= t_upto || p[node] < 0.5f) { visited[d] = 1; continue; }
    if (visited[d]) continue;
    int64_t track = y_out[2 * d + 1] == -1 ? next_track++ : y_out[2 * d + 1];
    while (true) {
      visited[d] = 1;
      y_out[2 * d + 1] = track;
      int64_t nxt = ass_id[node];
      if (nxt == -1) break;
      if (y_out[2 * d] >= t_upto && y_out[2 * nxt] >= t_upto) break;
      d = nxt;
      node = row_of[d];
      if (node < 0) break;  // defensive; reference assumes chain stays live
    }
  }

  // prefix deletion with retain-window re-id candidates
  int64_t max_id = 0;
  for (int64_t i = 0; i < n; ++i)
    if (ts[i] != -1 && ts[i] < t_upto) max_id = i + 1;
  std::vector<char> del(n, 0);
  for (int64_t i = 0; i < max_id; ++i) del[i] = 1;
  for (int64_t i = 0; i < max_id; ++i) {
    if (ts[i] == -1) continue;
    if (ass_id[i] == -1 && p[i] >= 0.5f && ts[i] >= t_upto - ret_win) {
      del[i] = 0;  // retained unassociated TP
    } else {
      for (int64_t e = max_id; e < n; ++e)
        if (ts[e] == -1 && (past[e] == i || fut[e] == i)) del[e] = 1;
    }
  }
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i)
    if (!del[i]) keep_out[kept++] = i;
  return kept;
}

int tm_abi_version() { return 1; }

}  // extern "C"
