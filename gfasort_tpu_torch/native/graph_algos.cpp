// Native host graph passes: exact-ODGI topological sort and groom BFS.
//
// Bit-identical ports of gfasort_tpu_torch/algos/{topo,groom}.py (which are
// themselves O(E log V) equivalents of the reference's quadratic passes,
// gfasort src/graph_ops.rs:1232-1485 and src/groom.rs:56-275).  The
// Python implementations remain the semantic definition; randomized
// equivalence tests pin this port against them.
//
// Handle encoding: id<<1 | is_reverse (src/graph.rs:11-64).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <vector>

namespace {

using std::vector;

static inline int64_t node_id(int64_t h) { return h >> 1; }
static inline int64_t flip(int64_t h) { return h ^ 1; }
static inline bool is_rev(int64_t h) { return h & 1; }

// Deterministic per-handle adjacency over the stored edge forms
// (algos/adjacency.py).  Edges sorted by (from, to); per-handle edge
// lists in ascending edge-index order (== Python dict-append order).
struct Adjacency {
  vector<int64_t> ef, et;     // sorted stored edge forms
  vector<int64_t> out_off, in_off;   // CSR offsets over handle space
  vector<int32_t> out_idx, in_idx;   // edge indices
  int64_t n_handles = 0;

  void build(int64_t n_edges, const int64_t* e_from, const int64_t* e_to,
             int64_t max_id) {
    n_handles = 2 * (max_id + 1);
    vector<std::pair<int64_t, int64_t>> pairs(n_edges);
    for (int64_t i = 0; i < n_edges; i++) pairs[i] = {e_from[i], e_to[i]};
    std::sort(pairs.begin(), pairs.end());
    ef.resize(n_edges);
    et.resize(n_edges);
    for (int64_t i = 0; i < n_edges; i++) {
      ef[i] = pairs[i].first;
      et[i] = pairs[i].second;
    }
    // count, then fill (ascending i keeps per-handle lists sorted by
    // edge index, matching the Python append order)
    vector<int32_t> out_cnt(n_handles, 0), in_cnt(n_handles, 0);
    for (int64_t i = 0; i < n_edges; i++) {
      int64_t f = ef[i], t = et[i];
      out_cnt[f]++;
      int64_t tf = flip(t);
      if (tf != f) out_cnt[tf]++;
      in_cnt[t]++;
      int64_t ff = flip(f);
      if (ff != t) in_cnt[ff]++;
    }
    out_off.assign(n_handles + 1, 0);
    in_off.assign(n_handles + 1, 0);
    for (int64_t h = 0; h < n_handles; h++) {
      out_off[h + 1] = out_off[h] + out_cnt[h];
      in_off[h + 1] = in_off[h] + in_cnt[h];
    }
    out_idx.resize(out_off[n_handles]);
    in_idx.resize(in_off[n_handles]);
    vector<int64_t> opos(out_off.begin(), out_off.end() - 1);
    vector<int64_t> ipos(in_off.begin(), in_off.end() - 1);
    for (int64_t i = 0; i < n_edges; i++) {
      int64_t f = ef[i], t = et[i];
      out_idx[opos[f]++] = (int32_t)i;
      int64_t tf = flip(t);
      if (tf != f) out_idx[opos[tf]++] = (int32_t)i;
      in_idx[ipos[t]++] = (int32_t)i;
      int64_t ff = flip(f);
      if (ff != t) in_idx[ipos[ff]++] = (int32_t)i;
    }
  }

  // successor handle following edge ei out of h
  inline int64_t next_handle(int64_t ei, int64_t h) const {
    return ef[ei] == h ? et[ei] : flip(ef[ei]);
  }
  // node id of the source of an edge incoming to h
  inline int64_t incoming_source_node(int64_t ei, int64_t h) const {
    return et[ei] == h ? node_id(ef[ei]) : node_id(et[ei]);
  }
};

// node_id -> earliest step rank in any path (algos/topo.py:32-41);
// missing = INT64_MAX.
static void path_position_map(int64_t n_steps, const int64_t* steps,
                              int64_t n_paths, const int64_t* path_off,
                              int64_t max_id, vector<int64_t>& pos) {
  pos.assign(max_id + 1, INT64_MAX);
  for (int64_t p = 0; p < n_paths; p++) {
    int64_t rank = 0;
    for (int64_t s = path_off[p]; s < path_off[p + 1]; s++, rank++) {
      int64_t nid = steps[s] >> 1;
      if (rank < pos[nid]) pos[nid] = rank;
    }
  }
}

// Forward handles with no edge entering their left side, sorted by
// (earliest path position, node id) (algos/topo.py:44-64).
static void find_heads(int64_t n_edges, const int64_t* e_from,
                       const int64_t* e_to, int64_t n_live,
                       const int64_t* live_ids, int64_t max_id,
                       int64_t n_steps, const int64_t* steps,
                       int64_t n_paths, const int64_t* path_off,
                       vector<int64_t>& heads) {
  vector<uint8_t> has_left(max_id + 1, 0);
  for (int64_t i = 0; i < n_edges; i++) {
    if (!is_rev(e_to[i])) has_left[node_id(e_to[i])] = 1;
    if (is_rev(e_from[i])) has_left[node_id(e_from[i])] = 1;
  }
  vector<int64_t> pos;
  path_position_map(n_steps, steps, n_paths, path_off, max_id, pos);
  heads.clear();
  for (int64_t i = 0; i < n_live; i++)
    if (!has_left[live_ids[i]]) heads.push_back(live_ids[i]);
  std::stable_sort(heads.begin(), heads.end(), [&](int64_t a, int64_t b) {
    if (pos[a] != pos[b]) return pos[a] < pos[b];
    return a < b;
  });
  for (auto& h : heads) h <<= 1;  // forward handles
}

// Forward handles with no stored edge leaving their forward orientation
// (direct form only), sorted by node id (algos/topo.py:67-84).
static void find_tails(int64_t n_edges, const int64_t* e_from,
                       int64_t n_live, const int64_t* live_ids,
                       int64_t max_id, vector<int64_t>& tails) {
  vector<uint8_t> has_out(max_id + 1, 0);
  for (int64_t i = 0; i < n_edges; i++)
    if (!is_rev(e_from[i])) has_out[node_id(e_from[i])] = 1;
  tails.clear();
  for (int64_t i = 0; i < n_live; i++)
    if (!has_out[live_ids[i]]) tails.push_back(live_ids[i] << 1);
}

using MinHeap =
    std::priority_queue<int64_t, vector<int64_t>, std::greater<int64_t>>;

}  // namespace

extern "C" {

// Exact-ODGI topological order (algos/topo.py:87-193).  Writes forward
// handles in emission order to out_order; returns the count (== n_live)
// or -1 on error.
int64_t topo_exact_order(int64_t n_edges, const int64_t* e_from,
                         const int64_t* e_to, int64_t n_live,
                         const int64_t* live_ids, int64_t max_id,
                         int64_t n_steps, const int64_t* steps,
                         int64_t n_paths, const int64_t* path_off,
                         int32_t use_heads, int32_t use_tails,
                         int64_t* out_order) {
  if (n_live == 0) return 0;
  Adjacency adj;
  adj.build(n_edges, e_from, e_to, max_id);

  vector<uint8_t> live(max_id + 1, 0);
  for (int64_t i = 0; i < n_live; i++) live[live_ids[i]] = 1;

  // unvisited is per-node: both orientations always enter/leave the
  // ready set together (topo.py:134-137).
  vector<uint8_t> unvisited_node(max_id + 1, 0);
  for (int64_t i = 0; i < n_live; i++) unvisited_node[live_ids[i]] = 1;
  int64_t remaining = n_live;

  vector<uint8_t> visited(max_id + 1, 0);
  vector<uint8_t> masked(n_edges, 0);
  vector<int32_t> in_count(adj.n_handles, 0);
  for (int64_t h = 0; h < adj.n_handles; h++)
    in_count[h] = (int32_t)(adj.in_off[h + 1] - adj.in_off[h]);

  MinHeap s;
  MinHeap seeds;
  vector<uint8_t> in_seeds(adj.n_handles, 0);

  auto mask_edge = [&](int64_t ei) {
    if (masked[ei]) return;
    masked[ei] = 1;
    int64_t f = adj.ef[ei], t = adj.et[ei];
    in_count[t]--;
    int64_t ff = flip(f);
    if (ff != t) in_count[ff]--;
  };
  auto enqueue = [&](int64_t h) {
    s.push(h);
    int64_t nid = node_id(h);
    if (unvisited_node[nid]) {
      unvisited_node[nid] = 0;
      remaining--;
    }
  };

  if (use_heads) {
    vector<int64_t> heads;
    find_heads(n_edges, e_from, e_to, n_live, live_ids, max_id, n_steps,
               steps, n_paths, path_off, heads);
    for (int64_t h : heads) enqueue(h);
  } else if (use_tails) {
    vector<int64_t> tails;
    find_tails(n_edges, e_from, n_live, live_ids, max_id, tails);
    for (int64_t h : tails) enqueue(h);
  }

  int64_t n_out = 0;
  int64_t scan = 0;  // fallback cursor: min unvisited live node is monotone
  while (remaining > 0 || !s.empty()) {
    if (s.empty()) {
      // consume seeds min-first until one is still unvisited
      while (!seeds.empty() && s.empty()) {
        int64_t h = seeds.top();
        seeds.pop();
        in_seeds[h] = 0;
        if (unvisited_node[node_id(h)]) enqueue(h);
      }
      if (s.empty() && remaining > 0) {
        // min unvisited handle == forward of min unvisited node
        while (scan < n_live && !unvisited_node[live_ids[scan]]) scan++;
        enqueue(live_ids[scan] << 1);
      }
    }
    while (!s.empty()) {
      int64_t handle = s.top();
      s.pop();
      int64_t nid = node_id(handle);
      int64_t fwd = nid << 1;
      if (!visited[nid]) {
        visited[nid] = 1;
        out_order[n_out++] = fwd;
      }
      // mask incoming edges whose source node is already out of
      // unvisited (topo.py:169-177)
      for (int64_t k = adj.in_off[fwd]; k < adj.in_off[fwd + 1]; k++) {
        int64_t ei = adj.in_idx[k];
        if (masked[ei]) continue;
        int64_t src = adj.incoming_source_node(ei, fwd);
        if (!unvisited_node[src]) mask_edge(ei);
      }
      // follow outgoing edges from the FORWARD orientation
      for (int64_t k = adj.out_off[fwd]; k < adj.out_off[fwd + 1]; k++) {
        int64_t ei = adj.out_idx[k];
        if (masked[ei]) continue;
        mask_edge(ei);
        int64_t nxt = adj.next_handle(ei, fwd);
        if (unvisited_node[node_id(nxt)]) {
          if (in_count[nxt] == 0) {
            enqueue(nxt);
          } else if (!in_seeds[nxt]) {
            seeds.push(nxt);
            in_seeds[nxt] = 1;
          }
        }
      }
    }
  }
  return n_out;
}

// Groom (BFS / DFS): chosen orientation per live node, emitted in
// sorted-id order (algos/groom.py:68-191).  Seeds are the head nodes
// (fallback: lowest live id forward); multi-component restart scans
// live ids with a persistent cursor.  Returns n_live or -1.
int64_t groom_order(int64_t n_edges, const int64_t* e_from,
                    const int64_t* e_to, int64_t n_live,
                    const int64_t* live_ids, int64_t max_id,
                    int64_t n_steps, const int64_t* steps, int64_t n_paths,
                    const int64_t* path_off, int32_t use_bfs,
                    int64_t* out_handles) {
  if (n_live == 0) return 0;
  Adjacency adj;
  adj.build(n_edges, e_from, e_to, max_id);

  vector<uint8_t> visited(max_id + 1, 0), flipped(max_id + 1, 0);
  int64_t n_visited = 0;

  vector<int64_t> seeds;
  find_heads(n_edges, e_from, e_to, n_live, live_ids, max_id, n_steps,
             steps, n_paths, path_off, seeds);
  if (seeds.empty()) seeds.push_back(live_ids[0] << 1);

  std::deque<int64_t> queue;
  vector<int64_t> stack, succ;

  auto successors = [&](int64_t cur) {
    succ.clear();
    for (int64_t k = adj.out_off[cur]; k < adj.out_off[cur + 1]; k++)
      succ.push_back(adj.next_handle(adj.out_idx[k], cur));
    std::sort(succ.begin(), succ.end());
  };
  auto visit = [&](int64_t h) {
    int64_t nid = node_id(h);
    visited[nid] = 1;
    n_visited++;
    if (is_rev(h)) flipped[nid] = 1;
  };

  int64_t scan = 0;
  bool have_seeds = true;
  while (n_visited < n_live || have_seeds) {
    if (!have_seeds) {
      while (scan < n_live && visited[live_ids[scan]]) scan++;
      if (scan == n_live) break;
      seeds.assign(1, live_ids[scan] << 1);
    }
    if (use_bfs) {
      // ODGI greedy BFS (groom.py:68-87)
      for (int64_t seed : seeds)
        if (!visited[node_id(seed)]) {
          visit(seed);
          queue.push_back(seed);
        }
      while (!queue.empty()) {
        int64_t cur = queue.front();
        queue.pop_front();
        successors(cur);
        for (int64_t nxt : succ)
          if (!visited[node_id(nxt)]) {
            visit(nxt);
            queue.push_back(nxt);
          }
      }
    } else {
      // plain DFS (groom.py:90-105)
      stack.assign(seeds.begin(), seeds.end());
      while (!stack.empty()) {
        int64_t cur = stack.back();
        stack.pop_back();
        if (visited[node_id(cur)]) continue;
        visit(cur);
        successors(cur);
        for (int64_t nxt : succ)
          if (!visited[node_id(nxt)]) stack.push_back(nxt);
      }
    }
    seeds.clear();
    have_seeds = false;
  }

  for (int64_t i = 0; i < n_live; i++) {
    int64_t nid = live_ids[i];
    out_handles[i] = (nid << 1) | (flipped[nid] ? 1 : 0);
  }
  return n_live;
}

// Priority topological sort (algos/priority_topo.py; reference
// src/graph_ops.rs:1492-1760).  Ready set keyed
// (rank, is_reverse, node_id); auto reverse mode when backward edges
// outnumber forward 2:1; post-pass reverses a majority-against output.
// priority is an array of node ids (rank = index, last occurrence
// wins, matching the Python dict build).  Returns the emitted count.
int64_t priority_topo_order(int64_t n_edges, const int64_t* e_from,
                            const int64_t* e_to, int64_t n_live,
                            const int64_t* live_ids, int64_t max_id,
                            int64_t n_steps, const int64_t* steps,
                            int64_t n_paths, const int64_t* path_off,
                            int64_t n_prio, const int64_t* priority,
                            int32_t use_heads, int32_t reverse_edges,
                            int64_t* out_order) {
  if (n_live == 0) return 0;
  Adjacency adj;
  adj.build(n_edges, e_from, e_to, max_id);

  const int64_t max_rank = n_prio;
  vector<int64_t> rank_of(max_id + 1, max_rank);
  for (int64_t i = 0; i < n_prio; i++)
    if (priority[i] >= 0 && priority[i] <= max_id) rank_of[priority[i]] = i;

  // reverse mode (count_edge_directions, graph.py:346-356)
  int64_t fwd_cnt = 0, bwd_cnt = 0;
  for (int64_t i = 0; i < n_edges; i++) {
    int64_t a = node_id(e_from[i]), b = node_id(e_to[i]);
    if (a < b) fwd_cnt++;
    else if (a > b) bwd_cnt++;
  }
  const bool reverse_mode = reverse_edges || (bwd_cnt > fwd_cnt * 2);

  // in/out swap under reverse mode
  const auto& in_off = reverse_mode ? adj.out_off : adj.in_off;
  const auto& in_idx = reverse_mode ? adj.out_idx : adj.in_idx;
  const auto& out_off = reverse_mode ? adj.in_off : adj.out_off;
  const auto& out_idx = reverse_mode ? adj.in_idx : adj.out_idx;

  vector<uint8_t> unvisited_node(max_id + 1, 0);
  for (int64_t i = 0; i < n_live; i++) unvisited_node[live_ids[i]] = 1;
  int64_t remaining = n_live;

  vector<uint8_t> visited(max_id + 1, 0), masked(n_edges, 0);
  vector<int32_t> in_count(adj.n_handles, 0);
  for (int64_t h = 0; h < adj.n_handles; h++)
    in_count[h] = (int32_t)(in_off[h + 1] - in_off[h]);

  struct Key {
    int64_t rank;
    int64_t second;  // is_reverse for ready; seq for seeds
    int64_t third;   // node_id for ready; unused (0) for seeds
    int64_t handle;
    bool operator>(const Key& o) const {
      if (rank != o.rank) return rank > o.rank;
      if (second != o.second) return second > o.second;
      return third > o.third;
    }
  };
  using KeyHeap = std::priority_queue<Key, vector<Key>, std::greater<Key>>;
  KeyHeap s, seeds;
  vector<uint8_t> in_seeds(adj.n_handles, 0);
  int64_t seeds_seq = 0;

  auto mask_edge = [&](int64_t ei) {
    if (masked[ei]) return;
    masked[ei] = 1;
    int64_t f = adj.ef[ei], t = adj.et[ei];
    int64_t a = reverse_mode ? f : t;
    int64_t b = reverse_mode ? flip(t) : flip(f);
    in_count[a]--;
    if (b != a) in_count[b]--;
  };
  auto enqueue = [&](int64_t h) {
    s.push({rank_of[node_id(h)], (int64_t)(h & 1), node_id(h), h});
    int64_t nid = node_id(h);
    if (unvisited_node[nid]) {
      unvisited_node[nid] = 0;
      remaining--;
    }
  };

  if (use_heads) {
    vector<int64_t> inits;
    if (reverse_mode)
      find_tails(n_edges, e_from, n_live, live_ids, max_id, inits);
    else
      find_heads(n_edges, e_from, e_to, n_live, live_ids, max_id, n_steps,
                 steps, n_paths, path_off, inits);
    for (int64_t h : inits) enqueue(h);
  }

  // lazy fallback heap keyed (rank, is_rev, node_id); deterministic
  // tie-break by node id (the reference's HashSet min is undefined)
  KeyHeap unvisited_heap;
  {
    vector<Key> init;
    init.reserve(2 * n_live);
    for (int64_t i = 0; i < n_live; i++) {
      int64_t nid = live_ids[i];
      init.push_back({rank_of[nid], 0, nid, nid << 1});
      init.push_back({rank_of[nid], 1, nid, (nid << 1) | 1});
    }
    unvisited_heap = KeyHeap(std::greater<Key>(), std::move(init));
  }

  int64_t n_out = 0;
  while (remaining > 0 || !s.empty()) {
    if (s.empty()) {
      bool found_seed = false;
      if (!seeds.empty()) {
        Key k = seeds.top();
        seeds.pop();
        in_seeds[k.handle] = 0;
        if (unvisited_node[node_id(k.handle)]) {
          enqueue(k.handle);
          found_seed = true;
        }
      }
      if (!found_seed && s.empty() && remaining > 0) {
        while (!unvisited_node[node_id(unvisited_heap.top().handle)])
          unvisited_heap.pop();
        enqueue(unvisited_heap.top().handle);
      }
    }
    while (!s.empty()) {
      int64_t handle = s.top().handle;
      s.pop();
      int64_t nid = node_id(handle);
      if (!visited[nid]) {
        visited[nid] = 1;
        out_order[n_out++] = nid << 1;
      }
      // mask all "incoming" edges unconditionally (:1688-1693)
      for (int64_t k = in_off[handle]; k < in_off[handle + 1]; k++)
        mask_edge(in_idx[k]);
      // process "outgoing" edges (:1695-1726)
      for (int64_t k = out_off[handle]; k < out_off[handle + 1]; k++) {
        int64_t ei = out_idx[k];
        if (masked[ei]) continue;
        mask_edge(ei);
        // next handle: forward mode follows the edge out of `handle`,
        // reverse mode follows it backwards (prev_handle)
        int64_t nxt =
            reverse_mode
                ? (adj.et[ei] == handle ? adj.ef[ei] : flip(adj.et[ei]))
                : adj.next_handle(ei, handle);
        if (unvisited_node[node_id(nxt)]) {
          if (in_count[nxt] == 0) {
            enqueue(nxt);
          } else if (!in_seeds[nxt]) {
            seeds.push({rank_of[node_id(nxt)], (int64_t)(nxt & 1),
                        seeds_seq++, nxt});
            in_seeds[nxt] = 1;
          }
        }
      }
    }
  }

  // post-pass reversal (:1736-1757); skipped in reverse mode
  if (!reverse_mode && n_out > 0 && n_prio > 1) {
    int64_t in_order = 0, out_of_order = 0;
    for (int64_t i = 1; i < n_out; i++) {
      int64_t pr = rank_of[node_id(out_order[i - 1])];
      int64_t cr = rank_of[node_id(out_order[i])];
      if (pr < cr) in_order++;
      else out_of_order++;
    }
    if (out_of_order > in_order)
      std::reverse(out_order, out_order + n_out);
  }
  return n_out;
}

// Simple-component finder for unchop (algos/unchop.py:33-112; reference
// src/graph_ops.rs:128-287).  Scans handles in id order, extending a
// chain while the doubled adjacency stays 1-in/1-out and the
// path-successor ("perfect neighbors") test passes.  Writes chains
// flattened into out_chains with out_off[c]..out_off[c+1] per chain;
// returns the chain count, or -1 on error.
int64_t find_simple_components_native(
    int64_t n_edges, const int64_t* e_from, const int64_t* e_to,
    int64_t n_live, const int64_t* live_ids, int64_t max_id,
    int64_t n_steps, const int64_t* steps, int64_t n_paths,
    const int64_t* path_off, int64_t* out_chains, int64_t* out_off) {
  const int64_t H = 2 * (max_id + 1);

  // doubled adjacency degrees + the unique neighbor where degree == 1
  vector<int32_t> fdeg(H, 0), bdeg(H, 0);
  vector<int64_t> fnext(H, -1);
  for (int64_t i = 0; i < n_edges; i++) {
    int64_t f = e_from[i], t = e_to[i];
    fdeg[f]++;
    fnext[f] = t;
    bdeg[t]++;
    int64_t tf = flip(t), ff = flip(f);
    fdeg[tf]++;
    fnext[tf] = ff;
    bdeg[ff]++;
  }

  // path successor map: -2 absent, -1 conflict/path-final, else handle
  // (algos/unchop.py:33-52)
  vector<int64_t> succ(H, -2);
  for (int64_t p = 0; p < n_paths; p++) {
    for (int64_t s = path_off[p]; s < path_off[p + 1]; s++) {
      int64_t h = steps[s];
      int64_t nxt = (s + 1 < path_off[p + 1]) ? steps[s + 1] : -1;
      if (succ[h] == -2)
        succ[h] = nxt;
      else if (succ[h] != nxt)
        succ[h] = -1;
    }
  }

  auto perfect = [&](int64_t a, int64_t b) -> bool {
    int64_t sa = succ[a];
    if (sa == -1 || (sa != -2 && sa != b)) return false;
    int64_t sb = succ[flip(b)];
    if (sb == -1 || (sb != -2 && sb != flip(a))) return false;
    return true;
  };

  vector<uint8_t> visited(H, 0), merged(max_id + 1, 0);
  int64_t n_out = 0, pos = 0;
  out_off[0] = 0;
  for (int64_t i = 0; i < n_live; i++) {
    int64_t nid = live_ids[i];
    for (int rev = 0; rev < 2; rev++) {
      int64_t handle = (nid << 1) | rev;
      if (visited[handle]) continue;
      if (fdeg[handle] != 1) continue;
      int64_t chain_start = pos;
      out_chains[pos++] = handle;
      visited[handle] = 1;
      int64_t current = handle;
      while (true) {
        if (fdeg[current] != 1) break;
        int64_t nxt = fnext[current];
        if (bdeg[nxt] != 1 || visited[nxt]) break;
        if (!perfect(current, nxt)) break;
        out_chains[pos++] = nxt;
        visited[nxt] = 1;
        current = nxt;
        if (fdeg[nxt] != 1) break;
      }
      int64_t len = pos - chain_start;
      if (len >= 2) {
        bool clash = false;
        for (int64_t k = chain_start; k < pos; k++)
          if (merged[node_id(out_chains[k])]) { clash = true; break; }
        if (!clash) {
          for (int64_t k = chain_start; k < pos; k++)
            merged[node_id(out_chains[k])] = 1;
          out_off[++n_out] = pos;
          continue;
        }
      }
      pos = chain_start;  // discard
    }
  }
  return n_out;
}

}  // extern "C"
