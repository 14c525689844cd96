// Native host oracles for jepsen_tpu.
//
// TPU-native equivalents of the reference's JVM-native components
// (SURVEY.md §2.5): bifurcan's Java Tarjan SCC (#1) and Knossos's
// packed-bitset WGL search state (#2), rebuilt in C++ as the exact
// host-side anchors that double-check the device kernels.  Exposed via a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see ../build.py or ../Makefile (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Tarjan SCC, iterative (explicit stack), over CSR adjacency.
// comp[v] gets a component id; ids are assigned in completion order
// (reverse topological for the condensation), matching what Elle needs.

struct TarjanFrame {
  int64_t v;
  int64_t edge;  // next out-edge offset to try
};

}  // namespace

extern "C" {

// Returns the number of SCCs.  indptr has n+1 entries; indices has
// indptr[n] entries; comp has n entries (output).
int64_t jt_scc(int64_t n, const int64_t* indptr, const int64_t* indices,
               int64_t* comp) {
  std::vector<int64_t> index(n, -1), low(n, 0);
  std::vector<uint8_t> on_stack(n, 0);
  std::vector<int64_t> stack;       // Tarjan's node stack
  std::vector<TarjanFrame> frames;  // DFS stack
  stack.reserve(n);
  frames.reserve(64);
  int64_t next_index = 0, n_comps = 0;

  for (int64_t root = 0; root < n; ++root) {
    if (index[root] != -1) continue;
    frames.push_back({root, indptr[root]});
    index[root] = low[root] = next_index++;
    stack.push_back(root);
    on_stack[root] = 1;

    while (!frames.empty()) {
      TarjanFrame& f = frames.back();
      int64_t v = f.v;
      if (f.edge < indptr[v + 1]) {
        int64_t w = indices[f.edge++];
        if (index[w] == -1) {
          index[w] = low[w] = next_index++;
          stack.push_back(w);
          on_stack[w] = 1;
          frames.push_back({w, indptr[w]});
        } else if (on_stack[w] && index[w] < low[v]) {
          low[v] = index[w];
        }
      } else {
        if (low[v] == index[v]) {
          int64_t w;
          do {
            w = stack.back();
            stack.pop_back();
            on_stack[w] = 0;
            comp[w] = n_comps;
          } while (w != v);
          ++n_comps;
        }
        frames.pop_back();
        if (!frames.empty()) {
          int64_t parent = frames.back().v;
          if (low[v] < low[parent]) low[parent] = low[v];
        }
      }
    }
  }
  return n_comps;
}

// ---------------------------------------------------------------------------
// Shortest cycle through `start` (BFS over successors back to start) on a
// CSR graph restricted to nodes where mask[v] != 0.  Writes the cycle as
// node ids into out (capacity out_cap), returns its length, 0 if none.

int64_t jt_bfs_cycle(int64_t n, const int64_t* indptr,
                     const int64_t* indices, const uint8_t* mask,
                     int64_t start, int64_t* out, int64_t out_cap) {
  std::vector<int64_t> parent(n, -2);  // -2 unvisited
  std::vector<int64_t> queue;
  queue.reserve(256);
  queue.push_back(start);
  parent[start] = -1;
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    int64_t v = queue[qi];
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      int64_t w = indices[e];
      if (mask && !mask[w]) continue;
      if (w == start) {
        // reconstruct path start..v, then close the loop
        std::vector<int64_t> path;
        for (int64_t x = v; x != -1; x = parent[x]) path.push_back(x);
        int64_t len = static_cast<int64_t>(path.size());
        if (len + 1 > out_cap) return -1;  // caller's buffer too small
        for (int64_t i = 0; i < len; ++i) out[i] = path[len - 1 - i];
        out[len] = start;
        return len + 1;
      }
      if (parent[w] == -2) {
        parent[w] = v;
        queue.push_back(w);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// WGL linearizability search with memoized model (int transition table),
// dynamic bitsets (n_ops of any size), and a visited set of packed
// (linearized-set, state) configs — the C++ rebuild of Knossos's
// JVM BitSet configs.

namespace {

struct VecHash {
  size_t operator()(const std::vector<uint64_t>& v) const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (uint64_t x : v) {
      h ^= x;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

}  // namespace

// op_sym[i]: memoized symbol of op i.  invokes/returns: positions in the
// total order; returns[i] >= never  <=>  op i crashed (:info) and may
// linearize or not.  table[state * n_syms + sym] -> next state or -1.
// abort_flag (may be null): polled every 1024 configs; a nonzero value
// aborts the search — lets a competition kill the losing contestant
// (knossos/search.clj ctl semantics) instead of letting the C++ run to
// its full config budget after the verdict.
// Returns 1 linearizable, 0 not, -1 config budget exhausted, -2 aborted.
int32_t jt_wgl(int64_t n_ops, const int32_t* op_sym, const int64_t* invokes,
               const int64_t* returns, int64_t never, const int32_t* table,
               int64_t n_states, int64_t n_syms, int32_t init_state,
               int64_t max_configs, int64_t* explored_out,
               const volatile int32_t* abort_flag) {
  (void)n_states;
  const int64_t words = (n_ops + 63) / 64;

  auto test_bit = [&](const std::vector<uint64_t>& S, int64_t i) {
    return (S[i >> 6] >> (i & 63)) & 1ull;
  };

  // must-linearize mask (ops with real returns)
  std::vector<uint64_t> must(words, 0);
  for (int64_t i = 0; i < n_ops; ++i)
    if (returns[i] < never) must[i >> 6] |= 1ull << (i & 63);

  auto covers_must = [&](const std::vector<uint64_t>& S) {
    for (int64_t w = 0; w < words; ++w)
      if ((S[w] & must[w]) != must[w]) return false;
    return true;
  };

  auto candidates = [&](const std::vector<uint64_t>& S,
                        std::vector<int64_t>& out) {
    out.clear();
    int64_t minret = never + 1;
    for (int64_t i = 0; i < n_ops; ++i)
      if (!test_bit(S, i) && returns[i] < minret) minret = returns[i];
    for (int64_t i = 0; i < n_ops; ++i)
      if (!test_bit(S, i) && invokes[i] < minret) out.push_back(i);
  };

  struct Frame {
    std::vector<uint64_t> S;
    int32_t state;
    std::vector<int64_t> cands;
    size_t ci;
  };

  // visited keys: S words + state appended
  std::unordered_set<std::vector<uint64_t>, VecHash> seen;
  auto key_of = [&](const std::vector<uint64_t>& S, int32_t state) {
    std::vector<uint64_t> k(S);
    k.push_back(static_cast<uint64_t>(static_cast<uint32_t>(state)));
    return k;
  };

  std::vector<Frame> stack;
  Frame f0{std::vector<uint64_t>(words, 0), init_state, {}, 0};
  candidates(f0.S, f0.cands);
  seen.insert(key_of(f0.S, f0.state));
  stack.push_back(std::move(f0));

  int64_t explored = 0;
  while (!stack.empty()) {
    Frame& f = stack.back();
    if (covers_must(f.S)) {
      if (explored_out) *explored_out = explored;
      return 1;
    }
    if (f.ci >= f.cands.size()) {
      stack.pop_back();
      continue;
    }
    int64_t i = f.cands[f.ci++];
    int32_t s2 = table[static_cast<int64_t>(f.state) * n_syms + op_sym[i]];
    if (s2 < 0) continue;
    std::vector<uint64_t> S2(f.S);
    S2[i >> 6] |= 1ull << (i & 63);
    auto key = key_of(S2, s2);
    if (!seen.insert(std::move(key)).second) continue;
    if (++explored > max_configs) {
      if (explored_out) *explored_out = explored;
      return -1;
    }
    if (abort_flag && (explored & 1023) == 0 && *abort_flag) {
      if (explored_out) *explored_out = explored;
      return -2;
    }
    Frame nf{std::move(S2), s2, {}, 0};
    candidates(nf.S, nf.cands);
    stack.push_back(std::move(nf));
  }
  if (explored_out) *explored_out = explored;
  return 0;
}

}  // extern "C"
