// Exact maximum-weight set packing — native core.
//
// This is the framework's native replacement for the commercial Gurobi
// ILP solver used by the reference (reference: repic/commands/run_ilp.py:50-63):
//
//     maximize  w . x     over x in {0,1}^C
//     s.t.      A x <= 1  (each vertex/particle in at most one clique)
//
// Algorithm: decompose the conflict graph (cliques conflict iff they
// share a vertex) into connected components, then run depth-first
// branch-and-bound per component, branching heaviest-first with a
// suffix-sum upper bound.  Components are local overlap clusters and
// are tiny in practice, so exact search is fast; a node limit guards
// pathological inputs (greedy fallback within the component).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Component {
    // Local view of one conflict-graph component, heaviest-first.
    int n = 0;
    std::vector<double> w;                  // local weights
    std::vector<double> suffix;             // suffix[i] = sum w[i..]
    std::vector<std::vector<int>> adj;      // local conflict adjacency
    std::vector<int> global_ids;            // local -> global clique id
};

struct Search {
    const Component& c;
    int64_t node_limit;
    int64_t nodes_visited = 0;
    bool aborted = false;
    double best_val = -1.0;
    std::vector<int> best_sel;
    std::vector<int> cur;
    std::vector<int> blocked;  // counter per local clique

    explicit Search(const Component& comp, int64_t limit)
        : c(comp), node_limit(limit), blocked(comp.n, 0) {}

    // Iterative DFS (component size == max depth; recursion would blow
    // the native stack on 100k-clique components).  Each frame walks
    // phase ENTER -> LEAVE -> DONE, with take/undo of `pos` done
    // explicitly so `blocked`/`cur` mirror the recursive version.
    enum Phase : uint8_t { ENTER, LEAVE, DONE };
    struct Frame {
        int pos;     // advanced position (set during ENTER)
        double val;  // value on entry
        Phase phase;
    };

    void search() {
        std::vector<Frame> stk;
        stk.push_back({0, 0.0, ENTER});
        while (!stk.empty() && !aborted) {
            Frame& f = stk.back();
            switch (f.phase) {
                case ENTER: {
                    if (++nodes_visited > node_limit) {
                        aborted = true;
                        break;
                    }
                    while (f.pos < c.n && blocked[f.pos] > 0) ++f.pos;
                    if (f.val + c.suffix[f.pos] <= best_val) {
                        stk.pop_back();
                        break;
                    }
                    if (f.pos >= c.n) {
                        best_val = f.val;
                        best_sel = cur;
                        stk.pop_back();
                        break;
                    }
                    // Take `pos` first (strong incumbent early =>
                    // tighter bound); undo happens at LEAVE.
                    cur.push_back(f.pos);
                    for (int nb : c.adj[f.pos]) ++blocked[nb];
                    f.phase = LEAVE;
                    stk.push_back({f.pos + 1, f.val + c.w[f.pos], ENTER});
                    break;
                }
                case LEAVE: {
                    for (int nb : c.adj[f.pos]) --blocked[nb];
                    cur.pop_back();
                    f.phase = DONE;
                    stk.push_back({f.pos + 1, f.val, ENTER});
                    break;
                }
                case DONE:
                    stk.pop_back();
                    break;
            }
        }
    }

    void run() {
        search();
        if (aborted) {
            // Greedy heaviest-first fallback (bounded inputs only).
            best_sel.clear();
            std::vector<char> blk(c.n, 0);
            for (int i = 0; i < c.n; ++i) {
                if (!blk[i]) {
                    best_sel.push_back(i);
                    for (int nb : c.adj[i]) blk[nb] = 1;
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// member_vertex: C*K int32 global vertex ids (row-major per clique)
// w:             C weights
// picked_out:    C bytes, set to 1 for selected cliques
// Returns 0 on fully-exact solve, 1 if any component hit the node
// limit (greedy fallback used there), -1 on bad arguments.
int32_t setpack_solve(const int32_t* member_vertex, const double* w,
                      int64_t C, int32_t K, int64_t node_limit,
                      uint8_t* picked_out) {
    if (C < 0 || K <= 0 || !picked_out) return -1;
    std::memset(picked_out, 0, static_cast<size_t>(C));
    if (C == 0) return 0;

    // Group cliques by vertex to build conflict adjacency.
    int32_t max_v = 0;
    for (int64_t i = 0; i < C * K; ++i) {
        if (member_vertex[i] < 0) return -1;  // ids must be non-negative
        max_v = std::max(max_v, member_vertex[i]);
    }
    std::vector<std::vector<int64_t>> by_vertex(
        static_cast<size_t>(max_v) + 1);
    for (int64_t c = 0; c < C; ++c)
        for (int32_t k = 0; k < K; ++k)
            by_vertex[member_vertex[c * K + k]].push_back(c);

    std::vector<std::vector<int64_t>> adj(C);
    for (const auto& group : by_vertex) {
        if (group.size() < 2) continue;
        for (int64_t a : group)
            for (int64_t b : group)
                if (a != b) adj[a].push_back(b);
    }
    for (auto& nbrs : adj) {
        std::sort(nbrs.begin(), nbrs.end());
        nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
    }

    // Connected components (iterative DFS).
    std::vector<int64_t> comp(C, -1);
    int64_t n_comp = 0;
    std::vector<int64_t> stack;
    for (int64_t c = 0; c < C; ++c) {
        if (comp[c] >= 0) continue;
        comp[c] = n_comp;
        stack.assign(1, c);
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            for (int64_t nb : adj[u])
                if (comp[nb] < 0) {
                    comp[nb] = n_comp;
                    stack.push_back(nb);
                }
        }
        ++n_comp;
    }

    std::vector<std::vector<int64_t>> members(n_comp);
    for (int64_t c = 0; c < C; ++c) members[comp[c]].push_back(c);

    int32_t rc = 0;
    for (int64_t cid = 0; cid < n_comp; ++cid) {
        auto& nodes = members[cid];
        // Heaviest-first, stable on global index.
        std::sort(nodes.begin(), nodes.end(), [&](int64_t a, int64_t b) {
            if (w[a] != w[b]) return w[a] > w[b];
            return a < b;
        });
        Component cc;
        cc.n = static_cast<int>(nodes.size());
        cc.w.resize(cc.n);
        cc.adj.resize(cc.n);
        cc.global_ids.assign(nodes.begin(), nodes.end());
        std::vector<int64_t> local_of;  // sparse map via sorted lookup
        for (int i = 0; i < cc.n; ++i) cc.w[i] = w[nodes[i]];
        // Map global -> local for this component.
        {
            std::vector<std::pair<int64_t, int>> order(cc.n);
            for (int i = 0; i < cc.n; ++i) order[i] = {nodes[i], i};
            std::sort(order.begin(), order.end());
            for (int i = 0; i < cc.n; ++i) {
                for (int64_t nb : adj[nodes[i]]) {
                    auto it = std::lower_bound(
                        order.begin(), order.end(),
                        std::make_pair(nb, -1));
                    if (it != order.end() && it->first == nb)
                        cc.adj[i].push_back(it->second);
                }
            }
        }
        cc.suffix.resize(cc.n + 1);
        cc.suffix[cc.n] = 0.0;
        for (int i = cc.n - 1; i >= 0; --i)
            cc.suffix[i] = cc.suffix[i + 1] + cc.w[i];

        Search s(cc, node_limit);
        s.run();
        if (s.aborted) rc = 1;
        for (int i : s.best_sel)
            picked_out[cc.global_ids[i]] = 1;
    }
    return rc;
}

}  // extern "C"
