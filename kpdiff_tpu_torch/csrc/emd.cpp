// Exact transportation-problem solver (EMD) for the receptor-encoder OT
// loss — first-party replacement for POT's ot.emd (the reference calls the
// POT C network simplex on CPU per graph, losses/rec_encoder_loss.py:11-18).
//
// Algorithm: classic transportation (MODI / u-v) simplex.
//   * initial BFS via northwest-corner rule
//   * potentials from the basis via BFS over the bipartite basis graph
//   * entering cell = most negative reduced cost
//   * pivot cycle = entering edge + the unique row<->col path between its
//     endpoints in the basis forest (found by BFS); flows alternate +/-.
// Degeneracy is handled by allowing zero-flow basic cells; a disconnected
// basis forest (possible after degenerate pivots) simply admits the
// entering edge as a new zero-flow basic edge joining two components.
//
// Problem sizes here are tiny (rows <= 40 keypoints, cols <= ~128 pocket
// atoms / interface points), so this direct implementation solves an
// instance in tens of microseconds.
//
// Build: kpdiff_tpu_torch/native/emd.py compiles this file with g++ at first
// use into kpdiff_tpu_torch/_build/libemd.so and loads it with ctypes.

#include <cstring>
#include <limits>
#include <queue>
#include <vector>

extern "C" int emd_plan(int n_rows, int n_cols, const double* cost, const double* a_in,
                        const double* b_in, double* plan, int max_iters) {
    const int R = n_rows, C = n_cols;
    const int N = R + C;  // bipartite nodes: 0..R-1 rows, R..R+C-1 cols
    std::vector<double> X(static_cast<size_t>(R) * C, 0.0);
    std::vector<char> basic(static_cast<size_t>(R) * C, 0);

    auto idx = [C](int r, int c) { return static_cast<size_t>(r) * C + c; };

    // ---- initial basic feasible solution: northwest-corner
    {
        std::vector<double> ra(a_in, a_in + R), rb(b_in, b_in + C);
        int i = 0, j = 0;
        while (i < R && j < C) {
            double q = ra[i] < rb[j] ? ra[i] : rb[j];
            X[idx(i, j)] = q;
            basic[idx(i, j)] = 1;
            ra[i] -= q;
            rb[j] -= q;
            bool row_done = ra[i] <= 1e-15;
            bool col_done = rb[j] <= 1e-15;
            if (row_done && col_done) {
                // degenerate tie: keep the next cell basic with zero flow to
                // preserve the spanning-tree cell count
                if (i + 1 < R && j < C) {
                    basic[idx(i + 1, j)] = 1;
                }
                ++i;
                ++j;
            } else if (row_done) {
                ++i;
            } else {
                ++j;
            }
        }
    }

    std::vector<double> u(R), v(C);
    std::vector<char> udef(R), vdef(C);
    std::vector<int> parent(N), parent_other(N);  // BFS tree over bipartite nodes
    std::vector<char> seen(N);

    for (int iter = 0; iter < max_iters; ++iter) {
        // ---- potentials from basic cells (u[0] = 0; orphan components get 0)
        std::fill(udef.begin(), udef.end(), 0);
        std::fill(vdef.begin(), vdef.end(), 0);
        for (int r0 = 0; r0 < R; ++r0) {
            if (udef[r0]) continue;
            u[r0] = 0.0;
            udef[r0] = 1;
            bool progress = true;
            while (progress) {
                progress = false;
                for (int r = 0; r < R; ++r)
                    for (int c = 0; c < C; ++c) {
                        if (!basic[idx(r, c)]) continue;
                        if (udef[r] && !vdef[c]) {
                            v[c] = cost[idx(r, c)] - u[r];
                            vdef[c] = 1;
                            progress = true;
                        } else if (!udef[r] && vdef[c]) {
                            u[r] = cost[idx(r, c)] - v[c];
                            udef[r] = 1;
                            progress = true;
                        }
                    }
            }
        }
        for (int c = 0; c < C; ++c)
            if (!vdef[c]) v[c] = 0.0;

        // ---- entering cell
        int er = -1, ec = -1;
        double best = -1e-9;
        for (int r = 0; r < R; ++r)
            for (int c = 0; c < C; ++c) {
                size_t k = idx(r, c);
                if (basic[k]) continue;
                double red = cost[k] - u[r] - v[c];
                if (red < best) {
                    best = red;
                    er = r;
                    ec = c;
                }
            }
        if (er < 0) break;  // optimal

        // ---- BFS in the basis graph from row er to col ec
        std::fill(seen.begin(), seen.end(), 0);
        std::fill(parent.begin(), parent.end(), -1);
        std::queue<int> q;
        q.push(er);
        seen[er] = 1;
        bool connected = false;
        while (!q.empty()) {
            int node = q.front();
            q.pop();
            if (node == R + ec) {
                connected = true;
                break;
            }
            if (node < R) {
                for (int c = 0; c < C; ++c)
                    if (basic[idx(node, c)] && !seen[R + c]) {
                        seen[R + c] = 1;
                        parent[R + c] = node;
                        q.push(R + c);
                    }
            } else {
                int c = node - R;
                for (int r = 0; r < R; ++r)
                    if (basic[idx(r, c)] && !seen[r]) {
                        seen[r] = 1;
                        parent[r] = node;
                        q.push(r);
                    }
            }
        }

        if (!connected) {
            // basis forest is disconnected (degeneracy): admit the entering
            // edge as a zero-flow basic edge joining the components
            basic[idx(er, ec)] = 1;
            continue;
        }

        // ---- reconstruct cycle cells: entering + path edges, alternating signs
        std::vector<std::pair<int, int>> cycle;  // (r, c)
        cycle.emplace_back(er, ec);
        int node = R + ec;
        while (node != er) {
            int p = parent[node];
            int r = node < R ? node : p;
            int c = node < R ? p - R : node - R;
            cycle.emplace_back(r, c);
            node = p;
        }
        // cycle length is even; odd positions are the "minus" cells

        double theta = std::numeric_limits<double>::infinity();
        size_t leave = 0;
        for (size_t k = 1; k < cycle.size(); k += 2) {
            double x = X[idx(cycle[k].first, cycle[k].second)];
            if (x < theta) {
                theta = x;
                leave = k;
            }
        }
        for (size_t k = 0; k < cycle.size(); ++k) {
            size_t cell = idx(cycle[k].first, cycle[k].second);
            if (k % 2 == 0)
                X[cell] += theta;
            else
                X[cell] -= theta;
        }
        basic[idx(er, ec)] = 1;
        basic[idx(cycle[leave].first, cycle[leave].second)] = 0;
        X[idx(cycle[leave].first, cycle[leave].second)] = 0.0;
    }

    std::memcpy(plan, X.data(), sizeof(double) * R * C);
    return 0;
}
