// fastpd.cpp — native discrete pairwise-MRF solver for Mesh_correction.
//
// TPU-framework equivalent of the reference's compiled `libfastpd`
// extension (reference spateo/alignment/methods/morpho_mesh_correction.py:32
// imports `from .libfastpd import fastpd`; its C++ source implements
// Komodakis' FastPD primal-dual MRF optimization). Re-designed rather than
// translated:
//
//   * exact exhaustive MAP when the label-configuration space is small
//     (the Mesh_correction MRF is 5 variables x ~15 labels on the complete
//     graph -- 759k configurations, microseconds in native code, and exact
//     where FastPD is approximate);
//   * otherwise iterated conditional modes (ICM) with random restarts,
//     which handles arbitrary (non-metric) pairwise tables on arbitrary
//     graphs within the requested iteration budget.
//
// C ABI (ctypes-friendly):
//   fastpd_solve(n_vars, n_labels, unaries[n_labels*n_vars],
//                n_pairs, pairs[2*n_pairs], binaries[n_pairs*n_labels^2],
//                max_iter, seed, out_labels[n_vars]) -> double (energy)
//
// unaries are column-major per reference convention: u[l, v] (L x N).
// binaries[p] is the L x L row-major table for pair p = (i, j), indexed
// b[l_i * L + l_j].

#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Problem {
    int n_vars;
    int n_labels;
    const float* unaries;   // [L * N] u[l * N + v]
    int n_pairs;
    const int32_t* pairs;   // [2 * P] (i, j) per pair
    const float* binaries;  // [P * L * L]
};

double energy(const Problem& pb, const std::vector<int>& labels) {
    double e = 0.0;
    for (int v = 0; v < pb.n_vars; ++v)
        e += pb.unaries[labels[v] * pb.n_vars + v];
    const int LL = pb.n_labels * pb.n_labels;
    for (int p = 0; p < pb.n_pairs; ++p) {
        const int i = pb.pairs[2 * p], j = pb.pairs[2 * p + 1];
        e += pb.binaries[p * LL + labels[i] * pb.n_labels + labels[j]];
    }
    return e;
}

// Exact MAP by depth-first enumeration with branch-and-bound pruning on the
// accumulated partial energy (admissible because all terms are finite and we
// subtract per-variable lower bounds).
double solve_exact(const Problem& pb, std::vector<int>& best) {
    const int N = pb.n_vars, L = pb.n_labels, LL = L * L;

    // per-variable lower bound over remaining vars (unary min + adjacent
    // binary mins), used to prune branches early
    std::vector<double> lb(N + 1, 0.0);
    for (int v = N - 1; v >= 0; --v) {
        double umin = pb.unaries[0 * N + v];
        for (int l = 1; l < L; ++l)
            umin = std::min(umin, (double)pb.unaries[l * N + v]);
        double bmin = 0.0;
        for (int p = 0; p < pb.n_pairs; ++p) {
            // count the pair at its later endpoint so each is added once
            int later = std::max(pb.pairs[2 * p], pb.pairs[2 * p + 1]);
            if (later != v) continue;
            double m = pb.binaries[p * LL];
            for (int k = 1; k < LL; ++k)
                m = std::min(m, (double)pb.binaries[p * LL + k]);
            bmin += m;
        }
        lb[v] = lb[v + 1] + umin + bmin;
    }

    std::vector<int> cur(N, 0);
    best.assign(N, 0);
    double best_e = energy(pb, best);

    // iterative DFS over label assignments
    std::vector<double> partial(N + 1, 0.0);
    int depth = 0;
    cur[0] = -1;
    while (depth >= 0) {
        if (++cur[depth] >= L) { --depth; continue; }
        // partial energy of assigning cur[depth] to var `depth`
        double e = partial[depth] + pb.unaries[cur[depth] * N + depth];
        for (int p = 0; p < pb.n_pairs; ++p) {
            const int i = pb.pairs[2 * p], j = pb.pairs[2 * p + 1];
            const int later = std::max(i, j);
            if (later != depth) continue;
            e += pb.binaries[p * LL + cur[i] * L + cur[j]];
        }
        if (e + lb[depth + 1] >= best_e) continue;  // prune
        if (depth == N - 1) {
            best_e = e;
            best = cur;
            continue;
        }
        partial[depth + 1] = e;
        ++depth;
        cur[depth] = -1;
    }
    return best_e;
}

// ICM with random restarts: repeatedly sweep variables, setting each to its
// conditionally-optimal label; restart from random labelings until the
// iteration budget is spent.
double solve_icm(const Problem& pb, int max_iter, uint64_t seed, std::vector<int>& best) {
    const int N = pb.n_vars, L = pb.n_labels, LL = L * L;
    std::mt19937_64 rng(seed);
    std::uniform_int_distribution<int> randl(0, L - 1);

    // adjacency: pairs touching each variable
    std::vector<std::vector<int>> adj(N);
    for (int p = 0; p < pb.n_pairs; ++p) {
        adj[pb.pairs[2 * p]].push_back(p);
        adj[pb.pairs[2 * p + 1]].push_back(p);
    }

    best.assign(N, 0);
    double best_e = energy(pb, best);
    std::vector<int> cur(N);

    int sweeps_per_restart = std::max(max_iter / 10, 5);
    int budget = std::max(max_iter, 1);
    while (budget > 0) {
        for (int v = 0; v < N; ++v) cur[v] = randl(rng);
        bool changed = true;
        for (int s = 0; s < sweeps_per_restart && changed && budget > 0; ++s, --budget) {
            changed = false;
            for (int v = 0; v < N; ++v) {
                int arg = cur[v];
                double bestc = 1e300;
                for (int l = 0; l < L; ++l) {
                    double c = pb.unaries[l * N + v];
                    for (int p : adj[v]) {
                        const int i = pb.pairs[2 * p], j = pb.pairs[2 * p + 1];
                        const int li = (i == v) ? l : cur[i];
                        const int lj = (j == v) ? l : cur[j];
                        c += pb.binaries[p * LL + li * L + lj];
                    }
                    if (c < bestc) { bestc = c; arg = l; }
                }
                if (arg != cur[v]) { cur[v] = arg; changed = true; }
            }
        }
        double e = energy(pb, cur);
        if (e < best_e) { best_e = e; best = cur; }
    }
    return best_e;
}

}  // namespace

extern "C" double fastpd_solve(
    int n_vars,
    int n_labels,
    const float* unaries,
    int n_pairs,
    const int32_t* pairs,
    const float* binaries,
    int max_iter,
    uint64_t seed,
    int32_t* out_labels) {
    Problem pb{n_vars, n_labels, unaries, n_pairs, pairs, binaries};
    std::vector<int> best;

    // exact when the configuration space is enumerable in ~<=10^8 steps
    double log_space = n_vars * std::log((double)n_labels);
    double e;
    if (log_space <= std::log(1e8)) {
        e = solve_exact(pb, best);
    } else {
        e = solve_icm(pb, max_iter, seed, best);
    }
    for (int v = 0; v < n_vars; ++v) out_labels[v] = best[v];
    return e;
}
