// Native host-side meshing kernels for meshrecon.
//
// The reference keeps its combinatorial meshing native (CGAL alpha shapes /
// Poisson, alpha_shapes.cpp + cgal_poisson.cpp); these are our from-scratch
// C++ equivalents for the inherently sequential host stages:
//   - mt_extract: marching-tetrahedra iso-surface extraction with vertex
//     dedup and gradient-based outward orientation (consumes the chi grid the
//     device FFT Poisson solve produces; see meshrecon/meshing/poisson.py).
//   - greedy_suppress: density-ordered greedy point suppression, the
//     sequential tail of Heuristic::filterPoints (heuristic.cpp:145-175).
//
// Plain C ABI, loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// six tetrahedra sharing the 0-7 diagonal; cube corner c has offset bits
// (x, y, z) = (c&1, (c>>1)&1, (c>>2)&1)  [same tables as poisson.py]
static const int CUBE_TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7}};
static const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

static inline void unravel(int64_t lin, int64_t g, double *out) {
    out[0] = (double)(lin / (g * g));
    out[1] = (double)((lin / g) % g);
    out[2] = (double)(lin % g);
}

static inline double sample_grad(const float *f, int64_t g, const double *p, int axis) {
    // central-difference gradient of f at continuous point p, axis component,
    // trilinear sampling with clamping
    double q[3] = {p[0], p[1], p[2]};
    auto tri = [&](const double *pt) -> double {
        double x = pt[0] < 0 ? 0 : (pt[0] > g - 1.001 ? g - 1.001 : pt[0]);
        double y = pt[1] < 0 ? 0 : (pt[1] > g - 1.001 ? g - 1.001 : pt[1]);
        double z = pt[2] < 0 ? 0 : (pt[2] > g - 1.001 ? g - 1.001 : pt[2]);
        int64_t i = (int64_t)x, j = (int64_t)y, k = (int64_t)z;
        double fx = x - i, fy = y - j, fz = z - k;
        double acc = 0;
        for (int dx = 0; dx < 2; dx++)
            for (int dy = 0; dy < 2; dy++)
                for (int dz = 0; dz < 2; dz++) {
                    double w = (dx ? fx : 1 - fx) * (dy ? fy : 1 - fy) * (dz ? fz : 1 - fz);
                    acc += w * f[((i + dx) * g + (j + dy)) * g + (k + dz)];
                }
        return acc;
    };
    q[axis] = p[axis] + 0.5;
    double hi = tri(q);
    q[axis] = p[axis] - 0.5;
    double lo = tri(q);
    return hi - lo;
}

// Extract the iso-surface of chi (g*g*g, C order) at level `iso`.
// Outputs deduplicated vertices (grid coordinates) and outward-oriented
// triangles. Returns 0 on success, -1 if capacity exceeded.
int mt_extract(const float *chi, int64_t g, float iso,
               float *out_verts, int32_t *out_faces, int64_t max_tris,
               int64_t *n_verts, int64_t *n_faces) {
    std::unordered_map<uint64_t, int32_t> edge_vertex;
    edge_vertex.reserve(1 << 16);
    int64_t nv = 0, nf = 0;
    const int64_t max_verts = 3 * max_tris;

    int64_t corner_off[8];
    for (int c = 0; c < 8; c++)
        corner_off[c] = (int64_t)(c & 1) * g * g + (int64_t)((c >> 1) & 1) * g +
                        (int64_t)((c >> 2) & 1);

    auto edge_vert = [&](int64_t a, int64_t b) -> int32_t {
        if (a > b) std::swap(a, b);
        uint64_t key = (uint64_t)a * (uint64_t)(g * g * g) + (uint64_t)b;
        auto it = edge_vertex.find(key);
        if (it != edge_vertex.end()) return it->second;
        double fa = chi[a] - iso, fb = chi[b] - iso;
        double t = fa / (fa - fb);
        if (!(t >= 0)) t = 0;
        if (t > 1) t = 1;
        double pa[3], pb[3];
        unravel(a, g, pa);
        unravel(b, g, pb);
        if (nv >= max_verts) return -1;
        out_verts[3 * nv + 0] = (float)(pa[0] + (pb[0] - pa[0]) * t);
        out_verts[3 * nv + 1] = (float)(pa[1] + (pb[1] - pa[1]) * t);
        out_verts[3 * nv + 2] = (float)(pa[2] + (pb[2] - pa[2]) * t);
        int32_t id = (int32_t)nv++;
        edge_vertex.emplace(key, id);
        return id;
    };

    auto emit = [&](int64_t a0, int64_t b0, int64_t a1, int64_t b1,
                    int64_t a2, int64_t b2) -> bool {
        int32_t v0 = edge_vert(a0, b0);
        int32_t v1 = edge_vert(a1, b1);
        int32_t v2 = edge_vert(a2, b2);
        if (v0 < 0 || v1 < 0 || v2 < 0) return false;
        if (v0 == v1 || v1 == v2 || v0 == v2) return true;  // degenerate: skip
        if (nf >= max_tris) return false;
        // orient outward: normal must oppose the gradient of chi
        const float *p0 = out_verts + 3 * v0;
        const float *p1 = out_verts + 3 * v1;
        const float *p2 = out_verts + 3 * v2;
        double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
        double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
        double nx = e1[1] * e2[2] - e1[2] * e2[1];
        double ny = e1[2] * e2[0] - e1[0] * e2[2];
        double nz = e1[0] * e2[1] - e1[1] * e2[0];
        double c[3] = {(p0[0] + p1[0] + p2[0]) / 3.0, (p0[1] + p1[1] + p2[1]) / 3.0,
                       (p0[2] + p1[2] + p2[2]) / 3.0};
        double gx = sample_grad(chi, g, c, 0);
        double gy = sample_grad(chi, g, c, 1);
        double gz = sample_grad(chi, g, c, 2);
        bool flip = nx * gx + ny * gy + nz * gz > 0;
        out_faces[3 * nf + 0] = v0;
        out_faces[3 * nf + 1] = flip ? v2 : v1;
        out_faces[3 * nf + 2] = flip ? v1 : v2;
        nf++;
        return true;
    };

    for (int64_t i = 0; i + 1 < g; i++)
        for (int64_t j = 0; j + 1 < g; j++)
            for (int64_t k = 0; k + 1 < g; k++) {
                int64_t c0 = (i * g + j) * g + k;
                int64_t gid[8];
                float fv[8];
                bool any_in = false, any_out = false;
                for (int c = 0; c < 8; c++) {
                    gid[c] = c0 + corner_off[c];
                    fv[c] = chi[gid[c]] - iso;
                    (fv[c] > 0 ? any_in : any_out) = true;
                }
                if (!any_in || !any_out) continue;
                for (int t = 0; t < 6; t++) {
                    int64_t tv[4];
                    bool in[4];
                    int mask = 0;
                    for (int v = 0; v < 4; v++) {
                        tv[v] = gid[CUBE_TETS[t][v]];
                        in[v] = fv[CUBE_TETS[t][v]] > 0;
                        if (in[v]) mask |= 1 << v;
                    }
                    if (mask == 0 || mask == 15) continue;
                    int cnt = __builtin_popcount(mask);
                    if (cnt == 1 || cnt == 3) {
                        int a = -1;
                        for (int v = 0; v < 4; v++)
                            if (in[v] == (cnt == 1)) a = v;
                        int os[3], no = 0;
                        for (int v = 0; v < 4; v++)
                            if (v != a) os[no++] = v;
                        if (!emit(tv[a], tv[os[0]], tv[a], tv[os[1]], tv[a], tv[os[2]]))
                            return -1;
                    } else {  // two inside: quad u-x, u-y, v-y, v-x
                        int u = -1, v2i = -1, x = -1, y = -1;
                        for (int v = 0; v < 4; v++) {
                            if (in[v]) { if (u < 0) u = v; else v2i = v; }
                            else { if (x < 0) x = v; else y = v; }
                        }
                        if (!emit(tv[u], tv[x], tv[u], tv[y], tv[v2i], tv[y]))
                            return -1;
                        if (!emit(tv[u], tv[x], tv[v2i], tv[y], tv[v2i], tv[x]))
                            return -1;
                    }
                }
            }
    *n_verts = nv;
    *n_faces = nf;
    return 0;
}

// Greedy density-ordered suppression (heuristic.cpp:145-163): walk points by
// descending density; drop points whose (mutated) score fell below `limit`;
// kept points subtract density*weight from each neighbor's score.
// neighbors are CSR over ALL points. Returns number of kept points, written
// (in ascending original-index order like the reference's sort at
// heuristic.cpp:166) into out_kept.
int64_t greedy_suppress(const int64_t *order, int64_t n,
                        float *score, const float *density,
                        const int64_t *nbr_ptr, const int64_t *nbr_idx,
                        const float *nbr_w, float limit, int64_t *out_kept) {
    int64_t nkept = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t ord = order[i];
        if (score[ord] < limit) continue;
        double local = density[ord];
        for (int64_t j = nbr_ptr[ord]; j < nbr_ptr[ord + 1]; j++)
            score[nbr_idx[j]] -= (float)(local * nbr_w[j]);
        out_kept[nkept++] = ord;
    }
    std::sort(out_kept, out_kept + nkept);
    return nkept;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full native point filter: grid-hash neighbor search (capped k nearest
// in-radius), clamped density power iteration, density-ordered greedy
// suppression. One call replaces the host-side scipy/numpy pipeline of
// points/filter.py for large clouds (the e2e profile showed the Python path
// dominating wall time at ~10^6 points).
//
// Semantics mirror Heuristic::filterPoints (heuristic.cpp:55-176) with the
// same capped-neighbor approximation as the Python path:
//   - neighbors within SQUARED distance radius_sq (FLANN L2_Simple
//     convention), weight 1 - d^2/radius_sq, at most max_neighbors nearest
//     per point, deduplicated half edges (j < i);
//   - density: score_i = sum_j w_ij d_j (symmetric), L1-normalized to mean 1,
//     clamped at 2.0, until mean-squared change <= 1e-6 or max_iters;
//   - greedy: walk points by descending density; keep if raw score >= limit;
//     kept points subtract density*w from LOWER-INDEX neighbors' scores.
// Returns number of kept indices written (ascending) to out_kept; also
// exposes the converged density/score for cross-checking.

extern "C" {

int64_t filter_points_native(const float *pts, int64_t n, float radius_sq,
                             float density_limit, int32_t max_neighbors,
                             int32_t max_iters, int64_t *out_kept,
                             float *out_density, float *out_score) {
    if (n <= 0) return 0;
    const double radius = std::sqrt((double)radius_sq);

    // --- grid hash: 21 bits per axis ---
    double mins[3] = {1e300, 1e300, 1e300};
    for (int64_t i = 0; i < n; i++)
        for (int d = 0; d < 3; d++)
            mins[d] = std::min(mins[d], (double)pts[3 * i + d]);

    // Two-level grid. A single cell size cannot serve mixed densities:
    // cell == radius makes dense regions (per-pixel clouds: spacing <<
    // radius) scan thousands of candidates per point, while a fine cell
    // makes SPARSE points walk an O((radius/cell)^3) cube of mostly-empty
    // ring cells to prove absence (a dense sphere + 2% box outliers
    // measured 374 s with one fine grid). So: a FINE grid (shrunk until
    // mean occupancy is a small multiple of the cap) serves the dense
    // bulk, whose ring scans terminate after a couple of rings; any point
    // whose ring scan visits more than a budget of fine cells falls back
    // to a direct 27-cell scan of a COARSE grid (cell == radius) — cheap
    // precisely for the sparse points that trigger it.
    auto pack = [](int64_t cx, int64_t cy, int64_t cz) -> uint64_t {
        return ((uint64_t)cx << 42) | ((uint64_t)cy << 21) | (uint64_t)cz;
    };
    const double cellC = std::max(radius, 1e-12);
    double cellF = cellC;
    std::vector<uint64_t> keys(n);
    {
        std::unordered_map<uint64_t, int64_t> occ;
        for (int shrink = 0; shrink < 8; shrink++) {
            occ.clear();
            occ.reserve(n / 4 + 16);
            const double inv = 1.0 / cellF;
            for (int64_t i = 0; i < n; i++) {
                int64_t c[3];
                for (int d = 0; d < 3; d++)
                    c[d] = (int64_t)(((double)pts[3 * i + d] - mins[d]) * inv);
                occ[pack(c[0], c[1], c[2])]++;
            }
            // POINT-weighted occupancy (sum occ^2 / n): the expected cell
            // population a random QUERY point sees. The cell-weighted mean
            // (n / #occupied) is dominated by sparse singleton cells —
            // 2% box outliers once stopped the shrink at radius/2 while
            // dense cells still held ~6k points each (400 s search).
            double sq = 0.0;
            for (const auto &kv : occ)
                sq += (double)kv.second * (double)kv.second;
            if (sq / (double)n <= 2.0 * (double)max_neighbors) break;
            cellF *= 0.5;
        }
    }
    const double inv_cf = 1.0 / cellF;
    const double inv_cc = 1.0 / cellC;
    const int64_t rmax = (int64_t)std::ceil(radius * inv_cf);
    const int64_t kBudget = 4096;  // fine cells visited before falling back

    auto cell_of_f = [&](int64_t i, int64_t *c) {
        for (int d = 0; d < 3; d++)
            c[d] = (int64_t)(((double)pts[3 * i + d] - mins[d]) * inv_cf);
    };
    auto cell_of_c = [&](int64_t i, int64_t *c) {
        for (int d = 0; d < 3; d++)
            c[d] = (int64_t)(((double)pts[3 * i + d] - mins[d]) * inv_cc);
    };

    auto build_grid = [&](auto cell_of, std::vector<int64_t> &order,
                          std::unordered_map<uint64_t,
                                             std::pair<int64_t, int64_t>> &m,
                          std::vector<uint64_t> &ks) {
        order.resize(n);
        ks.resize(n);
        for (int64_t i = 0; i < n; i++) {
            int64_t c[3];
            cell_of(i, c);
            ks[i] = pack(c[0], c[1], c[2]);
            order[i] = i;
        }
        std::sort(order.begin(), order.end(),
                  [&](int64_t a, int64_t b) { return ks[a] < ks[b]; });
        m.reserve(n / 2 + 16);
        for (int64_t s = 0; s < n;) {
            int64_t e = s;
            uint64_t k = ks[order[s]];
            while (e < n && ks[order[e]] == k) e++;
            m.emplace(k, std::make_pair(s, e));
            s = e;
        }
    };

    std::vector<int64_t> order_pts, order_c;
    std::unordered_map<uint64_t, std::pair<int64_t, int64_t>> cells, cells_c;
    std::vector<uint64_t> keys_c;
    build_grid(cell_of_f, order_pts, cells, keys);
    build_grid(cell_of_c, order_c, cells_c, keys_c);

    // --- capped nearest in-radius neighbors per point; half-edge dedup ---
    struct Cand { float d2; int64_t j; };
    std::vector<uint64_t> half;  // packed (i << 32 | j), j < i; n < 2^31
    half.reserve((size_t)n * 8);
    std::vector<float> half_w;
    half_w.reserve((size_t)n * 8);
    std::vector<Cand> cands;
    auto prune = [&](void) -> float {
        // keep the max_neighbors nearest; return their max d2
        if ((int64_t)cands.size() > max_neighbors) {
            std::nth_element(cands.begin(), cands.begin() + max_neighbors,
                             cands.end(),
                             [](const Cand &a, const Cand &b) { return a.d2 < b.d2; });
            cands.resize(max_neighbors);
        }
        float kth = 0.0f;
        for (const Cand &cd : cands) kth = std::max(kth, cd.d2);
        return kth;
    };
    for (int64_t i = 0; i < n; i++) {
        int64_t c[3];
        cell_of_f(i, c);
        cands.clear();
        // scan rings of FINE cells outward (Chebyshev shells); a ring at
        // cell distance r cannot contain a point nearer than (r-1)*cellF,
        // so once the neighbor cap is full of nearer points the search
        // stops — dense clouds terminate after a couple of rings
        int64_t visited = 0;
        bool fallback = false;
        for (int64_t r = 0; r <= rmax && !fallback; r++) {
            if ((int64_t)cands.size() >= max_neighbors) {
                double ring_min = (double)(r - 1) * cellF;
                if (ring_min > 0.0) {
                    float kth = prune();
                    if ((double)kth <= ring_min * ring_min) break;
                }
            }
            for (int64_t dx = -r; dx <= r && !fallback; dx++)
                for (int64_t dy = -r; dy <= r && !fallback; dy++)
                    for (int64_t dz = -r; dz <= r; dz++) {
                        // shell only: at least one coordinate at +-r
                        if (std::max({std::llabs(dx), std::llabs(dy),
                                      std::llabs(dz)}) != r)
                            continue;
                        if (c[0] + dx < 0 || c[1] + dy < 0 || c[2] + dz < 0)
                            continue;
                        if (++visited > kBudget) { fallback = true; break; }
                        auto it = cells.find(
                            pack(c[0] + dx, c[1] + dy, c[2] + dz));
                        if (it == cells.end()) continue;
                        for (int64_t s = it->second.first;
                             s < it->second.second; s++) {
                            int64_t j = order_pts[s];
                            if (j == i) continue;
                            float ddx = pts[3 * i] - pts[3 * j];
                            float ddy = pts[3 * i + 1] - pts[3 * j + 1];
                            float ddz = pts[3 * i + 2] - pts[3 * j + 2];
                            float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                            if (d2 <= radius_sq) cands.push_back({d2, j});
                        }
                    }
        }
        if (fallback) {
            // sparse neighborhood at fine scale: the exact 27-cell scan of
            // the COARSE (cell == radius) grid is cheap for exactly the
            // points that reach here
            cands.clear();
            int64_t cc[3];
            cell_of_c(i, cc);
            for (int64_t dx = -1; dx <= 1; dx++)
                for (int64_t dy = -1; dy <= 1; dy++)
                    for (int64_t dz = -1; dz <= 1; dz++) {
                        if (cc[0] + dx < 0 || cc[1] + dy < 0 || cc[2] + dz < 0)
                            continue;
                        auto it = cells_c.find(
                            pack(cc[0] + dx, cc[1] + dy, cc[2] + dz));
                        if (it == cells_c.end()) continue;
                        for (int64_t s = it->second.first;
                             s < it->second.second; s++) {
                            int64_t j = order_c[s];
                            if (j == i) continue;
                            float ddx = pts[3 * i] - pts[3 * j];
                            float ddy = pts[3 * i + 1] - pts[3 * j + 1];
                            float ddz = pts[3 * i + 2] - pts[3 * j + 2];
                            float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                            if (d2 <= radius_sq) cands.push_back({d2, j});
                        }
                    }
        }
        prune();
        for (const Cand &cd : cands) {
            int64_t a = std::max(i, cd.j), b = std::min(i, cd.j);
            half.push_back(((uint64_t)a << 32) | (uint64_t)b);
            half_w.push_back(1.0f - cd.d2 / radius_sq);
        }
    }
    // dedup (each pair can appear from both endpoints)
    std::vector<int64_t> eidx(half.size());
    for (size_t i = 0; i < half.size(); i++) eidx[i] = (int64_t)i;
    std::sort(eidx.begin(), eidx.end(),
              [&](int64_t a, int64_t b) { return half[a] < half[b]; });
    std::vector<int64_t> he_i, he_j;
    std::vector<float> he_w;
    he_i.reserve(half.size());
    he_j.reserve(half.size());
    he_w.reserve(half.size());
    uint64_t prev = ~0ull;
    for (int64_t id : eidx) {
        if (half[id] == prev) continue;
        prev = half[id];
        he_i.push_back((int64_t)(half[id] >> 32));
        he_j.push_back((int64_t)(half[id] & 0xffffffffull));
        he_w.push_back(half_w[id]);
    }
    const int64_t m = (int64_t)he_i.size();

    // --- clamped density power iteration (heuristic.cpp:102-136) ---
    std::vector<double> density(n, 1.0), score(n, 0.0);
    for (int32_t it = 0; it < max_iters; it++) {
        std::fill(score.begin(), score.end(), 0.0);
        double total = 0.0;
        for (int64_t e = 0; e < m; e++) {
            double wij = he_w[e];
            score[he_i[e]] += density[he_j[e]] * wij;
            score[he_j[e]] += density[he_i[e]] * wij;
        }
        for (int64_t i = 0; i < n; i++) total += score[i];
        if (total <= 0) break;
        double norm = (double)n / total, change = 0.0;
        for (int64_t i = 0; i < n; i++) {
            double nd = std::min(score[i] * norm, 2.0);
            change += (density[i] - nd) * (density[i] - nd);
            density[i] = nd;
        }
        if (change / n <= 1e-6) break;
    }

    // --- greedy suppression (heuristic.cpp:139-163) ---
    // CSR over lower-index neighbors, grouped by he_i (already sorted)
    std::vector<int64_t> ptr(n + 1, 0);
    for (int64_t e = 0; e < m; e++) ptr[he_i[e] + 1]++;
    for (int64_t i = 0; i < n; i++) ptr[i + 1] += ptr[i];
    std::vector<int64_t> ord(n);
    for (int64_t i = 0; i < n; i++) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
        return density[a] > density[b];
    });
    int64_t nkept = 0;
    for (int64_t t = 0; t < n; t++) {
        int64_t i = ord[t];
        if (score[i] < density_limit) continue;
        double local = density[i];
        for (int64_t e = ptr[i]; e < ptr[i + 1]; e++)
            score[he_j[e]] -= local * he_w[e];
        out_kept[nkept++] = i;
    }
    std::sort(out_kept, out_kept + nkept);
    if (out_density)
        for (int64_t i = 0; i < n; i++) out_density[i] = (float)density[i];
    if (out_score)
        for (int64_t i = 0; i < n; i++) out_score[i] = (float)score[i];
    return nkept;
}

}  // extern "C"

extern "C" {

// Density power iteration + greedy suppression over a PRECOMPUTED half-edge
// graph (j < i), the hybrid used by points/filter.py: neighbor search stays
// in scipy's kd-tree (pruned kNN beats grid scans on surface-like clouds),
// while the O(iters * edges) iteration and the sequential greedy run here.
int64_t density_greedy_native(const int64_t *he_i, const int64_t *he_j,
                              const float *he_w, int64_t m, int64_t n,
                              float density_limit, int32_t max_iters,
                              int64_t *out_kept, float *out_density,
                              float *out_score) {
    std::vector<double> density(n, 1.0), score(n, 0.0);
    for (int32_t it = 0; it < max_iters; it++) {
        std::fill(score.begin(), score.end(), 0.0);
        double total = 0.0;
        for (int64_t e = 0; e < m; e++) {
            double wij = he_w[e];
            score[he_i[e]] += density[he_j[e]] * wij;
            score[he_j[e]] += density[he_i[e]] * wij;
        }
        for (int64_t i = 0; i < n; i++) total += score[i];
        if (total <= 0) break;
        double norm = (double)n / total, change = 0.0;
        for (int64_t i = 0; i < n; i++) {
            double nd = std::min(score[i] * norm, 2.0);
            change += (density[i] - nd) * (density[i] - nd);
            density[i] = nd;
        }
        if (change / n <= 1e-6) break;
    }

    // CSR over lower-index neighbors; edges must be grouped by he_i
    // (points/filter.py sorts them)
    std::vector<int64_t> ptr(n + 1, 0);
    for (int64_t e = 0; e < m; e++) ptr[he_i[e] + 1]++;
    for (int64_t i = 0; i < n; i++) ptr[i + 1] += ptr[i];
    std::vector<int64_t> ord(n);
    for (int64_t i = 0; i < n; i++) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
        return density[a] > density[b];
    });
    int64_t nkept = 0;
    for (int64_t t = 0; t < n; t++) {
        int64_t i = ord[t];
        if (score[i] < density_limit) continue;
        double local = density[i];
        for (int64_t e = ptr[i]; e < ptr[i + 1]; e++)
            score[he_j[e]] -= local * he_w[e];
        out_kept[nkept++] = i;
    }
    std::sort(out_kept, out_kept + nkept);
    if (out_density)
        for (int64_t i = 0; i < n; i++) out_density[i] = (float)density[i];
    if (out_score)
        for (int64_t i = 0; i < n; i++) out_score[i] = (float)score[i];
    return nkept;
}

}  // extern "C"
