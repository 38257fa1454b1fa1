// Native host runtime for the TPU MVS engine.
//
// The device (JAX/Pallas) owns all dense math; this library owns the
// irregular host-side bookkeeping that Python loops handle too slowly at
// scale — the per-camera cell grids and the wavefront-expansion candidate
// generation (reference: TMVS/mvs/cellmap.{h,cpp} and the host half of
// MVS::expansionPatches / skipNeighborCell / runtimeFiltering's density
// clause, TMVS/mvs/mvs.cpp:529-601, 792-807, 877-895), plus the
// grid-hashed Euclidean neighbour counting of neighborPatchFiltering
// (mvs.cpp:448-525; the reference is an O(N^2) OMP loop — the spatial
// hash gives the same counts in ~O(N)).
//
// Plain C ABI (ctypes-loaded); geometry in double to match the host arena.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
    int num_cams;
    int cell_size;
    std::vector<int> gw, gh;                       // per-camera grid dims
    std::unordered_map<int64_t, std::vector<int>> cells;

    int64_t key(int cam, int cx, int cy) const {
        return (static_cast<int64_t>(cam) << 42) |
               (static_cast<int64_t>(cx) << 21) | static_cast<int64_t>(cy);
    }
    bool in_map(int cam, int cx, int cy) const {
        return cx >= 0 && cx < gw[cam] && cy >= 0 && cy < gh[cam];
    }
};

inline void cell_of(const Grid* g, double px, double py, int* cx, int* cy) {
    *cx = static_cast<int>(px / g->cell_size);
    *cy = static_cast<int>(py / g->cell_size);
}

inline void normal_of(const double* sph, double* n) {
    const double st = std::sin(sph[0]);
    n[0] = st * std::cos(sph[1]);
    n[1] = st * std::sin(sph[1]);
    n[2] = std::cos(sph[0]);
}

}  // namespace

extern "C" {

void* tg_create(int num_cams, const int* widths, const int* heights,
                int cell_size) {
    Grid* g = new Grid;
    g->num_cams = num_cams;
    g->cell_size = cell_size;
    g->gw.resize(num_cams);
    g->gh.resize(num_cams);
    for (int c = 0; c < num_cams; ++c) {
        g->gw[c] = (widths[c] + cell_size - 1) / cell_size;
        g->gh[c] = (heights[c] + cell_size - 1) / cell_size;
    }
    return g;
}

void tg_destroy(void* h) { delete static_cast<Grid*>(h); }

int tg_grid_dims(void* h, int cam, int* w, int* out_h) {
    Grid* g = static_cast<Grid*>(h);
    if (cam < 0 || cam >= g->num_cams) return -1;
    *w = g->gw[cam];
    *out_h = g->gh[cam];
    return 0;
}

// Insert/remove one patch into every visible camera's grid
// (CellMap::insert/drop, TMVS/mvs/cellmap.cpp:18-38).
void tg_insert_patch(void* h, int pid, const uint8_t* cam_mask,
                     const double* img_pts /* [C, 2] */) {
    Grid* g = static_cast<Grid*>(h);
    for (int c = 0; c < g->num_cams; ++c) {
        if (!cam_mask[c]) continue;
        int cx, cy;
        cell_of(g, img_pts[2 * c], img_pts[2 * c + 1], &cx, &cy);
        if (g->in_map(c, cx, cy)) g->cells[g->key(c, cx, cy)].push_back(pid);
    }
}

void tg_remove_patch(void* h, int pid, const uint8_t* cam_mask,
                     const double* img_pts) {
    Grid* g = static_cast<Grid*>(h);
    for (int c = 0; c < g->num_cams; ++c) {
        if (!cam_mask[c]) continue;
        int cx, cy;
        cell_of(g, img_pts[2 * c], img_pts[2 * c + 1], &cx, &cy);
        auto it = g->cells.find(g->key(c, cx, cy));
        if (it == g->cells.end()) continue;
        auto& v = it->second;
        for (size_t i = 0; i < v.size(); ++i) {
            if (v[i] == pid) { v.erase(v.begin() + i); break; }
        }
    }
}

// Enumerate non-empty cells. Returns the count; fills up to max_out
// (cam, cx, cy) triples when the buffers are non-null.
int tg_all_cells(void* h, int* out_cam, int* out_cx, int* out_cy,
                 int max_out) {
    Grid* g = static_cast<Grid*>(h);
    int n = 0;
    for (const auto& kv : g->cells) {
        if (kv.second.empty()) continue;
        if (out_cam != nullptr && n < max_out) {
            out_cam[n] = static_cast<int>(kv.first >> 42);
            out_cx[n] = static_cast<int>((kv.first >> 21) & 0x1FFFFF);
            out_cy[n] = static_cast<int>(kv.first & 0x1FFFFF);
        }
        ++n;
    }
    return n;
}

int tg_cell_count(void* h, int cam, int cx, int cy) {
    Grid* g = static_cast<Grid*>(h);
    auto it = g->cells.find(g->key(cam, cx, cy));
    return it == g->cells.end() ? 0 : static_cast<int>(it->second.size());
}

int tg_cell_ids(void* h, int cam, int cx, int cy, int* out, int max_out) {
    Grid* g = static_cast<Grid*>(h);
    auto it = g->cells.find(g->key(cam, cx, cy));
    if (it == g->cells.end()) return 0;
    int n = static_cast<int>(it->second.size());
    if (n > max_out) n = max_out;
    std::memcpy(out, it->second.data(), n * sizeof(int));
    return n;
}

// The insert-time density clause of MVS::runtimeFiltering
// (mvs.cpp:877-895): pass iff NOT every visible view's target cell is full.
int tg_insert_time_filter(void* h, const uint8_t* cam_mask,
                          const double* img_pts, int max_cell_patch_num) {
    Grid* g = static_cast<Grid*>(h);
    int cams = 0, full = 0;
    for (int c = 0; c < g->num_cams; ++c) {
        if (!cam_mask[c]) continue;
        ++cams;
        int cx, cy;
        cell_of(g, img_pts[2 * c], img_pts[2 * c + 1], &cx, &cy);
        if (tg_cell_count(h, c, cx, cy) >= max_cell_patch_num) ++full;
    }
    return full < cams ? 1 : 0;
}

// Wavefront candidate generation: for every parent x visible camera x
// 4-neighbour cell, apply skipNeighborCell (mvs.cpp:792-807: density cap,
// confident occupant, geometric neighbour) and the per-round seen-cells
// budget. Emits (parent, cam, cx, cy) quads. Returns the count (<= max_out;
// negative if max_out was too small).
int tg_candidates(void* h,
                  const int64_t* parents, int n_parents,
                  const double* centers,       // [N, 3] arena
                  const double* normal_sph,    // [N, 2]
                  const double* correlation,   // [N]
                  const uint8_t* alive,        // [N]
                  const uint8_t* cam_mask,     // [N, C]
                  const double* img_pts,       // [N, C, 2]
                  double min_correlation, double neighbor_radius,
                  int max_cell_patch_num,
                  int64_t* out_parent, int* out_cam, int* out_cx,
                  int* out_cy, int max_out) {
    Grid* g = static_cast<Grid*>(h);
    const int C = g->num_cams;
    int n_out = 0;
    std::unordered_map<int64_t, int> seen;   // per-round cell budget
    static const int offs[4][2] = {{-1, 0}, {0, -1}, {1, 0}, {0, 1}};

    for (int pi = 0; pi < n_parents; ++pi) {
        const int64_t pid = parents[pi];
        double n1[3];
        normal_of(normal_sph + 2 * pid, n1);
        const double* c1 = centers + 3 * pid;

        for (int cam = 0; cam < C; ++cam) {
            if (!cam_mask[pid * C + cam]) continue;
            int cx, cy;
            cell_of(g, img_pts[(pid * C + cam) * 2],
                    img_pts[(pid * C + cam) * 2 + 1], &cx, &cy);
            for (int o = 0; o < 4; ++o) {
                const int nx = cx + offs[o][0];
                const int ny = cy + offs[o][1];
                if (!g->in_map(cam, nx, ny)) continue;
                const int64_t k = g->key(cam, nx, ny);

                // skipNeighborCell over the live occupants
                auto it = g->cells.find(k);
                int occ_n = 0;
                bool skip = false;
                if (it != g->cells.end()) {
                    occ_n = static_cast<int>(it->second.size());
                    if (occ_n >= max_cell_patch_num) skip = true;
                    if (!skip) {
                        for (int q : it->second) {
                            if (!alive[q]) continue;
                            if (correlation[q] > min_correlation) {
                                skip = true;
                                break;
                            }
                            double n2[3];
                            normal_of(normal_sph + 2 * q, n2);
                            const double* c2 = centers + 3 * q;
                            const double d[3] = {c2[0] - c1[0], c2[1] - c1[1],
                                                 c2[2] - c1[2]};
                            const double dist =
                                std::fabs(d[0]*n1[0] + d[1]*n1[1] + d[2]*n1[2])
                              + std::fabs(d[0]*n2[0] + d[1]*n2[1] + d[2]*n2[2]);
                            if (dist <= neighbor_radius) { skip = true; break; }
                        }
                    }
                }
                if (skip) continue;
                auto se = seen.find(k);
                int cnt = (se == seen.end()) ? occ_n : se->second;
                if (cnt >= max_cell_patch_num) continue;
                seen[k] = cnt + 1;
                if (n_out >= max_out) return -1;
                out_parent[n_out] = pid;
                out_cam[n_out] = cam;
                out_cx[n_out] = nx;
                out_cy[n_out] = ny;
                ++n_out;
            }
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// post filters (mvs.cpp:279-446). Each mirrors the Python loop exactly —
// cells processed in the caller-supplied order, deletions effective
// immediately (alive flag + grid removal) — so native and Python paths
// stay bit-identical. out_kill records deleted ids; returns the count.
// ---------------------------------------------------------------------------

static void kill_patch(Grid* g, int64_t pid, const uint8_t* cam_mask,
                       const double* img_pts, uint8_t* alive, int C) {
    alive[pid] = 0;
    tg_remove_patch(g, static_cast<int>(pid), cam_mask + pid * C,
                    img_pts + pid * C * 2);
}

// PMVS outlier rule (mvs.cpp:279-325): in each cell drop patch j when
// corr_j * camNum_j < sum of cellmates' correlations.
int tg_cell_filter(void* h, const int* cams, const int* cxs, const int* cys,
                   int n_cells, const double* correlation,
                   const uint8_t* cam_mask, const double* img_pts,
                   uint8_t* alive, int64_t* out_kill, int max_out) {
    Grid* g = static_cast<Grid*>(h);
    const int C = g->num_cams;
    int n_kill = 0;
    std::vector<int> occ;
    std::vector<int64_t> kill;
    for (int ci = 0; ci < n_cells; ++ci) {
        auto it = g->cells.find(g->key(cams[ci], cxs[ci], cys[ci]));
        if (it == g->cells.end()) continue;
        occ.clear();
        for (int q : it->second)
            if (alive[q]) occ.push_back(q);
        if (occ.size() < 2) continue;
        double tot = 0.0;
        for (int q : occ) tot += correlation[q];
        kill.clear();
        for (int q : occ) {
            int camn = 0;
            for (int c = 0; c < C; ++c) camn += cam_mask[q * C + c] ? 1 : 0;
            if (correlation[q] * camn < tot - correlation[q])
                kill.push_back(q);
        }
        for (int64_t q : kill) {
            kill_patch(g, q, cam_mask, img_pts, alive, C);
            if (n_kill < max_out) out_kill[n_kill] = q;
            ++n_kill;
        }
    }
    return n_kill;
}

// Depth-ordering consistency per view (mvs.cpp:399-446): a view stops
// counting when any live cellmate is closer to that camera; drop the patch
// when fewer than min_cam_num views remain.
int tg_visibility_filter(void* h, const int64_t* ids, int n_ids,
                         const double* centers, const double* cam_centers,
                         const uint8_t* cam_mask, const double* img_pts,
                         uint8_t* alive, int min_cam_num,
                         int64_t* out_kill, int max_out) {
    Grid* g = static_cast<Grid*>(h);
    const int C = g->num_cams;
    int n_kill = 0;
    for (int i = 0; i < n_ids; ++i) {
        const int64_t pid = ids[i];
        if (!alive[pid]) continue;
        const double* p = centers + 3 * pid;
        int visible = 0;
        for (int c = 0; c < C; ++c) visible += cam_mask[pid * C + c] ? 1 : 0;
        for (int c = 0; c < C; ++c) {
            if (!cam_mask[pid * C + c]) continue;
            const double* cc = cam_centers + 3 * c;
            const double d0 = p[0]-cc[0], d1 = p[1]-cc[1], d2 = p[2]-cc[2];
            const double depth2 = d0*d0 + d1*d1 + d2*d2;
            int cx, cy;
            cell_of(g, img_pts[(pid * C + c) * 2],
                    img_pts[(pid * C + c) * 2 + 1], &cx, &cy);
            auto it = g->cells.find(g->key(c, cx, cy));
            if (it == g->cells.end()) continue;
            for (int q : it->second) {
                if (q == pid || !alive[q]) continue;
                const double* pq = centers + 3 * q;
                const double e0 = pq[0]-cc[0], e1 = pq[1]-cc[1],
                             e2 = pq[2]-cc[2];
                if (depth2 > e0*e0 + e1*e1 + e2*e2) { --visible; break; }
            }
        }
        if (visible < min_cam_num) {
            kill_patch(g, pid, cam_mask, img_pts, alive, C);
            if (n_kill < max_out) out_kill[n_kill] = pid;
            ++n_kill;
        }
    }
    return n_kill;
}

// 3x3-cell neighbourhood support ratio (mvs.cpp:327-397): per cell, drop
// patches whose fraction of geometric neighbours (isNeighbor) among the
// neighbourhood's occupants is below the ratio. Kills apply after each
// cell (matching the reference's per-cell collect-then-delete).
int tg_neighbor_cell_filter(void* h, const int* cams, const int* cxs,
                            const int* cys, int n_cells,
                            const double* centers, const double* normal_sph,
                            const uint8_t* cam_mask, const double* img_pts,
                            uint8_t* alive, double neighbor_radius,
                            double ratio, int64_t* out_kill, int max_out) {
    Grid* g = static_cast<Grid*>(h);
    const int C = g->num_cams;
    int n_kill = 0;
    std::vector<int64_t> kill;
    for (int ci = 0; ci < n_cells; ++ci) {
        const int cam = cams[ci], x = cxs[ci], y = cys[ci];
        auto it = g->cells.find(g->key(cam, x, y));
        if (it == g->cells.end()) continue;
        kill.clear();
        // snapshot: the Python loop lists occupants before killing any
        std::vector<int> occ;
        for (int q : it->second)
            if (alive[q]) occ.push_back(q);
        for (int pid : occ) {
            double n1[3];
            normal_of(normal_sph + 2 * pid, n1);
            const double* c1 = centers + 3 * pid;
            int64_t nsum = 0, nnum = 0;
            for (int dx = -1; dx <= 1; ++dx) {
                for (int dy = -1; dy <= 1; ++dy) {
                    const int nx = x + dx, ny = y + dy;
                    if (!g->in_map(cam, nx, ny)) continue;
                    auto jt = g->cells.find(g->key(cam, nx, ny));
                    if (jt == g->cells.end()) continue;
                    for (int q : jt->second) {
                        if (!alive[q]) continue;
                        ++nsum;
                        double n2[3];
                        normal_of(normal_sph + 2 * q, n2);
                        const double* c2 = centers + 3 * q;
                        const double d[3] = {c2[0]-c1[0], c2[1]-c1[1],
                                             c2[2]-c1[2]};
                        const double dist =
                            std::fabs(d[0]*n1[0] + d[1]*n1[1] + d[2]*n1[2])
                          + std::fabs(d[0]*n2[0] + d[1]*n2[1] + d[2]*n2[2]);
                        if (dist <= neighbor_radius) ++nnum;
                    }
                }
            }
            if (nsum && static_cast<double>(nnum) / nsum < ratio)
                kill.push_back(pid);
        }
        for (int64_t q : kill) {
            kill_patch(g, q, cam_mask, img_pts, alive, C);
            if (n_kill < max_out) out_kill[n_kill] = q;
            ++n_kill;
        }
    }
    return n_kill;
}

// Sequential accepted-patch insertion for one expansion round: walks the
// candidates in priority order and, before each insert, re-applies BOTH
// runtimeFiltering's density clause (mvs.cpp:877-895) AND the
// skipNeighborCell test of the candidate's TARGET cell (mvs.cpp:792-807)
// against the LIVE grid state — in the serial reference, a patch inserted
// earlier in the round is visible to every later candidate-generation
// check, and without this re-check a wavefront round over-fills cells
// ~1.7x vs the reference (measured against the serial oracle).
// Occupants with id >= first_id are this round's own inserts; their
// geometry is read from the CANDIDATE arrays via new_row[].
// Survivors get consecutive ids starting at first_id; marks out_accept;
// returns the number inserted.
int tg_batch_insert(void* h, const int64_t* order, int n,
                    const uint8_t* keep, const uint8_t* cam_masks,
                    const double* img_pts,
                    const int64_t* parents,      // [N] arena parent ids
                    const int* cand_cam, const int* cand_cx,
                    const int* cand_cy,          // [N] target cells
                    const double* centers,       // arena [*, 3]
                    const double* normal_sph,    // arena [*, 2]
                    const double* correlation,   // arena [*]
                    const uint8_t* alive,        // arena [*]
                    const double* cand_center,   // [N, 3] refined
                    const double* cand_sph,      // [N, 2]
                    const double* cand_corr,     // [N]
                    double min_correlation, double neighbor_radius,
                    int max_cell_patch_num,
                    int64_t first_id, uint8_t* out_accept) {
    Grid* g = static_cast<Grid*>(h);
    const int C = g->num_cams;
    int n_acc = 0;
    std::vector<int> new_row;                    // id - first_id -> cand row
    for (int k = 0; k < n; ++k) {
        const int64_t i = order[k];
        out_accept[i] = 0;
        if (!keep[i]) continue;
        if (!tg_insert_time_filter(h, cam_masks + i * C,
                                   img_pts + i * C * 2,
                                   max_cell_patch_num)) continue;
        // skipNeighborCell re-check on the candidate's target cell
        const int64_t pid = parents[i];
        double n1[3];
        normal_of(normal_sph + 2 * pid, n1);
        const double* c1 = centers + 3 * pid;
        auto it = g->cells.find(g->key(cand_cam[i], cand_cx[i], cand_cy[i]));
        bool skip = false;
        if (it != g->cells.end()) {
            if (static_cast<int>(it->second.size()) >= max_cell_patch_num)
                skip = true;
            for (size_t qi = 0; !skip && qi < it->second.size(); ++qi) {
                const int q = it->second[qi];
                const double* cq;
                const double* sq;
                double corrq;
                if (q >= first_id) {
                    const int row = new_row[q - first_id];
                    cq = cand_center + 3 * row;
                    sq = cand_sph + 2 * row;
                    corrq = cand_corr[row];
                } else {
                    if (!alive[q]) continue;
                    cq = centers + 3 * q;
                    sq = normal_sph + 2 * q;
                    corrq = correlation[q];
                }
                if (corrq > min_correlation) { skip = true; break; }
                double n2[3];
                normal_of(sq, n2);
                const double d[3] = {cq[0]-c1[0], cq[1]-c1[1], cq[2]-c1[2]};
                const double dist =
                    std::fabs(d[0]*n1[0] + d[1]*n1[1] + d[2]*n1[2])
                  + std::fabs(d[0]*n2[0] + d[1]*n2[1] + d[2]*n2[2]);
                if (dist <= neighbor_radius) { skip = true; break; }
            }
        }
        if (skip) continue;
        tg_insert_patch(h, static_cast<int>(first_id + n_acc),
                        cam_masks + i * C, img_pts + i * C * 2);
        new_row.push_back(static_cast<int>(i));
        out_accept[i] = 1;
        ++n_acc;
    }
    return n_acc;
}

// Grid-hashed Euclidean neighbour counts (neighborPatchFiltering's inner
// O(N^2) loop, mvs.cpp:465-508): count patches within ``radius`` of each
// patch (excluding self). Same counts as brute force.
void tg_neighbor_counts(const double* centers, const int64_t* ids, int n,
                        double radius, int64_t* out_counts) {
    if (n == 0) return;
    const double cell = radius > 0 ? radius : 1.0;
    std::unordered_map<uint64_t, std::vector<int>> hash;
    hash.reserve(n * 2);
    auto kf = [](int64_t ix, int64_t iy, int64_t iz) -> uint64_t {
        // unsigned arithmetic: signed overflow would be UB
        return (static_cast<uint64_t>(ix) * 73856093ull) ^
               (static_cast<uint64_t>(iy) * 19349663ull) ^
               (static_cast<uint64_t>(iz) * 83492791ull);
    };
    std::vector<int64_t> cx(n), cy(n), cz(n);
    for (int i = 0; i < n; ++i) {
        const double* p = centers + 3 * ids[i];
        cx[i] = static_cast<int64_t>(std::floor(p[0] / cell));
        cy[i] = static_cast<int64_t>(std::floor(p[1] / cell));
        cz[i] = static_cast<int64_t>(std::floor(p[2] / cell));
        hash[kf(cx[i], cy[i], cz[i])].push_back(i);
    }
    const double r2 = radius * radius;
    for (int i = 0; i < n; ++i) {
        const double* p = centers + 3 * ids[i];
        int64_t count = 0;
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t ix = cx[i] + dx, iy = cy[i] + dy,
                                  iz = cz[i] + dz;
                    auto it = hash.find(kf(ix, iy, iz));
                    if (it == hash.end()) continue;
                    for (int j : it->second) {
                        if (j == i) continue;
                        // hash collisions are possible: re-check the cell
                        if (cx[j] != ix || cy[j] != iy || cz[j] != iz)
                            continue;
                        const double* q = centers + 3 * ids[j];
                        const double d0 = p[0] - q[0], d1 = p[1] - q[1],
                                     d2 = p[2] - q[2];
                        if (d0*d0 + d1*d1 + d2*d2 <= r2) ++count;
                    }
                }
        out_counts[i] = count;
    }
}

}  // extern "C"
