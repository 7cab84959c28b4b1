// Intrinsic Delaunay edge flipping — native core.
//
// C++ implementation of geometry/intrinsic_delaunay.py's flip loop (same
// algorithm, same halfedge layout, same greedy twin pairing); the Python
// version is the readable reference and fallback, this one handles the
// 10^5..10^6-halfedge covers of dense meshes and point-cloud local
// triangulations (reference workloads: human_cloud400k) at native speed.
//
// Exported C ABI (see geometry/intrinsic_delaunay.py for the ctypes bridge):
//   idt_flip(F, faces[F*3] int64 in/out as src-per-halfedge layout, ...)
// operates in place on caller-allocated arrays.

#include <cstdint>
#include <cmath>
#include <vector>
#include <deque>
#include <algorithm>
#include <unordered_map>

namespace {

struct Mesh {
    int64_t H;
    std::vector<int64_t> src, dst, nxt, twin;
    std::vector<double> elen;
};

inline double corner_cot(double a, double b, double c) {
    // cot of the angle opposite side a; Kahan-stable 4*Area.
    double x = a, y = b, z = c;
    if (x < y) std::swap(x, y);
    if (x < z) std::swap(x, z);
    if (y < z) std::swap(y, z);  // x >= y >= z
    double arg = (x + (y + z)) * (z - (x - y)) * (z + (x - y)) * (x + (y - z));
    double area4 = std::sqrt(arg > 1e-300 ? arg : 1e-300);
    return (b * b + c * c - a * a) / area4;
}

inline bool is_delaunay(const Mesh& m, int64_t h, double eps = 1e-12) {
    int64_t t = m.twin[h];
    if (t < 0) return true;
    int64_t a1 = m.nxt[h], b1 = m.nxt[a1];
    int64_t a2 = m.nxt[t], b2 = m.nxt[a2];
    double c1 = corner_cot(m.elen[h], m.elen[a1], m.elen[b1]);
    double c2 = corner_cot(m.elen[t], m.elen[a2], m.elen[b2]);
    return c1 + c2 >= -eps;
}

inline double flipped_length(const Mesh& m, int64_t h) {
    int64_t t = m.twin[h];
    int64_t a1 = m.nxt[h], b1 = m.nxt[a1];
    int64_t a2 = m.nxt[t], b2 = m.nxt[a2];
    double l_uv = m.elen[h];
    double l_vw1 = m.elen[a1], l_w1u = m.elen[b1];
    double l_uw2 = m.elen[a2], l_w2v = m.elen[b2];
    double x1 = (l_uv * l_uv + l_w1u * l_w1u - l_vw1 * l_vw1) / (2.0 * l_uv);
    double y1s = l_w1u * l_w1u - x1 * x1;
    double y1 = std::sqrt(y1s > 0 ? y1s : 0);
    double x2 = (l_uv * l_uv + l_uw2 * l_uw2 - l_w2v * l_w2v) / (2.0 * l_uv);
    double y2s = l_uw2 * l_uw2 - x2 * x2;
    double y2 = -std::sqrt(y2s > 0 ? y2s : 0);
    double dx = x1 - x2, dy = y1 - y2;
    return std::sqrt(dx * dx + dy * dy);
}

}  // namespace

extern "C" {

// faces: [F*3] int64, lengths: [F*3] double (opposite-corner convention),
// faces_out/lengths_out same shapes. Returns flip count, or -1 on a broken
// halfedge structure.
int64_t idt_flip(int64_t F,
                 const int64_t* faces,
                 const double* lengths,
                 int64_t* faces_out,
                 double* lengths_out,
                 int64_t max_flips) {
    Mesh m;
    m.H = 3 * F;
    m.src.resize(m.H);
    m.dst.resize(m.H);
    m.elen.resize(m.H);
    m.nxt.resize(m.H);
    m.twin.assign(m.H, -1);

    for (int64_t f = 0; f < F; ++f) {
        for (int s = 0; s < 3; ++s) {
            int64_t h = 3 * f + s;
            m.src[h] = faces[3 * f + s];
            m.dst[h] = faces[3 * f + (s + 1) % 3];
            m.elen[h] = lengths[3 * f + (s + 2) % 3];
            m.nxt[h] = 3 * f + (s + 1) % 3;
        }
    }

    // Greedy opposite-direction twin matching per undirected edge
    // (identical to the Python pairing: halfedges in index order).
    {
        std::unordered_map<uint64_t, std::pair<std::vector<int64_t>, std::vector<int64_t>>> by_edge;
        by_edge.reserve(m.H);
        for (int64_t h = 0; h < m.H; ++h) {
            int64_t lo = std::min(m.src[h], m.dst[h]);
            int64_t hi = std::max(m.src[h], m.dst[h]);
            uint64_t key = (static_cast<uint64_t>(lo) << 32) ^ static_cast<uint64_t>(hi);
            auto& buckets = by_edge[key];
            (m.src[h] == lo ? buckets.first : buckets.second).push_back(h);
        }
        for (auto& kv : by_edge) {
            auto& fwd = kv.second.first;
            auto& bwd = kv.second.second;
            size_t n = std::min(fwd.size(), bwd.size());
            for (size_t i = 0; i < n; ++i) {
                m.twin[fwd[i]] = bwd[i];
                m.twin[bwd[i]] = fwd[i];
            }
        }
    }

    std::deque<int64_t> queue;
    std::vector<uint8_t> in_queue(m.H, 0);
    for (int64_t h = 0; h < m.H; ++h) {
        if (m.twin[h] >= 0 && h < m.twin[h]) {
            queue.push_back(h);
            in_queue[h] = 1;
        }
    }

    int64_t flips = 0;
    int64_t limit = max_flips > 0 ? max_flips : 100 * m.H;

    while (!queue.empty() && flips < limit) {
        int64_t h = queue.front();
        queue.pop_front();
        in_queue[h] = 0;
        if (m.twin[h] < 0 || is_delaunay(m, h)) continue;

        int64_t t = m.twin[h];
        int64_t a1 = m.nxt[h], b1 = m.nxt[a1];
        int64_t a2 = m.nxt[t], b2 = m.nxt[a2];
        int64_t w1 = m.dst[a1], w2 = m.dst[a2];

        double new_len = flipped_length(m, h);

        m.src[h] = w2; m.dst[h] = w1;
        m.src[t] = w1; m.dst[t] = w2;
        m.elen[h] = m.elen[t] = new_len;

        // f1' = h -> b1 -> a2 ; f2' = t -> b2 -> a1
        m.nxt[h] = b1; m.nxt[b1] = a2; m.nxt[a2] = h;
        m.nxt[t] = b2; m.nxt[b2] = a1; m.nxt[a1] = t;
        ++flips;

        const int64_t nbs[4] = {a1, b1, a2, b2};
        for (int64_t nb : nbs) {
            if (m.twin[nb] < 0) continue;
            int64_t e = std::min(nb, m.twin[nb]);
            if (!in_queue[e]) {
                queue.push_back(e);
                in_queue[e] = 1;
            }
        }
    }

    // Recover faces + per-face lengths from the 3-cycles.
    std::vector<uint8_t> visited(m.H, 0);
    int64_t f = 0;
    for (int64_t h = 0; h < m.H; ++h) {
        if (visited[h]) continue;
        int64_t h1 = m.nxt[h], h2 = m.nxt[h1];
        if (m.nxt[h2] != h) return -1;  // broken cycle
        visited[h] = visited[h1] = visited[h2] = 1;
        faces_out[3 * f + 0] = m.src[h];
        faces_out[3 * f + 1] = m.src[h1];
        faces_out[3 * f + 2] = m.src[h2];
        lengths_out[3 * f + 0] = m.elen[h1];
        lengths_out[3 * f + 1] = m.elen[h2];
        lengths_out[3 * f + 2] = m.elen[h];
        ++f;
    }
    if (f != F) return -1;
    return flips;
}

}  // extern "C"
