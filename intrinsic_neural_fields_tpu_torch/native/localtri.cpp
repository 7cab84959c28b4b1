// Local triangulation of a point cloud — native core.
//
// C++ replacement for the per-point Python loop in
// geometry/pointcloud.local_triangulation (which itself replaces the
// reference's C++ potpourri3d PointCloudLocalTriangulation, reference
// mesh.py:19-36). Per point: k nearest neighbors (kd-tree), PCA tangent
// plane (Jacobi eigen of the 3x3 neighbor covariance), 2D Delaunay of the
// projected patch (Bowyer-Watson), keep triangles incident to the center,
// deduplicate globally. Semantics match the Python version: the tangent
// plane is the top-2 eigenvector span of the MEAN-centered covariance while
// offsets are measured from the center POINT, and only triangles containing
// the center survive. Delaunay triangulations agree with qhull's for points
// in general position (cocircular ties may resolve differently — both
// results are valid Delaunay triangulations and the downstream union is
// insensitive to the choice).
//
// Exported (extern "C"):
//   local_triangulation(n, points[n*3], k, faces_out[max_faces*3], max_faces)
//     -> number of faces written, or -1 if the buffer was too small
//        (caller retries with a larger buffer), or -2 if n >= 2^21
//        (dedup key packs three 21-bit ids; caller falls back to Python).
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// kd-tree (3D, median split) for k-nearest-neighbor queries
// ----------------------------------------------------------------------
struct KDTree {
  const double* pts;  // [n,3]
  int64_t n;
  std::vector<int32_t> idx;  // permutation; subtree = contiguous range

  KDTree(const double* p, int64_t n_) : pts(p), n(n_), idx(n_) {
    for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
    build(0, n, 0);
  }

  void build(int64_t lo, int64_t hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int32_t a, int32_t b) {
                       return pts[a * 3 + axis] < pts[b * 3 + axis];
                     });
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  // k nearest (including the query point itself when it is in the tree).
  // out: indices sorted by ascending distance.
  void knn(const double* q, int k, std::vector<int32_t>& out) const {
    // max-heap of (dist2, index)
    std::priority_queue<std::pair<double, int32_t>> heap;
    search(0, n, 0, q, k, heap);
    out.resize(heap.size());
    for (int64_t i = (int64_t)heap.size() - 1; i >= 0; --i) {
      out[i] = heap.top().second;
      heap.pop();
    }
  }

  void search(int64_t lo, int64_t hi, int depth, const double* q, int k,
              std::priority_queue<std::pair<double, int32_t>>& heap) const {
    if (hi <= lo) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    int32_t p = idx[mid];
    double dx = pts[p * 3] - q[0], dy = pts[p * 3 + 1] - q[1],
           dz = pts[p * 3 + 2] - q[2];
    double d2 = dx * dx + dy * dy + dz * dz;
    if ((int)heap.size() < k) {
      heap.emplace(d2, p);
    } else if (d2 < heap.top().first) {
      heap.pop();
      heap.emplace(d2, p);
    }
    double delta = q[axis] - pts[p * 3 + axis];
    int64_t near_lo = delta < 0 ? lo : mid + 1;
    int64_t near_hi = delta < 0 ? mid : hi;
    int64_t far_lo = delta < 0 ? mid + 1 : lo;
    int64_t far_hi = delta < 0 ? hi : mid;
    search(near_lo, near_hi, depth + 1, q, k, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
      search(far_lo, far_hi, depth + 1, q, k, heap);
  }
};

// ----------------------------------------------------------------------
// symmetric 3x3 eigendecomposition (cyclic Jacobi), eigenvalues ascending
// ----------------------------------------------------------------------
void eig3_sym(double a[3][3], double evals[3], double evecs[3][3]) {
  double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-30) break;
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(a[p][q]) < 1e-300) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int r = 0; r < 3; ++r) {
          double arp = a[r][p], arq = a[r][q];
          a[r][p] = c * arp - s * arq;
          a[r][q] = s * arp + c * arq;
        }
        for (int r = 0; r < 3; ++r) {
          double apr = a[p][r], aqr = a[q][r];
          a[p][r] = c * apr - s * aqr;
          a[q][r] = s * apr + c * aqr;
        }
        for (int r = 0; r < 3; ++r) {
          double vrp = v[r][p], vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
      }
  }
  int order[3] = {0, 1, 2};
  double d[3] = {a[0][0], a[1][1], a[2][2]};
  std::sort(order, order + 3, [&](int x, int y) { return d[x] < d[y]; });
  for (int i = 0; i < 3; ++i) {
    evals[i] = d[order[i]];
    for (int r = 0; r < 3; ++r) evecs[i][r] = v[r][order[i]];  // rows = vecs
  }
}

// ----------------------------------------------------------------------
// Bowyer-Watson 2D Delaunay on a small patch (m <= ~32 points)
// ----------------------------------------------------------------------
struct Tri {
  int a, b, c;   // indices into the patch point list (+3 super vertices)
  bool alive;
};

inline double orient2d(const double* pa, const double* pb, const double* pc) {
  return (pb[0] - pa[0]) * (pc[1] - pa[1]) -
         (pb[1] - pa[1]) * (pc[0] - pa[0]);
}

// d strictly inside circumcircle of CCW triangle (a,b,c)
inline bool in_circle(const double* pa, const double* pb, const double* pc,
                      const double* pd) {
  double adx = pa[0] - pd[0], ady = pa[1] - pd[1];
  double bdx = pb[0] - pd[0], bdy = pb[1] - pd[1];
  double cdx = pc[0] - pd[0], cdy = pc[1] - pd[1];
  double ad2 = adx * adx + ady * ady;
  double bd2 = bdx * bdx + bdy * bdy;
  double cd2 = cdx * cdx + cdy * cdy;
  double det = adx * (bdy * cd2 - cdy * bd2) -
               ady * (bdx * cd2 - cdx * bd2) +
               ad2 * (bdx * cdy - cdx * bdy);
  return det > 0.0;
}

// Delaunay of uv[0..m), triangles out as index triples (only those not
// touching the super-triangle). uv buffer must have room for m+3 points.
void bowyer_watson(double* uv, int m, std::vector<Tri>& tris) {
  tris.clear();
  if (m < 3) return;
  // super-triangle around the bounding box
  double minx = uv[0], maxx = uv[0], miny = uv[1], maxy = uv[1];
  for (int i = 1; i < m; ++i) {
    minx = std::min(minx, uv[2 * i]);
    maxx = std::max(maxx, uv[2 * i]);
    miny = std::min(miny, uv[2 * i + 1]);
    maxy = std::max(maxy, uv[2 * i + 1]);
  }
  double cx = 0.5 * (minx + maxx), cy = 0.5 * (miny + maxy);
  double span = std::max(maxx - minx, maxy - miny);
  if (span <= 0) span = 1.0;
  double R = 64.0 * span;
  uv[2 * m] = cx - 2.0 * R;     uv[2 * m + 1] = cy - R;
  uv[2 * (m + 1)] = cx + 2.0 * R; uv[2 * (m + 1) + 1] = cy - R;
  uv[2 * (m + 2)] = cx;         uv[2 * (m + 2) + 1] = cy + 2.0 * R;
  tris.push_back({m, m + 1, m + 2, true});

  std::vector<std::array<int, 2>> boundary;
  for (int i = 0; i < m; ++i) {
    const double* p = uv + 2 * i;
    // edge -> count among bad triangles; boundary edges appear once
    boundary.clear();
    bool any_bad = false;
    for (auto& t : tris) {
      if (!t.alive) continue;
      const double *pa = uv + 2 * t.a, *pb = uv + 2 * t.b, *pc = uv + 2 * t.c;
      // ensure CCW for the incircle test
      bool ccw = orient2d(pa, pb, pc) > 0;
      bool bad = ccw ? in_circle(pa, pb, pc, p) : in_circle(pa, pc, pb, p);
      if (!bad) continue;
      any_bad = true;
      t.alive = false;
      int e[3][2] = {{t.a, t.b}, {t.b, t.c}, {t.c, t.a}};
      for (auto& ed : e) {
        // undirected match against existing boundary entries
        bool dup = false;
        for (size_t j = 0; j < boundary.size(); ++j) {
          if ((boundary[j][0] == ed[0] && boundary[j][1] == ed[1]) ||
              (boundary[j][0] == ed[1] && boundary[j][1] == ed[0])) {
            boundary.erase(boundary.begin() + j);
            dup = true;
            break;
          }
        }
        if (!dup) boundary.push_back({ed[0], ed[1]});
      }
    }
    if (!any_bad) continue;  // duplicate / degenerate point: skip
    for (auto& ed : boundary)
      tris.push_back({ed[0], ed[1], i, true});
  }
  // drop super-triangle incidences
  for (auto& t : tris)
    if (t.alive && (t.a >= m || t.b >= m || t.c >= m)) t.alive = false;
}

}  // namespace

extern "C" int64_t local_triangulation(int64_t n, const double* points,
                                       int64_t k, int32_t* faces_out,
                                       int64_t max_faces) {
  if (n < 3) return 0;
  if (n >= (int64_t(1) << 21)) return -2;  // dedup key packs 3x21-bit ids
  int kk = (int)std::min<int64_t>(k, n);

  KDTree tree(points, n);
  std::unordered_set<uint64_t> seen;
  seen.reserve((size_t)(4 * n));
  int64_t n_faces = 0;

  std::vector<int32_t> nbrs;
  std::vector<double> uv(2 * (kk + 3));
  std::vector<int32_t> local2global(kk);
  std::vector<Tri> tris;

  for (int64_t i = 0; i < n; ++i) {
    tree.knn(points + 3 * i, kk, nbrs);
    int m = (int)nbrs.size();
    if (m < 3) continue;

    // mean-centered covariance (matches numpy _tangent_basis: SVD of the
    // mean-centered patch == eigen of its covariance)
    double mean[3] = {0, 0, 0};
    for (int j = 0; j < m; ++j)
      for (int d = 0; d < 3; ++d) mean[d] += points[3 * nbrs[j] + d];
    for (int d = 0; d < 3; ++d) mean[d] /= m;
    double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    for (int j = 0; j < m; ++j) {
      double c[3];
      for (int d = 0; d < 3; ++d) c[d] = points[3 * nbrs[j] + d] - mean[d];
      for (int a = 0; a < 3; ++a)
        for (int b = a; b < 3; ++b) cov[a][b] += c[a] * c[b];
    }
    cov[1][0] = cov[0][1];
    cov[2][0] = cov[0][2];
    cov[2][1] = cov[1][2];
    double evals[3], evecs[3][3];
    eig3_sym(cov, evals, evecs);
    const double* e1 = evecs[2];  // largest
    const double* e2 = evecs[1];  // second

    // project OFFSETS FROM THE CENTER POINT onto the tangent basis
    // (numpy: centered = nbrs - points[i]); ensure the center itself is
    // patch index 0 (its uv is exactly (0,0))
    int center_local = -1;
    for (int j = 0; j < m; ++j)
      if (nbrs[j] == (int32_t)i) { center_local = j; break; }
    if (center_local < 0) continue;  // duplicate points crowded it out
    if (center_local != 0) std::swap(nbrs[0], nbrs[center_local]);
    for (int j = 0; j < m; ++j) {
      double c[3];
      for (int d = 0; d < 3; ++d) c[d] = points[3 * nbrs[j] + d] - points[3 * i + d];
      uv[2 * j] = c[0] * e1[0] + c[1] * e1[1] + c[2] * e1[2];
      uv[2 * j + 1] = c[0] * e2[0] + c[1] * e2[1] + c[2] * e2[2];
      local2global[j] = nbrs[j];
    }

    bowyer_watson(uv.data(), m, tris);
    for (auto& t : tris) {
      if (!t.alive) continue;
      if (t.a != 0 && t.b != 0 && t.c != 0) continue;  // center-incident only
      int64_t ga = local2global[t.a], gb = local2global[t.b],
              gc = local2global[t.c];
      if (ga == gb || gb == gc || ga == gc) continue;
      int64_t s0 = ga, s1 = gb, s2 = gc;
      if (s0 > s1) std::swap(s0, s1);
      if (s1 > s2) std::swap(s1, s2);
      if (s0 > s1) std::swap(s0, s1);
      uint64_t key = ((uint64_t)s0 << 42) | ((uint64_t)s1 << 21) | (uint64_t)s2;
      if (!seen.insert(key).second) continue;
      if (n_faces >= max_faces) return -1;
      faces_out[3 * n_faces] = (int32_t)ga;
      faces_out[3 * n_faces + 1] = (int32_t)gb;
      faces_out[3 * n_faces + 2] = (int32_t)gc;
      ++n_faces;
    }
  }
  return n_faces;
}
