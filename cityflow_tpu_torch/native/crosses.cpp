// Native scenario-compile kernel: conflict-cross discovery.
//
// Replicates Intersection::initCrosses (reference roadnet.cpp:515-576)
// bit-for-bit: for every ordered pair of lanelinks in an intersection, walk
// both polylines segment-by-segment, take the FIRST proper intersection
// point, record distances along both links, the crossing angle, and the
// safe distances. Per-link cross lists are then sorted by distance with
// std::sort — the same unstable introsort whose tie order the simulation's
// yield scan depends on.
//
// The Python host compiler does the same in pure Python (compiler/roadnet.py)
// — exact but O(sum_i links_i^2 * segs^2) slow for city-scale nets (30x30:
// ~65k crosses over 32k links). This kernel is the hot path in C++; both
// produce identical doubles (same IEEE op order; build with -ffp-contract=off
// to forbid FMA contraction, matching the reference's g++ -O2 defaults).
//
// Build: see build.py. Interface: plain C arrays via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kEps = 1e-8;

inline int sign(double x) {
    // reference utility.h Point::sign: (x + eps > 0) - (x < eps)
    return (x + kEps > 0 ? 1 : 0) - (x < kEps ? 1 : 0);
}

struct P {
    double x, y;
};

inline double cross(P a, P b) { return a.x * b.y - a.y * b.x; }
inline double dot(P a, P b) { return a.x * b.x + a.y * b.y; }
inline P sub(P a, P b) { return {a.x - b.x, a.y - b.y}; }
inline double len(P a) { return std::sqrt(a.x * a.x + a.y * a.y); }

inline P calc_intersect(P A, P B, P C, P D) {
    // reference utility.cpp calcIntersectPoint
    P u = sub(B, A);
    P v = sub(D, C);
    double k = cross(sub(C, A), v) / cross(u, v);
    return {A.x + u.x * k, A.y + u.y * k};
}

inline bool on_segment(P A, P B, P Pt) {
    double v1 = cross(sub(B, A), sub(Pt, A));
    double v2 = dot(sub(Pt, A), sub(Pt, B));
    return sign(v1) == 0 && sign(v2) <= 0;
}

inline double ang_of(P a) { return std::atan2(a.y, a.x); }

inline double calc_ang(P A, P B) {
    // reference utility.cpp calcAng
    double ang = ang_of(A) - ang_of(B);
    double pi = std::acos(-1.0);
    while (ang >= pi / 2) ang -= pi / 2;
    while (ang < 0) ang += pi / 2;
    return std::min(ang, pi - ang);
}

}  // namespace

extern "C" {

// links are grouped per intersection by the caller: this call processes ONE
// intersection's lanelinks.
//   n_links           number of lanelinks
//   pts               flattened (x,y) doubles of all polylines
//   offsets           n_links+1 prefix offsets (in POINTS) into pts
//   widths            per-link widths
// outputs (caller-allocated, capacity cap):
//   out_a, out_b      local link indices of each cross
//   out_da, out_db    distance of the cross along each link
//   out_ang           crossing angle
//   out_safe_a/b      safe distances
// returns number of crosses found, or -1 if cap exceeded.
long long find_crosses(
    long long n_links, const double* pts, const long long* offsets,
    const double* widths,
    long long cap, long long* out_a, long long* out_b, double* out_da,
    double* out_db, double* out_ang, double* out_safe_a, double* out_safe_b) {
    long long cnt = 0;
    for (long long i = 0; i < n_links; ++i) {
        const P* va = reinterpret_cast<const P*>(pts) + offsets[i];
        long long na = offsets[i + 1] - offsets[i];
        for (long long j = i + 1; j < n_links; ++j) {
            const P* vb = reinterpret_cast<const P*>(pts) + offsets[j];
            long long nb = offsets[j + 1] - offsets[j];
            bool found = false;
            double disa = 0.0;
            for (long long ia = 0; ia + 1 < na && !found; ++ia) {
                double disb = 0.0;
                for (long long ib = 0; ib + 1 < nb; ++ib) {
                    P A = va[ia], B = va[ia + 1];
                    P C = vb[ib], D = vb[ib + 1];
                    if (sign(cross(sub(B, A), sub(D, C))) == 0) continue;
                    P ip = calc_intersect(A, B, C, D);
                    if (on_segment(A, B, ip) && on_segment(C, D, ip)) {
                        double ang = calc_ang(sub(B, A), sub(D, C));
                        double w1 = widths[i], w2 = widths[j];
                        double sa = std::sin(ang);
                        double c1 = w1 / sa;  // IEEE inf when sin==0,
                        double c2 = w2 / sa;  // matching the reference
                        double diag =
                            (c1 * c1 + c2 * c2 + 2 * c1 * c2 * std::cos(ang)) / 4;
                        if (cnt >= cap) return -1;
                        out_a[cnt] = i;
                        out_b[cnt] = j;
                        out_da[cnt] = disa + len(sub(ip, A));
                        out_db[cnt] = disb + len(sub(ip, C));
                        out_ang[cnt] = ang;
                        out_safe_a[cnt] = std::sqrt(diag - w2 * w2 / 4);
                        out_safe_b[cnt] = std::sqrt(diag - w1 * w1 / 4);
                        ++cnt;
                        found = true;
                        break;
                    }
                    disb += len(sub(vb[ib + 1], vb[ib]));
                }
                if (found) break;
                disa += len(sub(va[ia + 1], va[ia]));
            }
        }
    }
    return cnt;
}

// std::sort per-link cross order (reference roadnet.cpp:568-575): sorts the
// (cross_index) array for one link by its distance, with libstdc++'s exact
// unstable introsort. dist[k] is the distance of cross order[k] on the link.
void sort_link_crosses(long long n, long long* order, const double* dist) {
    std::vector<std::pair<double, long long>> v(n);
    for (long long k = 0; k < n; ++k) v[k] = {dist[k], order[k]};
    std::sort(v.begin(), v.end(),
              [](const std::pair<double, long long>& a,
                 const std::pair<double, long long>& b) {
                  return a.first < b.first;
              });
    for (long long k = 0; k < n; ++k) order[k] = v[k].second;
}

}  // extern "C"
