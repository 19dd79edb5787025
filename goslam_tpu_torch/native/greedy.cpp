// Greedy distance-sorted edge-proposal scan with NMS suppression.
//
// Native twin of utils/greedy.greedy_nms_scan composed with the two
// accept() bodies of tracking/backend.propose_scan_plain (the reference's
// backend.py:62-94): the Python loop over a 2048x2048 candidate matrix
// costs tens of seconds of a 2048-keyframe global-BA trigger on one host
// core; this scan takes milliseconds.
//
// Semantics (kept bit-identical to the Python pair, which
// tests/test_torch_cg.py holds against this library):
//   * snapshot-sort candidates ascending (ties broken by flat index),
//     visiting only entries <= thresh,
//   * skip (not stop) candidates suppressed after the snapshot,
//   * capacity check BEFORE appending: stop once es_len > max_factors,
//   * dense mode appends (i, j) and (j, i),
//   * loop mode runs the neighborhood-consistency vote on the UNMASKED
//     distance snapshot rawd and appends all voting pairs si != sj;
//     a failed vote still suppresses the candidate's neighborhood,
//   * suppression sets [di-nms, di+nms] x [dj-nms, dj+nms] to +inf.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Returns the number of (i, j) pairs appended to out_i/out_j, or -1 if
// out_cap would be exceeded (caller sized the buffer wrong).
// n_accepts_out receives the number of accepted loop-vote candidates
// (0 in dense mode suppressions do not count).
int64_t greedy_propose(
    double* d,             // [ilen * jlen], mutated by suppression
    const double* rawd,    // [ilen * jlen] unmasked snapshot (loop mode)
    int64_t ilen, int64_t jlen,
    double thresh, int64_t nms,
    int64_t es_len0,       // pre-seeded edge count (capacity accounting)
    int64_t max_factors,
    int32_t loop, int64_t n_neigh,
    int64_t t_start_loop, int64_t t_start, int64_t t_end,
    int32_t* out_i, int32_t* out_j, int64_t out_cap,
    int64_t* n_accepts_out)
{
    const double inf = std::numeric_limits<double>::infinity();
    const int64_t total = ilen * jlen;

    // collect + sort only the candidates that can ever be visited
    std::vector<int64_t> order;
    order.reserve(1024);
    for (int64_t k = 0; k < total; ++k) {
        if (d[k] <= thresh) order.push_back(k);
    }
    std::sort(order.begin(), order.end(),
              [d](int64_t a, int64_t b) {
                  if (d[a] != d[b]) return d[a] < d[b];
                  return a < b;
              });

    int64_t es_len = es_len0;
    int64_t n_out = 0;
    int64_t n_accepts = 0;

    auto push = [&](int64_t i, int64_t j) -> bool {
        if (n_out >= out_cap) return false;
        out_i[n_out] = (int32_t)i;
        out_j[n_out] = (int32_t)j;
        ++n_out;
        ++es_len;
        return true;
    };

    for (int64_t k : order) {
        const int64_t di = k / jlen, dj = k % jlen;
        if (!(d[k] <= thresh)) continue;   // suppressed after snapshot
        if (es_len > max_factors) break;   // accept() returned False

        const int64_t i = di + t_start_loop;
        const int64_t j = dj + t_start;
        if (loop) {
            // neighborhood-consistency vote (backend.py:79-89)
            const int64_t si0 = std::max(i - n_neigh, t_start_loop);
            const int64_t si1 = std::min(i + n_neigh + 1, t_end);
            const int64_t sj0 = std::max(j - n_neigh, t_start);
            const int64_t sj1 = std::min(j + n_neigh + 1, t_end);
            int64_t votes = 0;
            for (int64_t si = si0; si < si1; ++si)
                for (int64_t sj = sj0; sj < sj1; ++sj)
                    if (rawd[(si - t_start_loop) * jlen + (sj - t_start)]
                        <= thresh)
                        ++votes;
            const int64_t need = (int64_t)(
                ((2 * n_neigh + 1) * (2 * n_neigh + 1)) / 2);
            if (votes > need) {
                for (int64_t si = si0; si < si1; ++si)
                    for (int64_t sj = sj0; sj < sj1; ++sj)
                        if (si != sj &&
                            rawd[(si - t_start_loop) * jlen
                                 + (sj - t_start)] <= thresh)
                            if (!push(si, sj)) return -1;
                ++n_accepts;
            }
        } else {
            if (!push(i, j)) return -1;
            if (!push(j, i)) return -1;
        }

        const int64_t r0 = std::max<int64_t>(0, di - nms);
        const int64_t r1 = std::min(ilen - 1, di + nms);
        const int64_t c0 = std::max<int64_t>(0, dj - nms);
        const int64_t c1 = std::min(jlen - 1, dj + nms);
        for (int64_t r = r0; r <= r1; ++r)
            for (int64_t c = c0; c <= c1; ++c)
                d[r * jlen + c] = inf;
    }

    *n_accepts_out = n_accepts;
    return n_out;
}

}  // extern "C"
