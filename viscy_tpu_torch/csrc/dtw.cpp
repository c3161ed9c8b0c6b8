// Dynamic-time-warping accumulated-cost DP (host kernel H2).
//
// D[i][j] = c[i][j] + min(D[i-1][j-1], D[i-1][j], D[i][j-1]) depends on its
// left, upper and upper-left neighbours, so it runs as a row-major double
// loop on the host: DBA's pairs are tens by tens of frames, far too small
// for a device launch per pair. The caller computes the cost matrix and
// backtracks the path; only the O(T*N) DP lives here.
//
// Each cell is one min over three float64 values and one add, so any order
// of evaluation gives the same bits as the plain Python loop.
//
// subsequence = 1 frees the start and end along the query axis (j): row 0
// of the accumulator is 0, so the template (i axis) must fully take part
// while the matched query segment floats.

#include <cstdint>
#include <limits>

extern "C" {

// cost: (T, N) row-major; acc: (T+1, N+1) row-major output.
void dtw_dp(const double* cost, int64_t T, int64_t N, int subsequence, double* acc) {
    const double inf = std::numeric_limits<double>::infinity();
    const int64_t W = N + 1;
    acc[0] = 0.0;
    for (int64_t j = 1; j <= N; ++j) acc[j] = subsequence ? 0.0 : inf;
    for (int64_t i = 1; i <= T; ++i) acc[i * W] = inf;
    for (int64_t i = 1; i <= T; ++i) {
        const double* crow = cost + (i - 1) * N;
        const double* prev = acc + (i - 1) * W;
        double* cur = acc + i * W;
        for (int64_t j = 1; j <= N; ++j) {
            double best = prev[j - 1];
            if (prev[j] < best) best = prev[j];
            if (cur[j - 1] < best) best = cur[j - 1];
            cur[j] = crow[j - 1] + best;
        }
    }
}

}  // extern "C"
