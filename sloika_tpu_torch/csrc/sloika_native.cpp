// The port's host aligner, compiled by g++ (not nvcc): a copy of the JAX
// package's native/sloika_native.cpp, built apart from it.
//
// align_semiglobal: banded affine-gap alignment of a query (basecall)
// against a reference sequence with free end gaps on the reference,
// emitting the counts a SAM-based evaluator derives (match, mismatch,
// insertion, deletion and the spans); used by ``align.py`` to score calls.
//
// Build: ``sloika_tpu_torch/native.py`` runs
//     g++ -O3 -shared -fPIC -std=c++17 csrc/sloika_native.cpp \
//         -o _build/libsloika_native.so
// at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Alignment op codes in the traceback
enum Op : uint8_t { OP_STOP = 0, OP_DIAG = 1, OP_UP = 2, OP_LEFT = 3,
                    OP_UP_EXT = 4, OP_LEFT_EXT = 5 };

static const int32_t NEG_INF = -(1 << 29);

// Banded semi-global affine alignment.
//   query  — fully aligned (global in query)
//   ref    — free gaps at both ends (alignment may start/end anywhere)
// The band is centred on the diagonal scaled by rlen/qlen.
//
// out[9]: score, nmatch, nmismatch, nins, ndel, qstart, qend, rstart, rend
//         (ins = bases in query not in ref; del = bases in ref not in query;
//          qstart==0, qend==qlen by construction)
// Returns 0 on success, -1 on failure (e.g. empty input).
int align_semiglobal(const char* query, int64_t qlen,
                     const char* ref, int64_t rlen,
                     int32_t match, int32_t mismatch,
                     int32_t gap_open, int32_t gap_extend,
                     int64_t band, int64_t* out) {
    if (qlen <= 0 || rlen <= 0) return -1;
    if (band <= 0) {
        band = std::max<int64_t>(128, (std::max(qlen, rlen) / 10)
                                 + std::llabs(qlen - rlen));
    }
    const int64_t W = 2 * band + 1;

    // rows i = 0..qlen over query; banded columns j in
    // [centre(i)-band, centre(i)+band] where centre(i) = i * rlen / qlen
    std::vector<int32_t> M(W), Ix(W), Iy(W), Mp(W), Ixp(W), Iyp(W);
    // 2 bits would do; one byte per cell for simplicity: 3 matrices packed
    std::vector<uint8_t> tb((qlen + 1) * W * 3);

    auto centre = [&](int64_t i) { return i * rlen / qlen; };
    auto TB = [&](int64_t i, int64_t k, int m) -> uint8_t& {
        return tb[(i * W + k) * 3 + m];
    };

    // row 0: free leading ref gap — M[0][j] = 0 for all j in band
    {
        int64_t c0 = centre(0);
        for (int64_t k = 0; k < W; ++k) {
            int64_t j = c0 - band + k;
            M[k] = (j >= 0 && j <= rlen) ? 0 : NEG_INF;
            Ix[k] = Iy[k] = NEG_INF;
        }
    }

    for (int64_t i = 1; i <= qlen; ++i) {
        std::swap(M, Mp); std::swap(Ix, Ixp); std::swap(Iy, Iyp);
        const int64_t ci = centre(i), cp = centre(i - 1);
        const int64_t shift = ci - cp;  // band window moves by this much
        const char qc = query[i - 1];
        for (int64_t k = 0; k < W; ++k) {
            const int64_t j = ci - band + k;
            M[k] = Ix[k] = Iy[k] = NEG_INF;
            if (j < 0 || j > rlen) continue;
            // previous-row index of column j' in the shifted window
            const int64_t kd = k + shift - 1;  // (i-1, j-1)
            const int64_t ku = k + shift;      // (i-1, j)
            // Ix: gap in ref (insertion in query): from (i-1, j)
            if (ku >= 0 && ku < W) {
                int32_t open = Mp[ku] + gap_open + gap_extend;
                int32_t ext = Ixp[ku] + gap_extend;
                if (open >= ext) { Ix[k] = open; TB(i, k, 1) = OP_UP; }
                else             { Ix[k] = ext;  TB(i, k, 1) = OP_UP_EXT; }
            }
            // Iy: gap in query (deletion from ref): from (i, j-1)
            if (k - 1 >= 0 && j - 1 >= 0) {
                int32_t open = M[k - 1] + gap_open + gap_extend;
                int32_t ext = Iy[k - 1] + gap_extend;
                if (open >= ext) { Iy[k] = open; TB(i, k, 2) = OP_LEFT; }
                else             { Iy[k] = ext;  TB(i, k, 2) = OP_LEFT_EXT; }
            }
            // M: (mis)match from (i-1, j-1)
            if (j - 1 >= 0 && kd >= 0 && kd < W) {
                const int32_t s = (qc == ref[j - 1]) ? match : mismatch;
                int32_t best = Mp[kd];
                uint8_t op = OP_DIAG;
                if (Ixp[kd] > best) { best = Ixp[kd]; op = OP_UP; }
                if (Iyp[kd] > best) { best = Iyp[kd]; op = OP_LEFT; }
                if (best > NEG_INF / 2) {
                    M[k] = best + s;
                    TB(i, k, 0) = op;
                }
            }
        }
    }

    // termination: best of last row over all ref positions (free tail gap)
    const int64_t cq = centre(qlen);
    int32_t best = NEG_INF;
    int64_t bestk = -1;
    int bestm = 0;
    for (int64_t k = 0; k < W; ++k) {
        const int64_t j = cq - band + k;
        if (j < 0 || j > rlen) continue;
        if (M[k] > best) { best = M[k]; bestk = k; bestm = 0; }
        if (Ix[k] > best) { best = Ix[k]; bestk = k; bestm = 1; }
    }
    if (bestk < 0 || best <= NEG_INF / 2) return -1;

    // traceback
    int64_t i = qlen, k = bestk;
    int m = bestm;
    int64_t nmatch = 0, nmis = 0, nins = 0, ndel = 0;
    const int64_t rend = cq - band + bestk;
    int64_t j = rend;
    while (i > 0) {
        const uint8_t op = TB(i, k, m);
        const int64_t shift = centre(i) - centre(i - 1);
        if (m == 0) {             // arrived via (mis)match
            if (query[i - 1] == ref[j - 1]) ++nmatch; else ++nmis;
            const uint8_t prev = op;  // which matrix at (i-1, j-1)
            i -= 1; j -= 1; k = k + shift - 1;
            m = (prev == OP_DIAG) ? 0 : (prev == OP_UP ? 1 : 2);
        } else if (m == 1) {      // Ix: query insertion
            ++nins;
            const bool ext = (op == OP_UP_EXT);
            i -= 1; k = k + shift;
            m = ext ? 1 : 0;
        } else {                  // Iy: deletion from ref
            ++ndel;
            const bool ext = (op == OP_LEFT_EXT);
            j -= 1; k = k - 1;
            m = ext ? 2 : 0;
        }
    }
    out[0] = best;
    out[1] = nmatch;
    out[2] = nmis;
    out[3] = nins;
    out[4] = ndel;
    out[5] = 0;
    out[6] = qlen;
    out[7] = j;
    out[8] = rend;
    return 0;
}

}  // extern "C"
