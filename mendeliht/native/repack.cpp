// Native genotype-ingestion kernels (the framework's C++ runtime layer).
//
// Replaces the role of SnpArrays.jl's native SIMD/threaded layer on the
// ingestion path (SURVEY.md §2.10): PLINK .bed payloads are repacked into the
// crumb-transposed layout (crumb s of byte b = sample s*n4 + b; see
// genotype/snparray.py) and per-SNP genotype counts are gathered in the same
// pass. Multithreaded over SNP blocks; bit manipulation uses 64-bit gathers
// plus popcount-based counting.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// Extract crumb i from a .bed row (sample-major 2-bit codes).
inline uint8_t get_crumb(const uint8_t* row, int64_t i) {
    return (row[i >> 2] >> ((i & 3) * 2)) & 0x3;
}

void repack_block(const uint8_t* bed, int64_t n, int64_t bpr, int64_t n4,
                  uint8_t* out, int64_t* counts, int64_t j0, int64_t j1) {
    for (int64_t j = j0; j < j1; ++j) {
        const uint8_t* row = bed + j * bpr;
        uint8_t* orow = out + j * n4;
        std::memset(orow, 0, n4);
        int64_t c_het = 0, c_alt = 0, c_mis = 0;
        for (int s = 0; s < 4; ++s) {
            const int64_t lo = (int64_t)s * n4;
            const int64_t hi = std::min(lo + n4, n);
            for (int64_t i = lo; i < hi; ++i) {
                const uint8_t c = get_crumb(row, i);
                orow[i - lo] |= (uint8_t)(c << (2 * s));
                c_het += (c == 2);
                c_alt += (c == 3);
                c_mis += (c == 1);
            }
        }
        counts[3 * j + 0] = c_het;
        counts[3 * j + 1] = c_alt;
        counts[3 * j + 2] = c_mis;
    }
}

}  // namespace

extern "C" {

// bed: p rows of ceil(n/4) bytes (no 3-byte header). out: (p, n4) bytes,
// crumb-transposed. counts: (p, 3) int64 [het, hom-alt, missing].
void mendeliht_repack_bed(const uint8_t* bed, int64_t n, int64_t p,
                          int64_t n4, uint8_t* out, int64_t* counts,
                          int32_t n_threads) {
    const int64_t bpr = (n + 3) / 4;
    if (n_threads <= 1 || p < 1024) {
        repack_block(bed, n, bpr, n4, out, counts, 0, p);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t per = (p + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t j0 = t * per;
        const int64_t j1 = std::min(j0 + per, p);
        if (j0 >= j1) break;
        ts.emplace_back(repack_block, bed, n, bpr, n4, out, counts, j0, j1);
    }
    for (auto& th : ts) th.join();
}

// Interleave crumb-transposed byte rows into the canonical SNP-quad word
// layout (byte k of out[i][w] = packed[4i+k][w]; rows past p are zero).
// See genotype/snparray.py _bytes_to_words.
void mendeliht_quad_words(const uint8_t* packed, int64_t p, int64_t n4,
                          uint32_t* out, int32_t n_threads) {
    const int64_t p4 = (p + 3) / 4;
    auto work = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            const uint8_t* r[4];
            for (int k = 0; k < 4; ++k)
                r[k] = (4 * i + k < p) ? packed + (4 * i + k) * n4 : nullptr;
            uint32_t* orow = out + i * n4;
            for (int64_t w = 0; w < n4; ++w) {
                uint32_t v = 0;
                for (int k = 0; k < 4; ++k)
                    if (r[k]) v |= (uint32_t)r[k][w] << (8 * k);
                orow[w] = v;
            }
        }
    };
    if (n_threads <= 1 || p4 < 256) {
        work(0, p4);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t per = (p4 + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t i0 = t * per, i1 = std::min(i0 + per, p4);
        if (i0 >= i1) break;
        ts.emplace_back(work, i0, i1);
    }
    for (auto& th : ts) th.join();
}

// Inverse helper for writers: pack an (n, p) sample-major code matrix into
// .bed payload bytes (SNP-major). codes values 0..3.
void mendeliht_pack_codes_bed(const uint8_t* codes, int64_t n, int64_t p,
                              uint8_t* bed, int32_t n_threads) {
    const int64_t bpr = (n + 3) / 4;
    auto work = [&](int64_t j0, int64_t j1) {
        for (int64_t j = j0; j < j1; ++j) {
            uint8_t* row = bed + j * bpr;
            std::memset(row, 0, bpr);
            for (int64_t i = 0; i < n; ++i) {
                row[i >> 2] |= (uint8_t)((codes[i * p + j] & 0x3) << ((i & 3) * 2));
            }
        }
    };
    if (n_threads <= 1 || p < 1024) {
        work(0, p);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t per = (p + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t j0 = t * per, j1 = std::min(j0 + per, p);
        if (j0 >= j1) break;
        ts.emplace_back(work, j0, j1);
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
