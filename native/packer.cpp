// 2-bit genotype packer/decoder — the native host-side component of the
// packed marker store (the counterpart of the reference's streaming
// backend, reference: src/1.JWAS/src/markers/streaming_genotypes.jl:204-452,
// whose hot conversion loops are pure Julia; here they are C++ exposed to
// Python through ctypes).
//
// Layout: marker-major. Marker j occupies ceil(n/4) bytes; individual i is
// stored in byte i>>2 at bit offset 2*(i&3). Codes: 0,1,2 = dosage,
// 3 = missing (decoded to the marker mean).
//
// Build: g++ -O3 -march=native -shared -fPIC packer.cpp -o libjwaspack.so

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// One pass over a dense float matrix (n x p, row-major, individuals x
// markers): compute per-marker mean (over non-missing), allele frequency and
// missing count (scan phase of _scan_streaming_stats!, :204-315).
void jwas_scan_stats(const float* geno, int64_t n, int64_t p,
                     float missing_value,
                     double* means, double* freqs, int64_t* n_missing) {
    for (int64_t j = 0; j < p; ++j) {
        means[j] = 0.0;
        n_missing[j] = 0;
    }
    for (int64_t i = 0; i < n; ++i) {
        const float* row = geno + i * p;
        for (int64_t j = 0; j < p; ++j) {
            float v = row[j];
            if (v == missing_value || std::isnan(v)) {
                n_missing[j] += 1;
            } else {
                means[j] += v;
            }
        }
    }
    for (int64_t j = 0; j < p; ++j) {
        int64_t cnt = n - n_missing[j];
        means[j] = cnt > 0 ? means[j] / cnt : 0.0;
        freqs[j] = means[j] / 2.0;
    }
}

// Pack a dense float matrix (n x p, row-major) into marker-major 2-bit codes.
// out: p x bytes_per_marker with bytes_per_marker = (n + 3) / 4.
// Values are rounded to the nearest integer in [0, 2]; missing -> code 3.
void jwas_pack_2bit(const float* geno, int64_t n, int64_t p,
                    float missing_value, uint8_t* out) {
    int64_t bpm = (n + 3) / 4;
    std::memset(out, 0, static_cast<size_t>(p) * bpm);
    for (int64_t i = 0; i < n; ++i) {
        const float* row = geno + i * p;
        int64_t byte = i >> 2;
        int shift = 2 * (i & 3);
        for (int64_t j = 0; j < p; ++j) {
            float v = row[j];
            uint8_t code;
            if (v == missing_value || std::isnan(v)) {
                code = 3;
            } else {
                long r = std::lround(v);
                code = static_cast<uint8_t>(r < 0 ? 0 : (r > 2 ? 2 : r));
            }
            out[j * bpm + byte] |= static_cast<uint8_t>(code << shift);
        }
    }
}

// Decode selected markers into a centered float32 matrix (n x len(cols),
// column-major over the requested markers: out[i + k*n]).
// Missing (code 3) decodes to the marker mean, i.e. centered zero
// (decode_marker!, :978-1002).
void jwas_decode_markers(const uint8_t* packed, int64_t n, int64_t bpm,
                         const int64_t* cols, int64_t ncols,
                         const double* means, int center, float* out) {
    for (int64_t k = 0; k < ncols; ++k) {
        const uint8_t* src = packed + cols[k] * bpm;
        float mean = static_cast<float>(means[cols[k]]);
        float base = center ? mean : 0.0f;
        float* dst = out + k * n;
        for (int64_t i = 0; i < n; ++i) {
            uint8_t code = (src[i >> 2] >> (2 * (i & 3))) & 3u;
            float v = code == 3u ? mean : static_cast<float>(code);
            dst[i] = v - base;
        }
    }
}

// X' w for the packed store without densifying X: out[j] = sum_i x_ij w_i
// with x centered. Used by host-side checks and the CPU fallback path
// (streaming_mul_alpha!, :1009-1027 is the transposed op).
void jwas_packed_xtw(const uint8_t* packed, int64_t n, int64_t p, int64_t bpm,
                     const double* means, const float* w, float* out) {
    double wsum = 0.0;
    for (int64_t i = 0; i < n; ++i) wsum += w[i];
    for (int64_t j = 0; j < p; ++j) {
        const uint8_t* src = packed + j * bpm;
        double acc = 0.0;
        double mean = means[j];
        for (int64_t i = 0; i < n; ++i) {
            uint8_t code = (src[i >> 2] >> (2 * (i & 3))) & 3u;
            double v = code == 3u ? mean : static_cast<double>(code);
            acc += v * w[i];
        }
        out[j] = static_cast<float>(acc - mean * wsum);
    }
}

// Accumulate per-marker sums and missing counts over a row chunk (R x p,
// row-major). Callers zero-init sums/n_missing once and finalize means after
// the last chunk — the chunked (out-of-core) stats scan
// (_scan_streaming_stats!, streaming_genotypes.jl:204-315).
void jwas_scan_stats_accum(const float* geno, int64_t rows, int64_t p,
                           float missing_value,
                           double* sums, int64_t* n_missing) {
    for (int64_t i = 0; i < rows; ++i) {
        const float* row = geno + i * p;
        for (int64_t j = 0; j < p; ++j) {
            float v = row[j];
            if (v == missing_value || std::isnan(v)) {
                n_missing[j] += 1;
            } else {
                sums[j] += v;
            }
        }
    }
}

// Pack one row chunk (rows x p, row-major) directly into marker-major 2-bit
// bytes: out is (p x ceil(rows/4)). When chunks are 4-row aligned, each chunk
// owns a disjoint byte range of the final (p x ceil(n/4)) store, so the
// out-of-core conversion writes every output byte exactly once (the tiled
// transpose of streaming_genotypes.jl:385-452, without the row-major spool —
// the source file is simply read twice).
void jwas_pack_tile_transposed(const float* geno, int64_t rows, int64_t p,
                               float missing_value, uint8_t* out) {
    int64_t bpt = (rows + 3) / 4;
    std::memset(out, 0, static_cast<size_t>(p) * bpt);
    for (int64_t i = 0; i < rows; ++i) {
        const float* row = geno + i * p;
        int64_t byte = i >> 2;
        int shift = 2 * (i & 3);
        for (int64_t j = 0; j < p; ++j) {
            float v = row[j];
            uint8_t code;
            if (v == missing_value || std::isnan(v)) {
                code = 3;
            } else {
                long r = std::lround(v);
                code = static_cast<uint8_t>(r < 0 ? 0 : (r > 2 ? 2 : r));
            }
            out[j * bpt + byte] |= static_cast<uint8_t>(code << shift);
        }
    }
}

}  // extern "C"
