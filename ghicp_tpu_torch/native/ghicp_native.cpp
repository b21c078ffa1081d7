// Native host runtime of the PyTorch port: the host-side hot loops around
// the card's work (LAS integer <-> double conversion, voxel-grid dedup of
// 100M+ point scans before upload, the txt parser, a rigid transform of a
// host array) as OpenMP C++ with a C ABI, loaded with ctypes
// (ghicp_tpu_torch/native/__init__.py).  The reference links libLAS + PCL
// for file IO (CMakeLists.txt:12-31, include/dataio.hpp).
//
// Built at first use with g++ into ghicp_tpu_torch/_build/ (see
// native/__init__.py for the flags).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <unordered_map>

extern "C" {

// Decode LAS point records: interleaved int32 x,y,z at the start of each
// record -> double xyz with scale/offset applied.  Parallel over points.
// raw: n_points * record_len bytes; out: n_points * 3 doubles.
void ghicp_las_decode(const uint8_t* raw, int64_t n_points,
                      int32_t record_len, const double* scale,
                      const double* offset, double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_points; ++i) {
        const uint8_t* rec = raw + i * record_len;
        int32_t v[3];
        std::memcpy(v, rec, 12);
        out[i * 3 + 0] = v[0] * scale[0] + offset[0];
        out[i * 3 + 1] = v[1] * scale[1] + offset[1];
        out[i * 3 + 2] = v[2] * scale[2] + offset[2];
    }
}

// Encode xyz doubles back to LAS int32 records (format 0 layout prefix).
void ghicp_las_encode(const double* xyz, int64_t n_points,
                      int32_t record_len, const double* scale,
                      const double* offset, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_points; ++i) {
        uint8_t* rec = out + i * record_len;
        int32_t v[3];
        for (int k = 0; k < 3; ++k) {
            v[k] = (int32_t)std::llround((xyz[i * 3 + k] - offset[k])
                                         / scale[k]);
        }
        std::memcpy(rec, v, 12);
    }
}

// Voxel-grid dedup: mark one representative point (lowest index) per voxel.
// Reference semantics (filter.hpp:28-88) without the duplicated-point-0
// quirk.  Returns number of kept points; keep[i] = 1 for representatives.
// Hash map over 64-bit voxel keys — the host-side path for clouds too big
// to round-trip through the accelerator just for downsampling.
int64_t ghicp_voxel_mark(const float* xyz, int64_t n, float voxel,
                         uint8_t* keep) {
    if (n == 0) return 0;
    float mn[3] = {xyz[0], xyz[1], xyz[2]};
    for (int64_t i = 1; i < n; ++i) {
        for (int k = 0; k < 3; ++k) {
            float v = xyz[i * 3 + k];
            if (v < mn[k]) mn[k] = v;
        }
    }
    const double inv = 1.0 / voxel;
    std::unordered_map<uint64_t, int64_t> first;
    first.reserve((size_t)std::min<int64_t>(n, 1 << 22));
    std::memset(keep, 0, (size_t)n);
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t vx = (uint64_t)((xyz[i * 3 + 0] - mn[0]) * inv);
        uint64_t vy = (uint64_t)((xyz[i * 3 + 1] - mn[1]) * inv);
        uint64_t vz = (uint64_t)((xyz[i * 3 + 2] - mn[2]) * inv);
        uint64_t key = (vx * 73856093ULL) ^ (vy * 19349663ULL)
                       ^ (vz * 83492791ULL);
        auto it = first.find(key);
        if (it == first.end()) {
            first.emplace(key, i);
            keep[i] = 1;
            ++kept;
        }
    }
    return kept;
}

// Parse whitespace-separated xyz[ extras] text, one point per line
// (reference readTxtFile, dataio.hpp:508-560 — its std::getline +
// istringstream loop is single-threaded; np.loadtxt is likewise seconds
// per million lines).  Two passes over thread-chunks aligned to newline
// boundaries: count lines, then strtod the first three fields of each.
// Comment/blank lines are skipped.  Assumes every numeric line carries at
// least three fields (the reference's x y z [intensity] format) — strtod
// skips newlines, so a 2-field line would borrow its z from the next line.
// Returns points written (<= max_points).
int64_t ghicp_txt_parse(const char* buf, int64_t len, double* out,
                        int64_t max_points) {
    int n_chunks = 64;
    std::vector<int64_t> chunk_begin(n_chunks + 1, len);
    chunk_begin[0] = 0;
    for (int c = 1; c < n_chunks; ++c) {
        int64_t p = (len * c) / n_chunks;
        while (p < len && buf[p] != '\n') ++p;
        chunk_begin[c] = (p < len) ? p + 1 : len;
    }
    chunk_begin[n_chunks] = len;
    std::vector<int64_t> counts(n_chunks, 0);
#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        int64_t i = chunk_begin[c], e = chunk_begin[c + 1], cnt = 0;
        while (i < e) {
            // a line counts if it starts with a parseable number
            while (i < e && (buf[i] == ' ' || buf[i] == '\t'
                             || buf[i] == '\r')) ++i;
            if (i < e && (buf[i] == '-' || buf[i] == '+' || buf[i] == '.'
                          || (buf[i] >= '0' && buf[i] <= '9'))) ++cnt;
            while (i < e && buf[i] != '\n') ++i;
            ++i;
        }
        counts[c] = cnt;
    }
    std::vector<int64_t> offs(n_chunks + 1, 0);
    for (int c = 0; c < n_chunks; ++c) offs[c + 1] = offs[c] + counts[c];
    int64_t total = std::min<int64_t>(offs[n_chunks], max_points);
#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        int64_t i = chunk_begin[c], e = chunk_begin[c + 1];
        int64_t w = offs[c];
        while (i < e) {
            while (i < e && (buf[i] == ' ' || buf[i] == '\t'
                             || buf[i] == '\r')) ++i;
            bool numeric = i < e && (buf[i] == '-' || buf[i] == '+'
                                     || buf[i] == '.'
                                     || (buf[i] >= '0' && buf[i] <= '9'));
            if (numeric && w < max_points) {
                char* p = const_cast<char*>(buf + i);
                char* q = p;
                double x = std::strtod(p, &q);
                double y = std::strtod(q, &q);
                double z = std::strtod(q, &q);
                out[w * 3 + 0] = x;
                out[w * 3 + 1] = y;
                out[w * 3 + 2] = z;
                ++w;
            } else if (numeric) {
                ++w;  // counted but beyond max_points: keep offsets aligned
            }
            while (i < e && buf[i] != '\n') ++i;
            ++i;
        }
    }
    return total;
}

// Apply a rigid 4x4 transform to n xyz float32 points in place (row-major T).
void ghicp_transform_points(float* xyz, int64_t n, const float* T) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
        xyz[i * 3 + 0] = T[0] * x + T[1] * y + T[2] * z + T[3];
        xyz[i * 3 + 1] = T[4] * x + T[5] * y + T[6] * z + T[7];
        xyz[i * 3 + 2] = T[8] * x + T[9] * y + T[10] * z + T[11];
    }
}

}  // extern "C"
