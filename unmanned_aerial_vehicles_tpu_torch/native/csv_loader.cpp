// Fast flight-CSV parser (the data-ingest hot path).
//
// The reference loads its gp_datasets CSVs through pandas and iterates rows
// in Python (src/px4/train_gp_offline.py:43-69 of the reference). This is
// the native replacement: a single-pass strtod scanner over a memory
// buffer, ~2 orders of magnitude faster than numpy.genfromtxt on the
// 16-column schema. Exposed via ctypes; see ../io/fast_csv.py, which builds
// it into the package's git-ignored _build/native/ at first use.
//
// Build:  g++ -O3 -shared -fPIC -o libuavcsv.so csv_loader.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse a numeric CSV into a row-major double buffer.
//   path        : file path
//   out         : caller-allocated buffer of max_rows * n_cols doubles
//   max_rows    : buffer capacity in rows
//   n_cols      : expected columns per row
//   skip_header : number of leading lines to skip
// Returns rows parsed, or a negative error code:
//   -1 cannot open, -2 read failure, -3 malformed row (wrong column count).
long uav_parse_csv(const char* path, double* out, long max_rows, long n_cols,
                   int skip_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;

    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) {
        std::fclose(f);
        return -2;
    }
    if (std::fread(buf, 1, size, f) != static_cast<size_t>(size)) {
        std::free(buf);
        std::fclose(f);
        return -2;
    }
    std::fclose(f);
    buf[size] = '\0';

    char* p = buf;
    char* end = buf + size;

    for (int h = 0; h < skip_header && p < end; ++h) {
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }

    long rows = 0;
    while (p < end && rows < max_rows) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;

        long col = 0;
        while (col < n_cols) {
            char* next = nullptr;
            double v = std::strtod(p, &next);
            if (next == p) {  // no parse progress -> malformed
                std::free(buf);
                return -3;
            }
            out[rows * n_cols + col] = v;
            p = next;
            ++col;
            if (col < n_cols) {
                if (p < end && *p == ',') {
                    ++p;
                } else {
                    std::free(buf);
                    return -3;
                }
            }
        }
        // after the last column the line must END: a row with extra columns
        // is malformed, matching the NumPy fallback's strict shape check
        // (io/datasets.load_gp_dataset)
        while (p < end && *p == '\r') ++p;
        if (p < end && *p != '\n') {
            std::free(buf);
            return -3;
        }
        if (p < end) ++p;
        ++rows;
    }

    std::free(buf);
    return rows;
}

// Count data lines (for buffer sizing).
long uav_count_rows(const char* path, int skip_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    long lines = 0;
    int c, prev = '\n';
    bool nonblank = false;
    while ((c = std::fgetc(f)) != EOF) {
        if (c == '\n') {
            if (nonblank) ++lines;
            nonblank = false;
        } else if (c != '\r') {
            nonblank = true;
        }
        prev = c;
    }
    if (nonblank) ++lines;
    (void)prev;
    std::fclose(f);
    return lines - skip_header;
}

}  // extern "C"
