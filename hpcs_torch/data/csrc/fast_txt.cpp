// Fast whitespace-separated point-cloud text parser.
//
// ShapeNet-Part ships raw .txt files (x y z nx ny nz seg per row), which
// numpy.loadtxt reads tens of times slower than this parser.  Built with g++
// at first use and bound with ctypes by hpcs_torch/data/fast_txt.py, which
// falls back to numpy.loadtxt when no compiler is found.
//
// API: returns the number of rows parsed, or -1 on open failure.
//   values: row-major [max_rows, n_cols] float32 (all columns incl. label)
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

long parse_float_table(const char* path, float* values, long max_rows,
                       long n_cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;

    // slurp the file
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(f); return -1; }
    long got = (long)fread(buf, 1, size, f);
    fclose(f);
    buf[got] = '\0';

    long row = 0, col = 0;
    char* p = buf;
    char* end = buf + got;
    while (p < end && row < max_rows) {
        // skip whitespace/newlines
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
            ++p;
        if (p >= end) break;
        char* next = p;
        float v = strtof(p, &next);
        if (next == p) break;  // malformed token
        p = next;
        values[row * n_cols + col] = v;
        if (++col == n_cols) {
            col = 0;
            ++row;
        }
    }
    free(buf);
    return row;
}

long count_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long rows = 0;
    char chunk[1 << 16];
    size_t n;
    bool line_has_content = false;
    while ((n = fread(chunk, 1, sizeof(chunk), f)) > 0) {
        for (size_t i = 0; i < n; ++i) {
            if (chunk[i] == '\n') {
                if (line_has_content) ++rows;
                line_has_content = false;
            } else if (chunk[i] != ' ' && chunk[i] != '\t' && chunk[i] != '\r') {
                line_has_content = true;
            }
        }
    }
    if (line_has_content) ++rows;
    fclose(f);
    return rows;
}

}  // extern "C"
