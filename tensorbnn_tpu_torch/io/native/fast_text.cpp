// Fast whitespace-separated float parser for the reference posterior text
// format (SURVEY.md #5: {tensorIdx}.{fileIdx}.txt / hypers{f}.txt files).
//
// The reference (and a naive port) reads these with np.loadtxt, which is
// ~50-100x slower than a strtod sweep for the multi-megabyte sample files a
// long production run produces. This is the framework's host-side native
// component: a single-pass mmap-free parser exposed over a C ABI and loaded
// with ctypes (no pybind11 dependency in the image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC fast_text.cpp -o libfast_text.so
// (done automatically on first use by tensorbnn_tpu_torch/io/fast_text.py,
// into tensorbnn_tpu_torch/_build/). A copy of the JAX package's
// tensorbnn_tpu/io/native/fast_text.cpp.

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses every float in `path` into `out` (capacity `max_n`).
// Returns the number parsed, or -1 on IO error, or -2 if the file holds
// more than `max_n` values.
long tbnn_parse_floats(const char* path, double* out, long max_n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return -1; }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    buf[got] = '\0';

    long n = 0;
    const char* p = buf;
    char* end = nullptr;
    while (*p) {
        double v = std::strtod(p, &end);
        if (end == p) {  // not a number: skip one byte (separators/newlines)
            ++p;
            continue;
        }
        if (n >= max_n) { std::free(buf); return -2; }
        out[n++] = v;
        p = end;
    }
    std::free(buf);
    return n;
}

// Counts floats without storing them (for exact preallocation).
long tbnn_count_floats(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return -1; }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    buf[got] = '\0';

    long n = 0;
    const char* p = buf;
    char* end = nullptr;
    while (*p) {
        std::strtod(p, &end);
        if (end == p) { ++p; continue; }
        ++n;
        p = end;
    }
    std::free(buf);
    return n;
}

// Formats `n` doubles into `out` (capacity `cap` bytes) as text rows of
// `cols` space-separated "%.18e" values, each row '\n'-terminated —
// byte-identical to np.savetxt's default format, which the streaming
// RunWriter otherwise spends most of an epoch's host budget producing in
// Python (one "%.18e" % v per value). Returns bytes written, or -1 if
// `cap` is too small or arguments are invalid.
long tbnn_format_floats(const double* vals, long n, long cols,
                        char* out, long cap) {
    if (cols < 1 || n < 0) return -1;
    long pos = 0;
    for (long i = 0; i < n; ++i) {
        if (cap - pos < 32) return -1;
        // std::to_chars(scientific, 18) is byte-identical to printf
        // "%.18e" (both correctly rounded, >= 2 exponent digits; verified
        // over 200k values incl. subnormals) and ~6.7x faster (no locale)
        auto r = std::to_chars(out + pos, out + cap,
                               vals[i], std::chars_format::scientific, 18);
        if (r.ec != std::errc()) return -1;
        pos = r.ptr - out;
        out[pos++] = ((i + 1) % cols == 0 || i + 1 == n) ? '\n' : ' ';
    }
    return pos;
}

}  // extern "C"
