// Native data-plane kernels for the HITRAN spectroscopy pipeline.
//
// The port's copy of climatemodel_tpu/native/hitran_native.cpp (the same
// code, so the same bits).  The NumPy original builds its lookup tables with
// np.genfromtxt over ~1e5-row whitespace tables and a per-line Python loop
// of windowed Lorentzians (its real_gas_data/hitran.py:40-247) — both
// CPU-bound host work outside the card's compute path.  This library
// provides the native equivalents, exposed to Python via ctypes
// (climatemodel_tpu_torch/native/__init__.py):
//
//   table_dims / parse_table    whitespace-delimited numeric table parser
//                               (the data-loader; header handled in Python)
//   accumulate_lines            OpenMP windowed Lorentzian accumulation
//                               (line list -> absorption-coefficient grid)
//
// Build: g++ -O3 -shared -fPIC -fopenmp, retried without -fopenmp
// (climatemodel_tpu_torch/native/__init__.py).  Each row sums its lines in
// order, so both builds give the same bits.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// read the whole file into memory; returns empty vector on failure
std::vector<char> read_file(const char* path) {
    std::vector<char> buf;
    FILE* f = std::fopen(path, "rb");
    if (!f) return buf;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(n) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(n), f);
    std::fclose(f);
    buf.resize(got);
    buf.push_back('\0');
    return buf;
}

inline const char* skip_ws(const char* s) {
    while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
    return s;
}

}  // namespace

extern "C" {

// Dimensions of the numeric body of a whitespace table (data starts after
// `skip_lines` lines).  Returns 0 on success.
int table_dims(const char* path, long skip_lines, long* rows, long* cols) {
    std::vector<char> buf = read_file(path);
    if (buf.empty()) return 1;
    const char* s = buf.data();
    for (long k = 0; k < skip_lines; ++k) {
        while (*s && *s != '\n') ++s;
        if (*s) ++s;
    }
    long r = 0, c = 0;
    while (*s) {
        const char* line_start = s;
        long this_cols = 0;
        while (*s && *s != '\n') {
            s = skip_ws(s);
            if (*s && *s != '\n') {
                ++this_cols;
                while (*s && *s != ' ' && *s != '\t' && *s != '\r' && *s != '\n')
                    ++s;
            }
        }
        if (*s) ++s;
        if (this_cols > 0) {
            if (c == 0) c = this_cols;
            if (this_cols == c) ++r;   // ignore ragged trailing lines
        }
        (void)line_start;
    }
    *rows = r;
    *cols = c;
    return 0;
}

// Parse the numeric body into out[rows * cols] (row-major).  Returns the
// number of complete rows parsed.
long parse_table(const char* path, long skip_lines, long rows, long cols,
                 double* out) {
    std::vector<char> buf = read_file(path);
    if (buf.empty()) return -1;
    char* s = buf.data();
    for (long k = 0; k < skip_lines; ++k) {
        while (*s && *s != '\n') ++s;
        if (*s) ++s;
    }
    long r = 0;
    while (*s && r < rows) {
        long c = 0;
        char* line_end = s;
        while (*line_end && *line_end != '\n') ++line_end;
        char saved = *line_end;
        *line_end = '\0';
        char* p = s;
        while (c < cols) {
            char* end;
            double v = std::strtod(p, &end);
            if (end == p) break;
            out[r * cols + c] = v;
            ++c;
            p = end;
        }
        // a row counts only with EXACTLY cols tokens — table_dims skips
        // ragged lines (extra or missing columns), and counting a partial
        // parse here would silently shift every subsequent row
        bool extra = false;
        if (c == cols) {
            char* q = const_cast<char*>(skip_ws(p));
            extra = (*q != '\0');
        }
        *line_end = saved;
        s = (*line_end) ? line_end + 1 : line_end;
        if (c == cols && !extra) ++r;
    }
    return r;
}

// Windowed Lorentzian line accumulation (hitran.py:202-247 semantics):
//   gamma(p, T)    = g_ref * (p / p_ref) * (T_ref / T)^n          [eq. 4.61]
//   s(T)           = s_ref * (T / T_ref)^n * exp(-hck*nu*(1/T - 1/T_ref))
//   shape          = gamma / (pi * (gamma^2 + (nu - nu_l)^2))
// Each line contributes over +- n_line_widths * max_p(gamma) about the
// nearest grid bin; nu_grid must be uniform with spacing dnu.
// out has shape [np_ x nnu], overwritten.
void accumulate_lines(const double* p, const double* T, long np_,
                      const double* nu_grid, long nnu, double dnu,
                      const double* lnu, const double* lsw,
                      const double* lgamma, const double* lnair, long nlines,
                      double n_line_widths, double p_ref, double T_ref,
                      double hck, double* out) {
    const double nu0 = nu_grid[0];
    const double inv_pi = 1.0 / M_PI;
    // prepass: per-line window size (max gamma over the p column) and centre
    std::vector<long> win(nlines), cen(nlines);
    for (long l = 0; l < nlines; ++l) {
        double gmax = 0.0;
        for (long k = 0; k < np_; ++k) {
            double g = lgamma[l] * (p[k] / p_ref)
                       * std::pow(T_ref / T[k], lnair[l]);
            if (g > gmax) gmax = g;
        }
        win[l] = static_cast<long>(n_line_widths * gmax / dnu);
        // nearest grid bin with argmin tie-breaking (first/lower index wins,
        // matching np.argmin in wavenumbers_near_line, hitran.py:195)
        long c0 = static_cast<long>(std::floor((lnu[l] - nu0) / dnu));
        if (c0 < 0) c0 = 0;
        if (c0 > nnu - 1) c0 = nnu - 1;
        long c1 = c0 + 1 > nnu - 1 ? nnu - 1 : c0 + 1;
        double d0 = std::fabs(lnu[l] - nu_grid[c0]);
        double d1 = std::fabs(nu_grid[c1] - lnu[l]);
        cen[l] = (d1 < d0) ? c1 : c0;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < np_; ++i) {
        double* row = out + i * nnu;
        std::memset(row, 0, sizeof(double) * static_cast<size_t>(nnu));
        const double pi_ = p[i];
        const double Ti = T[i];
        for (long l = 0; l < nlines; ++l) {
            const long n_w = win[l];
            const long centre = cen[l];
            long j1 = centre - n_w;
            if (j1 < 0) j1 = 0;
            long j2 = centre + n_w;
            if (j2 > nnu - 1) j2 = nnu - 1;
            const double gamma = lgamma[l] * (pi_ / p_ref)
                                 * std::pow(T_ref / Ti, lnair[l]);
            const double strength =
                lsw[l] * std::pow(Ti / T_ref, lnair[l])
                * std::exp(-hck * lnu[l] * (1.0 / Ti - 1.0 / T_ref));
            const double g2 = gamma * gamma;
            const double amp = strength * gamma * inv_pi;
            for (long j = j1; j <= j2; ++j) {
                const double d = nu_grid[j] - lnu[l];
                row[j] += amp / (g2 + d * d);
            }
        }
    }
}

int native_version(void) { return 1; }

}  // extern "C"
