/* Fast Matrix Market I/O for symmetric tridiagonal matrices.
 *
 * The port's own copy of the JAX package's native parser (the same code and
 * error contract): a C equivalent of the reference's vendored NIST mmio
 * library plus its readSymmTriadiagonalMatrixFromSparseMTX (lib/mmio.c,
 * src/filehandling.c:76-153), built by ``cc`` into ``build/native/`` at the
 * repository root and loaded through ctypes
 * (symmetric_eigenvalue_tpu_torch/io/native.py).  The Python parser in
 * io/mtx.py is the portable fallback.  Host IO, not a device kernel.
 *
 * Error contract: functions return n (>0) on success or a negative code and
 * fill errbuf with a message mirroring the reference's diagnostics.
 */

#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define ERR(code, ...)                                        \
    do {                                                      \
        if (errbuf && errlen > 0)                             \
            snprintf(errbuf, (size_t)errlen, __VA_ARGS__);    \
        if (f) fclose(f);                                     \
        free(d); free(el); free(eu); free(have);              \
        return (code);                                        \
    } while (0)

/* Parse header; returns 0 on success, fills dims/nnz. */
static int parse_header(FILE *f, long *rows, long *cols, long *nnz,
                        char *errbuf, long errlen) {
    char line[1024];
    char obj[64], fmt[64], field[64], symm[64];
    if (!fgets(line, sizeof line, f)) {
        if (errbuf) snprintf(errbuf, (size_t)errlen, "empty file");
        return -1;
    }
    if (sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s",
               obj, fmt, field, symm) != 4) {
        if (errbuf) snprintf(errbuf, (size_t)errlen,
                             "Could not process Matrix Market banner.");
        return -1;
    }
    for (char *p = obj; *p; ++p) *p = (char)tolower((unsigned char)*p);
    for (char *p = fmt; *p; ++p) *p = (char)tolower((unsigned char)*p);
    for (char *p = field; *p; ++p) *p = (char)tolower((unsigned char)*p);
    for (char *p = symm; *p; ++p) *p = (char)tolower((unsigned char)*p);
    if (strcmp(obj, "matrix") || strcmp(fmt, "coordinate") ||
        strcmp(field, "real") || strcmp(symm, "general")) {
        if (errbuf) snprintf(errbuf, (size_t)errlen,
                             "Unsupported Matrix Market type: [%s %s %s %s]",
                             obj, fmt, field, symm);
        return -1;
    }
    /* skip comments */
    do {
        if (!fgets(line, sizeof line, f)) {
            if (errbuf) snprintf(errbuf, (size_t)errlen, "missing size line");
            return -1;
        }
    } while (line[0] == '%');
    if (sscanf(line, "%ld %ld %ld", rows, cols, nnz) != 3) {
        if (errbuf) snprintf(errbuf, (size_t)errlen, "malformed size line");
        return -1;
    }
    return 0;
}

/* Read a symmetric tridiagonal matrix.  On success returns n and stores
 * malloc'd arrays (caller frees with mtx_free): d_out length n, e_out length
 * n-1.  Validation mirrors filehandling.c:111-147. */
long mtx_read_symm_tridiag(const char *path, double **d_out, double **e_out,
                           char *errbuf, long errlen) {
    double *d = NULL, *el = NULL, *eu = NULL;
    unsigned char *have = NULL;
    FILE *f = fopen(path, "r");
    if (!f) {
        if (errbuf) snprintf(errbuf, (size_t)errlen, "Could not open file");
        return -2;
    }
    long rows, cols, nnz;
    if (parse_header(f, &rows, &cols, &nnz, errbuf, errlen)) {
        fclose(f);
        return -1;
    }
    if (rows != cols) ERR(-3, "Matrix is not square");
    long n = rows;
    if (n < 1) ERR(-3, "Matrix dimension must be >= 1");
    d = (double *)calloc((size_t)n, sizeof(double));
    el = (double *)calloc((size_t)(n > 1 ? n - 1 : 1), sizeof(double));
    eu = (double *)calloc((size_t)(n > 1 ? n - 1 : 1), sizeof(double));
    have = (unsigned char *)calloc((size_t)(n > 1 ? n - 1 : 1), 2);
    if (!d || !el || !eu || !have) ERR(-4, "out of memory");

    for (long i = 0; i < nnz; ++i) {
        long r, c;
        double v;
        if (fscanf(f, "%ld %ld %lg", &r, &c, &v) != 3)
            ERR(-5, "malformed entry at index %ld", i);
        if (r < 1 || r > n || c < 1 || c > n)
            ERR(-5, "entry index out of range at %ld", i);
        long diff = r - c;
        if (diff > 1 || diff < -1) ERR(-6, "Matrix is not tridiagonal");
        if (diff == 0) {
            d[r - 1] = v;
        } else if (diff == 1) { /* sub-diagonal */
            el[c - 1] = v;
            have[2 * (c - 1)] = 1;
        } else { /* super-diagonal */
            eu[r - 1] = v;
            have[2 * (r - 1) + 1] = 1;
        }
    }
    fclose(f);
    f = NULL;

    for (long i = 0; i < n - 1; ++i) {
        if (have[2 * i] && have[2 * i + 1] && el[i] != eu[i])
            ERR(-7, "Matrix is not symmetric");
        if (!have[2 * i] && have[2 * i + 1]) el[i] = eu[i];
    }
    free(eu);
    free(have);
    *d_out = d;
    *e_out = el;
    return n;
}

/* Write (d, e) in coordinate/real/general form, column-major entry order
 * (layout of the reference's sample fixture). */
long mtx_write_symm_tridiag(const char *path, const double *dv,
                            const double *ev, long n, const char *comment) {
    FILE *fp = fopen(path, "w");
    if (!fp) return -2;
    long entries = n + 2 * (n > 1 ? n - 1 : 0);
    fprintf(fp, "%%%%MatrixMarket matrix coordinate real general\n");
    fprintf(fp, "%%%s\n", comment ? comment : "");
    fprintf(fp, "%ld %ld %ld\n", n, n, entries);
    for (long c = 1; c <= n; ++c) {
        if (c > 1) fprintf(fp, "%ld %ld %.17g\n", c - 1, c, ev[c - 2]);
        fprintf(fp, "%ld %ld %.17g\n", c, c, dv[c - 1]);
        if (c < n) fprintf(fp, "%ld %ld %.17g\n", c + 1, c, ev[c - 1]);
    }
    fclose(fp);
    return n;
}

void mtx_free(double *p) { free(p); }
