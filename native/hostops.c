/* Native host-side runtime ops: result-store scatter, packed-triangular row
 * reconstruction, and bucket packing.
 *
 * Native equivalents of the reference's output-fill and HDF5-conversion
 * hot loops (/root/reference/src/io/output.c:68-84, io/format/hdf5.c:148-196)
 * and of the host-side sequence packing that feeds the device.  OpenMP
 * parallel like the reference's conversion loop; loaded via ctypes
 * (io/native.py) with NumPy fallbacks.
 *
 * Build: gcc -O3 -march=native -fopenmp -shared -fPIC -o libhostops.so hostops.c
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

/* Scatter pair scores into the packed triangular store:
 * matrix[j*(j-1)/2 + i] = s  (i < j elementwise). */
void fill_pairs_tri(int32_t *matrix, const int64_t *i, const int64_t *j,
                    const int32_t *s, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < n; t++)
        matrix[j[t] * (j[t] - 1) / 2 + i[t]] = s[t];
}

/* Scatter into the full symmetric store (both mirrors). */
void fill_pairs_full(int32_t *matrix, int64_t dim, const int64_t *i,
                     const int64_t *j, const int32_t *s, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < n; t++) {
        matrix[i[t] * dim + j[t]] = s[t];
        matrix[j[t] * dim + i[t]] = s[t];
    }
}

/* Reconstruct full rows [r0, r1) from packed triangular storage (the
 * conversion loop of hdf5.c:148-163): row r gets
 *   out[r][i] = tri[tri_off(r) + i]          for i < r
 *   out[r][r] = 0
 *   out[r][j] = tri[tri_off(j) + r]          for j > r      */
void rows_from_tri(const int32_t *tri, int32_t *out, int64_t dim, int64_t r0,
                   int64_t r1) {
#pragma omp parallel for schedule(static)
    for (int64_t r = r0; r < r1; r++) {
        int32_t *row = out + (r - r0) * dim;
        const int64_t off = r * (r - 1) / 2;
        if (r > 0)
            memcpy(row, tri + off, (size_t)r * sizeof(int32_t));
        row[r] = 0;
        for (int64_t j = r + 1; j < dim; j++)
            row[j] = tri[j * (j - 1) / 2 + r];
    }
}

/* Pack selected sequences into a padded LUT-index matrix:
 * out[row][c] = lut[data[offsets[order[row]] + c]] for c < len, pad_value
 * beyond.  The host-side analogue of align.c:49-50's per-pair ind[] build,
 * done once per length bucket. */
void pack_rows(const uint8_t *data, const int64_t *offsets,
               const int64_t *order, int64_t nrows, int64_t edge,
               const int32_t *lut, int8_t pad_value, int8_t *out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; r++) {
        const int64_t s = order[r];
        const int64_t beg = offsets[s], end = offsets[s + 1];
        int8_t *row = out + r * edge;
        int64_t len = end - beg;
        if (len > edge)
            len = edge;
        for (int64_t c = 0; c < len; c++)
            row[c] = (int8_t)lut[data[beg + c]];
        if (len < edge)
            memset(row + len, pad_value, (size_t)(edge - len));
    }
}

/* Materialize one scheduler block's pair metadata in a single fused pass:
 * combo-local linear ids [s0, s0+nv) -> original indices (oi < oj) plus the
 * summed DP cell count.  The triangle inversion is the reference's d_find_j
 * bijection (src/bio/kernels.cu:17-30) in closed form (sqrt + correction).
 * Replaces ~8 NumPy passes per block that dominated flush-side host time. */
int64_t materialize_block(const int64_t *order, const int32_t *lengths,
                          int64_t a_start, int64_t a_count, int64_t b_start,
                          int32_t same, int64_t s0, int64_t nv,
                          int64_t *oi, int64_t *oj) {
    int64_t cells = 0;
#pragma omp parallel for schedule(static) reduction(+ : cells)
    for (int64_t t = 0; t < nv; t++) {
        const int64_t lin = s0 + t;
        int64_t rk, rc;
        if (same) {
            int64_t j = (int64_t)((1.0 + sqrt(1.0 + 8.0 * (double)lin)) * 0.5);
            while (j * (j - 1) / 2 > lin)
                j--;
            while ((j + 1) * j / 2 <= lin)
                j++;
            rc = j;
            rk = lin - j * (j - 1) / 2;
        } else {
            rk = lin % a_count;
            rc = lin / a_count;
        }
        const int64_t sk = a_start + rk, sc = b_start + rc;
        const int64_t ok = order[sk], oc = order[sc];
        oi[t] = ok < oc ? ok : oc;
        oj[t] = ok < oc ? oc : ok;
        cells += (int64_t)lengths[sk] * lengths[sc];
    }
    return cells;
}

/* Greedy keep-first-in-file-order filter resolution (the deterministic spec
 * of the reference's prefilter, src/bio/filter.c:48-54): within a column
 * block [j0, j1), sequence j is lost iff some kept i < j has sim[i][j-j0]
 * set.  sim is row-major (j1 rows guaranteed by caller, stride = j1 - j0).
 * Sequential by construction (each j depends on all i < j). */
void filter_resolve(const uint8_t *sim, uint8_t *lost, int64_t j0,
                    int64_t j1) {
    const int64_t stride = j1 - j0;
    for (int64_t j = (j0 > 1 ? j0 : 1); j < j1; j++) {
        const uint8_t *col = sim + (j - j0);
        uint8_t hit = 0;
        for (int64_t i = 0; i < j; i++) {
            if (col[i * stride] && !lost[i]) {
                hit = 1;
                break;
            }
        }
        lost[j] = hit;
    }
}
