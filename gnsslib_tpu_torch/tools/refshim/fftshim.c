/* fftw3f shim: iterative radix-2 with Bluestein for arbitrary n.
 *
 * Fast enough for the full-envelope parity scenario (n=32736 at the
 * 16.368 Msps reference config => Bluestein m=131072): per-(n,sign)
 * tables (radix-2 twiddles, chirp, chirp spectrum) are computed once
 * and cached process-wide, arrays are float (the reference's own FFTW
 * precision), and execution is thread-safe without FFTMTX — matching
 * real FFTW, where only planning needs a lock (the reference plans
 * inside cpxfft/cpxifft, src/sdrcmn.c:135-150, hence its mutex).
 * Table build stays double so the cached chirp/twiddles are exact. */
#include <pthread.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include "fftw3.h"

struct fftwf_plan_s { int n; int sign; struct tables_s *t; };

/* ------------------------------------------------------------------ */
/* per-size shared tables                                               */

typedef struct tables_s {
    int n, sign;
    int m;                     /* pow2 transform length (== n if pow2) */
    float *twr, *twi;          /* (m/2) radix-2 twiddles, given sign.. */
    float *twr_f, *twi_f;      /* ..and forward (-1) for Bluestein     */
    float *twr_b, *twi_b;      /* ..and backward (+1) for Bluestein    */
    float *cr, *ci;            /* (n) chirp (NULL if pow2)             */
    float *br, *bi;            /* (m) chirp spectrum (NULL if pow2)    */
    struct tables_s *next;
} tables_t;

static tables_t *g_tables;
static pthread_mutex_t g_lock = PTHREAD_MUTEX_INITIALIZER;

static int next_pow2(int n) { int p = 1; while (p < n) p <<= 1; return p; }

static void make_twiddles(float **prr, float **pii, int m, int sign)
{
    float *wr = malloc((m / 2) * sizeof(float));
    float *wi = malloc((m / 2) * sizeof(float));
    int j;
    for (j = 0; j < m / 2; j++) {
        double a = sign * 2.0 * M_PI * j / m;
        wr[j] = (float)cos(a);
        wi[j] = (float)sin(a);
    }
    *prr = wr; *pii = wi;
}

/* iterative radix-2 with a precomputed full-resolution twiddle table:
 * stage `len` uses tw[k * (m/len)] */
static void fft_pow2(float *re, float *im, int m,
                     const float *twr, const float *twi)
{
    int i, j, len;
    for (i = 1, j = 0; i < m; i++) {
        int bit = m >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) {
            float t = re[i]; re[i] = re[j]; re[j] = t;
            t = im[i]; im[i] = im[j]; im[j] = t;
        }
    }
    for (len = 2; len <= m; len <<= 1) {
        int half = len >> 1, stride = m / len;
        for (i = 0; i < m; i += len) {
            const float *cr = twr, *ci = twi;
            for (j = 0; j < half; j++) {
                int a = i + j, b = a + half;
                float wr = cr[j * stride], wi = ci[j * stride];
                float vr = re[b] * wr - im[b] * wi;
                float vi = re[b] * wi + im[b] * wr;
                float ur = re[a], ui = im[a];
                re[a] = ur + vr; im[a] = ui + vi;
                re[b] = ur - vr; im[b] = ui - vi;
            }
        }
    }
}

static tables_t *get_tables(int n, int sign)
{
    tables_t *t;
    pthread_mutex_lock(&g_lock);
    for (t = g_tables; t; t = t->next)
        if (t->n == n && t->sign == sign) {
            pthread_mutex_unlock(&g_lock);
            return t;
        }
    t = calloc(1, sizeof(*t));
    t->n = n; t->sign = sign;
    if ((n & (n - 1)) == 0) {
        t->m = n;
        make_twiddles(&t->twr, &t->twi, n, sign);
    } else {
        int m = next_pow2(2 * n - 1), k;
        double *dbr = calloc(m, sizeof(double));
        double *dbi = calloc(m, sizeof(double));
        t->m = m;
        make_twiddles(&t->twr_f, &t->twi_f, m, -1);
        make_twiddles(&t->twr_b, &t->twi_b, m, +1);
        t->cr = malloc(n * sizeof(float));
        t->ci = malloc(n * sizeof(float));
        for (k = 0; k < n; k++) {
            double ang = sign * M_PI
                * fmod((double)k * (double)k, 2.0 * n) / n;
            double c = cos(ang), s = sin(ang);
            t->cr[k] = (float)c; t->ci[k] = (float)s;
            dbr[k] = c; dbi[k] = -s;
            if (k) { dbr[m - k] = c; dbi[m - k] = -s; }
        }
        /* spectrum of the conjugate chirp, built in float via the same
         * kernel the execute path uses (forward twiddles) */
        t->br = malloc(m * sizeof(float));
        t->bi = malloc(m * sizeof(float));
        for (k = 0; k < m; k++) {
            t->br[k] = (float)dbr[k];
            t->bi[k] = (float)dbi[k];
        }
        free(dbr); free(dbi);
        fft_pow2(t->br, t->bi, m, t->twr_f, t->twi_f);
    }
    t->next = g_tables;
    g_tables = t;
    pthread_mutex_unlock(&g_lock);
    return t;
}

/* Bluestein with cached chirp + chirp spectrum: 2 pow2 FFTs/execute */
static void fft_any(float *re, float *im, tables_t *t)
{
    int n = t->n, m = t->m, k;
    float *ar, *ai;
    if (m == n) {
        fft_pow2(re, im, n, t->twr, t->twi);
        return;
    }
    ar = calloc(m, sizeof(float));
    ai = calloc(m, sizeof(float));
    for (k = 0; k < n; k++) {
        ar[k] = re[k] * t->cr[k] - im[k] * t->ci[k];
        ai[k] = re[k] * t->ci[k] + im[k] * t->cr[k];
    }
    fft_pow2(ar, ai, m, t->twr_f, t->twi_f);
    for (k = 0; k < m; k++) {
        float tr = ar[k] * t->br[k] - ai[k] * t->bi[k];
        ai[k] = ar[k] * t->bi[k] + ai[k] * t->br[k];
        ar[k] = tr;
    }
    fft_pow2(ar, ai, m, t->twr_b, t->twi_b);
    for (k = 0; k < n; k++) {          /* /m for inverse, then chirp */
        float rr = ar[k] / m, ri = ai[k] / m;
        re[k] = rr * t->cr[k] - ri * t->ci[k];
        im[k] = rr * t->ci[k] + ri * t->cr[k];
    }
    free(ar); free(ai);
}

/* ------------------------------------------------------------------ */

fftwf_plan fftwf_plan_dft_1d(int n, fftwf_complex *in, fftwf_complex *out,
                             int sign, unsigned flags)
{
    struct fftwf_plan_s *p = malloc(sizeof(*p));
    (void)in; (void)out; (void)flags;
    p->n = n; p->sign = sign;
    p->t = get_tables(n, sign);        /* build shared tables once */
    return p;
}

void fftwf_execute_dft(const fftwf_plan p, fftwf_complex *in,
                       fftwf_complex *out)
{
    int n = p->n, k;
    tables_t *t = p->t;
    float *re = malloc(n * sizeof(float));
    float *im = malloc(n * sizeof(float));
    for (k = 0; k < n; k++) { re[k] = in[k][0]; im[k] = in[k][1]; }
    fft_any(re, im, t);
    for (k = 0; k < n; k++) { out[k][0] = re[k]; out[k][1] = im[k]; }
    free(re); free(im);
}

void fftwf_destroy_plan(fftwf_plan p) { free(p); }
void *fftwf_malloc(size_t n) { return malloc(n); }
void fftwf_free(void *p) { free(p); }
int fftwf_init_threads(void) { return 1; }
void fftwf_plan_with_nthreads(int n) { (void)n; }
