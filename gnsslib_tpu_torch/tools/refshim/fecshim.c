/* Buffered soft Viterbi27 with the ka9q call pattern. */
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include "fec.h"

static int g_polys[2] = {V27POLYA, V27POLYB};

struct v27 {
    int maxbits, nsyms, start;
    unsigned char *syms;       /* 2 per step */
};

static int parity7(unsigned x){x^=x>>4;x^=x>>2;x^=x>>1;return x&1;}

void *create_viterbi27_port(int len)
{
    struct v27 *v = calloc(1, sizeof(*v));
    v->maxbits = len + 64;
    v->syms = malloc(2 * (size_t)v->maxbits);
    return v;
}
void set_viterbi27_polynomial_port(int polys[2])
{ g_polys[0] = polys[0]; g_polys[1] = polys[1]; }
int init_viterbi27_port(void *vp, int starting_state)
{ struct v27 *v = vp; v->nsyms = 0; v->start = starting_state & 63; return 0; }
int update_viterbi27_blk_port(void *vp, unsigned char sym[], int npairs)
{
    struct v27 *v = vp;
    if (v->nsyms + npairs > v->maxbits) npairs = v->maxbits - v->nsyms;
    memcpy(v->syms + 2 * v->nsyms, sym, 2 * (size_t)npairs);
    v->nsyms += npairs;
    return 0;
}
int chainback_viterbi27_port(void *vp, unsigned char *data,
                             unsigned int nbits, unsigned int endstate)
{
    struct v27 *v = vp;
    int NS = 64, t, s, b, n = v->nsyms;
    float *metric = malloc(NS * sizeof(float));
    float *nmetric = malloc(NS * sizeof(float));
    unsigned char *dec = malloc((size_t)n * NS);
    for (s = 0; s < NS; s++) metric[s] = 1e30f;
    metric[v->start] = 0.0f;
    for (t = 0; t < n; t++) {
        float sa = v->syms[2 * t], sb = v->syms[2 * t + 1];
        for (s = 0; s < NS; s++) nmetric[s] = 1e30f;
        for (s = 0; s < NS; s++) {
            if (metric[s] >= 1e30f) continue;
            for (b = 0; b < 2; b++) {
                unsigned r = ((unsigned)s << 1) | b;
                float oa = 255.0f * parity7(r & g_polys[0]);
                float ob = 255.0f * parity7(r & g_polys[1]);
                float bm = fabsf(sa - oa) + fabsf(sb - ob);
                int ns = r & 63;
                float cand = metric[s] + bm;
                if (cand < nmetric[ns]) {
                    nmetric[ns] = cand;
                    dec[(size_t)t * NS + ns] = (unsigned char)((s << 1) | b);
                }
            }
        }
        memcpy(metric, nmetric, NS * sizeof(float));
    }
    int state = (int)(endstate & 63);
    unsigned char *bits = malloc(n);
    for (t = n - 1; t >= 0; t--) {
        unsigned char d = dec[(size_t)t * NS + state];
        bits[t] = d & 1;
        state = d >> 1;
    }
    memset(data, 0, (nbits + 7) / 8);
    for (t = 0; t < (int)nbits && t < n; t++)
        if (bits[t]) data[t / 8] |= 0x80 >> (t % 8);
    free(metric); free(nmetric); free(dec); free(bits);
    return 0;
}
void delete_viterbi27_port(void *vp)
{ struct v27 *v = vp; free(v->syms); free(v); }
