/* Minimal fftw3f API shim for building the reference receiver in an
 * image without FFTW.  Backed by shim implementations in fftshim.c
 * (double-precision radix-2 + Bluestein).  API surface = exactly what
 * src/sdrcmn.c uses. */
#ifndef FFTW3_SHIM_H
#define FFTW3_SHIM_H
#ifdef __cplusplus
extern "C" {
#endif
typedef float fftwf_complex[2];
typedef struct fftwf_plan_s *fftwf_plan;
#define FFTW_FORWARD  (-1)
#define FFTW_BACKWARD (+1)
#define FFTW_ESTIMATE (1U << 6)
fftwf_plan fftwf_plan_dft_1d(int n, fftwf_complex *in, fftwf_complex *out,
                             int sign, unsigned flags);
void fftwf_execute_dft(const fftwf_plan p, fftwf_complex *in,
                       fftwf_complex *out);
void fftwf_destroy_plan(fftwf_plan p);
void *fftwf_malloc(size_t n);
void fftwf_free(void *p);
int fftwf_init_threads(void);
void fftwf_plan_with_nthreads(int n);
#ifdef __cplusplus
}
#endif
#endif
