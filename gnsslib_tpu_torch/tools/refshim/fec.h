/* Minimal ka9q-fec viterbi27 API shim (SBAS only; see fecshim.c). */
#ifndef FEC_SHIM_H
#define FEC_SHIM_H
#ifdef __cplusplus
extern "C" {
#endif
#define V27POLYA 0x4F
#define V27POLYB 0x6D
void *create_viterbi27_port(int len);
void set_viterbi27_polynomial_port(int polys[2]);
int init_viterbi27_port(void *vp, int starting_state);
int update_viterbi27_blk_port(void *vp, unsigned char sym[], int npairs);
int chainback_viterbi27_port(void *vp, unsigned char *data,
                             unsigned int nbits, unsigned int endstate);
void delete_viterbi27_port(void *vp);
#ifdef __cplusplus
}
#endif
#endif
