/* SBAS decode + NovAtel framing oracle.
 *
 * Links the REFERENCE's sdrnav_sbs.c (decode_msg_sbas, decode_MT12,
 * gen_novatel_sbasmsg) and RTKLIB's rtkcmn.c (getbitu/setbitu/crc) so the
 * framework's SBAS message decode and OEM6 RAWSBASFRAME framing
 * (gnsslib_tpu/nav/sbas.py) can be compared byte-for-byte against the
 * actual reference implementation.
 *
 * stdin:  lines of "week tow hex(32-byte msg)" — the packed 250-bit SBAS
 *         message as decode_l1sbas's bits2byte(bits,250,32,0,...) produces
 *         it (src/sdrnav.c:351-360), plus the sdrsbas_t state (week, tow)
 *         carried in from the previous message.
 * stdout: per line: "id week tow hex(80-byte novatelmsg)".
 */
#include <stdio.h>
#include <string.h>
#include "sdr.h"

/* globals other functions in sdrnav_sbs.o reference at link time
 * (decode_l1sbas reads sdrini/sdrch and calls sendsbas/bits2byte; we only
 * call decode_msg_sbas + gen_novatel_sbasmsg, but the symbols must
 * resolve) */
sdrini_t sdrini = {0};
sdrstat_t sdrstat = {0};
sdrch_t sdrch[MAXSAT] = {{0}};
sdrout_t sdrout = {0};
void sendsbas(sdrsbas_t *sbas, sdrsoc_t *soc) { (void)sbas; (void)soc; }
void bits2byte(int *bits, int nbits, int nbin, int right, uint8_t *bin)
{ (void)bits; (void)nbits; (void)nbin; (void)right; (void)bin; }

int main(void)
{
    char line[512], hex[256];
    int week;
    double tow;
    while (fgets(line, sizeof(line), stdin)) {
        sdrsbas_t sbas;
        memset(&sbas, 0, sizeof(sbas));
        if (sscanf(line, "%d %lf %255s", &week, &tow, hex) != 3) continue;
        sbas.week = week;
        sbas.tow = tow;
        for (int i = 0; i < 32; i++) {
            unsigned v;
            sscanf(&hex[2 * i], "%2x", &v);
            sbas.msg[i] = (uint8_t)v;
        }
        decode_msg_sbas(sbas.msg, &sbas);
        gen_novatel_sbasmsg(&sbas);
        printf("%d %d %.3f ", sbas.id, sbas.week, sbas.tow);
        for (int i = 0; i < LENSBASNOV; i++)
            printf("%02x", sbas.novatelmsg[i]);
        printf("\n");
    }
    return 0;
}
