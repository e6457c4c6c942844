/* Oracle harness: write RINEX 3.02 observation epochs via the ACTUAL
 * RTKLIB outrnxobsh/outrnxobsb (reference lib/RTKLIB/src/rinex.c) with the
 * reference receiver's rnxopt settings (src/sdrout.c:33-60: ver 3.02,
 * C1C/L1C/D1C/S1C, SNR quantized *4+0.5), so the framework's
 * RinexObsWriter epoch records can be compared byte-for-byte.
 *
 * stdin: repeated epochs "week tow ns" then ns lines "sys prn P L D S".
 * argv[1]: output path.  Built with -DENAGLO -DENAQZS by
 * tests/test_parity_reference.py.
 */
#include <stdio.h>
#include "rtklib.h"

int main(int argc, char **argv)
{
    rnxopt_t opt = {0};
    nav_t nav = {0};
    obsd_t data[64];
    FILE *fp;
    double week, tow, P, L, D, S;
    int i, ns, sys, prn;

    opt.rnxver = 3.02;
    opt.navsys = SYS_ALL;
    strcpy(opt.prog, "GNSS-SDRLIB v1.1");
    strcpy(opt.rec[0], "GNSS-SDRLIB");
    strcpy(opt.rec[1], "GNSS-SDRLIB");
    strcpy(opt.rec[2], "1.1");
    for (i = 0; i < 6; i++) {
        opt.nobs[i] = 4;
        strcpy(opt.tobs[i][0], "C1C");
        strcpy(opt.tobs[i][1], "L1C");
        strcpy(opt.tobs[i][2], "D1C");
        strcpy(opt.tobs[i][3], "S1C");
    }
    if (argc < 2 || !(fp = fopen(argv[1], "w"))) return 1;
    outrnxobsh(fp, &opt, &nav);

    while (scanf("%lf %lf %d", &week, &tow, &ns) == 3) {
        for (i = 0; i < ns && i < 64; i++) {
            if (scanf("%d %d %lf %lf %lf %lf", &sys, &prn, &P, &L, &D, &S)
                != 6) return 2;
            memset(data + i, 0, sizeof(obsd_t));
            data[i].time = gpst2time((int)week, tow);
            data[i].rcv = 1;
            data[i].sat = satno(sys, prn);
            data[i].P[0] = P;
            data[i].L[0] = L;
            data[i].D[0] = (float)D;
            data[i].SNR[0] = (unsigned char)(S * 4.0 + 0.5);
            data[i].code[0] = CODE_L1C;
        }
        if (!outrnxobsb(fp, &opt, data, ns, 0)) return 3;
    }
    fclose(fp);
    return 0;
}
