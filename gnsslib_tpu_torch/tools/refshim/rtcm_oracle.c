/* Oracle harness: feed RTCM3 frames from stdin through the ACTUAL RTKLIB
 * decoder (reference lib/RTKLIB/src/rtcm3.c input_rtcm3) and print the
 * decoded ephemeris / observable fields, so the framework's RTCM encoders
 * (gnsslib_tpu/obs/rtcm.py) are verified against the real consumer rather
 * than hand-rolled bitfield checks.
 *
 * argv: week tow  (reference time anchoring the 30-bit MSM epoch)
 * Built with -DENAGLO -DENAQZS by tests/test_parity_reference.py.
 */
#include <stdio.h>
#include "rtklib.h"

int main(int argc, char **argv)
{
    rtcm_t rtcm = {0};
    int c, i, ret, prn, sys;

    init_rtcm(&rtcm);
    if (argc >= 3)
        rtcm.time = gpst2time(atoi(argv[1]), atof(argv[2]));

    while ((c = getchar()) != EOF) {
        ret = input_rtcm3(&rtcm, (unsigned char)c);
        if (ret == 2) {
            sys = satsys(rtcm.ephsat, &prn);
            if (sys == SYS_GLO) {
                geph_t *g = rtcm.nav.geph + prn - 1;
                double tow; int week;
                tow = time2gpst(g->toe, &week);
                printf("GEPH prn=%d iode=%d frq=%d svh=%d week=%d "
                       "toe=%.3f px=%.3f py=%.3f pz=%.3f vx=%.6f vy=%.6f "
                       "vz=%.6f ax=%.9e ay=%.9e az=%.9e taun=%.12e "
                       "gamn=%.12e\n",
                       prn, g->iode, g->frq, g->svh, week, tow,
                       g->pos[0], g->pos[1], g->pos[2],
                       g->vel[0], g->vel[1], g->vel[2],
                       g->acc[0], g->acc[1], g->acc[2], g->taun, g->gamn);
            } else {
                eph_t *e = rtcm.nav.eph + rtcm.ephsat - 1;
                printf("EPH sys=%d prn=%d week=%d iode=%d iodc=%d sva=%d "
                       "svh=%d toes=%.3f A=%.6f e=%.15e i0=%.15e "
                       "OMG0=%.15e omg=%.15e M0=%.15e deln=%.15e "
                       "OMGd=%.15e idot=%.15e crc=%.9f crs=%.9f cuc=%.15e "
                       "cus=%.15e cic=%.15e cis=%.15e f0=%.15e f1=%.15e "
                       "f2=%.15e tgd=%.15e fit=%.1f\n",
                       sys, prn, e->week, e->iode, e->iodc, e->sva, e->svh,
                       e->toes, e->A, e->e, e->i0, e->OMG0, e->omg, e->M0,
                       e->deln, e->OMGd, e->idot, e->crc, e->crs, e->cuc,
                       e->cus, e->cic, e->cis, e->f0, e->f1, e->f2,
                       e->tgd[0], e->fit);
            }
        } else if (ret == 1) {
            for (i = 0; i < rtcm.obs.n; i++) {
                obsd_t *o = rtcm.obs.data + i;
                double tow; int week;
                tow = time2gpst(o->time, &week);
                /* print sys+prn, not the raw sat index: the uniform sat
                 * numbering depends on MAXPRN* vintage */
                sys = satsys(o->sat, &prn);
                printf("OBS sys=%d prn=%d week=%d tow=%.4f P=%.4f L=%.4f "
                       "D=%.4f S=%.2f code=%d\n",
                       sys, prn, week, tow, o->P[0], o->L[0], o->D[0],
                       o->SNR[0] * 0.25, o->code[0]);
            }
        }
    }
    free_rtcm(&rtcm);
    return 0;
}
