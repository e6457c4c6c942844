/* Oracle harness: emit RINEX 3.02 GLONASS nav records via the ACTUAL
 * RTKLIB outrnxgnavb (reference lib/RTKLIB/src/rinex.c:2343) for a list
 * of (week, tow[, eph-kind]) GPST toe values read from stdin, so the
 * framework's RinexNavWriter.write_geph can be compared byte-for-byte —
 * including toe/tof rounding at UTC day boundaries (the gpst->utc leap
 * shift moves 00:00:0x GPST toes onto the previous UTC day).
 *
 * Also emits GPS records via outrnxnavb (rinex.c:2257) when kind==1, so
 * the LNAV writer shares the oracle.
 *
 * Built by tests/test_parity_reference.py with rtkcmn.c + rinex.c only.
 */
#include <stdio.h>
#include "rtklib.h"

int main(int argc, char **argv)
{
    rnxopt_t opt = {0};
    FILE *fp;
    double week, tow;
    int kind;

    opt.rnxver = 3.02;
    opt.navsys = SYS_ALL;
    if (argc < 2 || !(fp = fopen(argv[1], "w"))) return 1;

    while (scanf("%lf %lf %d", &week, &tow, &kind) == 3) {
        if (kind == 0) {
            geph_t g = {0};
            g.sat = satno(SYS_GLO, 5);
            g.iode = 42; g.frq = -4; g.svh = 0; g.sva = 0; g.age = 0;
            g.toe = gpst2time((int)week, tow);
            g.tof = timeadd(g.toe, -15.0);
            g.pos[0] = 11123456.789; g.pos[1] = -12987654.321;
            g.pos[2] = 19456789.123;
            g.vel[0] = 1234.5678; g.vel[1] = -2345.6789; g.vel[2] = 345.9;
            g.acc[0] = 1.862645e-06; g.acc[1] = -9.313226e-07;
            g.acc[2] = 2.793968e-06;
            g.taun = 1.9073486e-05; g.gamn = 9.094947e-13;
            if (!outrnxgnavb(fp, &opt, &g)) return 2;
        } else {
            eph_t e = {0};
            e.sat = satno(SYS_GPS, 7);
            e.iode = 77; e.iodc = 77; e.sva = 2; e.svh = 0;
            e.week = (int)week;
            e.toe = e.toc = gpst2time((int)week, tow);
            e.ttr = timeadd(e.toe, -7200.0);
            e.A = 26559850.641; e.e = 0.012; e.i0 = 0.96; e.OMG0 = 1.2;
            e.omg = -2.1; e.M0 = 0.5; e.deln = 4.3e-09; e.OMGd = -8e-09;
            e.idot = 3.1e-10; e.crc = 287.4; e.crs = -52.1;
            e.cuc = -2.7e-06; e.cus = 7.6e-06; e.cic = 1.1e-07;
            e.cis = -6.0e-08;
            e.toes = tow; e.fit = 4.0;
            e.f0 = 3.2e-04; e.f1 = -1.8e-11; e.f2 = 0.0;
            e.tgd[0] = -1.2e-08; e.code = 1; e.flag = 0;
            if (!outrnxnavb(fp, &opt, &e)) return 3;
        }
    }
    fclose(fp);
    return 0;
}
