// Native host kernels of gnsslib_tpu_torch (host-side hot paths).
//
// The reference links native libraries for exactly these jobs: ka9q-fec's
// Viterbi27 (SBAS FEC, src/sdrnav.c:288-318), RTKLIB's CRC utilities
// (rtkcmn.c), and the front-end drivers' sample expansion loops
// (src/rcv/*).  This file provides the equivalents as a small
// C++ library loaded via ctypes; every entry point has a NumPy fallback
// in the port (nav/viterbi.py, nav/bits.py, io/formats.py) with
// identical semantics.
//
// Build: see gnsslib_tpu_torch/native/__init__.py (ensure_built) or
//   g++ -O3 -shared -fPIC -o libgnsslib_native.so gnsslib_native.cpp

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// Viterbi K=7 r=1/2, ka9q polynomial convention (V27POLYA=0x4F first),
// soft symbols 0..255 (0 = strong logical 0), equal-metric start,
// traceback from best end state.  Mirrors nav/viterbi.py.
// ---------------------------------------------------------------------------
static inline int parity7(unsigned x) {
    x ^= x >> 4; x ^= x >> 2; x ^= x >> 1; return x & 1;
}

void v27_decode(const uint8_t *sym, int nsteps, int nbits, uint8_t *out) {
    const int NS = 64;
    static int init_done = 0;
    static float outA[NS][2], outB[NS][2];
    static int nxt[NS][2];
    if (!init_done) {
        for (int s = 0; s < NS; s++) {
            for (int b = 0; b < 2; b++) {
                unsigned r = ((unsigned)s << 1) | b;
                outA[s][b] = 255.0f * parity7(r & 0x4F);
                outB[s][b] = 255.0f * parity7(r & 0x6D);
                nxt[s][b] = r & (NS - 1);
            }
        }
        init_done = 1;
    }
    float *metric = new float[NS]();
    float *nmetric = new float[NS];
    uint8_t *dec = new uint8_t[(size_t)nsteps * NS];

    for (int t = 0; t < nsteps; t++) {
        float sa = sym[2 * t], sb = sym[2 * t + 1];
        for (int n = 0; n < NS; n++) nmetric[n] = 1e30f;
        uint8_t *drow = dec + (size_t)t * NS;
        for (int s = 0; s < NS; s++) {
            for (int b = 0; b < 2; b++) {
                float bm = std::fabs(sa - outA[s][b]) +
                           std::fabs(sb - outB[s][b]);
                int n = nxt[s][b];
                float cand = metric[s] + bm;
                if (cand < nmetric[n]) {
                    nmetric[n] = cand;
                    drow[n] = (uint8_t)((s << 1) | b);
                }
            }
        }
        std::memcpy(metric, nmetric, NS * sizeof(float));
    }
    int state = 0;
    float best = metric[0];
    for (int n = 1; n < NS; n++)
        if (metric[n] < best) { best = metric[n]; state = n; }

    uint8_t *bits = new uint8_t[nsteps];
    for (int t = nsteps - 1; t >= 0; t--) {
        uint8_t d = dec[(size_t)t * NS + state];
        bits[t] = d & 1;
        state = d >> 1;
    }
    int n = nbits < nsteps ? nbits : nsteps;
    std::memcpy(out, bits, n);
    delete[] metric; delete[] nmetric; delete[] dec; delete[] bits;
}

// ---------------------------------------------------------------------------
// CRC-24Q (RTKLIB rtk_crc24q semantics: zero init, poly 0x1864CFB)
// ---------------------------------------------------------------------------
uint32_t crc24q(const uint8_t *data, int len) {
    static uint32_t tbl[256];
    static int done = 0;
    if (!done) {
        for (int b = 0; b < 256; b++) {
            uint32_t c = (uint32_t)b << 16;
            for (int k = 0; k < 8; k++) {
                c <<= 1;
                if (c & 0x1000000) c ^= 0x1864CFB;
            }
            tbl[b] = c & 0xFFFFFF;
        }
        done = 1;
    }
    uint32_t crc = 0;
    for (int i = 0; i < len; i++)
        crc = ((crc << 8) & 0xFFFFFF) ^ tbl[(crc >> 16) ^ data[i]];
    return crc;
}

// ---------------------------------------------------------------------------
// Front-end sample expansion (src/rcv/* LUT loops) -> float32
// ---------------------------------------------------------------------------
void unpack_rtlsdr(const uint8_t *raw, int n, float *out) {
    for (int i = 0; i < n; i++)
        out[i] = (float)(int8_t)(int)((double)raw[i] - 127.5);
}

void unpack_gn3s_v3_2bit(const uint8_t *raw, int n, float *out) {
    static const float lut[4] = {1, -1, 3, -3};
    for (int i = 0; i < n; i++) out[i] = lut[raw[i] & 0x03];
}

void unpack_gn3s_v3_4bit(const uint8_t *raw, int n, float *out) {
    static const float lutI[16] = {1, -1, 0, 0, 3, -3, 0, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0};
    static const float lutQ[16] = {1, 0, -1, 0, 0, 0, 0, 0,
                                   3, 0, -3, 0, 0, 0, 0, 0};
    for (int i = 0; i < n; i++) {
        out[2 * i] = lutI[raw[i] & 0x05];
        out[2 * i + 1] = lutQ[raw[i] & 0x0A];
    }
}

void unpack_stereo_fe1(const uint8_t *raw, int n, float *out) {
    static const float lut[4] = {-3, -1, 1, 3};
    for (int i = 0; i < n; i++) out[i] = lut[(raw[i] >> 6) & 0x03];
}

void unpack_stereo_fe2(const uint8_t *raw, int n, float *out) {
    static const float lut[8] = {1, 3, 5, 7, -7, -5, -3, -1};
    for (int i = 0; i < n; i++) {
        out[2 * i] = lut[(raw[i] >> 3) & 0x07];
        out[2 * i + 1] = lut[raw[i] & 0x07];
    }
}

}  // extern "C"
