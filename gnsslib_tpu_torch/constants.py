"""Physical constants, signal identifiers, and receiver defaults.

Mirrors the constant surface of the reference header (reference:
src/sdr.h:101-242) so every capability knob of the original receiver has a
named equivalent, while dropping pthread/plotting plumbing that has no
meaning in a functional TPU design.
"""
from __future__ import annotations

import enum

# --- physical constants (sdr.h:103-107) -----------------------------------
PI = 3.1415926535897932
DPI = 2.0 * PI
D2R = PI / 180.0
R2D = 180.0 / PI
CLIGHT = 299792458.0  # speed of light (m/s)

# --- carrier frequencies (rtklib.h equivalents) ----------------------------
FREQ1 = 1.57542e9        # GPS/QZSS/SBAS L1 (Hz)
FREQ2 = 1.22760e9        # GPS L2 (Hz)
FREQ5 = 1.17645e9        # GPS L5 (Hz)
FREQ1_CMP = 1.561098e9   # BeiDou B1 (Hz) — rtklib.h:84
FREQ1_GLO = 1.60200e9    # GLONASS G1 base (Hz)
DFRQ1_GLO = 0.56250e6    # GLONASS G1 FDMA channel spacing (Hz)
FREQ2_GLO = 1.24600e9    # GLONASS G2 base (Hz)
DFRQ2_GLO = 0.43750e6    # GLONASS G2 FDMA channel spacing (Hz)

# --- satellite systems (RTKLIB bit flags, rtklib.h) -------------------------
SYS_NONE = 0x00
SYS_GPS = 0x01
SYS_SBS = 0x02
SYS_GLO = 0x04
SYS_GAL = 0x08
SYS_QZS = 0x10
SYS_CMP = 0x20
SYS_ALL = 0xFF

# satellite number ranges (RTKLIB convention, rtklib.h:180-260)
MINPRNGPS, MAXPRNGPS = 1, 32
MINPRNGLO, MAXPRNGLO = 1, 27
MINPRNGAL, MAXPRNGAL = 1, 36
MINPRNQZS, MAXPRNQZS = 193, 202
MINPRNCMP, MAXPRNCMP = 1, 63
MINPRNSBS, MAXPRNSBS = 120, 158

NSATGPS = MAXPRNGPS - MINPRNGPS + 1
NSATGLO = MAXPRNGLO - MINPRNGLO + 1
NSATGAL = MAXPRNGAL - MINPRNGAL + 1
NSATQZS = MAXPRNQZS - MINPRNQZS + 1
NSATCMP = MAXPRNCMP - MINPRNCMP + 1
NSATSBS = MAXPRNSBS - MINPRNSBS + 1
MAXSAT = NSATGPS + NSATGLO + NSATGAL + NSATQZS + NSATCMP + NSATSBS

# --- code types (sdr.h:204-212) ---------------------------------------------
class CodeType(enum.IntEnum):
    L1CA = 1      # GPS/QZSS L1C/A
    L1CP = 2      # GPS/QZSS L1C pilot
    L1CD = 3      # GPS/QZSS L1C data
    L1CO = 4      # GPS/QZSS L1C overlay
    G1 = 20       # GLONASS G1
    L1SBAS = 27   # SBAS-compatible L1CA
    NH10 = 28     # 10-bit Neuman-Hoffman secondary
    NH20 = 29     # 20-bit Neuman-Hoffman secondary


# --- data / front-end types (sdr.h:112-127) ---------------------------------
class DType(enum.IntEnum):
    REAL = 1   # real sampling (DTYPEI)
    IQ = 2     # complex sampling (DTYPEIQ)


class FrontendType(enum.IntEnum):
    STEREO = 0
    GN3SV2 = 1
    GN3SV3 = 2
    RTLSDR = 3
    BLADERF = 4
    FSTEREO = 5
    FGN3SV2 = 6
    FGN3SV3 = 7
    FRTLSDR = 8
    FBLADERF = 9
    FILE = 10


FTYPE1 = 1
FTYPE2 = 2

# --- acquisition defaults (sdr.h:139-149) ------------------------------------
ACQINTG_L1CA = 10     # non-coherent integration rounds
ACQINTG_G1 = 10
ACQINTG_SBAS = 10
ACQHBAND = 7000.0     # Doppler half search band (Hz)
ACQSTEP = 200.0       # Doppler search step (Hz)
ACQTH = 3.0           # peak-ratio acceptance threshold
ACQSLEEP = 2000       # retry interval after failed acquisition (ms)

# --- tracking loop-update cadences (sdr.h:151-154) ---------------------------
LOOP_L1CA = 10        # loop-filter interval (code periods) after bit sync
LOOP_G1 = 10
LOOP_SBAS = 2

# --- navigation framing parameters (sdr.h:156-193) ---------------------------
NAVSYNCTH = 50        # bit-edge vote threshold for bit sync

NAVRATE_L1CA = 20     # code periods per nav bit
NAVFLEN_L1CA = 300    # frame length (bits)
NAVADDFLEN_L1CA = 2   # extra leading bits kept (previous word parity tail)
NAVPRELEN_L1CA = 8
NAVEPHCNT_L1CA = 3    # subframes needed for a full ephemeris

NAVRATE_SBAS = 2
NAVFLEN_SBAS = 1500
NAVADDFLEN_SBAS = 12
NAVPRELEN_SBAS = 16
NAVEPHCNT_SBAS = 3

NAVRATE_G1 = 10
NAVFLEN_G1 = 200
NAVADDFLEN_G1 = 0
NAVPRELEN_G1 = 30
NAVEPHCNT_G1 = 5

MAXBITS = 3000        # max frame bit length (sdr.h:110)

# --- observable generation (sdr.h:195-198) -----------------------------------
PTIMING = 68.802      # pseudorange generation timing offset (ms)
OBSINTERPN = 80       # observation history depth for interpolation
SNSMOOTHMS = 100      # SNR smoothing interval (ms)

# --- spectrum analysis (sdr.h:228-237) ----------------------------------------
SPEC_MS = 200            # diagnostics refresh cadence (sdr.h:229)
SPEC_LEN = 7             # spectrum integration span, ms (sdr.h:230)
SPEC_BITN = 8
SPEC_NLOOP = 100
SPEC_NFFT = 16384

# --- SBAS message sizes (sdr.h:239-241) ----------------------------------------
LENSBASMSG = 32       # 250 bits + pad (bytes)
LENSBASNOV = 80       # NovAtel-framed message length (bytes)

# --- Viterbi polynomials for SBAS r=1/2 k=7 FEC (ka9q-fec V27POLYA/B) ----------
V27POLYA = 0x4F
V27POLYB = 0x6D
