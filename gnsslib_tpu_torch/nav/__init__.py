"""Navigation-message decode layer.

Host-side subsystem: bit sync votes and prompt-correlator harvesting happen
on device (track/), but frame decode is branch-heavy scalar work at
~50-500 bits/s per channel — it runs in NumPy/Python exactly as SURVEY.md
§7.1(5) prescribes (reference: src/sdrnav*.c).
"""
from .bits import (getbitu, getbits, getbitu2, getbits2, getbitu3, getbits3,
                   bits2byte, interleave, crc24q, crc32_rtk)
from .eph import Eph, Geph, SdrEph
from .framer import NavChannel, NavParams, nav_params
from .lnav import decode_frame_l1ca, encode_frame_l1ca, paritycheck_l1ca
from .glonass import decode_frame_g1, encode_string_g1
from .sbas import decode_msg_sbas, gen_novatel_sbasmsg, SbasMsg
from .viterbi import viterbi27_decode, conv27_encode

__all__ = [
    "getbitu", "getbits", "getbitu2", "getbits2", "getbitu3", "getbits3",
    "bits2byte", "interleave", "crc24q", "crc32_rtk",
    "Eph", "Geph", "SdrEph",
    "NavChannel", "NavParams", "nav_params",
    "decode_frame_l1ca", "encode_frame_l1ca", "paritycheck_l1ca",
    "decode_frame_g1", "encode_string_g1",
    "decode_msg_sbas", "gen_novatel_sbasmsg", "SbasMsg",
    "viterbi27_decode", "conv27_encode",
]
