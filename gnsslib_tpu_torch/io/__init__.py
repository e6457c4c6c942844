"""Sample sources: the file front end (every supported IF byte format,
replayed from disk), the live front ends (a capture process or a growing
file feeding a host ring, and the in-process driver bindings of RTL-SDR,
bladeRF, GN3S and NSL STEREO through their vendor libraries), and the
device-resident sample cache."""
from .formats import (unpack_int8, unpack_rtlsdr, unpack_gn3s_v2,  # noqa: F401
                      unpack_gn3s_v3_2bit, unpack_gn3s_v3_4bit,
                      unpack_stereo_fe1, unpack_stereo_fe2, unpack_bladerf)
from .frontend import FileFrontend, FrontendSpec  # noqa: F401
from .live import (LiveFrontend, ProcessFrontend, RingView,  # noqa: F401
                   StreamFrontend, StreamOverrun)
from .bladerf import BladeRfFrontend  # noqa: F401
from .gn3s import Gn3sFrontend  # noqa: F401
from .rtlsdr import RtlSdrFrontend  # noqa: F401
from .stereo import StereoFrontend  # noqa: F401
from .devcache import DeviceBlockCache  # noqa: F401

__all__ = ["LiveFrontend", "ProcessFrontend", "RingView",
           "StreamFrontend", "StreamOverrun",
           "RtlSdrFrontend", "BladeRfFrontend", "Gn3sFrontend",
           "StereoFrontend",
           "unpack_int8", "unpack_rtlsdr", "unpack_gn3s_v2",
           "unpack_gn3s_v3_2bit", "unpack_gn3s_v3_4bit",
           "unpack_stereo_fe1", "unpack_stereo_fe2", "unpack_bladerf",
           "FileFrontend", "FrontendSpec", "DeviceBlockCache"]
