"""Sample sources: the file front end (every supported IF byte format,
replayed from disk) and the device-resident sample cache.  The live
front-end drivers of the JAX package are not ported."""
from .formats import (unpack_int8, unpack_rtlsdr, unpack_gn3s_v2,  # noqa: F401
                      unpack_gn3s_v3_2bit, unpack_gn3s_v3_4bit,
                      unpack_stereo_fe1, unpack_stereo_fe2, unpack_bladerf)
from .frontend import FileFrontend, FrontendSpec  # noqa: F401
from .devcache import DeviceBlockCache  # noqa: F401
