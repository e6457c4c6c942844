"""Device-resident sample cache; front-end file formats come from
:mod:`gnsslib_tpu.io`."""
from .devcache import DeviceBlockCache  # noqa: F401
