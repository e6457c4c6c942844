"""Receiver runtime of the port: configuration, file-replay receiver, CLI."""
from .config import ChannelConfig, ReceiverConfig, load_ini  # noqa: F401
from .receiver import OutputHub, Receiver  # noqa: F401
