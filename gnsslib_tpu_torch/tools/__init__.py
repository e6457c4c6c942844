"""Measurement tools of the port (``python -m gnsslib_tpu_torch.tools.<name>``).

Each tool runs on the card unless ``--device cpu`` is given, and exits 2
when the card is asked for and absent: a number it prints is never a CPU
number under the card's name."""
from __future__ import annotations

import sys


def no_card(device: str, prog: str) -> bool:
    """Whether ``device`` is ``cuda`` and torch sees no card; if so, says
    so on stderr (the caller then exits 2)."""
    if device != "cuda":
        return False
    import torch       # not at import time: ttff times torch's import
    if torch.cuda.is_available():
        return False
    print(f"{prog}: no CUDA card (use --device cpu to run the plain "
          f"versions on the CPU)", file=sys.stderr)
    return True
