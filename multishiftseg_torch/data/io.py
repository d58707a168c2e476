"""Image decoding through PIL.

The JAX package's ``data/native_io.py::decode`` uses its native library and
falls back to exactly this; the port's binding to ``native/dataio.cc`` is not
written yet.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def decode(path: str) -> np.ndarray:
    """Decode an image file to HWC uint8 (HW for single-channel files)."""
    with Image.open(path) as im:
        return np.asarray(im)
