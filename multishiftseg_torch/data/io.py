"""Image decoding for the datasets: the native decoder of :mod:`.native_io`
(``native/dataio.cc``), or PIL where it cannot be built, as the JAX package's
``data/native_io.py::decode`` does."""

from __future__ import annotations

from .native_io import decode, decode_batch  # noqa: F401
