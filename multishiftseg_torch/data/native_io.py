"""ctypes binding to the repository's native decoder (``native/dataio.cc``).

Counterpart of ``multishiftseg_tpu/data/native_io.py``: ``decode``,
``decode_batch`` (one native thread per file, the GIL released for the whole
batch) and ``normalize_crop`` (uint8 -> normalised float32 crop in one pass).
The library is built at first use with ``g++`` into ``multishiftseg_torch/build/``
(git-ignored), named by a hash of the source and flags so an edited source is
rebuilt; ``native/`` itself is only read. Where the compiler or the codec
headers are missing, everything decodes through PIL, as the JAX binding does.
This is host decoding, not a device kernel. The decoder in use is logged once
and reported by :func:`decoder`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lwebp", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_state = {"tried": False, "decoder": None}
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libmssdataio-{digest.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mss_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_U8P), _INTP, _INTP, _INTP]
    lib.mss_decode.restype = ctypes.c_int
    lib.mss_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                     ctypes.POINTER(_U8P), _INTP, _INTP, _INTP]
    lib.mss_decode_batch.restype = ctypes.c_int
    lib.mss_free.argtypes = [_U8P]
    lib.mss_free.restype = None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mss_normalize_crop.argtypes = [_U8P] + [ctypes.c_int] * 6 + [fp, fp, fp]
    lib.mss_normalize_crop.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be built
    or loaded (then PIL decodes)."""
    global _lib
    with _lock:
        if _state["tried"]:
            return _lib
        _state["tried"] = True
        try:
            path = _library_path()
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # built on another host against other codec libraries
                _build(path)
                lib = ctypes.CDLL(str(path))
            _lib = _bind(lib)
            _state["decoder"] = "native"
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or e
            _state["decoder"] = "pil"
            last = (str(detail).strip().splitlines() or [""])[-1]
            log.warning("native decoder unavailable (%s); decoding through PIL", last)
        else:
            log.warning("decoding images with the native decoder %s", path.name)
        return _lib


def decoder() -> str:
    """``"native"`` or ``"pil"``: the decoder this process uses."""
    get_lib()
    return _state["decoder"]


def _pil(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def _copy_out(lib, data_p, h: int, w: int, c: int) -> np.ndarray:
    buf = np.ctypeslib.as_array(data_p, shape=(h * w * c,)).copy()
    lib.mss_free(data_p)
    arr = buf.reshape(h, w, c)
    return arr[..., 0] if c == 1 else arr


def decode(path: str) -> np.ndarray:
    """Decode an image file to HWC uint8 (HW for single-channel and paletted
    files: a palette's indices, as PIL gives them)."""
    lib = get_lib()
    if lib is None:
        return _pil(path)
    data_p = _U8P()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mss_decode(str(path).encode(), ctypes.byref(data_p), ctypes.byref(h),
                      ctypes.byref(w), ctypes.byref(c)) != 0:
        return _pil(path)
    return _copy_out(lib, data_p, h.value, w.value, c.value)


def decode_batch(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode several files, one native thread each."""
    lib = get_lib()
    if lib is None:
        return [decode(p) for p in paths]
    n = len(paths)
    arr_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    datas = (_U8P * n)()
    hs, ws, cs = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    if lib.mss_decode_batch(arr_paths, n, datas, hs, ws, cs) != 0:
        return [decode(p) for p in paths]
    return [_copy_out(lib, datas[i], hs[i], ws[i], cs[i]) for i in range(n)]


def normalize_crop(img_u8: np.ndarray, top: int, left: int, crop_h: int, crop_w: int,
                   mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """uint8 HWC image -> the normalised float32 crop, in one pass; numpy where
    the library is missing or the image is not a contiguous RGB array."""
    if not (0 <= top and 0 <= left and top + crop_h <= img_u8.shape[0]
            and left + crop_w <= img_u8.shape[1]):
        raise ValueError(f"crop ({top}, {left}, {crop_h}, {crop_w}) outside the image "
                         f"{img_u8.shape[:2]}")
    lib = get_lib()
    if (lib is None or img_u8.dtype != np.uint8 or img_u8.ndim != 3 or img_u8.shape[2] != 3
            or not img_u8.flags["C_CONTIGUOUS"]):
        crop = img_u8[top:top + crop_h, left:left + crop_w].astype(np.float32) / 255.0
        return (crop - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    out = np.empty((crop_h, crop_w, 3), np.float32)
    m = (ctypes.c_float * 3)(*[float(v) for v in mean])
    s = (ctypes.c_float * 3)(*[float(v) for v in std])
    lib.mss_normalize_crop(img_u8.ctypes.data_as(_U8P), img_u8.shape[0], img_u8.shape[1],
                           top, left, crop_h, crop_w, m, s,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
