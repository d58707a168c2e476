"""The image operations of the train augmentations, on numpy, with OpenCV's
arithmetic.

The JAX package's transforms (``multishiftseg_tpu/data/transforms.py``) and its
anomaly mix call OpenCV; the port does not depend on OpenCV, so each call has
its counterpart here, reproducing what OpenCV 5.0 computes on an x86 host with
AVX-512 and its IPP back end, down to the order of the float operations where
it decides a rounding:

- ``resize_linear`` (``cv2.resize``, ``INTER_LINEAR``, float32): IPP's
  resize, half-pixel source positions clamped at the edge, the fraction taken
  in float64 and rounded to float32, then one fused multiply-add lerp along x
  and one along y.
- ``resize_nearest`` (``INTER_NEAREST``): source index ``floor(d * src / dst)``.
- ``rgb2gray``, ``rgb2hsv``, ``hsv2rgb`` (``cv2.cvtColor`` on uint8): the
  fixed-point gray weights, the table-driven HSV forward and the float HSV
  inverse with H in 0-179 (truncated in its 32-pixel vector body, rounded in
  the scalar tail of each row).
- ``gaussian_blur`` (``cv2.GaussianBlur`` on float32, ``BORDER_REFLECT_101``):
  the bit-exact kernel, then the separable filter's row pass and symmetric
  column pass, each with the fused multiply-adds of its vector body and the
  plain arithmetic of its scalar tail.
- ``equalize_hist`` (``cv2.equalizeHist``): its lookup table and rounding.
- ``rotation_matrix`` and ``warp_affine`` (``cv2.getRotationMatrix2D``,
  ``cv2.warpAffine``, ``BORDER_CONSTANT`` 0): on float32 the inverse map
  evaluated in float32 per destination pixel (16-pixel vector body, scalar
  tail), the bilinear value as three fused lerps, the nearest pixel rounded
  half to even; on float64 the fixed-point remap (``AB_BITS`` 10, 1/32-pixel
  steps).

float64 images (the JAX pipeline's contrast jitter promotes to float64 through
its ``np.float64`` mean, and OpenCV keeps the depth) take OpenCV's float64
paths: resize and blur in float64, the rotation through the fixed-point remap.

A fused multiply-add ``fma(a, b, c)`` is evaluated as ``a * b + c`` in float64
and rounded once to float32: the float32 product is exact in float64, so only
the final rounding remains (it can differ from a true fused operation only
where the float64 sum is itself a float32 tie, which these inputs do not
produce in practice). ``tests/test_torch_data.py`` holds every function
against OpenCV bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

F32 = np.float32
F64 = np.float64


def fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (see the module docstring)."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def _lerp(a, b, t):
    return fma(t, b - a, a)


# ---------------------------------------------------------------- resize


def _linear_taps(dst: int, src: int, dtype=F32):
    pos = (np.arange(dst, dtype=F64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(dtype)
    low = i0 < 0
    frac[low], i0[low] = 0, 0
    high = i0 >= src - 1
    frac[high], i0[high] = 0, src - 1
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """float32 or float64 HW or HWC image -> ``size_hw``, bilinear
    (``cv2.resize`` ``INTER_LINEAR``); a float64 image keeps float64
    fractions and lerps. A uint8 image is resized in float32 and rounded back,
    which is not OpenCV's fixed-point uint8 resize to the last bit."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        out = resize_linear(img.astype(F32), size_hw)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    double = img.dtype == F64
    img = img if double else img.astype(F32)
    lerp = (lambda a, b, t: a + t * (b - a)) if double else _lerp
    h, w = img.shape[:2]
    dh, dw = size_hw
    x0, x1, fx = _linear_taps(dw, w, img.dtype)
    y0, y1, fy = _linear_taps(dh, h, img.dtype)
    extra = (None,) * (img.ndim - 2)
    rows = lerp(img[:, x0], img[:, x1], fx[(slice(None),) + extra])
    return lerp(rows[y0], rows[y1], fy[(slice(None), None) + extra])


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Any-dtype HW or HWC array -> ``size_hw``, nearest (``cv2.resize``
    ``INTER_NEAREST``: the source index is ``floor(d * src / dst)``)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    dh, dw = size_hw
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]


# ---------------------------------------------------------------- colour

_GRAY_SHIFT = 15
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735  # 0.299, 0.587, 0.114 of 2^15, summing to it


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 gray (``COLOR_RGB2GRAY``)."""
    c = rgb.astype(np.int32)
    y = (c[..., 0] * _GRAY_R + c[..., 1] * _GRAY_G + c[..., 2] * _GRAY_B
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(256, dtype=F64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0).astype(np.int32)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0).astype(np.int32)
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb2hsv(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 HSV, H in 0-179 (``COLOR_RGB2HSV``)."""
    c = rgb.astype(np.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h += 180 * (h < 0)
    out = np.empty(rgb.shape, np.uint8)
    out[..., 0], out[..., 1], out[..., 2] = h, s, v
    return out


# sector -> (b, g, r) entries of [v, v(1-s), v(1-sh), v(1-s(1-h))]
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


HSV_VECTOR_PIXELS = 32


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV [..., W, 3], H in 0-179 -> uint8 RGB (``COLOR_HSV2RGB``):
    float32 H / 30 and S, V / 255, the sector table with ``1 - s h`` and
    ``1 - s (1 - h)`` fused, times 255; truncated in each row's vector body of
    32-pixel blocks, rounded half to even in its scalar tail."""
    h = hsv[..., 0].astype(F32) * F32(6.0 / 180)
    s = hsv[..., 1].astype(F32) * F32(1.0 / 255)
    v = hsv[..., 2].astype(F32) * F32(1.0 / 255)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(F32)
    one = F32(1)
    tab = [v, v * (one - s), v * fma(-s, h, one), v * fma(-s, one - h, one)]
    body = hsv.shape[-2] - hsv.shape[-2] % HSV_VECTOR_PIXELS
    out = np.empty(hsv.shape, np.uint8)
    for c in range(3):  # r, g, b: entries 2, 1, 0 of each sector's row
        x = np.choose(_SECTORS[:, 2 - c][sector], tab) * F32(255)
        x[..., :body] = np.trunc(x[..., :body])
        x[..., body:] = np.rint(x[..., body:])
        out[..., c] = x
    return out


# ---------------------------------------------------------------- blur

_SMALL_KERNELS = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                  7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def gaussian_kernel(ksize: int, sigma: float, dtype=F32) -> np.ndarray:
    """1-D Gaussian taps (``cv2.getGaussianKernel``): the fixed table for
    sigma <= 0 at ksize <= 7, else exp(-d^2 / 2 sigma^2) normalised."""
    if sigma <= 0 and ksize in _SMALL_KERNELS:
        return np.asarray(_SMALL_KERNELS[ksize], dtype)
    sx = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    scale = -0.125 / (sx * sx)
    half = [math.exp(x * x * scale) for x in range(1 - ksize, 0, 2)]
    mul = 1.0 / (2 * sum(half) + 1)
    side = [t * mul for t in half]
    return np.asarray(side + [mul] + side[::-1], dtype)


def _row_pass(rows: np.ndarray, k: np.ndarray, r: int, cn: int, n: int) -> np.ndarray:
    """Row filter over flattened rows [R, (W + 2r) * cn] -> [R, n], fused
    multiply-adds in the vector body, plain ones in the scalar tail (the last
    n % 4 elements). Up to 5 taps the filter is symmetric (centre, then the
    pairs outward), above it runs from tap 0."""
    taps = [rows[:, cn * i:cn * i + n] for i in range(2 * r + 1)]
    if r <= 2:
        order = [(taps[r - i] + taps[r + i], k[r + i]) for i in range(1, r + 1)]
        out = taps[r] * k[r]
    else:
        order = [(taps[i], k[i]) for i in range(1, 2 * r + 1)]
        out = taps[0] * k[0]
    body = n - n % 4
    tail = out[:, body:].copy()
    for x, kk in order:
        out = fma(x, kk, out)
        tail = tail + x[:, body:] * kk
    out[:, body:] = tail
    return out


def _col_pass(rows: np.ndarray, k: np.ndarray, r: int, h: int) -> np.ndarray:
    """Symmetric column filter over [h + 2r, n] -> [h, n]: the centre tap,
    then the pairs outward, fused in the vector body, plain in the scalar
    tail (the last n % 8 elements)."""
    n = rows.shape[1]
    taps = [rows[i:i + h] for i in range(2 * r + 1)]
    out = taps[r] * k[r]
    body = n - n % 8
    tail = out[:, body:].copy()
    for i in range(1, r + 1):
        pair = taps[r - i] + taps[r + i]
        out = fma(pair, k[r + i], out)
        tail = tail + pair[:, body:] * k[r + i]
    out[:, body:] = tail
    return out


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """float32 or float64 HW or HWC image blurred by a ksize x ksize Gaussian
    of ``sigma`` (``cv2.GaussianBlur(img, (ksize, ksize), sigma)``,
    ``BORDER_REFLECT_101``). A float64 image is filtered in float64 with
    float64 taps, to its last bits only up to the order of the sums."""
    img = np.asarray(img)
    double = img.dtype == F64
    img = img if double else img.astype(F32)
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    k = gaussian_kernel(ksize, sigma, img.dtype)
    r = ksize // 2
    pad = ((r, r), (r, r)) + (((0, 0),) if img.ndim == 3 else ())
    padded = np.pad(img, pad, mode="reflect").reshape(h + 2 * r, -1)
    if double:
        rows = sum(padded[:, cn * i:cn * i + w * cn] * k[i] for i in range(ksize))
        return sum(rows[i:i + h] * k[i] for i in range(ksize)).reshape(img.shape)
    rows = _row_pass(padded, k, r, cn, w * cn)
    return _col_pass(rows, k, r, h).reshape(img.shape)


# ---------------------------------------------------------------- histogram


def equalize_hist(gray: np.ndarray) -> np.ndarray:
    """uint8 HW -> uint8 HW (``cv2.equalizeHist``): the cumulative histogram
    from the first occupied bin, scaled by 255 / (N - its count) in float32
    and rounded half to even."""
    hist = np.bincount(gray.reshape(-1), minlength=256)
    total = gray.size
    first = int(np.argmax(hist > 0))
    if hist[first] == total:
        return np.full_like(gray, first)
    scale = F32(255.0 / (total - hist[first]))
    cum = np.cumsum(hist)
    cum = cum - cum[first]
    lut = np.clip(np.rint(cum.astype(F32) * scale), 0, 255).astype(np.uint8)
    lut[:first + 1] = 0
    return lut[gray]


# ---------------------------------------------------------------- rotation


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """2x3 float64 affine map (``cv2.getRotationMatrix2D``): ``angle`` in
    degrees, counter-clockwise, about ``center`` (x, y)."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_affine(m: np.ndarray) -> Sequence[float]:
    m = [float(v) for v in np.asarray(m, F64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


VECTOR_PIXELS = 16


def _source_coords(m: np.ndarray, h: int, w: int):
    """Source (x, y) in float32 of every destination pixel: in the vector body
    ``fma(m0, x, m1 y + m2)``, in the scalar tail of each row
    ``fma(m0, x, m1 y) + m2``."""
    a = [F32(v) for v in _inverse_affine(m)]
    xs = np.arange(w, dtype=F32)[None]
    ys = np.arange(h, dtype=F32)[:, None]
    body = w - w % VECTOR_PIXELS
    xb, xt = xs[:, :body], xs[:, body:]
    out = []
    for c0, c1, c2 in ((a[0], a[1], a[2]), (a[3], a[4], a[5])):
        s = np.empty((h, w), F32)
        s[:, :body] = fma(c0, xb, c1 * ys + c2)
        s[:, body:] = fma(c0, xt, c1 * ys) + c2
        out.append(s)
    return out


AB_BITS, INTER_BITS = 10, 5


def _fixed_point_coords(m: np.ndarray, h: int, w: int):
    """The remap's source pixel and 1/2^INTER_BITS interpolation steps (x, y)
    of every destination pixel: the inverse map in units of 2^-AB_BITS,
    rounded."""
    a = _inverse_affine(m)
    scale = 1 << AB_BITS
    delta = scale // (1 << INTER_BITS) // 2
    xs, ys = np.arange(w, dtype=F64), np.arange(h, dtype=F64)
    cx = np.rint((a[1] * ys + a[2]) * scale).astype(np.int64)[:, None] + delta
    cy = np.rint((a[4] * ys + a[5]) * scale).astype(np.int64)[:, None] + delta
    cx = cx + np.rint(a[0] * xs * scale).astype(np.int64)[None]
    cy = cy + np.rint(a[3] * xs * scale).astype(np.int64)[None]
    cx, cy = cx >> (AB_BITS - INTER_BITS), cy >> (AB_BITS - INTER_BITS)
    steps = F64(1 << INTER_BITS)
    return (cx >> INTER_BITS, cy >> INTER_BITS,
            (cx & ((1 << INTER_BITS) - 1)) / steps, (cy & ((1 << INTER_BITS) - 1)) / steps)


def warp_affine(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """float32 HW or HWC ``img`` under the forward map ``m`` into a
    ``size_wh`` (w, h) canvas, 0 outside the source (``cv2.warpAffine`` with
    ``INTER_LINEAR`` or ``INTER_NEAREST`` and ``BORDER_CONSTANT``), in float32
    coordinates (see the module docstring). A float64 image (bilinear) takes
    the fixed-point remap, its coordinates in 1/1024 and its weights in 1/32
    of a pixel; masks are warped as float32."""
    img = np.asarray(img)
    double = img.dtype == F64 and not nearest
    img = img if double else img.astype(F32)
    sh, sw = img.shape[:2]
    w, h = size_wh

    def fetch(yy, xx):
        ok = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        v = img[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(ok if img.ndim == 2 else ok[..., None], v, img.dtype.type(0))

    if double:
        x0, y0, ax, ay = _fixed_point_coords(m, h, w)
        if img.ndim == 3:
            ax, ay = ax[..., None], ay[..., None]
        return (fetch(y0, x0) * ((1 - ax) * (1 - ay)) + fetch(y0, x0 + 1) * (ax * (1 - ay))
                + fetch(y0 + 1, x0) * ((1 - ax) * ay) + fetch(y0 + 1, x0 + 1) * (ax * ay))
    sx, sy = _source_coords(m, h, w)
    if nearest:
        return fetch(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    top = _lerp(fetch(y0, x0), fetch(y0, x0 + 1), ax)
    bottom = _lerp(fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1), ax)
    return _lerp(top, bottom, ay)
