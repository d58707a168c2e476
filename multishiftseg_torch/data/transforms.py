"""The paired augmentation pipeline on numpy, for (image, mask, gen_image,
gen_mask).

Counterpart of ``multishiftseg_tpu/data/transforms.py``: ``Sample``,
``Compose``, ``ToTensor``, ``Normalize`` and the twelve train transforms
(:91-300). Spatial transforms apply one geometry to all four arrays;
photometric ones touch both images and not the masks. Images are float32 HWC in
[0, 1] until ``Normalize``; masks are int32 HW. ``Compose`` takes ``(aug,
prob)`` pairs (or bare transforms, probability 1) and draws from a
``numpy.random.Generator``; every transform draws from it in the JAX package's
order, so one seed gives the same crop, flip, scale and angle in both. The
OpenCV calls of the JAX versions are :mod:`.image_ops`, which reproduces their
arithmetic; the truncations ``(x * 255).astype(uint8)`` and ``int(h * f)`` are
copied as they are. A rotated mask takes 0 (road's train id) where the rotation
uncovers the border, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from . import image_ops as ops


class Sample:
    """The 4-tuple the pipeline threads through (gen_* may be None for eval)."""

    __slots__ = ("image", "mask", "gen_image", "gen_mask")

    def __init__(self, image, mask, gen_image=None, gen_mask=None):
        self.image = image
        self.mask = mask
        self.gen_image = gen_image
        self.gen_mask = gen_mask

    def images(self):
        return [x for x in (self.image, self.gen_image) if x is not None]

    def map_images(self, fn):
        self.image = fn(self.image)
        if self.gen_image is not None:
            self.gen_image = fn(self.gen_image)
        return self

    def map_all(self, img_fn, mask_fn):
        self.image = img_fn(self.image)
        self.mask = mask_fn(self.mask)
        if self.gen_image is not None:
            self.gen_image = img_fn(self.gen_image)
            self.gen_mask = mask_fn(self.gen_mask)
        return self


class Compose:
    def __init__(self, augmentations: Sequence):
        self.augmentations = list(augmentations)

    def __call__(self, rng: np.random.Generator, sample: Sample) -> Sample:
        for a in self.augmentations:
            aug, prob = a if isinstance(a, (tuple, list)) else (a, 1.0)
            if rng.random() < prob:
                sample = aug(rng, sample)
        return sample


class ToTensor:
    """uint8 HWC -> float32 [0, 1] HWC; masks -> int32."""

    def __call__(self, rng, s: Sample) -> Sample:
        def img(x):
            x = np.asarray(x)
            if x.dtype == np.uint8:
                # one fused pass, value-identical to astype(f32) / 255
                return np.divide(x, np.float32(255), dtype=np.float32)
            return x.astype(np.float32)

        return s.map_all(img, lambda m: np.asarray(m).astype(np.int32))


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, rng, s: Sample) -> Sample:
        return s.map_images(lambda x: (x - self.mean) / self.std)


def _u8(x: np.ndarray) -> np.ndarray:
    return (x * 255).astype(np.uint8)


class ColorJitter:
    """brightness / contrast / saturation 0.8, hue 0.2; the factors are drawn
    once, applied in a drawn order, and shared by both images."""

    def __init__(self, brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def __call__(self, rng, s: Sample) -> Sample:
        fb = rng.uniform(max(0, 1 - self.b), 1 + self.b)
        fc = rng.uniform(max(0, 1 - self.c), 1 + self.c)
        fs = rng.uniform(max(0, 1 - self.s), 1 + self.s)
        fh = rng.uniform(-self.h, self.h)
        order = rng.permutation(4)

        def apply(x):
            for op in order:
                if op == 0:
                    x = np.clip(x * fb, 0, 1)
                elif op == 1:
                    mean = ops.rgb2gray(_u8(x)).mean() / 255.0
                    x = np.clip(mean + fc * (x - mean), 0, 1)
                elif op == 2:
                    g3 = (ops.rgb2gray(_u8(x)).astype(np.float32) / 255.0)[..., None]
                    x = np.clip(g3 + fs * (x - g3), 0, 1)
                else:
                    hsv = ops.rgb2hsv(_u8(x)).astype(np.int16)
                    hsv[..., 0] = (hsv[..., 0] + int(fh * 180)) % 180
                    x = ops.hsv2rgb(hsv.astype(np.uint8)).astype(np.float32) / 255.0
            return x

        return s.map_images(apply)


class GaussianBlur:
    """9x9 kernel, sigma U(0.1, 5.0)."""

    def __call__(self, rng, s: Sample) -> Sample:
        sigma = rng.uniform(0.1, 5.0)
        return s.map_images(lambda x: ops.gaussian_blur(x, 9, sigma))


class RandSharpness:
    """Sharpness factor U(0, 2) against a 3x3 blur."""

    def __call__(self, rng, s: Sample) -> Sample:
        f = rng.random() * 2

        def apply(x):
            blur = ops.gaussian_blur(x, 3, 0)
            return np.clip(blur + f * (x - blur), 0, 1)

        return s.map_images(apply)


class AutoContrast:
    def __call__(self, rng, s: Sample) -> Sample:
        def apply(x):
            out = np.empty_like(x)
            for c in range(x.shape[-1]):
                ch = x[..., c]
                lo, hi = ch.min(), ch.max()
                out[..., c] = (ch - lo) / (hi - lo) if hi > lo else ch
            return out

        return s.map_images(apply)


class Equalize:
    """Per-channel histogram equalisation on uint8."""

    def __call__(self, rng, s: Sample) -> Sample:
        def apply(x):
            u8 = _u8(x)
            out = np.stack([ops.equalize_hist(u8[..., c]) for c in range(u8.shape[-1])], -1)
            return out.astype(np.float32) / 255.0

        return s.map_images(apply)


def _resize_all(s: Sample, size: Tuple[int, int]) -> Sample:
    """Images bilinear, masks nearest, to ``size`` (h, w)."""
    return s.map_all(lambda x: ops.resize_linear(x, size),
                     lambda m: ops.resize_nearest(m, size))


class Resize:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, rng, s: Sample) -> Sample:
        return _resize_all(s, self.size)


class RandResize:
    def __init__(self, scale: Sequence[float]):
        self.scale = list(scale)

    def __call__(self, rng, s: Sample) -> Sample:
        f = self.scale[rng.integers(len(self.scale))]
        h, w = s.image.shape[:2]
        return _resize_all(s, (int(h * f), int(w * f)))


def _crop(s: Sample, top: int, left: int, th: int, tw: int) -> Sample:
    return s.map_all(lambda x: x[top:top + th, left:left + tw],
                     lambda m: m[top:top + th, left:left + tw])


class RandCrop:
    """Resize when smaller than ``size``, then one shared random crop."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, rng, s: Sample) -> Sample:
        th, tw = self.size
        h, w = s.image.shape[:2]
        if h < th or w < tw:
            s = _resize_all(s, self.size)
            h, w = s.image.shape[:2]
        top = int(rng.integers(0, h - th + 1))
        left = int(rng.integers(0, w - tw + 1))
        return _crop(s, top, left, th, tw)


class RandCropIncludeOOD:
    """OOD-aware crop: when the generated mask has anomaly pixels (100 < label
    < 255), the window partly (with ``prob``) or wholly includes them; else a
    plain shared random crop."""

    def __init__(self, size: Tuple[int, int], prob: float = 0.5):
        self.size = size
        self.prob = prob

    def __call__(self, rng, s: Sample) -> Sample:
        if s.gen_mask is None:
            raise ValueError("RandCropIncludeOOD needs the generated mask")
        th, tw = self.size
        h, w = s.image.shape[:2]
        if h < th or w < tw:
            s = _resize_all(s, self.size)
            h, w = s.image.shape[:2]
        ys, xs = np.nonzero((s.gen_mask > 100) & (s.gen_mask < 255))
        if ys.size == 0:
            top = int(rng.integers(0, h - th + 1))
            left = int(rng.integers(0, w - tw + 1))
        else:
            y_min, y_max = int(ys.min()), int(ys.max())
            x_min, x_max = int(xs.min()), int(xs.max())
            if rng.random() < self.prob:  # partly include the object
                top_lo, top_hi = max(0, y_min - th + 1), min(y_max, h - th)
                left_lo, left_hi = max(0, x_min - tw + 1), min(x_max, w - tw)
            else:  # wholly include it (a crop at least the object's size)
                top_lo, top_hi = max(0, y_max - th + 1), min(y_min, h - th)
                left_lo, left_hi = max(0, x_max - tw + 1), min(x_min, w - tw)
            top = int(rng.integers(top_lo, max(top_lo, top_hi) + 1))
            left = int(rng.integers(left_lo, max(left_lo, left_hi) + 1))
        return _crop(s, top, left, th, tw)


class RandRotate:
    """One rotation U(-10, 10) degrees about the centre; images bilinear,
    masks nearest, 0 outside the source."""

    def __call__(self, rng, s: Sample) -> Sample:
        angle = rng.random() * 20 - 10
        h, w = s.image.shape[:2]
        mat = ops.rotation_matrix((w / 2, h / 2), angle, 1.0)
        return s.map_all(
            lambda x: ops.warp_affine(x, mat, (w, h)),
            lambda m: ops.warp_affine(m.astype(np.float32), mat, (w, h),
                                      nearest=True).astype(m.dtype))


class RandHorizontalFlip:
    def __call__(self, rng, s: Sample) -> Sample:
        return s.map_all(lambda x: x[:, ::-1].copy(), lambda m: m[:, ::-1].copy())


class RandVerticalFlip:
    def __call__(self, rng, s: Sample) -> Sample:
        return s.map_all(lambda x: x[::-1].copy(), lambda m: m[::-1].copy())
