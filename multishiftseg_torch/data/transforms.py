"""Eval transforms on numpy: ``Sample``, ``Compose``, ``ToTensor``, ``Normalize``.

Counterpart of the eval part of ``multishiftseg_tpu/data/transforms.py``
(:21-89). Images are float32 HWC in [0, 1] until ``Normalize``; masks are int32
HW. ``Compose`` takes ``(aug, prob)`` pairs (or bare transforms, probability 1)
and draws from a ``numpy.random.Generator``. The train augmentations are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Sample:
    """The 4-tuple the pipeline threads through (gen_* may be None for eval)."""

    __slots__ = ("image", "mask", "gen_image", "gen_mask")

    def __init__(self, image, mask, gen_image=None, gen_mask=None):
        self.image = image
        self.mask = mask
        self.gen_image = gen_image
        self.gen_mask = gen_mask

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
