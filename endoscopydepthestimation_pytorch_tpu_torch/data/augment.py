"""Host-side photometric augmentation and color normalization: the port's
copy of the JAX package's ``data/augment.py`` (``TrainingAugmentation``
:128, its transforms :49-118, ``normalize_color`` :157).

A native (cv2/numpy) re-implementation of the reference's albumentations
pipeline (train.py:121-142): one color jitter, one image-quality
degradation, one noise injection, on uint8 RGB images. The order of the
random draws is the JAX package's, so the same ``RandomState`` gives the
same image in both packages (the JAX module's docstring records how each
block's distribution follows albumentations).
"""
from __future__ import annotations

import cv2
import numpy as np


def _brightness_contrast(img, rng, limit=0.3):
    alpha = 1.0 + rng.uniform(-limit, limit)   # contrast
    beta = rng.uniform(-limit, limit)          # brightness
    out = img.astype(np.float32) * alpha + beta * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _gamma(img, rng, lo=80, hi=120):
    # albumentations RandomGamma draws an INTEGER gamma in [80, 120]
    gamma = int(rng.randint(lo, hi + 1)) / 100.0
    lut = np.clip(((np.arange(256) / 255.0) ** gamma) * 255.0, 0, 255).astype(np.uint8)
    return lut[img]


def _hsv_shift(img, rng, hue_limit, sat_limit, val_limit):
    # albumentations HueSaturationValue semantics: cv2's 180-range hue
    # channel with mod-180 wrap (NOT the 256-range HSV_FULL — a +-30 shift
    # there would be ~0.7x weaker), float shifts, sat/val clipped
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 0] = np.mod(hsv[..., 0] + rng.uniform(-hue_limit, hue_limit), 180.0)
    hsv[..., 1] = np.clip(hsv[..., 1] + rng.uniform(-sat_limit, sat_limit), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + rng.uniform(-val_limit, val_limit), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def _blur(img, rng):
    # albumentations Blur: any kernel size in [3, 7], even included
    k = int(rng.randint(3, 8))
    return cv2.blur(img, (k, k))


def _median_blur(img, rng):
    k = int(rng.choice([3, 5, 7]))
    return cv2.medianBlur(img, k)


def _motion_blur(img, rng):
    k = int(rng.choice([3, 5, 7]))
    kernel = np.zeros((k, k), np.float32)
    angle = rng.uniform(0, np.pi)
    c = (k - 1) / 2.0
    for t in np.linspace(-c, c, 2 * k):
        x = int(round(c + t * np.cos(angle)))
        y = int(round(c + t * np.sin(angle)))
        kernel[np.clip(y, 0, k - 1), np.clip(x, 0, k - 1)] = 1.0
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def _jpeg(img, rng, lo=20, hi=100):
    # albumentations JpegCompression: integer quality, both bounds inclusive
    quality = int(rng.randint(lo, hi + 1))
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _gauss_noise(img, rng, var_lo=10, var_hi=30):
    sigma = np.sqrt(rng.uniform(var_lo, var_hi))
    noise = rng.normal(0.0, sigma, img.shape).astype(np.float32)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _additive_gauss_noise(img, rng, lo=0.005 * 255, hi=0.02 * 255):
    sigma = rng.uniform(lo, hi)
    noise = rng.normal(0.0, sigma, img.shape).astype(np.float32)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _color_jitter_compose(img, rng):
    if rng.uniform() < 0.5:
        img = _brightness_contrast(img, rng)
    if rng.uniform() < 0.5:
        img = _gamma(img, rng)
    if rng.uniform() < 0.5:
        img = _hsv_shift(img, rng, 30, 0, 0)
    return img


class TrainingAugmentation:
    """The reference's three-block OneOf pipeline (train.py:121-142)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)

    def reseed(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def __call__(self, image: np.ndarray,
                 rng: np.random.RandomState = None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        img = np.ascontiguousarray(image.astype(np.uint8))
        # Block 1: color augmentation. OneOf member weights are the
        # members' own p normalized: Compose(p=1.0) vs HSV(p=0.5) -> 2/3
        if rng.uniform() < 0.5:
            if rng.uniform() < 2.0 / 3.0:
                img = _color_jitter_compose(img, rng)
            else:
                img = _hsv_shift(img, rng, 30, 30, 30)
        # Block 2: image-quality augmentation
        if rng.uniform() < 0.5:
            img = [_blur, _median_blur, _motion_blur, _jpeg][rng.randint(4)](img, rng)
        # Block 3: noise augmentation
        if rng.uniform() < 0.5:
            img = [_gauss_noise, _additive_gauss_noise][rng.randint(2)](img, rng)
        return img


def normalize_color(image: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (reference dataset.py:148:
    albu.Normalize(mean=std=0.5, max_pixel_value=255))."""
    return (np.asarray(image, dtype=np.float32) / 255.0 - 0.5) / 0.5
