"""Data augmentation (host-side NumPy, NCHW internal layout); a copy of
bflow_tpu/data/augmentor.py, so that items match the JAX package's under
the same rng.

A shared random crop across event grids / flow / validity / images,
horizontal & vertical flips with flow-sign negation, and an optional
photometric pass (color jitter + speckle noise). Randomness comes from an
explicit `np.random.Generator` (seeded per item by the Loader), so batches
are reproducible by construction.

Color jitter reproduces torchvision.ColorJitter's semantics (uniform
factor ranges, random order of the four ops); speckle matches skimage
``random_noise(mode='speckle')``: img + img * N(0, var), clipped.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class FlowAugmentor:
    """Shared spatial augmentation: flips then a common random crop."""

    def __init__(
        self,
        crop_size_hw: Tuple[int, int],
        h_flip_prob: float = 0.5,
        v_flip_prob: float = 0.1,
    ):
        assert crop_size_hw[0] > 0 and crop_size_hw[1] > 0
        assert 0 <= h_flip_prob <= 1 and 0 <= v_flip_prob <= 1
        self.crop_size_hw = tuple(crop_size_hw)
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob

    def __call__(
        self,
        rng: np.random.Generator,
        ev_repr: Optional[List[np.ndarray]] = None,
        flow: Optional[List[np.ndarray]] = None,
        valid: Optional[List[np.ndarray]] = None,
        images: Optional[List[np.ndarray]] = None,
    ):
        """All array args are lists of NCHW-style arrays: ev (C,H,W),
        flow (2,H,W), valid (H,W), images (C,H,W). Returns same structure.
        """

        def flip(arrs, axis):
            return None if arrs is None else [
                np.ascontiguousarray(np.flip(a, axis=axis)) for a in arrs
            ]

        if rng.random() < self.h_flip_prob:
            ev_repr = flip(ev_repr, -1)
            images = flip(images, -1)
            valid = flip(valid, -1)
            if flow is not None:
                flow = flip(flow, -1)
                for f in flow:
                    f[0] *= -1.0
        if rng.random() < self.v_flip_prob:
            ev_repr = flip(ev_repr, -2)
            images = flip(images, -2)
            valid = flip(valid, -2)
            if flow is not None:
                flow = flip(flow, -2)
                for f in flow:
                    f[1] *= -1.0

        ref = (ev_repr or images)[0]
        height, width = ref.shape[-2:]
        ch, cw = self.crop_size_hw
        assert height > ch and width > cw, ((height, width), (ch, cw))
        y0 = int(rng.integers(0, height - ch))
        x0 = int(rng.integers(0, width - cw))

        def crop(arrs):
            return None if arrs is None else [
                a[..., y0 : y0 + ch, x0 : x0 + cw] for a in arrs
            ]

        return crop(ev_repr), crop(flow), crop(valid), crop(images)


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(img, cv2.COLOR_RGB2HSV)


def _hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(img, cv2.COLOR_HSV2RGB)


class PhotoAugmentor:
    """Color jitter + speckle noise on uint8 RGB images (C, H, W)."""

    def __init__(
        self,
        brightness: float = 0.4,
        contrast: float = 0.4,
        saturation: float = 0.4,
        hue: float = 0.5 / 3.14,
        probability_color: float = 0.2,
        noise_variance_range: Tuple[float, float] = (0.001, 0.01),
        probability_noise: float = 0.2,
    ):
        assert 0 <= probability_color <= 1 and 0 <= probability_noise <= 1
        assert noise_variance_range[1] > noise_variance_range[0]
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p_color = probability_color
        self.p_noise = probability_noise
        self.var_range = noise_variance_range

    def _jitter_one(self, rng: np.random.Generator, img: np.ndarray):
        """img: (C, H, W) uint8 -> jittered uint8."""
        chw = img.astype(np.float32) / 255.0
        hwc = np.moveaxis(chw, 0, -1)

        b = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
        h = rng.uniform(-self.hue, self.hue)

        def apply_brightness(x):
            return np.clip(x * b, 0, 1)

        def apply_contrast(x):
            # torchvision: blend with the mean of the grayscale image
            gray = x @ np.asarray([0.299, 0.587, 0.114], np.float32)
            return np.clip(x * c + (1 - c) * gray.mean(), 0, 1)

        def apply_saturation(x):
            gray = (x @ np.asarray([0.299, 0.587, 0.114], np.float32))[..., None]
            return np.clip(x * s + (1 - s) * gray, 0, 1)

        def apply_hue(x):
            hsv = _rgb_to_hsv(x)
            hsv[..., 0] = np.mod(hsv[..., 0] + h * 360.0, 360.0)
            return np.clip(_hsv_to_rgb(hsv), 0, 1)

        ops = [apply_brightness, apply_contrast, apply_saturation, apply_hue]
        for i in rng.permutation(4):
            hwc = ops[i](hwc)
        out = np.moveaxis(hwc, -1, 0)
        return (out * 255.0 + 0.5).astype(np.uint8)

    def __call__(
        self, rng: np.random.Generator, images: List[np.ndarray]
    ) -> List[np.ndarray]:
        if rng.random() < self.p_color:
            images = [self._jitter_one(rng, im) for im in images]
        if rng.random() < self.p_noise:
            var = rng.uniform(*self.var_range)
            out = []
            for im in images:
                x = im.astype(np.float32) / 255.0
                noise = rng.normal(0.0, np.sqrt(var), size=x.shape)
                y = np.clip(x + x * noise, 0.0, 1.0)
                out.append((y * 255.0 + 0.5).astype(np.uint8))
            images = out
        return images
