"""Host-side frame transforms, copied from the JAX package's
``data/transform.py`` (numpy, no JAX): the scoring dataset's normalize and
uniform crop, and the training path's DINO multi-crop augmentation
(``VideoDataAugmentationDINO``) with the crops, jitters and temporal
sampling it calls (ref: datasets_custom/transform.py, decoder.py).
Every stochastic op takes a ``numpy.random.RandomState``."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .interp import resize


def tensor_normalize(frames: np.ndarray, mean, std) -> np.ndarray:
    """uint8 -> float/255, subtract mean, divide std
    (ref: datasets_custom/data_utils.py:308-325). frames (..., C)
    channels-last like the reference call sites (T, H, W, C)."""
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (frames - mean) / std


def uniform_crop(
    images: np.ndarray, size: int, spatial_idx: int
) -> Tuple[np.ndarray, None]:
    """Left/center/right (or top/center/bottom) crop with ceil-centering
    (ref: datasets_custom/transform.py:206-250). images (T, C, H, W)."""
    assert spatial_idx in (0, 1, 2)
    height, width = images.shape[2], images.shape[3]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = height - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = width - size
    cropped = images[:, :, y_offset:y_offset + size, x_offset:x_offset + size]
    return cropped, None


def random_resized_crop(
    images: np.ndarray, size: int, scale: Tuple[float, float], rng,
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    interpolation: str = "bilinear",
) -> np.ndarray:
    """Inception-style crop (ref: datasets_custom/transform.py:134-173).

    Reproduces the reference's quirk of NOT breaking out of the 10-try loop:
    the last successful (h, w, i, j) draw wins.
    """
    height, width = images.shape[-2:]
    area = height * width
    non_central = False
    h = w = i = j = 0
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect_ratio = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w_try = int(round(math.sqrt(target_area * aspect_ratio)))
        h_try = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w_try <= width and 0 < h_try <= height:
            i = int(rng.randint(0, height - h_try + 1))
            j = int(rng.randint(0, width - w_try + 1))
            h, w = h_try, w_try
            non_central = True
    if not non_central:
        in_ratio = float(width) / float(height)
        if in_ratio < min(ratio):
            w = width
            h = int(round(w / min(ratio)))
        elif in_ratio > max(ratio):
            h = height
            w = int(round(h * max(ratio)))
        else:
            w, h = width, height
        i = (height - h) // 2
        j = (width - w) // 2
    cropped = images[:, :, i:i + h, j:j + w]
    return resize(cropped, size, mode=interpolation)


def horizontal_flip(prob: float, images: np.ndarray, rng) -> np.ndarray:
    """(ref: datasets_custom/transform.py:176-203)."""
    if rng.uniform() < prob:
        images = images[..., ::-1]
    return images


def blend(images1: np.ndarray, images2: np.ndarray, alpha: float) -> np.ndarray:
    return images1 * alpha + images2 * (1 - alpha)


def grayscale(images: np.ndarray) -> np.ndarray:
    """BGR-ordered grayscale per the reference's comment — channel 2 gets the
    0.299 weight (ref: datasets_custom/transform.py:349-370)."""
    gray = 0.299 * images[:, 2] + 0.587 * images[:, 1] + 0.114 * images[:, 0]
    out = images.copy()
    out[:, 0] = gray
    out[:, 1] = gray
    out[:, 2] = gray
    return out


def brightness_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-var, var)
    return blend(images, np.zeros_like(images), alpha)


def contrast_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-var, var)
    img_gray = grayscale(images)
    img_gray[:] = img_gray.mean(axis=(1, 2, 3), keepdims=True)
    return blend(images, img_gray, alpha)


def saturation_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-var, var)
    return blend(images, grayscale(images), alpha)


def color_jitter(images: np.ndarray, rng, img_brightness=0, img_contrast=0,
                 img_saturation=0) -> np.ndarray:
    """Random-order jitter chain (ref: datasets_custom/transform.py:372-404)."""
    jitter = []
    if img_brightness != 0:
        jitter.append("brightness")
    if img_contrast != 0:
        jitter.append("contrast")
    if img_saturation != 0:
        jitter.append("saturation")
    if jitter:
        order = rng.permutation(np.arange(len(jitter)))
        for idx in range(len(jitter)):
            if jitter[order[idx]] == "brightness":
                images = brightness_jitter(img_brightness, images, rng)
            elif jitter[order[idx]] == "contrast":
                images = contrast_jitter(img_contrast, images, rng)
            elif jitter[order[idx]] == "saturation":
                images = saturation_jitter(img_saturation, images, rng)
    return images


def color_normalization(images: np.ndarray, mean, stddev) -> np.ndarray:
    """(ref: datasets_custom/transform.py:495-516). images (T, C, H, W)."""
    mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(stddev, np.float32).reshape(1, -1, 1, 1)
    return (images - mean) / std


class VideoDataAugmentationDINO:
    """DINO video multi-crop augmentation
    (ref: datasets_custom/transform.py:661-749): 2 global 224-crops + N local
    96-crops; the reference's gaussian-blur / solarization are stubbed no-ops
    there and stay no-ops here. ``no_aug`` resizes and normalizes only; the
    two-token trainer's 6 views mix it with the augmented crops.
    """

    def __init__(self, global_crops_scale=(0.4, 1.0), local_crops_scale=(0.05, 0.4),
                 local_crops_number=8, rng: Optional[np.random.RandomState] = None):
        self.global_crops_scale = global_crops_scale
        self.local_crops_scale = local_crops_scale
        self.local_crops_number = local_crops_number
        self.rng = rng or np.random.RandomState()

    def flip_and_color_jitter(self, frames):
        frames = horizontal_flip(0.5, frames, self.rng)
        if self.rng.uniform() < 0.8:
            frames = color_jitter(frames, self.rng, img_brightness=0.4,
                                  img_contrast=0.4, img_saturation=0.2)
        if self.rng.uniform() < 0.2:
            frames = grayscale(frames)
        return frames

    @staticmethod
    def normalize(frames):
        return color_normalization(frames, mean=[0.485, 0.456, 0.406],
                                   stddev=[0.229, 0.224, 0.225])

    def no_aug(self, frames):
        return self.normalize(resize(frames, 224, mode="bicubic"))

    def global_transform1(self, frames):
        frames = random_resized_crop(frames, 224, self.global_crops_scale,
                                     self.rng, interpolation="bicubic")
        frames = self.flip_and_color_jitter(frames)
        return self.normalize(frames)

    def global_transform2(self, frames):
        frames = random_resized_crop(frames, 224, self.global_crops_scale,
                                     self.rng, interpolation="bicubic")
        frames = self.flip_and_color_jitter(frames)
        # blur/solarize branches are no-ops but still consume RNG draws in
        # the reference; mirror that for stream compatibility
        self.rng.uniform()
        self.rng.uniform()
        return self.normalize(frames)

    def local_transform(self, frames):
        frames = random_resized_crop(frames, 96, self.local_crops_scale,
                                     self.rng, interpolation="bicubic")
        frames = self.flip_and_color_jitter(frames)
        self.rng.uniform()
        return self.normalize(frames)

    def __call__(self, image, from_list=False, no_aug=False, two_token=False):
        """One (T, C, H, W) clip, or with ``from_list`` the clips of one
        video (2 globals, then the locals) -> the list of crops. With
        ``no_aug`` each clip of the list resized and normalized only; with
        ``two_token`` the list's 5 clips (3 global, 2 local) -> 6 views:
        [augmented global, plain global of clip 0, 96-px crops of clips 1
        and 2, plain 224-px views of clips 3 and 4] (ref:
        transform.py:738-743)."""
        def to_float(x):
            return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x

        if two_token:
            image = [to_float(x) for x in image]
            return [self.global_transform1(image[0]), self.no_aug(image[0]),
                    self.local_transform(image[1]), self.local_transform(image[2]),
                    self.no_aug(image[3]), self.no_aug(image[4])]
        if no_aug:
            return [self.no_aug(to_float(x)) for x in image]
        if from_list:
            image = [to_float(x) for x in image]
            crops = [self.global_transform1(image[0]), self.global_transform2(image[1])]
            for local_image in image[2:]:
                crops.append(self.local_transform(local_image))
            return crops
        image = to_float(image)
        crops = [self.global_transform1(image), self.global_transform2(image)]
        for _ in range(self.local_crops_number):
            crops.append(self.local_transform(image))
        return crops


def spatial_tile_local_crops(frame_hwc: np.ndarray) -> list:
    """The spatial-tiling local crops (ref: datasets_custom/decoder.py:
    576-601): one (H, W, C) frame, center-cropped to 240 x 240, cut into 8
    overlapping 96 x 96 tiles on a 2 x 4 grid (x stride 48, rows at y = 24
    and y = 120). Returns 8 arrays of (1, 96, 96, C)."""
    tchw = np.moveaxis(frame_hwc[None], -1, 1)  # (1, C, H, W)
    tchw, _ = uniform_crop(tchw, 240, spatial_idx=1)
    frame = np.moveaxis(tchw[0], 0, -1)  # (240, 240, C)
    return [frame[y:y + 96, x:x + 96, :][None]
            for y in (24, 120) for x in range(0, 4 * 48, 48)]


def get_start_end_idx(video_size, clip_size, clip_idx, num_clips, rng):
    """A clip's start and end frame (ref: datasets_custom/decoder.py:34-63):
    ``clip_idx`` -1 draws the start uniformly from ``rng``."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = rng.uniform(0, delta)
    else:
        start_idx = delta * clip_idx / num_clips
    return start_idx, start_idx + clip_size - 1


def temporal_sampling(frames: np.ndarray, start_idx, end_idx, num_samples) -> np.ndarray:
    """Equal-interval index sampling (ref: datasets_custom/decoder.py:14-31).
    frames (T, ...)."""
    # float32 linspace: torch.linspace defaults to float32, and the
    # truncation to integer indices is sensitive to that rounding
    index = np.linspace(start_idx, end_idx, num_samples, dtype=np.float32)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]
