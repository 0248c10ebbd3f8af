"""Host-side image transforms of the evaluation path (the port's own copy),
matching the reference's albumentations val/test pipeline
(generate_reports_for_images.py:134-141):

  LongestMaxSize(512, INTER_AREA) -> PadIfNeeded(512, 512, center, zeros)
  -> Normalize(mean .471, std .302, max_pixel 255)

Bbox coordinates (pascal_voc) follow the same resize and shift. Output is
NHWC float32 [H, W, 1]. The resize is data/preprocess.py's numpy copy of
the JAX package's C++ INTER_AREA (no cv2), rounded back to the image's
integer dtype as cv2 does; only `load_image` reads files with cv2,
imported inside it. The training augmentations are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.data.preprocess import resize_area, resize_area_upscale


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    image_size: int = C.IMAGE_SIZE
    mean: float = C.IMAGE_MEAN
    std: float = C.IMAGE_STD
    max_pixel_value: float = 255.0


def longest_max_size(image: np.ndarray, max_size: int,
                     boxes: Optional[np.ndarray] = None):
    """Resize so the longest side == max_size (INTER_AREA), scaling boxes
    by the same factor (albumentations LongestMaxSize)."""
    h, w = image.shape[:2]
    scale = max_size / max(h, w)
    if scale != 1.0:
        new_w, new_h = round(w * scale), round(h * scale)  # half to even, as JAX
        if (new_h, new_w) != (h, w):
            resize = resize_area if scale < 1.0 else resize_area_upscale
            out = resize(image, new_h, new_w)
            image = (np.rint(out).astype(image.dtype)
                     if np.issubdtype(image.dtype, np.integer) else out)
        if boxes is not None and len(boxes):
            boxes = boxes * scale
    return image, boxes


def pad_to_square(image: np.ndarray, size: int,
                  boxes: Optional[np.ndarray] = None):
    """Center-pad with zeros to size x size (albumentations PadIfNeeded
    default position), shifting boxes."""
    h, w = image.shape[:2]
    top = max((size - h) // 2, 0)
    bottom = max(size - h - top, 0)
    left = max((size - w) // 2, 0)
    right = max(size - w - left, 0)
    image = np.pad(image, ((top, bottom), (left, right)))
    if boxes is not None and len(boxes):
        boxes = boxes + np.array([left, top, left, top], boxes.dtype)
    return image, boxes


def normalize(image: np.ndarray, cfg: TransformConfig) -> np.ndarray:
    """(img - mean*maxpix) / (std*maxpix), float32 (albumentations
    Normalize)."""
    denom = cfg.std * cfg.max_pixel_value
    return (image.astype(np.float32) - cfg.mean * cfg.max_pixel_value) / denom


def val_transform(image: np.ndarray, boxes: Optional[np.ndarray] = None,
                  cfg: TransformConfig = TransformConfig()):
    """Eval/inference pipeline. image: [H, W] grayscale uint8/uint16.
    Returns (image [S, S, 1] float32, boxes or None)."""
    image, boxes = longest_max_size(image, cfg.image_size, boxes)
    image, boxes = pad_to_square(image, cfg.image_size, boxes)
    image = normalize(image, cfg)
    return image[..., None], boxes


def load_image(path: str) -> np.ndarray:
    """Single-channel read of an image file, cv2.IMREAD_UNCHANGED (the
    reference's custom_image_dataset_object_detector.py:15); cv2 is
    imported only here."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return img
