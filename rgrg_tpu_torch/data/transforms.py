"""Host-side image transforms (the port's own copy), matching the
reference's albumentations pipelines (train_full_model.py:340-383,
generate_reports_for_images.py:134-141):

  val/test: LongestMaxSize(512, INTER_AREA) -> PadIfNeeded(512, 512,
            center, zeros) -> Normalize(mean .471, std .302, max_pixel 255)
  train:    + ColorJitter(hue=0) + GaussNoise + Affine(+-2% translate,
            +-2 degrees) before padding.

Bbox coordinates (pascal_voc) follow the same resize, warp and shift.
Output is NHWC float32 [H, W, 1]. Nothing here needs cv2 but `load_image`,
which imports it inside: the resize is data/preprocess.py's numpy copy of
the JAX package's C++ INTER_AREA, rounded back to the image's integer
dtype as cv2 does; `lut_uint8` is cv2.LUT and `warp_affine_linear` a
numpy copy of cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) for the two
dtypes the train pipeline gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class AugParams:
    """One draw of the train augmentations' parameters (albumentations
    1.1.0's order: each transform draws its p-gate, then its parameters only
    if it fired; Compose order ColorJitter, GaussNoise, Affine)."""
    jitter: bool
    order: Tuple[int, ...] = ()       # permutation of (b, c, s, h) ops
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0           # no-op on grayscale, drawn anyway
    hue: float = 0.0                  # hue=0 in the reference: no-op
    noise: bool = False
    sigma: float = 0.0
    affine: bool = False
    angle: float = 0.0                # degrees
    tx: float = 0.0                   # pixels (translate_percent * width)
    ty: float = 0.0


def sample_aug_params(rng: np.random.Generator, height: int, width: int) -> AugParams:
    """Draw one sample's augmentation parameters with the reference's
    distributions (train_full_model.py:348-361): ColorJitter(hue=0) p=.5,
    factors in [0.8, 1.2] and a shuffled op order; GaussNoise var [10, 50]
    p=.5; Affine rotate +-2 degrees and translate_percent +-2%, drawn
    independently per axis, p=.5. (height, width) are the resized image's:
    albumentations draws Affine against the image it receives. The draws,
    and their order on `rng`, are the JAX package's."""
    kw = {}
    jitter = rng.uniform() < 0.5
    if jitter:
        kw.update(brightness=rng.uniform(0.8, 1.2), contrast=rng.uniform(0.8, 1.2),
                  saturation=rng.uniform(0.8, 1.2), hue=0.0,
                  order=tuple(int(i) for i in rng.permutation(4)))
    noise = rng.uniform() < 0.5
    if noise:
        kw["sigma"] = float(np.sqrt(rng.uniform(10.0, 50.0)))
    affine = rng.uniform() < 0.5
    if affine:
        kw.update(tx=rng.uniform(-0.02, 0.02) * width, ty=rng.uniform(-0.02, 0.02) * height,
                  angle=rng.uniform(-2.0, 2.0))
    return AugParams(jitter=jitter, noise=noise, affine=affine, **kw)


def lut_uint8(image: np.ndarray, table: np.ndarray) -> np.ndarray:
    """cv2.LUT for a uint8 image and a 256-entry uint8 table: table[image]."""
    return table[image]


def _lut_clipped(image: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """albumentations' clip(): np.clip, then astype (truncation, not
    rounding), the uint8 step every LUT op inherits."""
    return lut_uint8(image, np.clip(lut, 0, 255).astype(np.uint8))


def adjust_brightness_uint8(image: np.ndarray, factor: float) -> np.ndarray:
    """albumentations 1.1.0 adjust_brightness_torchvision for uint8:
    LUT = clip(arange(256) * factor), the table float32 as the library's
    _multiply_uint8_optimized allocates it (its contrast helper uses a
    float64 arange: the library is asymmetric, and so is this copy)."""
    if factor == 0:
        return np.zeros_like(image)
    if factor == 1:
        return image
    return _lut_clipped(image, np.arange(0, 256, dtype=np.float32) * factor)


def adjust_contrast_uint8(image: np.ndarray, factor: float) -> np.ndarray:
    """albumentations 1.1.0 adjust_contrast_torchvision for uint8
    grayscale: pivot on the current image's float mean,
    LUT = clip(arange(256) * factor + mean * (1 - factor)), float64."""
    if factor == 1:
        return image
    mean = image.mean()
    if factor == 0:
        return np.full_like(image, int(mean + 0.5))
    return _lut_clipped(image, np.arange(0, 256, dtype=np.float64) * factor
                        + mean * (1 - factor))


def color_jitter_gray_uint8(image: np.ndarray, p: AugParams) -> np.ndarray:
    """ColorJitter on grayscale uint8: the four sub-ops in the drawn order;
    saturation is the identity on grayscale and hue is 0, so only
    brightness and contrast act, but their order matters (contrast pivots
    on the current mean)."""
    for i in p.order:
        if i == 0:
            image = adjust_brightness_uint8(image, p.brightness)
        elif i == 1:
            image = adjust_contrast_uint8(image, p.contrast)
    return image


def affine_matrix(angle_deg: float, tx: float, ty: float, height: int,
                  width: int) -> np.ndarray:
    """albumentations 1.1.0's Affine matrix: skimage's to_topleft ->
    AffineTransform(rotation, translation) -> to_center about the
    half-pixel center (w/2 - 0.5, h/2 - 0.5), with skimage's rotation sign
    [[c, -s], [s, c]]. Returns the 3x3 homogeneous matrix."""
    r = np.deg2rad(angle_deg)
    c, s = np.cos(r), np.sin(r)
    rot = np.array([[c, -s, tx], [s, c, ty], [0, 0, 1]])

    def shift(sx, sy):
        return np.array([[1, 0, sx], [0, 1, sy], [0, 0, 1]], np.float64)

    sx, sy = width / 2 - 0.5, height / 2 - 0.5
    return shift(sx, sy) @ rot @ shift(-sx, -sy)


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """cv2.warpAffine's inverse of a forward 2x3 matrix, in float64 and in
    its operation order: [A11, A12, b1, A21, A22, b2]."""
    m = np.asarray(m, np.float64).reshape(-1)[:6]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5],
                     a21, a22, -a21 * m[2] - a22 * m[5]])


def _taps(image: np.ndarray, iy: np.ndarray, ix: np.ndarray):
    """The 2x2 source pixels at (iy, ix) .. (iy+1, ix+1), zero outside the
    image (BORDER_CONSTANT 0)."""
    h, w = image.shape
    out = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        y, x = iy + dy, ix + dx
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        out.append(np.where(inside, image[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)], 0))
    return out


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: a * b exactly, plus c, rounded once (the
    product of two float32 is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_uint8(image: np.ndarray, inv: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2 5.0's uint8 INTER_LINEAR warp (its float32 SIMD kernel): source
    coordinates x * M0 + (y * M1 + M2) with one fused multiply-add per
    pixel (the scalar tail past the last 16-wide vector fuses x * M0 + y * M1
    and then adds M2), weights from the fractional parts, interpolation as
    three fused multiply-adds, round half to even."""
    m = inv.astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    sx = _fma_f32(xs, m[0], ys * m[1] + m[2])
    sy = _fma_f32(xs, m[3], ys * m[4] + m[5])
    tail = w - w % 16
    if tail < w:
        sx[:, tail:] = _fma_f32(xs[:, tail:], m[0], ys * m[1]) + m[2]
        sy[:, tail:] = _fma_f32(xs[:, tail:], m[3], ys * m[4]) + m[5]
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = sx - ix, sy - iy
    p00, p01, p10, p11 = (t.astype(np.float32) for t in
                          _taps(image, iy.astype(np.int64), ix.astype(np.int64)))
    top = _fma_f32(ax, p01 - p00, p00)
    bottom = _fma_f32(ax, p11 - p10, p10)
    out = _fma_f32(ay, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _warp_fixed_point(image: np.ndarray, inv: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2's fixed-point warp, which float64 images take: source
    coordinates in units of 1/1024 (rounded half to even, plus a rounding
    delta of 16), cut to 1/32 of a pixel, and the 2x2 taps weighted from a
    32 x 32 float32 table of products of (1 - f, f), f = k/32, summed in
    float64."""
    ab = 1024
    xs, ys = np.arange(w), np.arange(h)
    adelta = np.rint(inv[0] * xs * ab).astype(np.int64)
    bdelta = np.rint(inv[3] * xs * ab).astype(np.int64)
    x0 = np.rint((inv[1] * ys + inv[2]) * ab).astype(np.int64) + 16
    y0 = np.rint((inv[4] * ys + inv[5]) * ab).astype(np.int64) + 16
    x = (x0[:, None] + adelta[None, :]) >> 5
    y = (y0[:, None] + bdelta[None, :]) >> 5
    fx = (x & 31).astype(np.float32) * np.float32(1 / 32)
    fy = (y & 31).astype(np.float32) * np.float32(1 / 32)
    one = np.float32(1)
    weights = ((one - fy) * (one - fx), (one - fy) * fx, fy * (one - fx), fy * fx)
    taps = _taps(image, y >> 5, x >> 5)
    out = taps[0] * weights[0].astype(np.float64)
    for t, wt in zip(taps[1:], weights[1:]):
        out = out + t * wt.astype(np.float64)
    return out


def warp_affine_linear(image: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine(image, m, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=0) for a 2-D image: m is the
    forward 2x3 matrix, dsize (width, height). Two dtypes reach it from
    train_transform: uint8 (no noise drawn) through cv2 5.0's float32
    kernel, and float64 (after GaussNoise) through its fixed-point one
    (see _warp_uint8 and _warp_fixed_point); others raise."""
    w, h = dsize
    inv = _inverse_affine(m)
    if image.dtype == np.uint8:
        return _warp_uint8(image, inv, w, h)
    if image.dtype == np.float64:
        return _warp_fixed_point(image, inv, w, h)
    raise TypeError(f"warp_affine_linear takes uint8 or float64 images, got {image.dtype}")


def transform_boxes_affine(boxes: np.ndarray, m: np.ndarray) -> np.ndarray:
    """albumentations bbox_affine: transform the 4 corners and take each
    box's min / max (no clipping here: filter_boxes clips)."""
    corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]],
                        boxes[:, [2, 3]]], axis=1)                      # [N, 4, 2]
    ones = np.ones((*corners.shape[:2], 1))
    tc = np.concatenate([corners, ones], axis=-1) @ m[:2].T            # [N, 4, 2]
    return np.concatenate([tc.min(axis=1), tc.max(axis=1)], axis=-1).astype(np.float32)


def filter_boxes(boxes: np.ndarray, width: int, height: Optional[int] = None):
    """albumentations' bbox clip-and-filter with the reference's default
    BboxParams (min_area=0, min_visibility=0): clip each box to the frame
    and drop boxes whose clipped area is zero. Returns (all boxes clipped,
    keep mask)."""
    if height is None:
        height = width
    if not len(boxes):
        return boxes, np.zeros((0,), bool)
    clipped = np.clip(boxes, 0, [width, height, width, height]).astype(np.float32)
    keep = ((clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])) > 0
    return clipped, keep


def train_transform(image: np.ndarray, boxes: Optional[np.ndarray],
                    rng: np.random.Generator, cfg: TransformConfig = TransformConfig()):
    """The reference's albumentations-1.1.0 train pipeline
    (train_full_model.py:348-367):

      LongestMaxSize(512, INTER_AREA) -> ColorJitter(hue=0) p=.5 ->
      GaussNoise(var 10-50) p=.5 -> Affine(+-2% translate, +-2 degrees,
      zero fill) p=.5 -> PadIfNeeded(512, center, zeros) -> Normalize

    with uint8 LUT truncation in the jitter, float64 noise added without
    clipping (so the warp interpolates unclipped values), the corner
    min / max box transform, and boxes clipped and filtered against the
    pre-pad frame after the warp (BboxParams' check_each_transform) and
    again after the pad. Draws come from `rng` in the JAX package's order
    (sample_aug_params, then the noise).

    Returns (image [S, S, 1] float32, boxes [K, 4] of the survivors, keep
    [N] bool marking the input boxes that survived)."""
    if boxes is None:
        boxes = np.zeros((0, 4), np.float32)
    image, boxes = longest_max_size(image, cfg.image_size, boxes)
    h, w = image.shape[:2]
    p = sample_aug_params(rng, h, w)

    if p.jitter:
        image = color_jitter_gray_uint8(image, p)
    if p.noise:
        image = image.astype(np.float32) + rng.normal(0.0, p.sigma, image.shape)
    if p.affine:
        m = affine_matrix(p.angle, p.tx, p.ty, h, w)
        image = warp_affine_linear(image, m[:2], (w, h))
        if len(boxes):
            boxes = transform_boxes_affine(boxes, m)

    boxes, keep = filter_boxes(boxes, w, h)
    image, boxes = pad_to_square(image, cfg.image_size, boxes)
    boxes, keep2 = filter_boxes(boxes, cfg.image_size)
    keep &= keep2
    image = normalize(image, cfg)
    return image[..., None], boxes[keep], keep


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
