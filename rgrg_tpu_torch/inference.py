"""Product inference API: uint8 X-rays in, radiology reports out (greedy).

Images of one shape per batch are uploaded as raw uint8 and resized,
padded and normalized on the device (ops/resize.py), the batch runs
through the detector and one batched decode of all selected regions, and
the host assembles one report per image with exact sentence dedup (soft
dedup takes a caller-supplied `similarity_fn`).

Usage:
    params = RGRG(cfg).init(seed=0)              # or core.convert.from_jax_params
    gen = ReportGenerator(params, GPT2Tokenizer.from_dir(vocab_dir), cfg=cfg)
    reports = gen.generate_reports([xray_u8_a, xray_u8_b])
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.config import ModelConfig
from rgrg_tpu_torch.models.full_model import RGRG, Params
from rgrg_tpu_torch.ops.resize import resize_matrices
from rgrg_tpu_torch.text.report import SimilarityFn, assemble_report
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

ImageLike = Union[str, np.ndarray]


@dataclasses.dataclass
class GeneratedReport:
    report: str
    region_sentences: Dict[str, str]          # region name -> sentence
    selected_regions: np.ndarray              # [29] bool
    class_detected: np.ndarray                # [29] bool
    top_region_boxes: np.ndarray              # [29, 4]


def load_image(path: str) -> np.ndarray:
    """Single-channel read of an image file (cv2, imported only here)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return img


class ReportGenerator:
    def __init__(self, params: Params, tokenizer: GPT2Tokenizer,
                 cfg: ModelConfig = ModelConfig(),
                 similarity_fn: Optional[SimilarityFn] = None,
                 bertscore_threshold: float = 0.9):
        self.model = RGRG(cfg=cfg)
        self.params = params
        self.tokenizer = tokenizer
        self.similarity_fn = similarity_fn
        self.threshold = bertscore_threshold
        self.device = next(params["detector"].parameters()).device
        self._resize_cache: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _resize_mats(self, shape: Tuple[int, int]):
        """Per-input-shape (wy, wx) resize matrices, built once on the host
        and kept on the device."""
        if shape not in self._resize_cache:
            wy, wx = resize_matrices(shape[0], shape[1],
                                     self.model.cfg.detector.image_size)
            self._resize_cache[shape] = (torch.from_numpy(wy.copy()).to(self.device),
                                         torch.from_numpy(wx.copy()).to(self.device))
        return self._resize_cache[shape]

    def preprocess_raw(self, images: Sequence[ImageLike]):
        """Paths or 2-D uint8 arrays of ONE shape -> (raw [B, H, W] uint8 on
        the device, (wy, wx)). Raises on mixed shapes or dtypes."""
        arrays = [load_image(im) if isinstance(im, str) else np.asarray(im)
                  for im in images]
        shape = arrays[0].shape
        for a in arrays:
            if a.ndim != 2 or a.dtype != np.uint8 or a.shape != shape:
                raise ValueError(
                    "generate_reports takes 2-D uint8 images of one shape per "
                    f"batch; got {a.dtype} {a.shape} beside uint8 {shape}")
        raw = torch.from_numpy(np.stack(arrays)).to(self.device)
        return raw, self._resize_mats(shape)

    def generate_reports(self, images: Sequence[ImageLike],
                         num_beams: int = 1,
                         max_length: Optional[int] = None) -> List[GeneratedReport]:
        """Greedy reports for a batch of same-shape uint8 X-rays (or paths)."""
        cfg = self.model.cfg
        if max_length is None:
            max_length = cfg.generation.max_length
        raw, mats = self.preprocess_raw(images)
        out = self.model.generate(self.params, raw, max_length=max_length,
                                  num_beams=num_beams, resize_mats=mats)
        ids = out["output_ids"].cpu().numpy()

        results = []
        for b in range(len(images)):
            decoded = out["decoded_mask"][b]
            region_sents: Dict[str, str] = {}
            ordered: List[str] = []
            for r in range(C.NUM_REGIONS):
                if decoded[r]:
                    text = self.tokenizer.decode(ids[b, r], skip_special_tokens=True)
                    region_sents[C.REGION_NAMES[r]] = text
                    ordered.append(text)
            results.append(GeneratedReport(
                report=assemble_report(ordered, self.similarity_fn, self.threshold),
                region_sentences=region_sents,
                selected_regions=out["selected_regions"][b],
                class_detected=out["class_detected"][b],
                top_region_boxes=out["detections"]["top_region_boxes"][b]))
        return results
