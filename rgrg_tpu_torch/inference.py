"""Product inference API: X-rays in, radiology reports out.

As in the JAX package, `generate_reports` and the interactive APIs
preprocess on the host (data/preprocess.py, a copy of the JAX package's
C++ pipeline: resize, uint8-domain rounding, pad, normalise) and upload the
normalised batch; the batch runs through the detector and one batched
decode of all selected regions (beam 4 with early stopping by default;
num_beams=1 is greedy), and the host assembles one report per image with
exact sentence dedup and, by default (`similarity_fn="auto"`), the
BERTScore soft dedup of eval/bertscore.py when $RGRG_DISTILBERT_DIR names a
local distilbert-base-uncased directory.
`preprocess_raw` is the device-resize route the pipelined server
(serving.py) takes for a batch of one uint8 shape: raw uint8 goes up and
ops/resize.py resizes on the device. The interactive APIs decode named
regions (generate_for_regions) or user-drawn boxes (generate_for_boxes) of
one image.

Usage:
    gen = ReportGenerator.from_torch_checkpoint("ckpt.pt", tokenizer_dir)
    gen = ReportGenerator.from_checkpoint("runs/r1/last", tokenizer_dir)
    reports = gen.generate_reports(["a.png", xray_u8_b])
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.config import ModelConfig
from rgrg_tpu_torch.core.device import DeviceLike, resolve_device
from rgrg_tpu_torch.data.preprocess import preprocess_batch
from rgrg_tpu_torch.data.transforms import load_image
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


class ReportGenerator:
    def __init__(self, params: Params, tokenizer: GPT2Tokenizer,
                 cfg: ModelConfig = ModelConfig(),
                 similarity_fn: Union[SimilarityFn, str, None] = "auto",
                 bertscore_threshold: float = 0.9):
        self.model = RGRG(cfg=cfg)
        self.params = params
        self.tokenizer = tokenizer
        self.device = next(params["detector"].parameters()).device
        if similarity_fn == "auto":
            # the reference's default, distilbert BERTScore soft dedup
            # (generate_reports_for_images.py:60-96), on this generator's
            # device; exact dedup only when $RGRG_DISTILBERT_DIR is unset
            from rgrg_tpu_torch.eval.bertscore import default_scorer
            similarity_fn = default_scorer(device=self.device)
        self.similarity_fn = similarity_fn
        self.threshold = bertscore_threshold
        self._resize_cache: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_torch_checkpoint(cls, checkpoint_path: str, tokenizer_dir: str,
                              cfg: ModelConfig = ModelConfig(),
                              device: DeviceLike = None, **kw) -> "ReportGenerator":
        """A reference `.pt` (core/checkpoint.py) and a GPT-2 tokenizer
        directory -> a generator with its parameters on `device` (default
        cuda)."""
        from rgrg_tpu_torch.core.checkpoint import (convert_full_checkpoint,
                                                    load_torch_checkpoint)
        from rgrg_tpu_torch.core.convert import from_jax_params
        device = resolve_device(device)
        tree = convert_full_checkpoint(load_torch_checkpoint(checkpoint_path),
                                       num_layers=cfg.decoder.num_layers,
                                       stage_sizes=cfg.detector.backbone_stages)
        return cls(from_jax_params(tree, cfg, device),
                   GPT2Tokenizer.from_dir(tokenizer_dir), cfg=cfg, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer_dir: str,
                        cfg: ModelConfig = ModelConfig(), device: DeviceLike = None,
                        **kw) -> "ReportGenerator":
        """A checkpoint directory of core/checkpoint.save_checkpoint (a
        training run's `<run_dir>/last` or `best`, whose TrainState's params
        are taken, or a bare params tree) built for `cfg`, and a GPT-2
        tokenizer directory -> a generator on `device` (default cuda)."""
        from rgrg_tpu_torch.core.checkpoint import load_params
        return cls(load_params(path, cfg, device), GPT2Tokenizer.from_dir(tokenizer_dir),
                   cfg=cfg, **kw)

    def preprocess(self, images: Sequence[ImageLike],
                   transfer_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Paths or grayscale arrays (any shapes) -> the normalised batch
        [B, 512, 512, 1] on the generator's device, preprocessed on the
        host. transfer_dtype (e.g. torch.bfloat16): cast on the host before
        the upload, which halves its bytes when the detector computes in
        bf16 anyway."""
        arrays = [load_image(im) if isinstance(im, str) else im for im in images]
        batch = torch.from_numpy(preprocess_batch(arrays))
        if transfer_dtype is not None:
            batch = batch.to(transfer_dtype)
        return batch.to(self.device)

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
        """Device-resize route: paths or arrays -> ((raw [B, H, W] uint8 on
        the device, (wy, wx)), None) when every image is 2-D uint8 of one
        shape; (None, the loaded arrays) otherwise, so that the caller can
        preprocess them on the host without reading the files again."""
        arrays = [load_image(im) if isinstance(im, str) else np.asarray(im)
                  for im in images]
        shape = arrays[0].shape
        if any(a.ndim != 2 or a.dtype != np.uint8 or a.shape != shape for a in arrays):
            return None, arrays
        raw = torch.from_numpy(np.stack(arrays)).to(self.device)
        return (raw, self._resize_mats(shape)), None

    def _decode_args(self, num_beams: Optional[int], max_length: Optional[int]):
        gen = self.model.cfg.generation
        return (gen.num_beams if num_beams is None else num_beams,
                gen.max_length if max_length is None else max_length)

    def generate_reports(self, images: Sequence[ImageLike],
                         num_beams: Optional[int] = None,
                         max_length: Optional[int] = None,
                         early_stopping: bool = True) -> List[GeneratedReport]:
        """Reports for a batch of grayscale X-rays (arrays of any shapes, or
        paths). num_beams/max_length default to the config's generation
        settings (beam 4, 300 tokens)."""
        num_beams, max_length = self._decode_args(num_beams, max_length)
        out = self.model.generate(self.params, self.preprocess(images),
                                  max_length=max_length, num_beams=num_beams,
                                  early_stopping=early_stopping)
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

    # -------------------- interactive APIs --------------------

    def generate_for_regions(self, image: ImageLike, region_names: Sequence[str],
                             num_beams: Optional[int] = None,
                             max_length: Optional[int] = None,
                             early_stopping: bool = True) -> Dict[str, str]:
        """Anatomy-based generation: sentences for the named regions of one
        image, those the detector found."""
        num_beams, max_length = self._decode_args(num_beams, max_length)
        det = self.model.detect(self.params, self.preprocess([image]))
        mask = torch.zeros((1, C.NUM_REGIONS), dtype=torch.bool, device=self.device)
        for name in region_names:
            mask[0, C.ANATOMICAL_REGIONS[name]] = True
        mask &= det["class_detected"]
        ids, decoded = self.model.decode_selected(
            self.params, det["region_features"], mask,
            self.model.budget_for(int(mask.sum()), 1), max_length,
            num_beams=num_beams, early_stopping=early_stopping)
        ids, decoded = ids.cpu().numpy(), decoded.cpu().numpy()
        return {name: self.tokenizer.decode(ids[0, C.ANATOMICAL_REGIONS[name]],
                                            skip_special_tokens=True)
                for name in region_names if decoded[0, C.ANATOMICAL_REGIONS[name]]}

    @torch.inference_mode()
    def generate_for_boxes(self, image: ImageLike, boxes: np.ndarray,
                           num_beams: Optional[int] = None,
                           max_length: Optional[int] = None,
                           early_stopping: bool = True) -> List[str]:
        """Selection-based generation: one sentence per user-drawn box
        ([N, 4] xyxy in the 512-pixel model frame), RoI-pooled straight from
        the backbone's map, bypassing the RPN."""
        num_beams, max_length = self._decode_args(num_beams, max_length)
        det = self.params["detector"]
        feats = det.backbone(self.preprocess([image]))
        bx = torch.as_tensor(np.asarray(boxes, np.float32)[None], device=self.device)
        region = det.region_features_from_boxes(feats, bx)[0]          # [N, 1024]
        ids, _ = self.model.decode_rows(self.params, region, max_length,
                                        num_beams, early_stopping)
        return [self.tokenizer.decode(row) for row in ids.cpu().numpy()]


def write_generated_reports_to_txt(image_paths: Sequence[str],
                                   reports: Sequence[GeneratedReport],
                                   path: str) -> None:
    """The reference's report file: per image its path and report, then a
    rule of 30 '=' (the JAX package writes the same)."""
    with open(path, "w") as f:
        for image_path, rep in zip(image_paths, reports):
            f.write(f"Image path: {image_path}\n")
            f.write(f"Generated report: {rep.report}\n\n")
            f.write("=" * 30)
            f.write("\n\n")
