"""Full RGRG pipeline: detector -> region selection -> per-region decoding.

The selected (image, region) pairs are stably compacted to the front (the
order of the boolean-mask flattening), padded to a static row budget from
the {2^k, 3*2^k} ladder, decoded as one batch and scattered back to
[B, 29, L]. Padding rows are born finished, so an empty selection costs
almost nothing. The decode runs through a ladder of KV-cache length
buckets (64/128/304): everything at a short cache first, then only the rows
that hit the cap at the next bucket. Greedy decoding is prefix-
deterministic, so a row that finishes inside a bucket is identical to the
full-length decode.

Params are {"detector": RegionDetector (nn.Module), "decoder": dict of
tensors} (RGRG.init, or core/convert.py from the JAX package's tree).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.config import ModelConfig
from rgrg_tpu_torch.core.device import DeviceLike, resolve_device
from rgrg_tpu_torch.decode.greedy import greedy_generate
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.detector import RegionDetector
from rgrg_tpu_torch.models.layers import init_module_
from rgrg_tpu_torch.ops.resize import device_preprocess

Params = Dict[str, Any]


def ladder_budget(n: int) -> int:
    """Smallest {2^k, 3*2^k}-ladder value >= n (8, 12, 16, 24, 32, 48, ...)."""
    budget = 8
    while budget < n:
        budget = (budget * 3 // 2 if (budget & (budget - 1)) == 0
                  else budget * 4 // 3)
    return budget


def stable_compaction(mask: torch.Tensor) -> torch.Tensor:
    """Indices that move True entries of a 1-D mask to the front, each side
    in its original order."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices


@dataclasses.dataclass(frozen=True)
class RGRG:
    cfg: ModelConfig = ModelConfig()

    def init(self, seed: int = 0, device: DeviceLike = None,
             decoder_dtype: torch.dtype = torch.float32) -> Params:
        """Random params from one seed: the detector (lecun-normal convs and
        dense layers, identity BatchNorm, f32) and the decoder (GPT-2
        conventions, in `decoder_dtype`), each from its own
        torch.Generator on `device`."""
        dev = resolve_device(device)
        g_det = torch.Generator(device=dev).manual_seed(seed)
        g_dec = torch.Generator(device=dev).manual_seed(seed + 1)
        detector = RegionDetector(self.cfg.detector, device=dev)
        init_module_(detector, g_det)
        detector.eval()
        decoder = gpt2.init_decoder_params(g_dec, self.cfg.decoder,
                                           decoder_dtype, dev)
        return {"detector": detector, "decoder": decoder}

    # ---------------- stages ----------------

    def _prepare_images(self, images: torch.Tensor, resize_mats) -> torch.Tensor:
        """Raw uint8 [B, H, W] + (wy, wx) -> normalized NHWC in the
        detector's compute dtype; preprocessed NHWC images pass through."""
        if resize_mats is None:
            return images
        wy, wx = resize_mats
        out_dtype = (torch.bfloat16 if self.cfg.detector.dtype == "bfloat16"
                     else torch.float32)
        return device_preprocess(images, wy, wx, out_dtype=out_dtype)

    @torch.inference_mode()
    def detect(self, params: Params, images: torch.Tensor, resize_mats=None,
               image_chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """images: [B, H, W, 1] normalized NHWC, or raw [B, H, W] uint8 when
        `resize_mats` (wy, wx) is given (resize, pad and normalize then run
        on the device). image_chunk runs the detector over sub-batches of
        that size when it divides B (per-image math: identical results)."""
        det = params["detector"]
        if det.cfg != self.cfg.detector:
            raise ValueError("params['detector'] was built for another "
                             "DetectorConfig than this model's")
        images = self._prepare_images(images, resize_mats)
        thr = self.cfg.classifier.logit_threshold
        b = images.shape[0]
        if image_chunk and image_chunk < b and b % image_chunk == 0:
            outs = [det(images[i:i + image_chunk], logit_threshold=thr)
                    for i in range(0, b, image_chunk)]
            return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return det(images, logit_threshold=thr)

    @torch.inference_mode()
    def decode_selected(self, params: Params, region_features: torch.Tensor,
                        selected_regions: torch.Tensor, r_budget: int,
                        max_length: int, kv_cache_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compact the selected regions to r_budget rows, greedy-decode them,
        scatter back. region_features [B, 29, 1024]; selected_regions
        [B, 29] bool. Returns (output_ids [B, 29, max_length],
        decoded_mask [B, 29]): decoded_mask marks the regions whose row fit
        in the budget."""
        b = region_features.shape[0]
        pad = self.cfg.decoder.pad_token_id
        flat_feats = region_features.reshape(b * C.NUM_REGIONS, -1)
        sel = selected_regions.reshape(-1)
        idx = stable_compaction(sel)[:r_budget]
        active = sel[idx]
        ids = greedy_generate(params["decoder"], flat_feats[idx],
                              self.cfg.decoder, max_length=max_length,
                              active=active, cache_dtype=kv_cache_dtype)
        out = torch.full((b * C.NUM_REGIONS, max_length), pad,
                         dtype=torch.long, device=ids.device)
        out[idx] = torch.where(active[:, None], ids, pad)
        decoded = torch.zeros(b * C.NUM_REGIONS, dtype=torch.bool, device=ids.device)
        decoded[idx] = active
        return (out.reshape(b, C.NUM_REGIONS, max_length),
                decoded.reshape(b, C.NUM_REGIONS))

    def detect_and_decode(self, params: Params, images: torch.Tensor,
                          selected_regions: Optional[torch.Tensor],
                          r_budget: int, max_length: int,
                          kv_cache_dtype: Optional[torch.dtype] = None,
                          resize_mats=None, image_chunk: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """Detector + one budgeted decode. selected_regions=None decodes the
        detector's own selection; rows beyond r_budget stay undecoded, as
        in decode_selected (the caller checks the count)."""
        det = self.detect(params, images, resize_mats, image_chunk=image_chunk)
        sel = det["selected_regions"] if selected_regions is None else selected_regions
        ids, decoded = self.decode_selected(params, det["region_features"], sel,
                                            r_budget, max_length,
                                            kv_cache_dtype=kv_cache_dtype)
        return {
            "output_ids": ids,
            "decoded_mask": decoded,
            "selected_regions": sel,
            "class_detected": det["class_detected"],
            "top_region_boxes": det["top_region_boxes"],
            "selection_logits": det["selection_logits"],
        }

    @torch.inference_mode()
    def decode_selected_cascade(self, params: Params,
                                region_features: torch.Tensor,
                                selected_regions: torch.Tensor,
                                max_length: int,
                                kv_cache_dtype: Optional[torch.dtype] = None,
                                buckets: Optional[Tuple[int, ...]] = None,
                                first_count: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode through the static length-bucket ladder; one host
        read of the remaining-row count per bucket used (`first_count`
        supplies the first when the caller has it).
        Returns (output_ids [B, 29, max_length], decoded_mask [B, 29])."""
        b = region_features.shape[0]
        pad = self.cfg.decoder.pad_token_id
        if buckets is None:
            buckets = self.cfg.generation.length_buckets
        if not buckets or buckets[-1] < max_length:
            # the ladder must reach max_length, or rows still unfinished at
            # the last bucket would come back truncated
            buckets = tuple(buckets) + (max_length,)

        output_ids, decoded_mask = None, None
        remaining = selected_regions
        for j, bucket in enumerate(buckets):
            bucket = min(bucket, max_length)
            n_rem = (first_count if j == 0 and first_count is not None
                     else int(remaining.sum()))
            if output_ids is not None and n_rem == 0:
                break
            ids_b, dec_b = self.decode_selected(
                params, region_features, remaining, self.budget_for(n_rem, b),
                bucket, kv_cache_dtype=kv_cache_dtype)
            ids_b = torch.nn.functional.pad(ids_b, (0, max_length - bucket),
                                            value=pad)
            if output_ids is None:
                output_ids, decoded_mask = ids_b, dec_b
            else:
                output_ids = torch.where(remaining[..., None], ids_b, output_ids)
                decoded_mask = decoded_mask | dec_b
            if bucket >= max_length:
                break
            # rows that filled the bucket without finishing (pad == eos, so
            # an unfinished row's last slot holds a real token)
            remaining = remaining & dec_b & (ids_b[:, :, bucket - 1] != pad)
        return output_ids, decoded_mask

    def budget_for(self, num_selected: int, batch: int) -> int:
        """Static decode row budget >= num_selected from the ladder, capped
        at B*29."""
        cap = batch * C.NUM_REGIONS
        return cap if num_selected >= cap else min(ladder_budget(num_selected), cap)

    def generate(self, params: Params, images: torch.Tensor,
                 max_length: Optional[int] = None, num_beams: int = 1,
                 resize_mats=None) -> Dict[str, Any]:
        """Full greedy inference for a batch: images as for `detect`.
        Returns output ids [B, 29, L] (a tensor on the device) plus the
        selection, decoded mask and detections as numpy arrays."""
        if num_beams != 1:
            raise NotImplementedError(
                "beam search (num_beams > 1) arrives with the port's beam-4 "
                "slice; this slice decodes greedily (num_beams=1)")
        if max_length is None:
            max_length = self.cfg.generation.max_length
        det = self.detect(params, images, resize_mats)
        sel = det["selected_regions"]
        num_selected = int(sel.sum())  # the one host read before decoding
        output_ids, decoded_mask = self.decode_selected_cascade(
            params, det["region_features"], sel, max_length,
            first_count=num_selected)
        return {
            "output_ids": output_ids,
            "selected_regions": sel.cpu().numpy(),
            "decoded_mask": decoded_mask.cpu().numpy(),
            "detections": {
                "top_region_boxes": det["top_region_boxes"].cpu().numpy(),
                "top_scores": det["top_scores"].cpu().numpy(),
            },
            "class_detected": det["class_detected"].cpu().numpy(),
        }
