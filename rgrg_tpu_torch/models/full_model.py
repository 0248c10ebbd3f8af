"""Full RGRG pipeline: detector -> region selection -> per-region decoding.

The selected (image, region) pairs are stably compacted to the front (the
order of the boolean-mask flattening), padded to a static row budget from
the {2^k, 3*2^k} ladder, decoded as one batch (greedy, or beam search with
num_beams > 1) and scattered back to [B, 29, L]. Padding rows are born
finished, so an empty selection costs almost nothing. The decode runs
through a ladder of KV-cache length buckets (64/128/304): everything at a
short cache first, then only the rows that need it at the next bucket
(decode_selected_cascade says why each mode's bucket results equal the
full-length decode).

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
from rgrg_tpu_torch.decode.beam import beam_generate
from rgrg_tpu_torch.decode.greedy import greedy_generate
from rgrg_tpu_torch.decode.sample import sample_generate
from rgrg_tpu_torch.models import decoder_module
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
        dense layers, identity BatchNorm, f32) and the decoder the config
        names (its module's init_decoder_params: N(0, 0.02) matrices, in
        `decoder_dtype`), each from its own torch.Generator on `device`."""
        dev = resolve_device(device)
        g_det = torch.Generator(device=dev).manual_seed(seed)
        g_dec = torch.Generator(device=dev).manual_seed(seed + 1)
        detector = RegionDetector(self.cfg.detector, device=dev)
        init_module_(detector, g_det)
        detector.eval()
        decoder = decoder_module(self.cfg.decoder).init_decoder_params(
            g_dec, self.cfg.decoder, decoder_dtype, dev)
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

    def decode_rows(self, params: Params, features: torch.Tensor, max_length: int,
                    num_beams: int = 1, early_stopping: bool = False,
                    active: Optional[torch.Tensor] = None,
                    kv_cache_dtype: Optional[torch.dtype] = None,
                    do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0,
                    sample_generator: Optional[torch.Generator] = None):
        """Decode region features [N, 1024] row by row: sampling when
        do_sample, else beam search when num_beams > 1, else greedy.
        Returns (ids [N, max_length], done): done is beam search's [N] mask
        of searches closed before max_length, None otherwise. Sampling draws
        from `sample_generator` (on the features' device), by default a
        generator seeded with 0."""
        if do_sample:
            if sample_generator is None:
                sample_generator = torch.Generator(device=features.device).manual_seed(0)
            return sample_generate(params["decoder"], features, sample_generator,
                                   self.cfg.decoder, max_length=max_length,
                                   temperature=temperature, top_k=top_k, top_p=top_p,
                                   active=active, cache_dtype=kv_cache_dtype), None
        if num_beams > 1:
            return beam_generate(
                params["decoder"], features, self.cfg.decoder,
                max_length=max_length, num_beams=num_beams,
                length_penalty=self.cfg.generation.length_penalty,
                early_stopping=early_stopping, active=active,
                cache_dtype=kv_cache_dtype, return_done=True)
        return greedy_generate(params["decoder"], features, self.cfg.decoder,
                               max_length=max_length, active=active,
                               cache_dtype=kv_cache_dtype), None

    @torch.inference_mode()
    def decode_selected(self, params: Params, region_features: torch.Tensor,
                        selected_regions: torch.Tensor, r_budget: int,
                        max_length: int, kv_cache_dtype: Optional[torch.dtype] = None,
                        num_beams: int = 1, early_stopping: bool = False,
                        return_done: bool = False, do_sample: bool = False,
                        temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                        sample_generator: Optional[torch.Generator] = None):
        """Compact the selected regions to r_budget rows, decode them
        (decode_rows: greedy, beam search when num_beams > 1, or sampling
        when do_sample, with temperature, top_k, top_p and
        sample_generator), scatter back.
        region_features [B, 29, 1024]; selected_regions [B, 29] bool.
        Returns (output_ids [B, 29, max_length], decoded_mask [B, 29]):
        decoded_mask marks the regions whose row fit in the budget.
        return_done (beam search only) adds a [B, 29] bool mask of the rows
        whose search closed before max_length (beam_generate), the
        cascade's test of a final row."""
        if return_done and (num_beams <= 1 or do_sample):
            raise ValueError("return_done is a beam-search signal "
                             "(num_beams > 1, no sampling)")
        b = region_features.shape[0]
        pad = self.cfg.decoder.pad_token_id
        flat_feats = region_features.reshape(b * C.NUM_REGIONS, -1)
        sel = selected_regions.reshape(-1)
        idx = stable_compaction(sel)[:r_budget]
        active = sel[idx]
        ids, row_done = self.decode_rows(params, flat_feats[idx], max_length,
                                         num_beams, early_stopping, active,
                                         kv_cache_dtype, do_sample, temperature,
                                         top_k, top_p, sample_generator)

        def scatter(rows: torch.Tensor, fill) -> torch.Tensor:
            full = torch.full((b * C.NUM_REGIONS,) + rows.shape[1:], fill,
                              dtype=rows.dtype, device=rows.device)
            full[idx] = rows
            return full.reshape((b, C.NUM_REGIONS) + rows.shape[1:])

        out = scatter(torch.where(active[:, None], ids, pad), pad)
        decoded = scatter(active, False)
        if return_done:
            return out, decoded, scatter(row_done & active, False)
        return out, decoded

    def detect_and_decode(self, params: Params, images: torch.Tensor,
                          selected_regions: Optional[torch.Tensor],
                          r_budget: int, max_length: int,
                          kv_cache_dtype: Optional[torch.dtype] = None,
                          resize_mats=None, image_chunk: Optional[int] = None,
                          num_beams: int = 1, early_stopping: bool = False,
                          return_features: bool = False,
                          return_done: bool = False) -> Dict[str, torch.Tensor]:
        """Detector + one budgeted decode. selected_regions=None decodes the
        detector's own selection; rows beyond r_budget stay undecoded, as
        in decode_selected (the caller checks the count). return_done adds
        "decode_done" (beam search only); return_features adds
        "region_features", from which serving continues the cascade or
        re-decodes a missed budget."""
        det = self.detect(params, images, resize_mats, image_chunk=image_chunk)
        sel = det["selected_regions"] if selected_regions is None else selected_regions
        res = self.decode_selected(params, det["region_features"], sel,
                                   r_budget, max_length,
                                   kv_cache_dtype=kv_cache_dtype,
                                   num_beams=num_beams,
                                   early_stopping=early_stopping,
                                   return_done=return_done)
        out = {
            "output_ids": res[0],
            "decoded_mask": res[1],
            "selected_regions": sel,
            "class_detected": det["class_detected"],
            "top_region_boxes": det["top_region_boxes"],
            "selection_logits": det["selection_logits"],
        }
        if return_done:
            out["decode_done"] = res[2]
        if return_features:
            out["region_features"] = det["region_features"]
        return out

    @torch.inference_mode()
    def decode_selected_cascade(self, params: Params,
                                region_features: torch.Tensor,
                                selected_regions: torch.Tensor,
                                max_length: int,
                                kv_cache_dtype: Optional[torch.dtype] = None,
                                buckets: Optional[Tuple[int, ...]] = None,
                                first_count: Optional[int] = None,
                                num_beams: int = 1, early_stopping: bool = False,
                                stats=None, stats_rung1: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode (greedy or beam) through the static length-bucket ladder;
        one host read of the remaining-row count per bucket used
        (`first_count` supplies the first when the caller has it).

        Why a bucket's rows equal the full-length decode:
          * greedy is prefix-deterministic: a row that finishes (EOS) inside
            the bucket is final; rows whose last slot holds a real token
            re-decode at the next bucket;
          * beam: a row is final when its search CLOSED (`done`, which
            depends on cur_len only, never on the cap) and its best
            hypothesis plus EOS fit the bucket. A closed search adds nothing
            to its pool and has no live beams, so finalize reads the same
            pool under any longer cap; every other row re-decodes from
            scratch at the next bucket, which is the longer cap's decode.
        stats: an optional serving.CascadeStats; it records the rows
        entering each rung and, unless stats_rung1 is False (the caller ran
        rung 1 itself and recorded it), the rung-1 closure.
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
        n_first = None
        for j, bucket in enumerate(buckets):
            bucket = min(bucket, max_length)
            n_rem = (first_count if j == 0 and first_count is not None
                     else int(remaining.sum()))
            if j == 0:
                n_first = n_rem
            elif j == 1 and stats is not None and stats_rung1:
                stats.record_rung1(n_first, n_rem)
            if stats is not None:
                stats.record_rung(bucket, n_rem)
            if output_ids is not None and n_rem == 0:
                break
            res = self.decode_selected(
                params, region_features, remaining, self.budget_for(n_rem, b),
                bucket, kv_cache_dtype=kv_cache_dtype, num_beams=num_beams,
                early_stopping=early_stopping,
                return_done=num_beams > 1 and bucket < max_length)
            ids_b, dec_b = res[0], res[1]
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
            # an unfinished row's last slot holds a real token), and for
            # beam search every row whose search is still open
            unfinished = ids_b[:, :, bucket - 1] != pad
            if num_beams > 1:
                unfinished = unfinished | ~res[2]
            remaining = remaining & dec_b & unfinished
        return output_ids, decoded_mask

    def budget_for(self, num_selected: int, batch: int) -> int:
        """Static decode row budget >= num_selected from the ladder, capped
        at B*29."""
        cap = batch * C.NUM_REGIONS
        return cap if num_selected >= cap else min(ladder_budget(num_selected), cap)

    def generate(self, params: Params, images: torch.Tensor,
                 max_length: Optional[int] = None, num_beams: int = 1,
                 early_stopping: bool = False, resize_mats=None,
                 selection_override=None
                 ) -> Dict[str, Any]:
        """Full inference for a batch: images as for `detect`. num_beams=1
        is greedy; the product default, beam 4 with early stopping, is
        what ReportGenerator asks for. selection_override: an optional
        [B, 29] bool mask decoded instead of the classifier's selection
        (caller-chosen regions). Returns output ids [B, 29, L] (a tensor on
        the device) plus the selection, decoded mask and detections as
        numpy arrays."""
        if max_length is None:
            max_length = self.cfg.generation.max_length
        det = self.detect(params, images, resize_mats)
        sel = (det["selected_regions"] if selection_override is None
               else torch.as_tensor(selection_override,
                                    device=det["selected_regions"].device))
        num_selected = int(sel.sum())  # the one host read before decoding
        output_ids, decoded_mask = self.decode_selected_cascade(
            params, det["region_features"], sel, max_length,
            first_count=num_selected, num_beams=num_beams,
            early_stopping=early_stopping)
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
