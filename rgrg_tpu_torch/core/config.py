"""Typed configuration of the inference path (the port's own copy).

Field names and defaults equal the JAX package's configs so the two can be
built side by side. Only the settings the greedy serving path reads are
kept; training-only settings arrive with the training slice. There is no
NMS or RoIAlign implementation knob: the detector always calls
ops.nms.nms_keep_mask and ops.roi_align.roi_align, which dispatch on the
tensor's device (plain PyTorch on the CPU, the hand-written kernel on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from rgrg_tpu_torch.core import constants as C


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor grid for the 512x512 input / 16x16 C5 feature map: 10 sizes x
    16 aspect ratios = 160 anchors per location."""

    sizes: Tuple[float, ...] = (20, 40, 60, 80, 100, 120, 140, 160, 180, 300)
    aspect_ratios: Tuple[float, ...] = (
        0.2, 0.25, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.3, 1.5, 2.1, 2.6, 3.0, 5.0, 8.0,
    )
    stride: int = C.BACKBONE_STRIDE
    grid_size: int = C.FEATURE_MAP_SIZE

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.sizes) * len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Region proposal settings read at inference."""

    # proposals kept per image before and after NMS (one count: the keep
    # mask needs no truncation)
    pre_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    min_box_size: float = 1e-3


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    output_size: int = 8             # RoIAlign output resolution
    sampling_ratio: int = 2          # RoIAlign samples per bin edge
    representation_size: int = 1024  # TwoMLPHead width
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    # proposals per RoI-head chunk: bounds the pooled [B, chunk, 8, 8, 2048]
    # f32 intermediate
    proposal_chunk: int = 256
    # compact NMS survivors to this many proposals before the RoI head
    # (None keeps every post-NMS slot). Exact whenever survivors <= budget.
    inference_proposal_budget: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    roi: RoIConfig = RoIConfig()
    num_classes: int = C.NUM_DETECTOR_CLASSES  # 29 regions + background
    image_size: int = C.IMAGE_SIZE
    # ResNet stage depths; (3, 4, 6, 3) == ResNet-50
    backbone_stages: Tuple[int, int, int, int] = (3, 4, 6, 3)
    # compute dtype of convs/dense layers ("bfloat16" for serving,
    # "float32" for parity); parameters stay f32, box math is always f32
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """The two binary-classifier MLP heads over region features."""

    # logit threshold -1.0 == probability 0.269
    logit_threshold: float = -1.0


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """GPT-2 Medium with pseudo self-attention."""

    vocab_size: int = C.VOCAB_SIZE
    hidden_dim: int = C.HIDDEN_DIM
    image_feature_dim: int = C.REGION_FEATURE_DIM
    num_heads: int = C.NUM_HEADS
    num_layers: int = C.NUM_LAYERS
    max_positions: int = C.MAX_POSITIONS
    bos_token_id: int = C.BOS_TOKEN_ID
    eos_token_id: int = C.EOS_TOKEN_ID
    pad_token_id: int = C.PAD_TOKEN_ID
    layer_norm_eps: float = 1e-5
    # the published checkpoints look position embeddings up in the WORD
    # embedding table (wte), not wpe; kept for weight-compatible output
    positions_from_wte: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 300
    # static KV-cache length buckets of the decode cascade
    length_buckets: Tuple[int, ...] = (64, 128, 304)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    detector: DetectorConfig = DetectorConfig()
    classifier: ClassifierConfig = ClassifierConfig()
    decoder: DecoderConfig = DecoderConfig()
    generation: GenerationConfig = GenerationConfig()
