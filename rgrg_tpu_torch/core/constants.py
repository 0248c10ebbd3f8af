"""Canonical constants of the RGRG task (the port's own copy).

The 29 anatomical regions and their fixed ordering are the contract between
every stage of the pipeline (detector classes 1..29, classifier/decoder
region axis of size 29).
"""

from __future__ import annotations

ANATOMICAL_REGIONS: dict[str, int] = {
    "right lung": 0,
    "right upper lung zone": 1,
    "right mid lung zone": 2,
    "right lower lung zone": 3,
    "right hilar structures": 4,
    "right apical zone": 5,
    "right costophrenic angle": 6,
    "right hemidiaphragm": 7,
    "left lung": 8,
    "left upper lung zone": 9,
    "left mid lung zone": 10,
    "left lower lung zone": 11,
    "left hilar structures": 12,
    "left apical zone": 13,
    "left costophrenic angle": 14,
    "left hemidiaphragm": 15,
    "trachea": 16,
    "spine": 17,
    "right clavicle": 18,
    "left clavicle": 19,
    "aortic arch": 20,
    "mediastinum": 21,
    "upper mediastinum": 22,
    "svc": 23,
    "cardiac silhouette": 24,
    "cavoatrial junction": 25,
    "right atrium": 26,
    "carina": 27,
    "abdomen": 28,
}

REGION_NAMES: tuple[str, ...] = tuple(ANATOMICAL_REGIONS)

NUM_REGIONS = 29
# detector classes: 0 = background, 1..29 = regions
NUM_DETECTOR_CLASSES = NUM_REGIONS + 1

# input geometry (LongestMaxSize(512) + PadIfNeeded(512, 512))
IMAGE_SIZE = 512
# ResNet-50 C5 stride
BACKBONE_STRIDE = 32
FEATURE_MAP_SIZE = IMAGE_SIZE // BACKBONE_STRIDE  # 16
BACKBONE_CHANNELS = 2048

# dataset normalization of the uint8 X-ray
IMAGE_MEAN = 0.471
IMAGE_STD = 0.302

# GPT-2 medium decoder geometry
VOCAB_SIZE = 50257
HIDDEN_DIM = 1024
NUM_HEADS = 16
NUM_LAYERS = 24
MAX_POSITIONS = 1024
BOS_TOKEN_ID = 50256
EOS_TOKEN_ID = 50256
PAD_TOKEN_ID = 50256

# region feature dim after the RoI head's dim reduction
REGION_FEATURE_DIM = 1024
