"""PyTorch/CUDA port of the RGRG radiology-report pipeline for NVIDIA Hopper.

A second package beside the JAX one: it imports `torch`, never `jax`, and
keeps its own copies of the framework-free modules it needs. Entry points
run on `cuda` unless the caller passes `device="cpu"`; asking for the card
when none is present raises (core/device.py).

The greedy product path is ported: raw uint8 X-rays -> device resize ->
ResNet-50 -> RPN + NMS (kernel K1, csrc/nms.cu) -> RoIAlign (kernel K2,
csrc/roi_align.cu) + box head -> region selection -> greedy GPT-2 decode ->
report assembly (inference.ReportGenerator).
"""
