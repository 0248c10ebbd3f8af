"""PyTorch/CUDA port of the RGRG radiology-report pipeline for NVIDIA Hopper.

A second package beside the JAX one: it imports `torch`, never `jax`, and
keeps its own copies of the framework-free modules it needs. Entry points
run on `cuda` unless the caller passes `device="cpu"`; asking for the card
when none is present raises (core/device.py).

The product path is ported: raw uint8 X-rays -> device resize -> ResNet-50
-> RPN + NMS (kernel K1, csrc/nms.cu) -> RoIAlign (kernel K2,
csrc/roi_align.cu) + box head -> region selection -> GPT-2 decode -> report
assembly (inference.ReportGenerator). The decode is beam 4 with early
stopping by default, as in the JAX package, whose every step attends
through the ancestry table (kernel K3, csrc/beam_attn.cu); num_beams=1 is
greedy.

Tests on the CPU: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py
On the card: python3 chip_smoke.py

"""
