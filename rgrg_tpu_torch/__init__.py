"""PyTorch/CUDA port of the RGRG radiology-report pipeline for NVIDIA Hopper.

A second package beside the JAX one: it imports `torch`, never `jax`, and
keeps its own copies of the framework-free modules it needs. Entry points
run on `cuda` unless the caller passes `device="cpu"`; asking for the card
when none is present raises (core/device.py).

The product path is ported: X-rays -> resize (on the host as the JAX
package's generate_reports does, data/preprocess.py, or on the device for a
same-shape serving batch) -> ResNet-50 -> RPN + NMS (kernel K1, csrc/nms.cu)
-> RoIAlign (kernel K2, csrc/roi_align.cu) + box head -> region selection ->
GPT-2 decode -> report assembly (inference.ReportGenerator; exact dedup,
and by default BERTScore soft dedup, eval/bertscore.py, when
$RGRG_DISTILBERT_DIR names local distilbert weights). The decode is
beam 4 with early stopping by default, as in the JAX package, whose every
step attends through the ancestry table (kernel K3, csrc/beam_attn.cu);
num_beams=1 is greedy. serving.generate_reports_pipelined overlaps host
work with the card and can serve the decoder's matmul weights as
weight-only int8 (kernel K4, csrc/dense_wint8.cu); `python -m
rgrg_tpu_torch.serve` serves a directory of X-rays and `python -m
rgrg_tpu_torch.generate_reports` a list of them, from a reference `.pt` or
a checkpoint directory. Offline, `python -m rgrg_tpu_torch.create_dataset`
builds the split csvs from Chest ImaGenome + MIMIC-CXR (data/etl.py),
`dataset_stats` and `compute_cider_df` compute their statistics and the
CIDEr-D frequencies the evaluation reads.

Tests on the CPU: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py
On the card: python3 chip_smoke.py

"""
