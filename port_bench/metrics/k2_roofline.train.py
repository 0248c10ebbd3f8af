"""k2_roofline.train: the least time kernel K2 (`roi_align_kernel`, the
forward RoIAlign) could take on the traced mini-steps' launches, over the
device time of its launches in the trace, in %. A launch pools one chunk
of `roi_proposal_chunk` sampled proposals of every image: it reads the C5
map once and writes the pooled bins in float32 (the bytes bound them)."""

from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    cfg, trace, peaks = rec["config"], rec["trace"], rec["peaks"]
    spans = [(s, e) for n, s, e in trace["events"] if "roi_align_kernel" in n]
    if not spans or not peaks:
        return None
    t = cfg["train"]
    b, c, p = t["batch_size"], cfg["backbone_channels"], cfg["roi_output_size"]
    g = cfg["image_size"] // cfg["backbone_stride"]
    chunk = min(cfg["roi_proposal_chunk"], t["roi_batch_per_image"])
    nbytes = 4.0 * b * (g * g * c + chunk * (4 + p * p * c))
    flops = 2.0 * b * chunk * p * p * c * cfg["sampling_ratio"] ** 2 * 4
    bound = max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["f32_flops"])
    return 100.0 * len(spans) * bound / (sum(e - s for s, e in spans) * 1e-6)
