"""The program's configuration objects, built from a configuration file.

Every size and precision the program runs with comes from the file, so a
configuration is data: a later one changes the file, not this code.
"""

from __future__ import annotations

from typing import Dict

import torch


def program_config(cfg: Dict):
    """The program's ModelConfig for a configuration file."""
    from rgrg_tpu_torch.core import config as pc
    d, t = cfg["decoder"], cfg.get("train", {})
    rpn = dict(pre_nms_top_n_test=cfg["rpn_pre_nms_top_n_test"], nms_thresh=cfg["nms_thresh"],
               min_box_size=cfg["min_box_size"])
    roi = dict(output_size=cfg["roi_output_size"], sampling_ratio=cfg["sampling_ratio"],
               representation_size=cfg["representation_size"],
               bbox_reg_weights=tuple(cfg["bbox_reg_weights"]),
               proposal_chunk=cfg["roi_proposal_chunk"])
    dec = dict(vocab_size=d["vocab_size"], hidden_dim=d["hidden_dim"], num_heads=d["num_heads"],
               num_layers=d["num_layers"], max_positions=d["max_positions"],
               bos_token_id=d["bos_token_id"], eos_token_id=d["eos_token_id"],
               pad_token_id=d["pad_token_id"], positions_from_wte=d["positions_from_wte"],
               layer_norm_eps=d["layer_norm_eps"])
    cls = dict(logit_threshold=cfg["logit_threshold"])
    if t:
        rpn.update(pre_nms_top_n_train=t["rpn_pre_nms_top_n_train"],
                   post_nms_top_n_train=t["rpn_pre_nms_top_n_train"],
                   fg_iou_thresh=t["rpn_fg_iou"], bg_iou_thresh=t["rpn_bg_iou"],
                   batch_size_per_image=t["rpn_batch_per_image"],
                   positive_fraction=t["rpn_positive_fraction"])
        roi.update(fg_iou_thresh=t["roi_fg_iou"], bg_iou_thresh=t["roi_bg_iou"],
                   batch_size_per_image=t["roi_batch_per_image"],
                   positive_fraction=t["roi_positive_fraction"])
        dec.update(embd_dropout=t["dropout"], attn_dropout=t["dropout"], resid_dropout=t["dropout"])
        cls.update(selection_pos_weight=t["selection_pos_weight"],
                   abnormal_pos_weight=t["abnormal_pos_weight"])
    det = pc.DetectorConfig(
        anchors=pc.AnchorConfig(sizes=tuple(cfg["anchor_sizes"]),
                                aspect_ratios=tuple(cfg["anchor_aspect_ratios"])),
        rpn=pc.RPNConfig(**rpn), roi=pc.RoIConfig(**roi),
        backbone_stages=tuple(cfg["backbone_stages"]), dtype=cfg["detector_dtype"])
    return pc.ModelConfig(detector=det, classifier=pc.ClassifierConfig(**cls),
                          decoder=pc.DecoderConfig(**dec),
                          generation=pc.GenerationConfig(length_buckets=tuple(cfg["length_buckets"])))


def train_config(cfg: Dict):
    """The program's TrainConfig for a configuration file's `train`."""
    from rgrg_tpu_torch.core.config import TrainConfig
    t = cfg["train"]
    return TrainConfig(batch_size=t["batch_size"], grad_accumulation_steps=t["grad_accumulation_steps"],
                       learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
                       loss_weight_detector=t["loss_weight_detector"],
                       loss_weight_selection=t["loss_weight_selection"],
                       loss_weight_abnormal=t["loss_weight_abnormal"],
                       loss_weight_lm=t["loss_weight_lm"])


def program_params(w: Dict[str, torch.Tensor], mcfg, device: torch.device) -> Dict:
    """The program's params, its own copies of the weights: the detector
    module and the decoder's nested dict."""
    from rgrg_tpu_torch.models.detector import RegionDetector
    det = RegionDetector(mcfg.detector, device=device)
    det.load_state_dict({k: v for k, v in w.items() if not k.startswith("decoder.")},
                        strict=True)
    det.eval()
    dec: Dict = {}
    for name, t in w.items():
        if name.startswith("decoder."):
            node = dec
            *path, leaf = name.split(".")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t.clone()
    return {"detector": det, "decoder": dec}
