"""Bbox-variation robustness evaluation (the reference's
evaluate_bbox_variations.py, paper section 5.3): perturb the gt boxes with
growing position, scale or aspect-ratio noise, RoI-pool features directly
from the perturbed boxes, decode, and report sentence METEOR per noise
level.

    python -m rgrg_tpu_torch.evaluate_bbox_variations --checkpoint CKPT \\
        --tokenizer-dir gpt2/ --csv valid.csv [--mode scale] [--device cpu]

--checkpoint takes a reference .pt/.pth or a training checkpoint
directory (<run_dir>/last). Writes {"mode", "meteor_by_std"} as JSON.
Runs on the card unless `--device cpu` is given; reading image files
needs cv2.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference .pt/.pth, or a training checkpoint directory")
    ap.add_argument("--tokenizer-dir", required=True)
    ap.add_argument("--csv", required=True, help="split csv with gt boxes + phrases")
    ap.add_argument("--mode", choices=["position", "scale", "aspect"], default="position")
    ap.add_argument("--stds", type=float, nargs="+",
                    default=[round(0.1 * i, 1) for i in range(20)])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=25)
    ap.add_argument("--max-length", type=int, default=64)
    ap.add_argument("--output", default="bbox_variations.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, cfg=None) -> dict:
    """`cfg`: the ModelConfig the checkpoint was built for (default the
    reference's). Returns {std: METEOR}."""
    import itertools

    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from rgrg_tpu_torch.eval.evaluator import evaluate_bbox_variations
    from rgrg_tpu_torch.evaluate import load_generator

    args = build_parser().parse_args(argv)
    gen = load_generator(args.checkpoint, args.tokenizer_dir, cfg, args.device)
    ds = RGRGDataset(read_split_csv(args.csv), gen.tokenizer)
    batches = list(itertools.islice(ds.batches(args.batch_size), args.max_batches))
    results = evaluate_bbox_variations(gen.model, gen.params, batches, gen.tokenizer,
                                       args.mode, stds=args.stds,
                                       max_length=args.max_length)
    with open(args.output, "w") as f:
        json.dump({"mode": args.mode, "meteor_by_std": results}, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
