"""Generate radiology reports for chest X-ray images (the product entry
point; the JAX package's scripts/generate_reports.py).

    python -m rgrg_tpu_torch.generate_reports --checkpoint full_model.pt \\
        --tokenizer-dir gpt2/ --images a.jpg b.jpg --output reports.txt

--checkpoint takes a reference .pt/.pth or a checkpoint directory
(core/checkpoint.save_checkpoint: a training run's <run_dir>/last or best,
or a bare params tree). Beam 4 with early stopping at max_length 300 by
default, `--batch-size` images a call. Runs on the card unless `--device
cpu` is given; reading image files needs cv2.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference .pt/.pth, or a checkpoint directory")
    ap.add_argument("--tokenizer-dir", required=True,
                    help="dir with GPT-2 vocab.json + merges.txt")
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--output", default="generated_reports.txt")
    ap.add_argument("--num-beams", type=int, default=4)
    ap.add_argument("--max-length", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--no-early-stopping", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, cfg=None) -> None:
    """`cfg`: the ModelConfig the checkpoint was built for (default the
    reference's)."""
    args = build_parser().parse_args(argv)
    from rgrg_tpu_torch.evaluate import load_generator
    from rgrg_tpu_torch.inference import write_generated_reports_to_txt
    gen = load_generator(args.checkpoint, args.tokenizer_dir, cfg, args.device)
    reports = []
    for i in range(0, len(args.images), args.batch_size):
        chunk = args.images[i:i + args.batch_size]
        reports.extend(gen.generate_reports(
            chunk, num_beams=args.num_beams, max_length=args.max_length,
            early_stopping=not args.no_early_stopping))
        for path, rep in zip(chunk, reports[i:]):
            print(f"{path}:\n  {rep.report}\n")
    write_generated_reports_to_txt(args.images, reports, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
