"""Test-set evaluation: detector / classifier / NLG / CE metrics over the
test split(s), writing final_scores_<split>.txt (the reference's
test_set_evaluation.py layout) and all scores as JSON.

    python -m rgrg_tpu_torch.evaluate --checkpoint full_model.pt \\
        --tokenizer-dir gpt2/ --test-csv test.csv [test-2.csv] \\
        [--chexbert-checkpoint chexbert.pth --bert-vocab vocab.txt] \\
        [--cider-df df.bin.gz]

--checkpoint takes a reference .pt/.pth or a checkpoint directory of a
training run (python -m rgrg_tpu_torch.train: <run_dir>/last or best).
Decodes with beam 4 and early stopping at max_length 300 through the
length-bucket cascade, as the reference evaluates. Runs on the card
unless `--device cpu` is given. The figures (--num-figure-images) need
matplotlib and reading image files needs cv2; the metrics need neither.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference .pt/.pth, or a training checkpoint directory")
    ap.add_argument("--tokenizer-dir", required=True)
    ap.add_argument("--test-csv", required=True, nargs="+",
                    help="test.csv [test-2.csv]")
    ap.add_argument("--output", default="final_scores.txt")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-beams", type=int, default=4)
    ap.add_argument("--max-length", type=int, default=300)
    ap.add_argument("--max-language-batches", type=int, default=100)
    ap.add_argument("--chexbert-checkpoint", default=None)
    ap.add_argument("--bert-vocab", default=None)
    ap.add_argument("--cider-df", default=None,
                    help="gzip doc-frequency cache from scripts/compute_cider_df.py")
    ap.add_argument("--artifacts-dir", default=None,
                    help="where sentence/report txt dumps + figures go "
                         "(default: alongside --output)")
    ap.add_argument("--num-figure-images", type=int, default=2,
                    help="bbox figures for the first N images (0 disables)")
    ap.add_argument("--workers", type=int, default=0,
                    help="sample-construction threads (DataLoader "
                         "num_workers analogue)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched ahead of the device step "
                         "(0 = synchronous)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def chexbert_labeler(params, vocab: str, cfg=None) -> Callable:
    """reports -> [14, N] CheXbert labels from `convert_chexbert`'s
    parameters, on their device; `cfg` is the encoder's BertConfig
    (default: BERT-base)."""
    from rgrg_tpu_torch.eval.chexbert import BertConfig, chexbert_label
    from rgrg_tpu_torch.text.wordpiece import WordPieceTokenizer
    cfg = cfg or BertConfig()
    wp = WordPieceTokenizer.from_vocab_file(vocab)

    def label(reports):
        ids, mask = wp.encode_batch(list(reports))
        return chexbert_label(params, ids, mask, cfg)
    return label


def evaluate_splits(gen, csv_paths: Sequence[str], out_dir: str, batch_size: int = 8,
                    num_beams: int = 4, max_length: int = 300,
                    max_language_batches: int = 100,
                    chexbert: Optional[Callable] = None, cider_df=None, cider_log_n=None,
                    num_figure_images: int = 2, workers: int = 0,
                    prefetch: int = 2) -> Dict[str, Any]:
    """Evaluate a ReportGenerator's model on each split csv; per split,
    artifacts under out_dir/<split> and out_dir/final_scores_<split>.txt.
    Returns {csv path: scores}. A split that yields no batch (every image
    unreadable, or fewer rows than batch_size) raises."""
    from itertools import chain

    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from rgrg_tpu_torch.data.prefetch import prefetched
    from rgrg_tpu_torch.eval.artifacts import write_final_scores
    from rgrg_tpu_torch.eval.evaluator import evaluate_model

    all_scores = {}
    for csv_path in csv_paths:
        ds = RGRGDataset(read_split_csv(csv_path), gen.tokenizer)
        tag = os.path.splitext(os.path.basename(csv_path))[0]
        batches = ds.batches(batch_size, workers=workers)
        if prefetch > 0:
            batches = prefetched(batches, depth=prefetch)
        first = next(batches, None)
        if first is None:
            raise ValueError(f"{csv_path}: no batch of {batch_size} readable images")
        batches = chain([first], batches)
        scores = evaluate_model(gen.model, gen.params, batches, gen.tokenizer,
                                num_beams=num_beams, max_length=max_length,
                                max_language_batches=max_language_batches,
                                chexbert=chexbert,
                                artifacts_dir=os.path.join(out_dir, tag),
                                num_figure_images=num_figure_images,
                                cider_df=cider_df, cider_log_n=cider_log_n)
        all_scores[csv_path] = scores
        # the reference's final_scores.txt format (test_set_evaluation.py:77-177)
        write_final_scores(scores, os.path.join(out_dir, f"final_scores_{tag}.txt"))
    return all_scores


def load_generator(checkpoint: str, tokenizer_dir: str, cfg=None, device="cuda"):
    """A ReportGenerator from a reference .pt/.pth or from a checkpoint
    directory of core/checkpoint.save_checkpoint, built for `cfg` (a
    ModelConfig; default the reference's)."""
    from rgrg_tpu_torch.core.config import ModelConfig
    from rgrg_tpu_torch.inference import ReportGenerator
    cfg = cfg or ModelConfig()
    if checkpoint.endswith((".pt", ".pth")):
        return ReportGenerator.from_torch_checkpoint(checkpoint, tokenizer_dir, cfg=cfg,
                                                     device=device)
    return ReportGenerator.from_checkpoint(checkpoint, tokenizer_dir, cfg=cfg, device=device)


def main(argv=None, cfg=None) -> None:
    """`cfg`: the ModelConfig the checkpoint was built for (default the
    reference's)."""
    args = build_parser().parse_args(argv)
    gen = load_generator(args.checkpoint, args.tokenizer_dir, cfg, args.device)
    chexbert = None
    if args.chexbert_checkpoint and args.bert_vocab:
        from rgrg_tpu_torch.core.checkpoint import load_torch_checkpoint
        from rgrg_tpu_torch.eval.chexbert import convert_chexbert
        params = convert_chexbert(load_torch_checkpoint(args.chexbert_checkpoint),
                                  device=gen.device)
        chexbert = chexbert_labeler(params, args.bert_vocab)
    cider_df = cider_log_n = None
    if args.cider_df:
        from rgrg_tpu_torch.data.stats import load_cider_doc_frequencies
        cider_df, cider_log_n = load_cider_doc_frequencies(args.cider_df)

    out_dir = args.artifacts_dir or os.path.dirname(os.path.abspath(args.output))
    all_scores = evaluate_splits(
        gen, args.test_csv, out_dir, batch_size=args.batch_size, num_beams=args.num_beams,
        max_length=args.max_length, max_language_batches=args.max_language_batches,
        chexbert=chexbert, cider_df=cider_df, cider_log_n=cider_log_n,
        num_figure_images=args.num_figure_images, workers=args.workers,
        prefetch=args.prefetch)
    with open(args.output, "w") as f:
        f.write(json.dumps(all_scores, indent=2, default=float))
    print(f"wrote {args.output} + artifacts under {out_dir}")


if __name__ == "__main__":
    main()
