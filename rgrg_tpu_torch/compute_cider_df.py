"""Precompute CIDEr-D document frequencies from the validation split's
reference reports (the reference's compute_cider_document_frequencies.py),
for `python -m rgrg_tpu_torch.evaluate --cider-df`.

    python -m rgrg_tpu_torch.compute_cider_df --valid-csv valid.csv \\
        --output mimic-cxr-document-frequency.bin.gz

Empty cells (and pandas' other NA spellings) are left out, as pandas'
dropna leaves them out.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--valid-csv", required=True)
    ap.add_argument("--output", default="mimic-cxr-document-frequency.bin.gz")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from rgrg_tpu_torch.data.dataset import read_split_csv
    from rgrg_tpu_torch.data.stats import compute_cider_doc_frequencies
    rows = read_split_csv(args.valid_csv, usecols=["reference_report"])
    # read_split_csv reads an NA cell as float("nan"), which is truthy
    reports = [r["reference_report"] for r in rows if isinstance(r["reference_report"], str)]
    compute_cider_doc_frequencies(reports, save_path=args.output)
    print(f"wrote {args.output} ({len(reports)} reports)")


if __name__ == "__main__":
    main()
