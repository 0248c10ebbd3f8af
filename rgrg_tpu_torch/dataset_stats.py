"""Dataset statistics of split csvs (the reference's
compute_stats_dataset.py / compute_mean_std_dataset.py): split counts,
pos_weight ratios, and optionally the streaming pixel mean/std.

    python -m rgrg_tpu_torch.dataset_stats --csv train.csv [--mean-std]

--mean-std reads every image file, which needs cv2.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True, nargs="+")
    ap.add_argument("--mean-std", action="store_true",
                    help="also stream pixel mean/std (slow)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from rgrg_tpu_torch.data.dataset import read_split_csv
    from rgrg_tpu_torch.data.stats import compute_mean_std, dataset_stats
    for path in args.csv:
        rows = read_split_csv(path)
        stats = dataset_stats(rows)
        if args.mean_std:
            mean, std = compute_mean_std([r["mimic_image_file_path"] for r in rows])
            stats.update({"pixel_mean": mean, "pixel_std": std})
        print(path, json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
