"""Build train/valid/test/test-2 csv splits from Chest ImaGenome +
MIMIC-CXR + MIMIC-CXR-JPG (the reference's src/dataset/create_dataset.py).

    python -m rgrg_tpu_torch.create_dataset --chest-imagenome ci/ \\
        --mimic-cxr mimic-cxr/ --mimic-cxr-jpg mimic-cxr-jpg/ --output-dir splits/

Host only: image sizes come from the JPEG headers (data/etl.image_size),
so neither PIL nor cv2 is needed.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chest-imagenome", required=True)
    ap.add_argument("--mimic-cxr", required=True)
    ap.add_argument("--mimic-cxr-jpg", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--splits", nargs="+", default=["train", "valid", "test"])
    ap.add_argument("--max-rows", type=int, default=None,
                    help="small sample csvs for dry runs")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from rgrg_tpu_torch.data.etl import EtlPaths, build_split
    paths = EtlPaths(args.chest_imagenome, args.mimic_cxr, args.mimic_cxr_jpg,
                     args.output_dir)
    for split in args.splits:
        written = build_split(split, paths, max_rows=args.max_rows)
        print(f"{split}: wrote {written}")


if __name__ == "__main__":
    main()
