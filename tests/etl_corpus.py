"""A synthetic Chest ImaGenome + MIMIC-CXR + MIMIC-CXR-JPG tree for the
offline ETL (`data/etl.build_split` of either package), made from a seed
with numpy.

Laid out as the ETL reads the real datasets:

  chest_imagenome/silver_dataset/splits/{train,valid,test}.csv
      (i, subject_id, study_id, dicom_id, path .dcm) and images_to_avoid.csv
  chest_imagenome/silver_dataset/scene_graph/<dicom_id>_SceneGraph.json
  mimic_cxr/files/pXX/p<subject>/s<study>.txt      (free-text reports)
  mimic_cxr_jpg/files/pXX/p<subject>/s<study>/<dicom_id>.jpg

Each study has two X-rays of 2048x2500 or 2500x2048 pixels; each .jpg is
header-only (SOI, a baseline frame header with the size, an empty scan,
EOI): the ETL reads only sizes, and PIL reads them from it too. The
corpus holds every case the ETL filters or rewrites: failed X-rays
(IMAGE_IDS_TO_IGNORE), gold-set images to avoid, a missing image and a
missing report, a study without a findings section, studies of the
published override tables, typo and repeated headers, WET READ spans,
boilerplate headers, duplicate sentences, abnormal attributes,
attributes and objects of non-region names, faulty (zero-area, outside)
and partial (clamped) boxes, regions without a box, and images with
fewer than 29 regions. In the test split the first X-ray of a study has
all 29 regions and the second fewer, so test.csv and test-2.csv each get
rows. Imports numpy, the standard library and the port's constants, no
JAX.
"""

from __future__ import annotations

import csv
import json
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from rgrg_tpu_torch.core.constants import REGION_NAMES

SPLIT_STUDIES = {"train": 14, "valid": 10, "test": 16}
SIZES = ((2048, 2500), (2500, 2048))   # (height, width)
# a failed X-ray of the reference's IMAGE_IDS_TO_IGNORE
IGNORED_ID = "f55a5fe2-395fc452-4e6b63d9-3341534a-ebb882d5"

SENTENCES = (
    "the lungs are clear.", "there is no pleural effusion or pneumothorax.",
    "heart size is normal.", "mild cardiomegaly is unchanged.",
    "there is a small left pleural effusion.", "right lower lobe opacity may reflect atelectasis.",
    "the mediastinal contours are within normal limits.", "no focal consolidation is seen.",
    "an endotracheal tube terminates 4.5 cm above the carina.",
    "osseous structures are intact.", "bilateral hilar prominence, unchanged.",
    'a "right-sided" picc line ends in the svc.')
# raw scene-graph phrase prefixes the ETL strips or rewrites
PREFIXES = ("", "", "", "PORTABLE CHEST RADIOGRAPH: ", "FINDINGS: ", "1. ",
            "WET READ: ___ ___ 8:19 AM ", "IMPRESSION: ", "CHEST, PA AND LATERAL: ")
ATTRIBUTES = (["anatomicalfinding|no|lung opacity", "nlp|yes|normal"],
              ["anatomicalfinding|yes|pleural effusion", "nlp|yes|abnormal"],
              ["tubesandlines|yes|endotracheal tube"])


def header_only_jpeg(path: str, height: int, width: int) -> None:
    """A JPEG of `height` x `width` with no pixel data: SOI, a JFIF APP0, a
    baseline SOF0 of one 8-bit component, an empty scan header, EOI."""
    app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    with open(path, "wb") as f:
        f.write(b"\xff\xd8"
                + b"\xff\xe0" + struct.pack(">H", 2 + len(app0)) + app0
                + b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, height, width, 1) + b"\x01\x11\x00"
                + b"\xff\xda" + struct.pack(">HB", 8, 1) + b"\x01\x00" + b"\x00\x3f\x00"
                + b"\xff\xd9")


def _report(rng, kind: str) -> str:
    findings = " ".join(s.capitalize() for s in rng.choice(SENTENCES, 3, replace=False))
    impression = "No acute cardiopulmonary process."
    head = ("                                 FINAL REPORT\n"
            " EXAMINATION:  CHEST (PA AND LAT)\n \n"
            " INDICATION:  ___ year old with cough, evaluate for pneumonia.\n \n"
            " COMPARISON:  ___.\n \n")
    if kind == "no_findings":
        return head + f" IMPRESSION: \n \n {impression}\n"
    if kind == "typo":
        return head + f" FINDNGS: \n \n {findings}\n \n IMPRESSION: \n \n {impression}\n"
    if kind == "twice":  # the ETL keeps the last findings section
        return (head + " FINDINGS: \n \n Preliminary read.\n \n"
                f" FINDINGS: \n \n {findings}\n \n IMPRESSION: \n \n {impression}\n")
    return (head + f" FINDINGS: \n \n {findings}\n   Wrapped   line,  with spaces.\n \n"
            f" IMPRESSION: \n \n {impression}\n")


def _phrases(rng) -> List[str]:
    n = int(rng.integers(1, 4))
    out = [str(rng.choice(PREFIXES)) + str(s) for s in rng.choice(SENTENCES, n)]
    if rng.uniform() < 0.3:
        out.append(out[0])                       # a duplicate sentence
    if rng.uniform() < 0.1:
        out.append("WET READ VERSION pending")   # unterminated WET READ span
    return out


def _scene_graph(rng, height: int, width: int, regions: List[int], faulty: bool) -> Dict:
    """Objects for `regions` (with faulty boxes mixed in when `faulty`) and
    one of another name; attributes for a few regions and another name."""
    objects = []
    for r in regions:
        x1, y1 = rng.uniform(0, 0.7 * width), rng.uniform(0, 0.7 * height)
        x2 = x1 + rng.uniform(20, 0.5 * width)
        y2 = y1 + rng.uniform(20, 0.5 * height)
        box = [int(x1), int(y1), int(x2), int(y2)]
        case = rng.uniform() if faulty else rng.uniform(0.1, 1.0)
        if case < 0.04:
            box[2] = box[0]                      # zero area: dropped
        elif case < 0.07:
            box = [width + 5, 10, width + 90, 200]   # outside the image: dropped
        elif case < 0.10:
            box = [-40, -12.5, -3, 300]          # x2 <= 0: dropped
        elif case < 0.18:
            box = [-15, y1 - 2 * height, width + 60.5, y2]   # partial: clamped
        elif case < 0.22:
            box = [round(float(x1), 2), round(float(y1), 2), int(x2), int(y2)]
        objects.append({"bbox_name": REGION_NAMES[r], "original_x1": box[0],
                        "original_y1": box[1], "original_x2": box[2],
                        "original_y2": box[3]})
    objects.append({"bbox_name": "left breast", "original_x1": 1, "original_y1": 1,
                    "original_x2": 50, "original_y2": 50})
    attributes = []
    for r in sorted(rng.choice(29, int(rng.integers(3, 12)), replace=False).tolist()):
        attributes.append({"bbox_name": REGION_NAMES[r], "phrases": _phrases(rng),
                           "attributes": [list(ATTRIBUTES[int(rng.integers(0, 3))])
                                          for _ in range(int(rng.integers(1, 3)))]})
    attributes.append({"bbox_name": "not a region", "phrases": ["ignored."],
                       "attributes": [["nlp|yes|abnormal"]]})
    return {"objects": objects, "attributes": attributes}


def write_corpus(root: str, seed: int = 0) -> Dict:
    """Writes the tree under `root` (SPLIT_STUDIES studies a split, each
    X-ray a header-only JPEG); returns {"chest_imagenome", "mimic_cxr",
    "mimic_cxr_jpg", "output_dir": paths, "images": {jpg path: (height,
    width)} of every image written}."""
    rng = np.random.default_rng(seed)
    ci = os.path.join(root, "chest_imagenome")
    sg_dir = os.path.join(ci, "silver_dataset", "scene_graph")
    split_dir = os.path.join(ci, "silver_dataset", "splits")
    mc = os.path.join(root, "mimic_cxr")
    jp = os.path.join(root, "mimic_cxr_jpg")
    for d in (sg_dir, split_dir, mc, jp):
        os.makedirs(d, exist_ok=True)
    images: Dict[str, Tuple[int, int]] = {}
    avoid: List[str] = []
    study_no = 0
    for split, n in SPLIT_STUDIES.items():
        rows = []
        for k in range(n):
            subject = f"{10000000 + 7919 * study_no:08d}"
            study = f"{53900000 + study_no:08d}"
            study_no += 1
            kind = "findings"
            if split in ("valid", "test"):
                kind = ("no_findings", "typo", "twice", "override", "no_report",
                        "findings", "findings", "findings")[k % 8]
            if kind == "override":
                # published override tables: skipped whatever the report says
                study = {"valid": "50525523", "test": "50913680"}[split]
            if kind != "no_report":
                report_dir = os.path.join(mc, "files", f"p{subject[:2]}", f"p{subject}")
                os.makedirs(report_dir, exist_ok=True)
                with open(os.path.join(report_dir, f"s{study}.txt"), "w") as f:
                    f.write(_report(rng, kind))
            for j in range(2):
                image_id = "-".join(f"{int(v):08x}" for v in rng.integers(0, 2 ** 32, 5))
                if k == 1 and j == 1 and split in ("train", "test"):
                    image_id = IGNORED_ID
                rel = f"files/p{subject[:2]}/p{subject}/s{study}/{image_id}.dcm"
                rows.append([len(rows), subject, study, image_id, rel])
                if k == 2 and j == 1:
                    avoid.append(image_id)       # gold set: out of train and valid only
                height, width = SIZES[int(rng.integers(0, 2))]
                if split == "test":
                    full = j == 0
                else:
                    full = rng.uniform() < 0.6
                regions = (list(range(29)) if full else
                           sorted(rng.choice(29, int(rng.integers(8, 29)),
                                             replace=False).tolist()))
                # faulty boxes in images with fewer regions, and in one
                # 29-region X-ray a split, which they move out of test.csv
                faulty = not full or (k == 5 and j == 0)
                with open(os.path.join(sg_dir, f"{image_id}_SceneGraph.json"), "w") as f:
                    json.dump(_scene_graph(rng, height, width, regions, faulty), f)
                if k == 3 and j == 1:
                    continue                     # the image file is missing
                path = os.path.join(jp, rel.replace(".dcm", ".jpg"))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                header_only_jpeg(path, height, width)
                images[path] = (height, width)
        with open(os.path.join(split_dir, f"{split}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["i", "subject_id", "study_id", "dicom_id", "path"])
            w.writerows(rows)
    with open(os.path.join(split_dir, "images_to_avoid.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_id"])
        w.writerows([a] for a in avoid)
    return {"chest_imagenome": ci, "mimic_cxr": mc, "mimic_cxr_jpg": jp,
            "output_dir": os.path.join(root, "splits"), "images": images}
