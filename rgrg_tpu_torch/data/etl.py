"""Offline dataset ETL (the port's own copy): Chest ImaGenome scene graphs
+ MIMIC-CXR reports + MIMIC-CXR-JPG images -> train/valid/test/test-2 csv
splits.

Same output schema, filtering rules and csv bytes as the JAX package's
`data/etl.py` (the reference's src/dataset/create_dataset.py):

  row: subject_id, study_id, image_id, mimic_image_file_path,
       bbox_coordinates (list of [x1,y1,x2,y2]), bbox_labels (1..29),
       bbox_phrases (always 29), bbox_phrase_exists, bbox_is_abnormal,
       [+ reference_report for valid/test]

  - failed x-rays (IMAGE_IDS_TO_IGNORE) and gold-set images skipped;
  - faulty boxes dropped (zero area / fully outside), partial boxes clamped;
  - phrases cleaned: WET READ spans removed, boilerplate headers stripped,
    whitespace collapsed, sentences capitalized, duplicate sentences removed;
  - abnormality from the 'nlp|yes|abnormal' scene-graph attribute;
  - valid split keeps only 29-region images; test splits into test.csv
    (29 regions) and test-2.csv (fewer).

Image sizes come from the file headers (`image_size`), as the reference's
`imagesize` package reads them: no PIL, no pixel decode. Sentence
boundaries use the rule-based splitter (the reference uses a spacy
transformer pipeline purely for splitting/capitalization).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from rgrg_tpu_torch.core.constants import ANATOMICAL_REGIONS
from rgrg_tpu_torch.data.sections import extract_findings

# permissive boundary for CAPITALIZATION of raw (lowercase) phrases: split
# after ./!/? + whitespace regardless of the next char's case (decimals like
# "1.5" have no whitespace and don't split)
_CAP_BOUNDARY = re.compile(r"(?<=[.!?])\s+(?=\S)")

log = logging.getLogger(__name__)

# failed x-rays without scene graphs (reference constants.py:34-59)
IMAGE_IDS_TO_IGNORE: Set[str] = {
    "0518c887-b80608ca-830de2d5-89acf0e2-bd3ec900",
    "03b2e67c-70631ff8-685825fb-6c989456-621ca64d",
    "786d69d0-08d16a2c-dd260165-682e66e9-acf7e942",
    "1d0bafd0-72c92e4c-addb1c57-40008638-b9ec8584",
    "f55a5fe2-395fc452-4e6b63d9-3341534a-ebb882d5",
    "14a5423b-9989fc33-123ce6f1-4cc7ca9a-9a3d2179",
    "9c42d877-dfa63a03-a1f2eb8c-127c60c3-b20b7e01",
    "996fb121-fab58dd2-7521fd7e-f9f3133c-bc202556",
    "56b8afd3-5f6d4419-8699d79e-6913a2bd-35a08557",
    "93020995-6b84ca33-2e41e00d-5d6e3bee-87cfe5c6",
    "f57b4a53-5fecd631-2fe14e8a-f4780ee0-b8471007",
    "d496943d-153ec9a5-c6dfe4c0-4fb9e57f-675596eb",
    "46b02f13-69fb7e49-321880e4-80584065-c1f57b50m",
    "422689b1-40e06ae8-d6151ff3-2780c186-6bd67271",
    "8385a8ad-ad5e02a8-8e1fa7f3-d822c648-2a41a205",
    "e180a7b6-684946d6-fe1782de-45ed1033-1a6f8a51",
    "f5f82c2f-e99a7a06-6ecc9991-072adb2f-497dae52",
    "6d54a492-7aade003-a238dc5c-019ccdd2-05661649",
    "2b5edbbf-116df0e3-d0fea755-fabd7b85-cbb19d84",
    "db9511e3-ee0359ab-489c3556-4a9b2277-c0bf0369",
    "87495016-a6efd89e-a3697ec7-89a81d53-627a2e13",
    "810a8e3b-2cf85e71-7ed0b3d3-531b6b68-24a5ca89",
    "a9f0620b-6e256cbd-a7f66357-2fe78c8a-49caac26",
    "46b02f13-69fb7e49-321880e4-80584065-c1f57b50",
}

# boilerplate exam headers stripped from phrases (reference constants.py:61;
# grouped here by family for maintainability — joined into one alternation)
_BOILERPLATE_FAMILIES: Tuple[Tuple[str, ...], ...] = (
    ("WET READ VERSION", "WET READ"),
    ("UPRIGHT PORTABLE AP CHEST RADIOGRAPH:", "UPRIGHT AP VIEW OF THE CHEST:",
     "UPRIGHT AP AND LATERAL VIEWS OF THE CHEST:"),
    ("TECHNOLOGIST'S NOTE:", "TECHNIQUE:"),
    ("SUPINE PORTABLE RADIOGRAPH:", "SUPINE PORTABLE CHEST RADIOGRAPHS:",
     "SUPINE PORTABLE CHEST RADIOGRAPH:", "SUPINE PORTABLE AP CHEST RADIOGRAPH:",
     "SUPINE FRONTAL CHEST RADIOGRAPH:", "SUPINE CHEST RADIOGRAPH:",
     "SUPINE AP VIEW OF THE CHEST:"),
    ("SINGLE SUPINE PORTABLE VIEW OF THE CHEST:",
     "SINGLE SEMI-ERECT AP PORTABLE VIEW OF THE CHEST:",
     "SINGLE PORTABLE UPRIGHT CHEST RADIOGRAPH:",
     "SINGLE PORTABLE CHEST RADIOGRAPH:", "SINGLE PORTABLE AP CHEST RADIOGRAPH:",
     "SINGLE FRONTAL VIEW OF THE CHEST:",
     "SINGLE FRONTAL PORTABLE VIEW OF THE CHEST:",
     "SINGLE AP UPRIGHT PORTABLE CHEST RADIOGRAPH:",
     "SINGLE AP UPRIGHT CHEST RADIOGRAPH:", "SINGLE AP PORTABLE CHEST RADIOGRAPH:"),
    ("SEMIERECT PORTABLE RADIOGRAPH OF THE CHEST:",
     "SEMIERECT AP VIEW OF THE CHEST:",
     "SEMI-UPRIGHT PORTABLE RADIOGRAPH OF THE CHEST:",
     "SEMI-UPRIGHT PORTABLE CHEST RADIOGRAPH:",
     "SEMI-UPRIGHT PORTABLE AP RADIOGRAPH OF THE CHEST:",
     "SEMI-UPRIGHT AP VIEW OF THE CHEST:",
     "SEMI-ERECT PORTABLE FRONTAL CHEST RADIOGRAPH:",
     "SEMI-ERECT PORTABLE CHEST:", "SEMI-ERECT PORTABLE CHEST RADIOGRAPH:"),
    ("REPORT:", "PORTABLES SEMI-ERECT CHEST RADIOGRAPH:"),
    ("PORTABLE UPRIGHT FRONTAL VIEW OF THE CHEST:",
     "PORTABLE UPRIGHT AP VIEW OF THE CHEST:",
     "PORTABLE UPRIGHT AP VIEW OF THE ABDOMEN:",
     "PORTABLE SUPINE FRONTAL VIEW OF THE CHEST:",
     "PORTABLE SUPINE FRONTAL CHEST RADIOGRAPH:",
     "PORTABLE SUPINE CHEST RADIOGRAPH:", "PORTABLE SEMI-UPRIGHT RADIOGRAPH:",
     "PORTABLE SEMI-UPRIGHT FRONTAL CHEST RADIOGRAPH:",
     "PORTABLE SEMI-UPRIGHT CHEST RADIOGRAPH:",
     "PORTABLE SEMI-UPRIGHT AP CHEST RADIOGRAPH:",
     "PORTABLE SEMI-ERECT FRONTAL CHEST RADIOGRAPHS:",
     "PORTABLE SEMI-ERECT FRONTAL CHEST RADIOGRAPH:",
     "PORTABLE SEMI-ERECT CHEST RADIOGRAPH:",
     "PORTABLE SEMI-ERECT AP AND PA CHEST RADIOGRAPH:",
     "PORTABLE FRONTAL VIEW OF THE CHEST:", "PORTABLE FRONTAL CHEST RADIOGRAPH:",
     "PORTABLE ERECT RADIOGRAPH:", "PORTABLE CHEST RADIOGRAPH:",
     "PORTABLE AP VIEW OF THE CHEST:", "PORTABLE AP UPRIGHT CHEST RADIOGRAPH:",
     "PORTABLE AP CHEST RADIOGRAPH:"),
    ("PA AND LATERAL VIEWS OF THE CHEST:", "PA AND LATERAL CHEST RADIOGRAPHS:",
     "PA AND LATERAL CHEST RADIOGRAPH:", "PA AND LAT CHEST RADIOGRAPH:",
     "PA AND AP CHEST RADIOGRAPH:"),
    ("NOTIFICATION:", "IMPRESSON:", "IMPRESSION: AP CHEST:", "IMPRESSION: AP",
     "IMPRESSION:", "IMPRESSION AP", "IMPRESSION"),
    ("FRONTAL UPRIGHT PORTABLE CHEST:",
     "FRONTAL UPPER ABDOMINAL RADIOGRAPH, TWO IMAGES:",
     "FRONTAL SUPINE PORTABLE CHEST:", "FRONTAL SEMI-UPRIGHT PORTABLE CHEST:",
     "FRONTAL RADIOGRAPH OF THE CHEST:", "FRONTAL PORTABLE SUPINE CHEST:",
     "FRONTAL PORTABLE CHEST:", "FRONTAL PORTABLE CHEST RADIOGRAPH:",
     "FRONTAL LATERAL VIEWS CHEST:", "FRONTAL LATERAL CHEST RADIOGRAPH:",
     "FRONTAL CHEST RADIOGRAPHS:", "FRONTAL CHEST RADIOGRAPH:",
     "FRONTAL CHEST RADIOGRAPH WITH THE PATIENT IN SUPINE AND UPRIGHT POSITIONS:",
     "FRONTAL AND LATERAL VIEWS OF THE CHEST:",
     "FRONTAL AND LATERAL FRONTAL CHEST RADIOGRAPH:",
     "FRONTAL AND LATERAL CHEST RADIOGRAPHS:",
     "FRONTAL AND LATERAL CHEST RADIOGRAPH:", "FRONTAL"),
    ("FINIDNGS:", "FINDNGS:", "FINDINGS:", "FINDINGS/IMPRESSION:",
     "FINDINGS AND IMPRESSION:", "FINDINGS", "FINDING:",
     "FINAL REPORT FINDINGS:", "FINAL REPORT EXAMINATION:", "FINAL REPORT",
     "FINAL ADDENDUM ADDENDUM:", "FINAL ADDENDUM ADDENDUM",
     r"FINAL ADDENDUM \*\*\*\*\*\*\*\*\*\*ADDENDUM\*\*\*\*\*\*\*\*\*\*\*",
     "FINAL ADDENDUM"),
    ("EXAMINATION: DX CHEST PORT LINE/TUBE PLCMT 1 EXAM",),
    ("CONCLUSION:", "COMPARISONS:", "COMPARISON:", "COMPARISON."),
    ("CHEST:", "CHEST/ABDOMEN RADIOGRAPHS:", "CHEST, TWO VIEWS:",
     "CHEST, SINGLE AP PORTABLE VIEW:", "CHEST, PA AND LATERAL:", "CHEST, AP:",
     "CHEST, AP UPRIGHT:", "CHEST, AP UPRIGHT AND LATERAL:", "CHEST, AP SUPINE:",
     "CHEST, AP SEMI-UPRIGHT:", "CHEST, AP PORTABLE, UPRIGHT:",
     "CHEST, AP AND LATERAL:", "CHEST SUPINE:", "CHEST RADIOGRAPH:",
     "CHEST PA AND LATERAL RADIOGRAPH:", "CHEST AP:"),
    ("BEDSIDE UPRIGHT FRONTAL CHEST RADIOGRAPH:", "AP:", "AP,",
     "AP VIEW OF THE CHEST:", "AP UPRIGHT PORTABLE CHEST RADIOGRAPH:",
     "AP UPRIGHT CHEST RADIOGRAPH:", "AP UPRIGHT AND LATERAL CHEST RADIOGRAPHS:",
     "AP PORTABLE SUPINE CHEST RADIOGRAPH:", "AP PORTABLE CHEST RADIOGRAPH:",
     "AP FRONTAL CHEST RADIOGRAPH:", "AP CHEST:", "AP CHEST RADIOGRAPH:",
     "AP AND LATERAL VIEWS OF THE CHEST:", "AP AND LATERAL CHEST RADIOGRAPHS:",
     "AP AND LATERAL CHEST RADIOGRAPH:"),
    ("5. ", "4. ", "3. ", "2. ", "1. ", "#1 ", "#2 ", "#3 ", "#4 ", "#5 "),
)

BOILERPLATE_RE = re.compile(
    "|".join(p for fam in _BOILERPLATE_FAMILIES for p in fam), re.DOTALL)

_WET_READ_RE = re.compile(r"WET READ.*?(?:AM|PM)", re.DOTALL)


def remove_wet_read(text: str) -> str:
    """Remove 'WET READ: ___ 8:19 AM'-style spans; a span without a
    terminating AM/PM is left in place (reference remove_wet_read,
    create_dataset.py:204-226)."""
    out = []
    i = 0
    while True:
        start = text.find("WET READ", i)
        if start == -1:
            out.append(text[i:])
            break
        out.append(text[i:start])
        j = start + 8
        while j < len(text):
            if text[j:j + 2] in ("AM", "PM") or text[j:j + 8] == "WET READ":
                break
            j += 1
        if text[j:j + 2] in ("AM", "PM"):
            i = j + 2
        else:  # unterminated: keep the text as-is
            out.append(text[start:])
            break
    return "".join(out)


def clean_phrases(phrases: Sequence[str]) -> str:
    """List of raw scene-graph phrases -> one cleaned string (reference
    convert_phrases_to_single_string, create_dataset.py:183-270)."""
    text = " ".join(phrases)
    text = remove_wet_read(text)
    text = BOILERPLATE_RE.sub("", text)
    text = " ".join(text.split())
    if not text:
        return ""
    # capitalize the first word of each sentence
    sents = _CAP_BOUNDARY.split(text)
    text = " ".join(s[0].upper() + s[1:] for s in sents if s)
    # duplicate-sentence removal over ". "-joined units
    if text.endswith("."):
        text = text[:-1]
    units = list(dict.fromkeys(text.split(". ")))
    return ". ".join(units) + "."


def is_abnormal(attributes_list: Sequence[Sequence[str]]) -> bool:
    return any(a == "nlp|yes|abnormal" for attrs in attributes_list for a in attrs)


def box_faulty(x1, y1, x2, y2, width, height) -> bool:
    """Zero-area or fully-outside boxes (create_dataset.py:136-161)."""
    return (x1 == x2 or y1 == y2 or x2 <= 0 or y2 <= 0
            or x1 >= width or y1 >= height)


def clamp(v, hi):
    return 0 if v < 0 else (hi if v > hi else v)


# JPEG start-of-frame markers (SOF0-SOF15 less DHT 0xC4, JPG 0xC8, DAC 0xCC):
# each carries the frame's height and width
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers without a length field: TEM, RST0-7, SOI
_STANDALONE_MARKERS = frozenset([0x01, *range(0xD0, 0xD9)])
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG or PNG from its header alone, as the
    reference's `imagesize` package reads it (and PIL's Image.size): a
    JPEG's first SOFn frame header, past any APPn (EXIF, JFIF, ICC) and
    table segments; a PNG's IHDR chunk. No pixel is decoded."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == _PNG_SIGNATURE and head[12:16] == b"IHDR":
            width, height = struct.unpack(">II", head[16:24])
            return width, height
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG or PNG file")
        f.seek(2)
        while True:
            byte = f.read(1)
            while byte and byte != b"\xff":   # garbage between segments
                byte = f.read(1)
            while byte == b"\xff":            # fill bytes
                byte = f.read(1)
            if not byte:
                break
            marker = byte[0]
            if marker in _STANDALONE_MARKERS:
                continue
            if marker in (0xD9, 0xDA):        # end of image, start of scan
                break
            seg = f.read(2)
            if len(seg) < 2:
                break
            (length,) = struct.unpack(">H", seg)
            if marker in _SOF_MARKERS:
                frame = f.read(5)             # precision, height, width
                if len(frame) < 5:
                    break
                height, width = struct.unpack(">HH", frame[1:])
                return width, height
            f.seek(length - 2, os.SEEK_CUR)
    raise ValueError(f"{path}: no JPEG frame header before the scan")


@dataclasses.dataclass
class EtlPaths:
    chest_imagenome: str   # root with silver_dataset/{scene_graph,splits}
    mimic_cxr: str         # root with files/pXX/pSUBJ/sSTUDY.txt reports
    mimic_cxr_jpg: str     # root with files/.../IMAGE.jpg
    output_dir: str


CSV_HEADER = ["subject_id", "study_id", "image_id", "mimic_image_file_path",
              "bbox_coordinates", "bbox_labels", "bbox_phrases",
              "bbox_phrase_exists", "bbox_is_abnormal"]


def load_images_to_avoid(paths: EtlPaths) -> Set[str]:
    """Gold-standard image ids excluded from train/valid
    (create_dataset.py:555-570)."""
    path = os.path.join(paths.chest_imagenome, "silver_dataset", "splits",
                        "images_to_avoid.csv")
    ids: Set[str] = set()
    if os.path.exists(path):
        with open(path) as f:
            reader = csv.reader(f)
            next(reader, None)
            for row in reader:
                ids.add(row[0])
    return ids


def iter_rows(split: str, paths: EtlPaths, image_ids_to_avoid: Set[str],
              image_size_fn=None, max_rows: Optional[int] = None
              ) -> Iterator[Tuple[List, bool]]:
    """Yields (row, has_29_regions) per usable image of a split.

    image_size_fn(path) -> (width, height); defaults to `image_size`, which
    reads the file's header.
    """
    if image_size_fn is None:
        image_size_fn = image_size

    split_csv = os.path.join(paths.chest_imagenome, "silver_dataset", "splits",
                             f"{split}.csv")
    produced = 0
    with open(split_csv) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            subject_id, study_id, image_id = row[1], row[2], row[3]
            if image_id in IMAGE_IDS_TO_IGNORE or image_id in image_ids_to_avoid:
                continue
            image_path = os.path.join(paths.mimic_cxr_jpg,
                                      row[4].replace(".dcm", ".jpg"))
            if not os.path.exists(image_path):
                log.warning("missing image %s", image_path)
                continue

            reference_report = None
            if split in ("valid", "test"):
                report_path = os.path.join(
                    paths.mimic_cxr, "files", f"p{subject_id[:2]}",
                    f"p{subject_id}", f"s{study_id}.txt")
                if not os.path.exists(report_path):
                    log.warning("missing report %s", report_path)
                    continue
                with open(report_path) as rf:
                    reference_report = extract_findings(rf.read(), study_id)
                if reference_report is None:
                    continue  # skip studies without findings sections

            sg_path = os.path.join(paths.chest_imagenome, "silver_dataset",
                                   "scene_graph", f"{image_id}_SceneGraph.json")
            with open(sg_path) as sf:
                scene = json.load(sf)

            width, height = image_size_fn(image_path)

            region_attrs: Dict[str, Tuple[str, bool]] = {}
            for attr in scene.get("attributes", []):
                name = attr["bbox_name"]
                if name not in ANATOMICAL_REGIONS:
                    continue
                region_attrs[name] = (clean_phrases(attr["phrases"]),
                                      is_abnormal(attr["attributes"]))

            region_boxes = {o["bbox_name"]: [o["original_x1"], o["original_y1"],
                                             o["original_x2"], o["original_y2"]]
                            for o in scene.get("objects", [])}

            coords, labels, phrases, exists, abnormal = [], [], [], [], []
            for name, idx in ANATOMICAL_REGIONS.items():
                bc = region_boxes.get(name)
                if bc is not None and not box_faulty(*bc, width, height):
                    x1, y1, x2, y2 = bc
                    coords.append([clamp(x1, width), clamp(y1, height),
                                   clamp(x2, width), clamp(y2, height)])
                    labels.append(idx + 1)
                phrase, abn = region_attrs.get(name, ("", False))
                phrases.append(phrase)
                exists.append(phrase != "")
                abnormal.append(abn)

            out = [subject_id, study_id, image_id, image_path,
                   coords, labels, phrases, exists, abnormal]
            if reference_report is not None:
                out.append(reference_report)
            yield out, len(labels) == len(ANATOMICAL_REGIONS)
            produced += 1
            if max_rows and produced >= max_rows:
                return


def build_split(split: str, paths: EtlPaths,
                image_ids_to_avoid: Optional[Set[str]] = None,
                max_rows: Optional[int] = None, **kw) -> List[str]:
    """Writes {split}.csv (and test-2.csv for the test split). Returns the
    written paths. Split policy (module docstring of the reference):
    train keeps everything; valid keeps only 29-region images; test splits
    into test.csv (29 regions) / test-2.csv (fewer)."""
    if image_ids_to_avoid is None:
        image_ids_to_avoid = load_images_to_avoid(paths) if split != "test" else set()

    os.makedirs(paths.output_dir, exist_ok=True)
    header = CSV_HEADER + (["reference_report"] if split in ("valid", "test") else [])

    main_path = os.path.join(paths.output_dir, f"{split}.csv")
    written = [main_path]
    main = open(main_path, "w", newline="")
    main_writer = csv.writer(main)
    main_writer.writerow(header)

    second_writer = None
    if split == "test":
        second_path = os.path.join(paths.output_dir, "test-2.csv")
        written.append(second_path)
        second = open(second_path, "w", newline="")
        second_writer = csv.writer(second)
        second_writer.writerow(header)

    try:
        for row, full29 in iter_rows(split, paths, image_ids_to_avoid,
                                     max_rows=max_rows, **kw):
            if split == "train" or full29:
                main_writer.writerow(row)
            elif split == "test":
                second_writer.writerow(row)
            # valid split drops <29-region images entirely
    finally:
        main.close()
        if second_writer is not None:
            second.close()
    return written
