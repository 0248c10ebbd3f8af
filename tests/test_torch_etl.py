"""The port's offline data pipeline against the JAX package's.

- `data/sections.py`: the same tables and patterns, and the same sections
  and findings for every override entry, typo header and the
  last-paragraph rule, and for reports a hypothesis strategy composes from
  the header vocabulary.
- `data/etl.py`: the helpers case for case (tests/test_etl.py's cases and
  more), and `build_split` over tests/etl_corpus.py's synthetic corpus:
  train, valid, test and test-2 csvs byte-identical to JAX's (JAX reads the
  image sizes with PIL, the port from the headers), also with max_rows.
- `image_size` against PIL on baseline, progressive, EXIF/APPn and ICC
  carrying JPEGs, a header-only JPEG and PNGs.
- `data/stats.py` and the three CLIs (`python -m
  rgrg_tpu_torch.{create_dataset,dataset_stats,compute_cider_df}`)
  against scripts/{create_dataset,dataset_stats,compute_cider_df}.py: the
  same csvs, the same printed statistics, the same CIDEr-D frequencies once
  loaded, with an empty and an "NA" reference_report cell left out.
"""

import filecmp
import importlib.util
import pathlib
import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from rgrg_tpu.data import etl as jetl
from rgrg_tpu.data import sections as jsec
from rgrg_tpu.data import stats as jstats
from rgrg_tpu.data.dataset import read_split_csv as j_read_split_csv

from rgrg_tpu_torch.data import etl as tetl
from rgrg_tpu_torch.data import sections as tsec
from rgrg_tpu_torch.data import stats as tstats
from rgrg_tpu_torch.data.dataset import read_split_csv

from tests.etl_corpus import header_only_jpeg, write_corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _sections(mod, text):
    return [(s.name, s.text, s.start) for s in mod.split_sections(text)]


# ------------------------------------------------------------------ sections

def test_section_tables_and_patterns_copied_entry_for_entry():
    assert tsec.HEADER_ALIASES == jsec.HEADER_ALIASES
    assert tsec.MAIN_SECTIONS == jsec.MAIN_SECTIONS
    assert tsec.STUDIES_WITHOUT_FINDINGS == jsec.STUDIES_WITHOUT_FINDINGS
    assert tsec.STUDY_INDEX_OVERRIDES == jsec.STUDY_INDEX_OVERRIDES
    for name in ("_HEADER_RE", "_FINDINGS_PHRASES"):
        assert getattr(tsec, name).pattern == getattr(jsec, name).pattern
        assert getattr(tsec, name).flags == getattr(jsec, name).flags


REPORT = ("                                 FINAL REPORT\n"
          " EXAMINATION:  CHEST (PA AND LAT)\n"
          "\n INDICATION:  Cough and fever.\n"
          "\n COMPARISON:  None.\n"
          "\n FINDINGS: \n"
          " The lungs are clear. The cardiomediastinal silhouette is normal.\n"
          "\n IMPRESSION: \n"
          " No acute cardiopulmonary process.\n")


@pytest.mark.parametrize("study", sorted(jsec.STUDIES_WITHOUT_FINDINGS)
                         + sorted(jsec.STUDY_INDEX_OVERRIDES))
def test_override_studies_skipped_as_in_jax(study):
    for sid in (study, study[1:]):
        assert tetl.extract_findings(REPORT, sid) is None
        assert jetl.extract_findings(REPORT, sid) is None


def test_normalize_header_matches_jax_on_every_table_entry():
    names = (list(jsec.HEADER_ALIASES) + list(jsec.MAIN_SECTIONS)
             + [f"  {k.upper()} " for k in jsec.HEADER_ALIASES]
             + ["final impression", "prior comparisons", "AP CHEST", "frontal view of ribs",
                "pa and lat", "bone windows", "signature", "wet read", "HISTORY OF PRESENT"])
    for name in names:
        assert tsec.normalize_header(name) == jsec.normalize_header(name), name


@pytest.mark.parametrize("text", [
    REPORT,
    "\n FINDNGS:  \n Lungs clear.\n",                                  # typo header
    "\n IMPRESSON: \n Stable.\n\n FINIDNGS: Heart ok.\n",               # two typos
    "\n FINDINGS: \n\n INDICATION: x.\n",                              # empty findings
    " INDICATION: Cough.\n",                                           # no newline header
    "no headers at all",
    "\n INDICATION: Cough.\n \n Lungs are clear.\n \n Heart normal.\n",  # last paragraph
    "\n HISTORY: a\n \n b\n \n c\n \n COMPARISON: d\n \n e\n",
    "\n FINDINGS: \n A.\n\n FINDINGS: \n B.\n",                        # the last one wins
    "\n PA AND LATERAL VIEWS OF THE CHEST: \n Clear.\n",               # findings phrase
    "\n CHEST, TWO VIEWS: \n Normal.\n\n FINAL IMPRESSION: \n Ok.\n",
])
def test_split_sections_and_findings_match_jax(text):
    assert _sections(tsec, text) == _sections(jsec, text)
    assert tsec.extract_findings(text, "12345") == jsec.extract_findings(text, "12345")


HEADERS = sorted({k.upper() for k in jsec.HEADER_ALIASES}
                 | {"FINAL IMPRESSION", "PA AND LAT VIEWS", "SIGNATURE", "NOTE", "WETREAD"})
BODIES = ["The lungs are clear.", "", " ", "Heart size normal.\n \nNo effusion.",
          "PORTABLE CHEST: ok", "\n", "x:\n", "Stable, unchanged (prior)."]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.sampled_from(HEADERS), st.sampled_from(BODIES),
                          st.sampled_from(["\n ", "\n", "\n \n ", " "])),
                max_size=6),
       st.sampled_from(["", "FINAL REPORT\n", "   \n"]))
def test_composed_reports_match_jax(parts, preamble):
    text = preamble + "".join(f"{sep}{h}: {body}\n" for h, body, sep in parts)
    assert _sections(tsec, text) == _sections(jsec, text)
    assert tsec.extract_findings(text, "57") == jsec.extract_findings(text, "57")


# ------------------------------------------------------------------ etl helpers

def test_etl_constants_copied():
    assert tetl.IMAGE_IDS_TO_IGNORE == jetl.IMAGE_IDS_TO_IGNORE
    assert tetl._BOILERPLATE_FAMILIES == jetl._BOILERPLATE_FAMILIES
    for name in ("BOILERPLATE_RE", "_WET_READ_RE", "_CAP_BOUNDARY"):
        assert getattr(tetl, name).pattern == getattr(jetl, name).pattern
        assert getattr(tetl, name).flags == getattr(jetl, name).flags
    assert tetl.CSV_HEADER == jetl.CSV_HEADER
    assert list(tetl.ANATOMICAL_REGIONS.items()) == list(jetl.ANATOMICAL_REGIONS.items())


@pytest.mark.parametrize("phrases,want", [
    (["PORTABLE CHEST RADIOGRAPH: The heart is normal."], "The heart is normal."),
    (["WET READ: ___ ___ 8:19 AM heart ok PM", "lungs are clear."], None),
    (["the heart is normal. the heart is normal.", "lungs clear."],
     "The heart is normal. Lungs clear."),
    ([""], ""),
    (["   "], ""),
    (["WET READ VERSION pending review"], "Pending review."),
    (["WET READ: unterminated, no meridiem"], None),
    (["1. ett 4.5 cm above the carina. 2. no effusion!  really?"], None),
    (["FINDINGS: lungs clear.", "IMPRESSION: lungs clear."], "Lungs clear."),
    (["CHEST, PA AND LATERAL: a.b. c"], None),
])
def test_clean_phrases_matches_jax(phrases, want):
    got = tetl.clean_phrases(phrases)
    assert got == jetl.clean_phrases(phrases)
    if want is not None:
        assert got == want
    assert "WET READ" not in got


@pytest.mark.parametrize("text", [
    "a WET READ: x 8:19 AM b", "WET READ x PM WET READ y AM z", "WET READ no end",
    "WET READ a WET READ b AM", "no span", "", "AM WET READ"])
def test_remove_wet_read_matches_jax(text):
    assert tetl.remove_wet_read(text) == jetl.remove_wet_read(text)


def test_abnormal_box_rules_and_clamp_match_jax():
    for attrs, want in ((
            [["anatomicalfinding|no|lung opacity"], ["nlp|yes|abnormal"]], True),
            ([["nlp|yes|normal"]], False), ([], False), ([[]], False)):
        assert tetl.is_abnormal(attrs) == jetl.is_abnormal(attrs) == want
    for box, want in (((0, 0, 0, 10), True), ((-5, -5, -1, 10), True),
                      ((150, 0, 160, 10), True), ((-5, 0, 50, 10), False),
                      ((0, 100, 10, 120), True), ((5, 5, 5.5, 6), False),
                      ((0, 0, 10, 0), True), ((0, -9, 10, 0), True)):
        assert tetl.box_faulty(*box, 100, 100) == jetl.box_faulty(*box, 100, 100) == want
    for v, want in ((-3, 0), (130, 100), (42, 42), (100.5, 100), (-0.5, 0), (7.25, 7.25)):
        assert tetl.clamp(v, 100) == jetl.clamp(v, 100) == want
        assert type(tetl.clamp(v, 100)) is type(jetl.clamp(v, 100))


# ------------------------------------------------------------------ build_split

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("etl")))


def _paths(mod, corpus, out):
    return mod.EtlPaths(corpus["chest_imagenome"], corpus["mimic_cxr"],
                        corpus["mimic_cxr_jpg"], str(out))


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_build_split_csvs_byte_identical_to_jax(corpus, tmp_path, split):
    jp, tp = _paths(jetl, corpus, tmp_path / "jax"), _paths(tetl, corpus, tmp_path / "port")
    assert tetl.load_images_to_avoid(tp) == jetl.load_images_to_avoid(jp)
    assert len(tetl.load_images_to_avoid(tp)) == 3
    want = jetl.build_split(split, jp)            # image sizes through PIL
    got = tetl.build_split(split, tp)             # image sizes from the headers
    assert [pathlib.Path(p).name for p in got] == [pathlib.Path(p).name for p in want]
    for g, w in zip(got, want):
        assert filecmp.cmp(g, w, shallow=False), g
    rows = [r for p in got for r in read_split_csv(p)]
    assert rows
    assert all(len(r["bbox_phrases"]) == 29 for r in rows)
    for r in rows:
        h, w = corpus["images"][r["mimic_image_file_path"]]
        assert all(0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                   for x1, y1, x2, y2 in r["bbox_coordinates"])
    if split == "test":
        full, fewer = (read_split_csv(p) for p in got)
        assert len(full) >= 8 and len(fewer) >= 8
        assert all(len(r["bbox_labels"]) == 29 for r in full)
        assert all(len(r["bbox_labels"]) < 29 for r in fewer)
    if split == "valid":
        assert all(len(r["bbox_labels"]) == 29 for r in rows)
    if split != "train":
        assert all(isinstance(r["reference_report"], str) and r["reference_report"]
                   for r in rows)
    ids = {r["image_id"] for r in rows}
    assert tetl.IMAGE_IDS_TO_IGNORE.isdisjoint(ids)
    if split != "test":
        assert ids.isdisjoint(tetl.load_images_to_avoid(tp))


def test_build_split_max_rows_matches_jax(corpus, tmp_path):
    jp, tp = _paths(jetl, corpus, tmp_path / "jax"), _paths(tetl, corpus, tmp_path / "port")
    for g, w in zip(tetl.build_split("test", tp, max_rows=5, image_ids_to_avoid=set()),
                    jetl.build_split("test", jp, max_rows=5, image_ids_to_avoid=set())):
        assert filecmp.cmp(g, w, shallow=False)
    assert sum(len(read_split_csv(p)) for p in tetl.build_split("train", tp, max_rows=3)) == 3


# ------------------------------------------------------------------ image sizes

def test_image_size_reads_headers_as_pil_does(tmp_path):
    rng = np.random.default_rng(0)
    exif = Image.Exif()
    exif[0x0112] = 6                      # orientation: PIL's size ignores it
    exif[0x010F] = "synthetic"
    cases = []
    for i, (h, w) in enumerate(((2048, 2500), (2500, 2048), (37, 91), (1, 1))):
        img = Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8))
        for kind, kw in (("baseline", {}), ("progressive", {"progressive": True}),
                         ("exif", {"exif": exif}),
                         ("appn", {"icc_profile": bytes(300), "comment": b"cxr" * 40,
                                   "dpi": (300, 300)}),
                         ("optimized", {"optimize": True, "quality": 40})):
            p = tmp_path / f"{i}_{kind}.jpg"
            img.save(p, "JPEG", **kw)
            cases.append(p)
        png = tmp_path / f"{i}.png"
        img.save(png)
        rgb = tmp_path / f"{i}_rgb.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(rgb)
        hdr = tmp_path / f"{i}_header_only.jpg"
        header_only_jpeg(str(hdr), h, w)
        cases += [png, rgb, hdr]
    cv2_png = tmp_path / "cv2.png"
    cv2.imwrite(str(cv2_png), rng.integers(0, 256, (30, 20), dtype=np.uint8))
    cases.append(cv2_png)
    for p in cases:
        with Image.open(p) as im:
            assert tetl.image_size(str(p)) == im.size, p.name
    bad = tmp_path / "x.jpg"
    bad.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError):
        tetl.image_size(str(bad))
    truncated = tmp_path / "t.jpg"
    truncated.write_bytes((tmp_path / "0_exif.jpg").read_bytes()[:40])
    with pytest.raises(ValueError):
        tetl.image_size(str(truncated))


# ------------------------------------------------------------------ stats

def _pngs(tmp_path, n, seed, same_after=None):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        if same_after is None or i <= same_after:
            img = rng.integers(0, 256, (24 + i, 40), dtype=np.uint8)
        p = tmp_path / f"px{seed}_{i}.png"
        cv2.imwrite(str(p), img)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("tolerance,patience", [(1e-4, 10), (1e-3, 3), (0.5, 2)])
def test_compute_mean_std_matches_jax(tmp_path, tolerance, patience):
    # X-rays that stop changing after the fourth: the running values hold
    # still, and the patience break returns the previous step's values
    paths = _pngs(tmp_path, 14, seed=1, same_after=3)
    got = tstats.compute_mean_std(paths, tolerance=tolerance, patience=patience)
    assert got == jstats.compute_mean_std(paths, tolerance=tolerance, patience=patience)
    assert all(np.isfinite(got)) and 0 < got[0] < 1 and 0 < got[1] < 1
    assert tstats.compute_mean_std([]) == jstats.compute_mean_std([]) == (0.0, 0.0)


def test_dataset_stats_and_cider_frequencies_match_jax(corpus, tmp_path):
    tp = _paths(tetl, corpus, tmp_path)
    for split in ("train", "valid", "test"):
        for p in tetl.build_split(split, tp):
            assert tstats.dataset_stats(read_split_csv(p)) == \
                jstats.dataset_stats(j_read_split_csv(p))
    for text in ("The ETT tip is 4.5cm above the carina; no PTX.", "", "a--b ... (c)"):
        assert tstats.wordpunct_lower(text) == jstats.wordpunct_lower(text)
    reports = [r["reference_report"] for r in read_split_csv(str(tmp_path / "test.csv"))]
    got = tstats.compute_cider_doc_frequencies(reports, save_path=str(tmp_path / "t.gz"))
    want = jstats.compute_cider_doc_frequencies(reports, save_path=str(tmp_path / "j.gz"))
    assert got == want and got[1] == np.log(len(reports))
    assert tstats.load_cider_doc_frequencies(str(tmp_path / "t.gz")) == \
        jstats.load_cider_doc_frequencies(str(tmp_path / "j.gz"))


# ------------------------------------------------------------------ the CLIs

def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    capsys.readouterr()
    _script(name).main()
    return capsys.readouterr().out


def _run_port(name, args, capsys):
    mod = importlib.import_module(f"rgrg_tpu_torch.{name}")
    capsys.readouterr()
    mod.main(args)
    return capsys.readouterr().out



def test_create_dataset_cli_matches_jax_script(corpus, tmp_path, monkeypatch, capsys):
    out = tmp_path / "splits"
    args = ["--chest-imagenome", corpus["chest_imagenome"], "--mimic-cxr", corpus["mimic_cxr"],
            "--mimic-cxr-jpg", corpus["mimic_cxr_jpg"], "--output-dir", str(out)]
    printed = _run_script("create_dataset", args, monkeypatch, capsys)
    want = {p.name: p.read_bytes() for p in out.iterdir()}
    assert sorted(want) == ["test-2.csv", "test.csv", "train.csv", "valid.csv"]
    for p in out.iterdir():
        p.unlink()
    assert _run_port("create_dataset", args, capsys) == printed
    assert {p.name: p.read_bytes() for p in out.iterdir()} == want
    assert printed.count(": wrote [") == 3
    sample = tmp_path / "sample"
    args[-1] = str(sample)
    assert _run_port("create_dataset", args + ["--splits", "test", "--max-rows", "2"],
                     capsys).startswith("test: wrote [")
    assert len(read_split_csv(str(sample / "test.csv"))) + \
        len(read_split_csv(str(sample / "test-2.csv"))) == 2


def test_dataset_stats_cli_matches_jax_script(corpus, tmp_path, monkeypatch, capsys):
    tp = _paths(tetl, corpus, tmp_path)
    csvs = [p for s in ("train", "valid", "test") for p in tetl.build_split(s, tp)]
    printed = _run_script("dataset_stats", ["--csv"] + csvs, monkeypatch, capsys)
    assert _run_port("dataset_stats", ["--csv"] + csvs, capsys) == printed
    assert printed.count('"ratio_normal_to_abnormal"') == 4
    # --mean-std over readable image files: the train rows pointed at PNGs
    rows = (tmp_path / "train.csv").read_text().splitlines()
    pngs = _pngs(tmp_path, len(rows) - 1, seed=2)
    px = tmp_path / "train_px.csv"
    px.write_text("\n".join([rows[0]] + [r.replace(r.split(",")[3], p, 1)
                                         for r, p in zip(rows[1:], pngs)]) + "\n")
    args = ["--csv", str(px), "--mean-std"]
    printed = _run_script("dataset_stats", args, monkeypatch, capsys)
    assert _run_port("dataset_stats", args, capsys) == printed
    assert '"pixel_mean"' in printed and '"pixel_std"' in printed


def test_compute_cider_df_cli_leaves_out_empty_reports_as_jax(corpus, tmp_path, monkeypatch,
                                                              capsys):
    tp = _paths(tetl, corpus, tmp_path)
    valid = tetl.build_split("valid", tp)[0]
    lines = pathlib.Path(valid).read_text().splitlines()
    n = len(lines) - 1
    assert n >= 3
    # an empty reference_report cell and pandas' "NA" spelling: both NaN
    lines[1] = lines[1][:lines[1].rindex(",") + 1]
    lines[2] = lines[2][:lines[2].rindex(",") + 1] + "NA"
    edited = tmp_path / "valid_na.csv"
    edited.write_text("\n".join(lines) + "\n")
    rows = read_split_csv(str(edited), usecols=["reference_report"])
    assert sum(isinstance(r["reference_report"], str) for r in rows) == n - 2
    out = str(tmp_path / "df.bin.gz")
    args = ["--valid-csv", str(edited), "--output", out]
    printed = _run_script("compute_cider_df", args, monkeypatch, capsys)
    want = jstats.load_cider_doc_frequencies(out)
    pathlib.Path(out).unlink()
    assert _run_port("compute_cider_df", args, capsys) == printed
    assert printed == f"wrote {out} ({n - 2} reports)\n"
    got = tstats.load_cider_doc_frequencies(out)
    assert got == want and got[1] == np.log(n - 2)
    assert all(isinstance(k, tuple) and v >= 1 for k, v in got[0].items())
