"""MIMIC-CXR report section splitting (the port's own copy).

Same published segmentation rules as the MIT-LCP mimic-cxr section parser,
and the same tables, as the JAX package's `data/sections.py`:

  - sections start at lines matching an ALL-CAPS "HEADER:" pattern;
  - text before the first header is the "preamble";
  - header names are normalized through a frequency/typo table, then by
    main-section substring containment, then by findings-phrase patterns;
  - empty impression/findings sections are dropped;
  - when neither impression nor findings exist, the last paragraph is split
    out as "last_paragraph";
  - per-study overrides for reports known to lack a findings section.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_HEADER_RE = re.compile(r"\n ([A-Z ()/,-]+):\s", re.DOTALL)

# normalized header names: exact-match table (frequent names + observed typos)
HEADER_ALIASES: Dict[str, str] = {
    "preamble": "preamble", "impression": "impression",
    "comparison": "comparison", "indication": "indication",
    "findings": "findings", "examination": "examination",
    "technique": "technique", "history": "history",
    "comparisons": "comparison", "clinical history": "history",
    "reason for examination": "indication", "notification": "notification",
    "reason for exam": "indication", "clinical information": "history",
    "exam": "examination", "clinical indication": "indication",
    "conclusion": "impression", "chest, two views": "findings",
    "recommendation(s)": "recommendations", "type of examination": "examination",
    "reference exam": "comparison", "patient history": "history",
    "addendum": "addendum", "comparison exam": "comparison", "date": "date",
    "comment": "comment", "findings and impression": "impression",
    "wet read": "wet read", "comparison film": "comparison",
    "recommendations": "recommendations", "findings/impression": "impression",
    "pfi": "history", "recommendation": "recommendations",
    "wetread": "wet read", "ndication": "impression",
    "impresson": "impression", "imprression": "impression",
    "imoression": "impression", "impressoin": "impression",
    "imprssion": "impression", "impresion": "impression",
    "imperssion": "impression", "mpression": "impression",
    "impession": "impression", "findings/ impression": "impression",
    "finding": "findings", "findins": "findings", "findindgs": "findings",
    "findgings": "findings", "findngs": "findings", "findnings": "findings",
    "finidngs": "findings", "idication": "indication",
    "reference findings": "findings", "comparision": "comparison",
    "comparsion": "comparison", "comparrison": "comparison",
    "comparisions": "comparison",
}

MAIN_SECTIONS = ("impression", "findings", "history", "comparison", "addendum")

_FINDINGS_PHRASES = re.compile(
    "(" + "|".join([
        "chest", "portable", "pa and lateral", "lateral and pa",
        "ap and lateral", "lateral and ap", "frontal and", "two views",
        "frontal view", "pa view", "ap view", "one view", "lateral view",
        "bone window", "frontal upright", "frontal semi-upright", "ribs",
        "pa and lat"]) + ")")


def normalize_header(name: str) -> str:
    name = name.lower().strip()
    alias = HEADER_ALIASES.get(name)
    if alias is not None:
        return alias
    for main in MAIN_SECTIONS:
        if main in name:
            return main
    if _FINDINGS_PHRASES.search(name):
        return "findings"
    return name


@dataclasses.dataclass
class Section:
    name: str
    text: str
    start: int


def split_sections(text: str) -> List[Section]:
    """Split a raw report into normalized sections."""
    out: List[Section] = []
    match = _HEADER_RE.search(text, 0)
    if not match:
        return [Section("full report", text, 0)]

    out.append(Section("preamble", text[:match.start(1)], 0))
    while match:
        raw_name = match.group(1)
        body_start = match.end()
        # skip past the first newline to avoid bad parses (same rule as the
        # published parser)
        skip = text[body_start:].find("\n")
        if skip == -1:
            skip = 0
        nxt = _HEADER_RE.search(text, body_start + skip)
        body_end = nxt.start() if nxt else len(text)
        out.append(Section(normalize_header(raw_name),
                           text[body_start:body_end], body_start))
        match = nxt

    # drop empty impression/findings sections
    out = [s for s in out
           if not (s.name in ("impression", "findings") and not s.text.strip())]

    names = {s.name for s in out}
    if "impression" not in names and "findings" not in names and out:
        last = out[-1]
        parts = last.text.split("\n \n")
        if len(parts) > 1:
            out[-1] = Section(last.name, parts[0], last.start)
            out.append(Section("last_paragraph", "\n \n".join(parts[1:]),
                               last.start + len(parts[0])))
    return out


# per-study overrides: reports whose parses need fixing (same published
# tables the MIT-LCP tool ships)
STUDIES_WITHOUT_FINDINGS: Dict[str, str] = {
    "s50913680": "recommendations", "s59363654": "examination",
    "s59279892": "technique", "s59768032": "recommendations",
    "s57936451": "indication", "s50058765": "indication",
    "s53356173": "examination", "s53202765": "technique",
    "s50808053": "technique", "s51966317": "indication",
    "s50743547": "examination", "s56451190": "note",
    "s59067458": "recommendations", "s59215320": "examination",
    "s55124749": "indication", "s54365831": "indication",
    "s59087630": "recommendations", "s58157373": "recommendations",
    "s56482935": "recommendations", "s58375018": "recommendations",
    "s54654948": "indication", "s55157853": "examination",
    "s51491012": "history",
}

STUDY_INDEX_OVERRIDES: Dict[str, Tuple[int, int]] = {
    "s50525523": (201, 349), "s57564132": (233, 554), "s59982525": (313, 717),
    "s53488209": (149, 475), "s54875119": (234, 988), "s50196495": (59, 399),
    "s56579911": (59, 218), "s52648681": (292, 631), "s59889364": (172, 453),
    "s53514462": (73, 377), "s59505494": (59, 450), "s53182247": (59, 412),
    "s51410602": (47, 320), "s56412866": (522, 822), "s54986978": (59, 306),
    "s59003148": (262, 505), "s57150433": (61, 394), "s56760320": (219, 457),
    "s59562049": (158, 348), "s52674888": (145, 296), "s55258338": (192, 568),
    "s59330497": (140, 655), "s52119491": (179, 454),
    "s58235663": (0, 0), "s50798377": (0, 0), "s54168089": (0, 0),
    "s53071062": (0, 0), "s56724958": (0, 0), "s54231141": (0, 0),
    "s53607029": (0, 0), "s52035334": (0, 0),
}


def extract_findings(report_text: str, study_id: str) -> Optional[str]:
    """Findings section of a report, whitespace-normalized, or None when the
    study has no findings (reference get_reference_report,
    create_dataset.py:290-322: custom-rule studies are skipped outright)."""
    key = f"s{study_id}" if not study_id.startswith("s") else study_id
    if key in STUDIES_WITHOUT_FINDINGS or key in STUDY_INDEX_OVERRIDES:
        return None
    sections = split_sections(report_text)
    findings = [s for s in sections if s.name == "findings"]
    if not findings:
        return None
    # reference picks the LAST findings section (reverse index search)
    return " ".join(findings[-1].text.split())
