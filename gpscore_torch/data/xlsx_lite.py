"""Numeric ``.xlsx`` workbooks on the standard library (the port's own copy
of `gpscore/data/xlsx_lite.py`; numpy, ``zipfile`` and ``ElementTree`` only).

The reference keeps KIN40K in ``kin40k.xlsx``, sheets trainx/trainy/testx/testy
(`kin40k-FULL-compare.py:197-200`). An ``.xlsx`` file is a zip of small XML
parts, and for plain numeric sheets a reader needs no spreadsheet engine.

- :func:`read_sheets`: sheet name -> float32 2-D array. Every row is a data
  row (``pd.read_excel(..., header=None)``). A cell is numeric
  (``<c r="B3"><v>1.5</v></c>``, with or without ``t="n"``), or a string or
  shared string that parses as a number; an empty or missing cell is NaN;
  anything else raises ``ValueError`` naming the cell.
- :func:`write_sheets`: the inverse, numeric inline values only; NaN becomes
  an empty cell. The tests write their workbooks with it.

:func:`gpscore_torch.data.kin40k.load_kin40k` reads with this module when
pandas has no xlsx engine.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, Iterable, List, Optional
from xml.etree import ElementTree as ET

import numpy as np

_DECL = '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
_MAIN = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_DOC_REL = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
_PKG_REL = "http://schemas.openxmlformats.org/package/2006/relationships"
_CONTENT = "http://schemas.openxmlformats.org/package/2006/content-types"
_SHEET_TYPE = "application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"
_BOOK_TYPE = "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"
_REF = re.compile(r"([A-Z]+)([0-9]+)")


def _tag(name: str) -> str:
    return f"{{{_MAIN}}}{name}"


def column_index(letters: str) -> int:
    """'A' -> 0, 'Z' -> 25, 'AA' -> 26, ...: bijective base 26."""
    idx = 0
    for ch in letters:
        idx = idx * 26 + ord(ch) - ord("A") + 1
    return idx - 1


def column_letters(idx: int) -> str:
    """The inverse of :func:`column_index`."""
    letters, idx = "", idx + 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return letters


def _sheet_paths(zf: zipfile.ZipFile) -> Dict[str, str]:
    """Sheet name -> the archive path of its worksheet part."""
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    target = {r.get("Id"): r.get("Target") for r in rels.iter(f"{{{_PKG_REL}}}Relationship")}
    paths = {}
    for sheet in ET.fromstring(zf.read("xl/workbook.xml")).iter(_tag("sheet")):
        t = target[sheet.get(f"{{{_DOC_REL}}}id")]
        # A target is absolute ("/xl/...") or relative to xl/.
        paths[sheet.get("name")] = t.lstrip("/") if t.startswith(("/", "xl/")) else "xl/" + t
    return paths


def _shared_strings(zf: zipfile.ZipFile) -> List[str]:
    if "xl/sharedStrings.xml" not in zf.namelist():
        return []
    root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
    return ["".join(t.text or "" for t in si.iter(_tag("t"))) for si in root.iter(_tag("si"))]


def _parse_sheet(raw: bytes, shared: List[str], path: str) -> np.ndarray:
    cells = {}  # (row, col), both 0-based -> value
    row_no = 0
    for row in ET.fromstring(raw).iter(_tag("row")):
        row_no = int(row.get("r", row_no + 1))
        col_no = 0
        for c in row.iter(_tag("c")):
            ref = c.get("r")
            col_no = column_index(_REF.fullmatch(ref).group(1)) + 1 if ref else col_no + 1
            v = c.find(_tag("v"))
            if v is None or v.text is None:
                continue
            kind, text = c.get("t", "n"), v.text
            if kind == "s":
                text = shared[int(text)]
            elif kind not in ("n", "str"):
                raise ValueError(f"{path}: unsupported cell type {kind!r} at {ref}; "
                                 "convert the workbook to .npz or csv")
            try:
                cells[(row_no - 1, col_no - 1)] = float(text)
            except ValueError as e:
                raise ValueError(f"{path}: non-numeric cell {ref} ({text!r}); "
                                 "convert the workbook to .npz or csv") from e
    shape = tuple(1 + max(k[axis] for k in cells) for axis in (0, 1)) if cells else (0, 0)
    out = np.full(shape, np.nan, np.float32)
    for (r, c), val in cells.items():
        out[r, c] = val
    return out


def read_sheets(path: str, names: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """The worksheets ``names`` (default: all) of the workbook at ``path`` as
    float32 arrays; ``KeyError`` for a sheet the workbook does not have."""
    with zipfile.ZipFile(path) as zf:
        paths = _sheet_paths(zf)
        names = list(paths) if names is None else list(names)
        missing = [n for n in names if n not in paths]
        if missing:
            raise KeyError(f"{path}: missing sheets {missing}; has {sorted(paths)}")
        shared = _shared_strings(zf)
        return {n: _parse_sheet(zf.read(paths[n]), shared, paths[n]) for n in names}


def _sheet_xml(name: str, values) -> str:
    arr = np.atleast_2d(np.asarray(values, np.float64))
    if arr.ndim != 2:
        raise ValueError(f"sheet {name!r}: need a 1-D or 2-D array, got {arr.ndim}-D")
    rows = []
    for r, line in enumerate(arr):
        cells = "".join(f'<c r="{column_letters(c)}{r + 1}"><v>{float(v)!r}</v></c>'
                        for c, v in enumerate(line) if not np.isnan(v))
        rows.append(f'<row r="{r + 1}">{cells}</row>')
    return f'{_DECL}<worksheet xmlns="{_MAIN}"><sheetData>{"".join(rows)}</sheetData></worksheet>'


def write_sheets(path: str, sheets: Dict[str, np.ndarray]) -> None:
    """Write 1-D or 2-D numeric arrays as one workbook, a sheet each (a 1-D
    array becomes one row)."""
    ids = range(1, len(sheets) + 1)
    overrides = "".join(f'<Override PartName="/xl/worksheets/sheet{i}.xml" '
                        f'ContentType="{_SHEET_TYPE}"/>' for i in ids)
    sheet_tags = "".join(f'<sheet name="{name}" sheetId="{i}" r:id="rId{i}"/>'
                         for i, name in zip(ids, sheets))
    sheet_rels = "".join(f'<Relationship Id="rId{i}" Type="{_DOC_REL}/worksheet" '
                         f'Target="worksheets/sheet{i}.xml"/>' for i in ids)
    parts = {
        "[Content_Types].xml":
            f'<Types xmlns="{_CONTENT}">'
            '<Default Extension="rels" '
            'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            f'<Override PartName="/xl/workbook.xml" ContentType="{_BOOK_TYPE}"/>'
            f"{overrides}</Types>",
        "_rels/.rels":
            f'<Relationships xmlns="{_PKG_REL}"><Relationship Id="rId1" '
            f'Type="{_DOC_REL}/officeDocument" Target="xl/workbook.xml"/></Relationships>',
        "xl/workbook.xml":
            f'<workbook xmlns="{_MAIN}" xmlns:r="{_DOC_REL}"><sheets>{sheet_tags}</sheets>'
            "</workbook>",
        "xl/_rels/workbook.xml.rels":
            f'<Relationships xmlns="{_PKG_REL}">{sheet_rels}</Relationships>',
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for part, xml in parts.items():
            zf.writestr(part, _DECL + xml)
        for i, (name, values) in zip(ids, sheets.items()):
            zf.writestr(f"xl/worksheets/sheet{i}.xml", _sheet_xml(name, values))
