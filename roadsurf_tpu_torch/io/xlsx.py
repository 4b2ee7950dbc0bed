"""Minimal XLSX reader and writer (a copy of the reference package's
``io/xlsx.py``; no openpyxl).

Label preparation reads data/roads_parameters.xlsx, a single-sheet table
with a header row (columns 'GDB-Code', 'Type', 'to keep', 'Definition',
'Width'). The writer makes single-sheet files with inline strings."""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET

import numpy as np
import pandas as pd

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_index(ref: str) -> int:
    """'C7' -> 2 (zero-based column)."""
    letters = re.match(r"([A-Z]+)", ref).group(1)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - 64)
    return idx - 1


def read_xlsx(path: str, sheet: int = 0, header: int = 0) -> pd.DataFrame:
    with zipfile.ZipFile(path) as z:
        shared: list[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or ""
                                      for t in si.iter(
                                          f"{{{_NS['m']}}}t")))
        sheets = sorted(n for n in z.namelist()
                        if re.match(r"xl/worksheets/sheet\d+\.xml$", n))
        root = ET.fromstring(z.read(sheets[sheet]))

    rows: dict[int, dict[int, object]] = {}
    maxcol = 0
    for row in root.iter(f"{{{_NS['m']}}}row"):
        r = int(row.get("r")) - 1
        for c in row.findall("m:c", _NS):
            ref = c.get("r")
            ci = _col_index(ref) if ref else 0
            t = c.get("t", "n")
            v = c.find("m:v", _NS)
            if v is None:
                is_ = c.find("m:is", _NS)
                val = ("".join(e.text or "" for e in is_.iter(
                    f"{{{_NS['m']}}}t")) if is_ is not None else None)
            elif t == "s":
                val = shared[int(v.text)]
            elif t == "b":
                val = bool(int(v.text))
            elif t == "str":
                val = v.text
            else:
                try:
                    fv = float(v.text)
                    val = int(fv) if fv.is_integer() else fv
                except (TypeError, ValueError):
                    val = v.text
            rows.setdefault(r, {})[ci] = val
            maxcol = max(maxcol, ci)

    if not rows:
        return pd.DataFrame()
    nrows = max(rows) + 1
    grid = [[rows.get(r, {}).get(c) for c in range(maxcol + 1)]
            for r in range(nrows)]
    headers = [h if h is not None else f"Unnamed: {i}"
               for i, h in enumerate(grid[header])]
    body = grid[header + 1:]
    df = pd.DataFrame(body, columns=headers)
    # numeric columns with missing cells -> float with NaN (pandas behaviour)
    for col in df.columns:
        s = df[col]
        if s.map(lambda x: x is None or isinstance(x, (int, float))).all():
            has_none = s.isna().any() or s.map(lambda x: x is None).any()
            if s.map(lambda x: isinstance(x, (int, float))).any():
                df[col] = s.map(
                    lambda x: np.nan if x is None else float(x)
                    if has_none or isinstance(x, float) else x)
    return df


def read_excel(path: str, sheet_name=0, header: int = 0,
               **kwargs) -> pd.DataFrame:
    """pandas.read_excel-compatible front end (positional sheet index only;
    unsupported pandas kwargs raise instead of being ignored)."""
    if kwargs:
        raise TypeError(f"unsupported read_excel arguments: {sorted(kwargs)}")
    if not isinstance(sheet_name, int):
        raise TypeError("sheet_name must be an integer index")
    return read_xlsx(path, sheet=sheet_name, header=header)


# ---------------------------------------------------------------------------
# writer (fixtures / exports; single sheet, inline strings)

_XLSX_STATIC = {
    "[Content_Types].xml": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/></Types>'),
    "_rels/.rels": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships"><Relationship Id="rId1" Type="http://schemas.'
        'openxmlformats.org/officeDocument/2006/relationships/officeDocument"'
        ' Target="xl/workbook.xml"/></Relationships>'),
    "xl/workbook.xml": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
        '2006/main" xmlns:r="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships"><sheets>'
        '<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'),
    "xl/_rels/workbook.xml.rels": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships"><Relationship Id="rId1" Type="http://schemas.'
        'openxmlformats.org/officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'),
}


def _cell_ref(r: int, c: int) -> str:
    letters = ""
    c += 1
    while c:
        c, rem = divmod(c - 1, 26)
        letters = chr(65 + rem) + letters
    return f"{letters}{r + 1}"


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def write_xlsx(df: pd.DataFrame, path: str) -> None:
    """Write a single-sheet xlsx with inline strings (round-trips through
    :func:`read_xlsx`)."""
    cells = []
    grid = [list(df.columns)] + df.values.tolist()
    for r, row in enumerate(grid):
        parts = []
        for c, val in enumerate(row):
            ref = _cell_ref(r, c)
            if val is None or (isinstance(val, float) and np.isnan(val)):
                continue
            if isinstance(val, bool):
                parts.append(f'<c r="{ref}" t="b"><v>{int(val)}</v></c>')
            elif isinstance(val, (int, float, np.integer, np.floating)):
                parts.append(f'<c r="{ref}"><v>{val}</v></c>')
            else:
                parts.append(f'<c r="{ref}" t="inlineStr"><is><t>'
                             f'{_xml_escape(str(val))}</t></is></c>')
        cells.append(f'<row r="{r + 1}">{"".join(parts)}</row>')
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>'
             + "".join(cells) + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, content in _XLSX_STATIC.items():
            z.writestr(name, content)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
