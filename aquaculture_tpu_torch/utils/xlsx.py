"""Minimal .xlsx sheet reader (zip + XML, no openpyxl dependency).
A copy of aquaculture_tpu/utils/xlsx.py in the PyTorch port.

Covers exactly what the pipeline needs: reading the production-factor
workbook (reference: src/utils_tonnage.py:472 pd.read_excel) — inline
numbers, shared strings, first row as header. Formula cells use their
cached <v> value.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile
from typing import Dict, List, Optional

import pandas as pd

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
_R_NS = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id"


def _col_index(cell_ref: str) -> int:
    """'BC12' -> 0-based column index."""
    col = 0
    for ch in cell_ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def _sheet_path(zf: zipfile.ZipFile, sheet_name: Optional[str]) -> str:
    wb = ET.fromstring(zf.read("xl/workbook.xml"))
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    rel_map = {
        r.get("Id"): r.get("Target")
        for r in rels.iter("{http://schemas.openxmlformats.org/package/2006/relationships}Relationship")
    }
    sheets = wb.find("m:sheets", _NS)
    for sh in sheets:
        if sheet_name is None or sh.get("name") == sheet_name:
            target = rel_map[sh.get(_R_NS)]
            return "xl/" + target.lstrip("/") if not target.startswith("xl/") else target
    raise KeyError(f"sheet {sheet_name!r} not found")


def read_xlsx(path: str, sheet_name: Optional[str] = None, header: bool = True) -> pd.DataFrame:
    """Read one worksheet into a DataFrame (first row as columns)."""
    zf = zipfile.ZipFile(path)
    shared: List[str] = []
    if "xl/sharedStrings.xml" in zf.namelist():
        root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
        for si in root.findall("m:si", _NS):
            shared.append("".join(t.text or "" for t in si.iter("{%s}t" % _NS["m"])))

    sheet = ET.fromstring(zf.read(_sheet_path(zf, sheet_name)))
    rows: Dict[int, Dict[int, object]] = {}
    for row in sheet.iter("{%s}row" % _NS["m"]):
        r = int(row.get("r")) - 1
        for c in row.findall("m:c", _NS):
            ref = c.get("r") or ""
            col = _col_index(ref)
            t = c.get("t", "n")
            v = c.find("m:v", _NS)
            if t == "inlineStr":
                is_el = c.find("m:is", _NS)
                val = "".join(tt.text or "" for tt in is_el.iter("{%s}t" % _NS["m"])) if is_el is not None else None
            elif v is None:
                val = None
            elif t == "s":
                val = shared[int(v.text)]
            elif t == "str":
                val = v.text
            elif t == "b":
                val = bool(int(v.text))
            else:
                try:
                    f = float(v.text)
                    val = int(f) if f.is_integer() and "e" not in v.text.lower() and "." not in v.text else f
                except (TypeError, ValueError):
                    val = v.text
            rows.setdefault(r, {})[col] = val

    if not rows:
        return pd.DataFrame()
    ncol = max(max(cols) for cols in rows.values()) + 1
    nrow = max(rows) + 1
    grid = [[rows.get(r, {}).get(c) for c in range(ncol)] for r in range(nrow)]
    if header:
        cols = [str(c) if c is not None else f"col{i}" for i, c in enumerate(grid[0])]
        return pd.DataFrame(grid[1:], columns=cols)
    return pd.DataFrame(grid)
