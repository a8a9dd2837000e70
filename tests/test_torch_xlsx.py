"""The port's xlsx reader and writer (gpscore_torch/data/xlsx_lite.py) and the
.xlsx branch of its load_kin40k, against the JAX package's on the same files.
Every workbook is written here, with write_sheets; values round-trip exactly
(a float32 written as its shortest float64 repr reads back as itself).
"""

import zipfile

import numpy as np
import pytest

from gpscore.data import kin40k as jax_kin40k
from gpscore.data import xlsx_lite as jax_xlsx
from gpscore_torch.data import (kin40k_replicate_split, load_kin40k, synthesize_kin40k_like,
                                xlsx_lite)

WRITERS = {"port": xlsx_lite.write_sheets, "jax": jax_xlsx.write_sheets}
READERS = {"port": xlsx_lite.read_sheets, "jax": jax_xlsx.read_sheets}


def _sheets():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 3)).astype(np.float32)
    holes = a.copy()
    holes[2, 1] = np.nan
    return {"alpha": a, "beta": rng.standard_normal(5).astype(np.float32), "gamma": holes}


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_round_trip_between_the_two_packages(tmp_path, writer, reader):
    """Several sheets, a 1-D sheet (one row) and a NaN (an empty cell), written
    by one package and read by the other, and by the port alone."""
    sheets = _sheets()
    path = str(tmp_path / "wb.xlsx")
    WRITERS[writer](path, sheets)
    back = READERS[reader](path)
    assert list(back) == list(sheets)
    np.testing.assert_array_equal(back["alpha"], sheets["alpha"])
    np.testing.assert_array_equal(back["beta"], sheets["beta"].reshape(1, -1))
    np.testing.assert_array_equal(back["gamma"], sheets["gamma"])
    assert all(v.dtype == np.float32 for v in back.values())


def test_the_two_writers_write_the_same_cells(tmp_path):
    sheets = _sheets()
    for name, write in WRITERS.items():
        write(str(tmp_path / f"{name}.xlsx"), sheets)
    parts = {}
    for name in WRITERS:
        with zipfile.ZipFile(tmp_path / f"{name}.xlsx") as zf:
            parts[name] = {n: zf.read(n) for n in zf.namelist() if n.startswith("xl/worksheets/")}
    assert parts["port"] == parts["jax"] and len(parts["port"]) == 3


def test_named_sheets_and_a_missing_sheet(tmp_path):
    path = str(tmp_path / "wb.xlsx")
    xlsx_lite.write_sheets(path, _sheets())
    assert list(xlsx_lite.read_sheets(path, ["gamma", "beta"])) == ["gamma", "beta"]
    with pytest.raises(KeyError, match="missing sheets"):
        xlsx_lite.read_sheets(path, ["nope"])


@pytest.mark.parametrize("cols", [26, 27, 30, 703])
def test_wide_columns_round_trip(tmp_path, cols):
    """Column letters past 'Z' ('AA' is column 26, 'AAA' column 702)."""
    arr = np.arange(2 * cols, dtype=np.float32).reshape(2, cols)
    path = str(tmp_path / "wide.xlsx")
    xlsx_lite.write_sheets(path, {"w": arr})
    np.testing.assert_array_equal(xlsx_lite.read_sheets(path)["w"], arr)
    np.testing.assert_array_equal(jax_xlsx.read_sheets(path)["w"], arr)


@pytest.mark.parametrize("idx,letters", [(0, "A"), (25, "Z"), (26, "AA"), (51, "AZ"), (52, "BA"),
                                         (701, "ZZ"), (702, "AAA")])
def test_column_letters_are_bijective_base_26(idx, letters):
    assert xlsx_lite.column_letters(idx) == letters == jax_xlsx._col_letters(idx)
    assert xlsx_lite.column_index(letters) == idx == jax_xlsx._col_index(letters)


def _with_cell(path, old, new):
    """Rewrite the workbook with one cell's XML replaced."""
    with zipfile.ZipFile(path) as zf:
        parts = {n: zf.read(n) for n in zf.namelist()}
    sheet = "xl/worksheets/sheet1.xml"
    assert old in parts[sheet]
    parts[sheet] = parts[sheet].replace(old, new)
    with zipfile.ZipFile(path, "w") as zf:
        for n, raw in parts.items():
            zf.writestr(n, raw)


@pytest.mark.parametrize("cell,match", [
    (b'<c r="A1" t="str"><v>header</v></c>', "non-numeric"),
    (b'<c r="A1" t="b"><v>1</v></c>', "unsupported cell type"),
])
def test_a_cell_that_is_no_number_is_refused(tmp_path, cell, match):
    path = str(tmp_path / "bad.xlsx")
    xlsx_lite.write_sheets(path, {"s": np.ones((2, 2), np.float32)})
    _with_cell(path, b'<c r="A1"><v>1.0</v></c>', cell)
    with pytest.raises(ValueError, match=match):
        xlsx_lite.read_sheets(path)


def test_numeric_strings_and_cells_without_a_reference_are_read(tmp_path):
    """A string cell that parses as a number is one (t="str"); a cell with no
    r attribute follows its left neighbour."""
    path = str(tmp_path / "s.xlsx")
    xlsx_lite.write_sheets(path, {"s": np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)})
    _with_cell(path, b'<c r="B1"><v>2.0</v></c>', b'<c t="str"><v>2.5</v></c>')
    want = np.array([[1.0, 2.5], [3.0, 4.0]], np.float32)
    np.testing.assert_array_equal(xlsx_lite.read_sheets(path)["s"], want)
    np.testing.assert_array_equal(jax_xlsx.read_sheets(path)["s"], want)


def test_an_empty_sheet_reads_as_an_empty_array(tmp_path):
    path = str(tmp_path / "e.xlsx")
    xlsx_lite.write_sheets(path, {"e": np.full((2, 2), np.nan, np.float32)})
    assert xlsx_lite.read_sheets(path)["e"].shape == (0, 0)


def test_more_than_two_dimensions_are_refused(tmp_path):
    with pytest.raises(ValueError, match="1-D or 2-D"):
        xlsx_lite.write_sheets(str(tmp_path / "x.xlsx"), {"x": np.zeros((2, 2, 2))})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_kin40k_reads_the_workbook_as_the_jax_package_does(tmp_path, writer):
    """The reference's on-disk format, sheets trainx/trainy/testx/testy: the
    port's loader returns the arrays that were written and that the JAX
    package's loader returns for the same file, and the replicate protocol
    runs on them."""
    d = synthesize_kin40k_like(n_pool=40, n_test=20)
    path = str(tmp_path / "kin40k.xlsx")
    WRITERS[writer](path, {"trainx": d.train_x, "trainy": d.train_y.reshape(-1, 1),
                           "testx": d.test_x, "testy": d.test_y.reshape(-1, 1)})
    got, want = load_kin40k(path), jax_kin40k.load_kin40k(path)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(d, f))
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
        assert getattr(got, f).dtype == np.float32
    s = kin40k_replicate_split(got, 0, n_subsample=10, n_va=5, n_test=10)
    assert s.train_x.shape == (10, 8) and s.test_y.shape == (10,)


def test_load_kin40k_names_a_missing_sheet(tmp_path):
    path = str(tmp_path / "kin40k.xlsx")
    xlsx_lite.write_sheets(path, {"trainx": np.ones((3, 8), np.float32)})
    with pytest.raises(KeyError, match="missing sheets"):
        load_kin40k(path)
