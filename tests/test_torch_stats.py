"""The port's statistical toolkit (``roadsurf_tpu_torch/stats``: descriptive
statistics, pixels and zonal statistics, the PCA) against the reference
package's, on the CPU.

1. Every case of tests/test_stats.py runs through the port (the same
   source, its imports pointed at the port; the analysis driver's PCA on
   the CPU, as the port's entry points take the card unless asked).
2. ``calculate_pca`` (PyTorch, float64, ``device="cpu"``) against the
   reference's, scikit-learn's StandardScaler and PCA, on seeded frames in
   both of scikit-learn's solver regimes (N >= 10·F: the covariance's
   eigendecomposition; N < 10·F: a full SVD, N < F among them), each with
   a zero-variance column and a duplicated one (tied loadings): the
   components, explained variances and their ratios and the coordinates
   agree to 1e-9 relative to their largest magnitude. A component whose
   explained variance is 0 (a direction of the null space, which any basis
   spans) is compared by its coordinates alone, which are 0.
3. ``pca_procedure``'s CSV files against the reference's on a pixel frame
   as the analysis builds it: byte for byte, but for values within 1e-9 of
   a rounding boundary of their printed digits, which may differ by one
   unit of the last digit (or in the sign of a printed zero); their count
   is stated.
"""

from __future__ import annotations

import csv
import functools
import inspect
import re
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from roadsurf_tpu.stats import pca as jpca
from roadsurf_tpu_torch.pipeline import stats_analysis as tstats_analysis
from roadsurf_tpu_torch.stats import pca as tpca

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REFERENCE_CASES = ("test_stats.py",)


# ---------------------------------------------------------------------------
# 1. the reference's tests, through the port

def _reference_cases():
    cases = []
    for fname in REFERENCE_CASES:
        src = (TESTS / fname).read_text()
        names = re.findall(r"^def (test_\w+)\(", src, re.M)
        assert len(names) == len(re.findall(r"^def test_", src, re.M))
        cases += [(fname, n) for n in names]
    return cases


@functools.lru_cache(maxsize=None)
def port_module(fname: str) -> types.ModuleType:
    """The reference's test module with every ``roadsurf_tpu`` import
    pointed at ``roadsurf_tpu_torch``; so is that of its helper module
    tests/fixtures.py, whose frames it takes (as ``port_fixtures``)."""
    src = re.sub(r"\broadsurf_tpu\b", "roadsurf_tpu_torch",
                 (TESTS / fname).read_text())
    if fname != "fixtures.py":
        if "port_fixtures" not in sys.modules:
            sys.modules["port_fixtures"] = port_module("fixtures.py")
        src = re.sub(r"^from fixtures import", "from port_fixtures import",
                     src, flags=re.M)
    mod = types.ModuleType(f"port_{fname[:-3]}")
    mod.__file__ = str(TESTS / fname)
    exec(compile(src, f"<{fname} through the port>", "exec"), mod.__dict__)
    return mod


def run_reference_case(fname, name, tmp_path, monkeypatch):
    """One reference case through the port, the analysis on the CPU."""
    monkeypatch.setattr(tstats_analysis, "run", functools.partial(
        tstats_analysis.run, device="cpu"))
    fn = getattr(port_module(fname), name)
    params = inspect.signature(fn).parameters
    assert set(params) <= {"tmp_path"}, params
    fn(**({"tmp_path": tmp_path} if params else {}))


def test_the_reference_cases_are_all_collected():
    assert len(_reference_cases()) == 6


@pytest.mark.parametrize("fname,name", _reference_cases())
def test_reference_case_holds_in_the_port(fname, name, tmp_path,
                                          monkeypatch):
    run_reference_case(fname, name, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# 2. calculate_pca against scikit-learn's

def _frame(n: int, f: int, seed: int) -> tuple[pd.DataFrame, list]:
    """n rows of f correlated features, the fourth constant (zero variance)
    and the last a copy of the one before it (tied loadings)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)) @ rng.normal(size=(f, f)) \
        + rng.uniform(-50, 50, f)
    x[:, 3] = 7.25
    x[:, -1] = x[:, -2]
    feats = [f"f{i}" for i in range(f)]
    df = pd.DataFrame(x, columns=feats)
    df["road_type"] = rng.choice(["artificial", "natural"], n)
    return df, feats


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


PCA_CASES = [  # (N, F, scikit-learn's solver)
    (2400, 12, "covariance_eigh"), (120, 12, "covariance_eigh"),
    (119, 12, "full"), (40, 12, "full"), (9, 12, "full"),
    (6, 5, "full")]


@pytest.mark.parametrize("n,f,solver", PCA_CASES)
def test_calculate_pca_equals_scikit_learns(n, f, solver):
    df, feats = _frame(n, f, seed=n + f)
    want, wcoor = jpca.calculate_pca(df, feats, "road_type", None)
    got, gcoor = tpca.calculate_pca(df, feats, "road_type", None,
                                    device="cpu")
    assert got.solver == solver
    assert got.n_components_ == want.n_components_ == min(n, f)
    assert gcoor.shape == wcoor.shape == (n, min(n, f))
    assert got.components_.shape == want.components_.shape
    ev = want.explained_variance_
    assert _rel(got.explained_variance_, ev) <= 1e-9
    assert _rel(got.explained_variance_ratio_,
                want.explained_variance_ratio_) <= 1e-9
    assert _rel(gcoor, wcoor) <= 1e-9
    # the components of non-zero variance are determined (the constant and
    # the duplicated feature each leave a direction of zero variance)
    k = int((ev > 1e-10 * ev[0]).sum())
    assert k == min(n - 1, f - 2)
    assert _rel(got.components_[:k], want.components_[:k]) <= 1e-9
    # each component's largest |loading| is positive, as svd_flip leaves it
    top = np.abs(got.components_[:k]).argmax(1)
    assert (got.components_[np.arange(k), top] > 0).all()


def test_calculate_pca_takes_the_card_unless_asked_for_the_cpu():
    df, feats = _frame(50, 4, seed=0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpca.calculate_pca(df, feats, "road_type", None)


# ---------------------------------------------------------------------------
# 3. pca_procedure's tables

def _pixel_frame(n: int, seed: int) -> tuple[pd.DataFrame, list]:
    """A pixel frame as the analysis builds it: four uint8 bands, their six
    ratios (3 decimals), VgNIR-BI (5 decimals) and the road width."""
    rng = np.random.default_rng(seed)
    cls = rng.choice([100, 200], n)
    base = np.where(cls[:, None] == 100, 140, 90)
    bands = np.clip(base + rng.normal(0, 25, (n, 4)), 0, 255).round()
    px = pd.DataFrame(bands, columns=[f"band{b}" for b in range(1, 5)])
    ratios = tstats_analysis.add_band_ratios(px)
    px = px.rename(columns={"band1": "red", "band2": "green",
                            "band3": "blue", "band4": "NIR"})
    px["road_width"] = np.where(cls == 100, 4.0, 8.0)
    px["road_type"] = np.where(cls == 100, "artificial", "natural")
    feats = ["red", "green", "blue", "NIR", *ratios, "VgNIR-BI",
             "road_width"]
    return px, feats


def _near_boundary(v: float, decimals: int) -> bool:
    """Whether ``v`` lies within 1e-9 of a rounding boundary (or of 0) of
    ``decimals`` printed digits."""
    s = abs(v) * 10 ** decimals
    return abs(s - np.floor(s) - 0.5) <= 1e-9 * 10 ** decimals \
        or abs(v) <= 1e-9


def _unrounded(name: str, pca, coor) -> np.ndarray:
    if name.endswith("values.csv"):
        return coor
    if name.endswith("loading_matrix.csv"):
        return pca.components_.T * np.sqrt(pca.explained_variance_)
    return pca.components_.T


@pytest.mark.parametrize("n", [3000, 60])
def test_pca_tables_equal_the_references(n, tmp_path):
    """3000 rows: the eigendecomposition; 60 rows (fewer than 10 a
    feature): the full SVD."""
    df, feats = _pixel_frame(n, seed=n)
    want = jpca.pca_procedure(df, feats, "road_type", str(tmp_path / "ref"),
                              str(tmp_path / "ref_img"), "PCA_x_")
    got = tpca.pca_procedure(df, feats, "road_type", str(tmp_path / "port"),
                             str(tmp_path / "port_img"), "PCA_x_",
                             device="cpu")
    names = [Path(p).name for p in got]
    assert names == [Path(p).name for p in want]
    pca, coor = tpca.calculate_pca(df, feats, "road_type", None,
                                   device="cpu")
    near = 0
    for name in (m for m in names if m.endswith(".csv")):
        with open(tmp_path / "ref" / name) as fa, \
                open(tmp_path / "port" / name) as fb:
            ra, rb = list(csv.reader(fa)), list(csv.reader(fb))
        assert len(ra) == len(rb) and ra[0] == rb[0], name
        values = _unrounded(name, pca, coor)
        for i, (la, lb) in enumerate(zip(ra[1:], rb[1:])):
            assert len(la) == len(lb), (name, i)
            for j, (a, b) in enumerate(zip(la, lb)):
                if a == b:
                    continue
                # a printed number of the port's unrounded table
                col = j - 1 if not name.endswith("values.csv") else j
                d = len(a.split(".")[1]) if "." in a else 0
                assert abs(float(a) - float(b)) <= 10 ** -d + 1e-12, \
                    (name, i, j, a, b)
                assert _near_boundary(values[i, col], d), \
                    (name, i, j, a, b, values[i, col])
                near += 1
    # measured: no printed value of these tables lies that near a boundary
    assert near == 0, near
