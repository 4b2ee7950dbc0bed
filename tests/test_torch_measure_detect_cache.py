"""``pipeline/detections.py::detect_tiles`` keeps its engine across calls
(``kept_engine``), and each call still runs its own weights.

Two calls of the port with different seeded weights (narrow heads at
64 px, six GeoTIFF tiles, batches of 4): the second call reuses the first
call's engine, and each call's records equal the reference's
``detect_tiles`` with the same weights, within the host stage's
tolerances (``tests/test_torch_port_detections.py``: the same detections,
scores within 1e-6, each detection's polygon area within 2%); the two
weights' records differ. The same at ``scan_k`` 2 (on the CPU a group
runs as its forwards; the graph is the card's, checked by
``chip_smoke.py``'s ``measure_path``), and with the int8 stack, whose
calibration runs afresh in each call and whose new ``quant`` tree must
reach the kept engine: its records are held to a fresh engine's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import roadsurf_tpu.pipeline.detections as j_det
import roadsurf_tpu_torch.pipeline.detections as t_det
from roadsurf_tpu_torch.io import wkb
from roadsurf_tpu_torch.io.geotiff import write_geotiff
from roadsurf_tpu_torch.utils.weights import from_jax_params
from test_torch_port_model import narrow_cfg as j_narrow_cfg, narrow_tree
from test_torch_ablations import _groups, _narrow_port_cfg

torch.set_num_threads(1)

SIDE = 64
N_TILES, BATCH = 6, 4


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(4)
    paths = []
    for i in range(N_TILES):
        p = str(d / f"t{i}.tif")
        write_geotiff(p, rng.integers(0, 255, (SIDE, SIDE, 3), np.uint8),
                      (0.0, 0.0, float(SIDE), float(SIDE)))
        paths.append(p)
    return paths, [(0.0, 0.0, float(SIDE), float(SIDE))] * N_TILES


def _tree(seed: int) -> dict:
    """``narrow_tree`` with the mask predictor's bias at +3, so that each
    mask fills its box (as ``test_torch_ablations.py`` sets it)."""
    tree = narrow_tree(j_narrow_cfg(SIDE), seed)
    tree["mask_head"]["predictor"]["b"] = np.full_like(
        tree["mask_head"]["predictor"]["b"], 3.0)
    return tree


def _same(got: list, want: list):
    want_g, got_g = _groups(want), _groups(got)
    assert len(want_g) > 2
    wk, gk = sorted(want_g), sorted(got_g)
    assert [k[0] for k in gk] == [k[0] for k in wk]
    for a, b in zip(gk, wk):
        assert abs(a[1] - b[1]) <= 1e-6, (a, b)
        assert abs(got_g[a] - want_g[b]) <= 0.02 * want_g[b], (a, b)


@pytest.mark.parametrize("scan_k", [1, 2])
def test_detect_tiles_keeps_its_engine_and_runs_each_calls_weights(
        tiles, scan_k):
    paths, bounds = tiles
    jcfg, tcfg = j_narrow_cfg(SIDE), _narrow_port_cfg()
    t_det.drop_engines()
    engines, records = [], []
    for seed in (0, 1):
        tree = _tree(seed)
        want = list(j_det.detect_tiles(tree, jcfg, paths, bounds,
                                       batch_size=BATCH, tile_size=SIDE,
                                       scan_k=scan_k))
        got = t_det.detect_tiles(from_jax_params(tree), tcfg, paths, bounds,
                                 batch_size=BATCH, tile_size=SIDE,
                                 scan_k=scan_k, device="cpu")
        _same(got, want)
        records.append(got)
        engines.extend(t_det._ENGINES.values())
    assert len(engines) == 2 and engines[0] is engines[1]
    assert sorted(_groups(records[0])) != sorted(_groups(records[1]))


def test_the_int8_calibration_of_each_call_reaches_the_kept_engine(tiles):
    """Int8 full scope with the pyramid: the second call (other weights,
    so another calibration) on the kept engine gives the records of a
    fresh engine."""
    from dataclasses import replace

    paths, bounds = tiles
    cfg = replace(_narrow_port_cfg(), int8_scope="full", int8_pyramid=True)
    kw = dict(batch_size=BATCH, tile_size=SIDE, device="cpu")
    t_det.drop_engines()
    t_det.detect_tiles(from_jax_params(_tree(0)), cfg, paths, bounds, **kw)
    kept = t_det.detect_tiles(from_jax_params(_tree(1)), cfg, paths, bounds,
                              **kw)
    assert len(t_det._ENGINES) == 1
    t_det.drop_engines()
    fresh = t_det.detect_tiles(from_jax_params(_tree(1)), cfg, paths, bounds,
                               **kw)
    assert len(kept) == len(fresh) > 0

    def keys(recs):
        return [(wkb.dumps(r["geometry"]), r["score"], r["det_class"])
                for r in recs]
    assert keys(kept) == keys(fresh)


def test_load_state_copies_into_the_engines_own_tensors():
    """The branch a replica with a captured graph takes (the card's, at
    scan_k > 1; here a stand-in graph on the CPU): new weights of the same
    layout are copied into the engine's own tensors, the addresses the
    graph reads, and never into the tensors of an earlier caller; a state
    of another layout is placed anew and the graph dropped."""
    from roadsurf_tpu_torch.engine.infer import TileInferenceEngine, \
        _private
    from roadsurf_tpu_torch.utils.graphs import storage_key, tensor_leaves

    cfg = _narrow_port_cfg()
    first, second = from_jax_params(_tree(0)), from_jax_params(_tree(1))
    kept = [t.clone() for t in tensor_leaves(first)]
    eng = TileInferenceEngine(first, cfg, batch_size=2, device="cpu")
    rep = eng.replicas[0]
    rep.state, rep.graph = _private(rep.state), object()
    ptrs = storage_key(rep.state)
    eng.load_state(second)
    assert rep.graph is not None and storage_key(rep.state) == ptrs
    assert eng.state is rep.state
    for got, want in zip(tensor_leaves(rep.state), tensor_leaves(second),
                         strict=True):
        assert torch.equal(got, want)
    for got, want in zip(tensor_leaves(first), kept, strict=True):
        assert torch.equal(got, want)
    eng.load_state(dict(second, extra={"w": torch.zeros(3)}))
    assert rep.graph is None and "extra" in eng.state
