"""Rules of the PyTorch port that hold whatever the numbers: it imports
nothing of JAX or of the JAX package, its entry points need a card unless
the caller asks for the CPU, the dispatcher routes each pooling to the
kernel the reference routes it to, and the kernel wrappers refuse what
their kernels do not take."""

import ast
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import fast_profile, forward_inference, \
    init_params, prepare_quantized
from roadsurf_tpu_torch.ops import roi_align as tra
from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused
from roadsurf_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(ROOT, "roadsurf_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return module == "jax" or module.startswith("jax.") \
        or module == "roadsurf_tpu" or module.startswith("roadsurf_tpu.")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Static: the test process itself has jax imported (conftest), so
    sys.modules proves nothing. Relative imports stay inside the port."""
    bad = []
    files = list(_port_sources())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names = [node.args[0].value]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_the_import_check_covers_every_module_of_the_port():
    """The data-parallel, tif2cog, label preparation, tileset and
    statistical-branch modules among them."""
    files = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("parallel/__init__.py", "parallel/mesh.py",
                   "parallel/dryrun.py", "io/cog.py", "io/objstore.py",
                   "pipeline/cog_pipeline.py", "utils/profiling.py",
                   "crs/transform.py", "geom/core.py", "geom/table.py",
                   "geom/cleanup.py", "geom/affinity.py", "geom/index.py",
                   "geom/_native.py", "io/shapefile.py", "io/geojson.py",
                   "io/xlsx.py", "io/gpkg.py", "io/wkb.py", "io/__init__.py",
                   "tiles/__init__.py", "tiles/grid.py", "tiles/fetch.py",
                   "utils/logging.py", "utils/misc.py",
                   "pipeline/label_prep.py", "pipeline/tilesets.py",
                   "viz/__init__.py", "viz/charts.py",
                   "pipeline/classify.py", "pipeline/evaluate.py",
                   "pipeline/assess.py", "tools/learning_smoke.py",
                   "tools/quality.py", "stats/__init__.py",
                   "stats/descriptive.py", "stats/pixels.py", "stats/pca.py",
                   "tiles/rasters.py", "pipeline/stats_prep.py",
                   "pipeline/stats_analysis.py", "pipeline/sandbox.py",
                   "pipeline/upload.py"):
        assert os.path.join("roadsurf_tpu_torch", module) in files, module
    assert "chip_smoke.py" in files


def test_port_imports_no_scikit_learn():
    """The statistical branch's PCA is the port's own (``stats/pca.py``, in
    PyTorch), so no module imports scikit-learn, at module level or
    inside a function; the card has no scikit-learn."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if n == "sklearn" or n.startswith("sklearn.")]
    assert not bad, bad


# the reference's modules whose counterpart in the port has another name:
# the Pallas kernels' wrappers and the checkpoint helpers
RENAMED = {"ops/nms_pallas.py": "ops/nms_kernel.py",
           "ops/roi_align_pallas.py": "ops/roi_align_kernel.py",
           "utils/checkpoint.py": "utils/weights.py"}


def test_every_module_of_the_reference_has_its_counterpart():
    """The port covers every module of the JAX package, under its name or
    the one RENAMED gives."""
    def modules(pkg):
        base = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(d, f), base)
                for d, _, fs in os.walk(base) for f in fs
                if f.endswith(".py")}
    port = modules("roadsurf_tpu_torch")
    missing = {m for m in modules("roadsurf_tpu")
               if RENAMED.get(m, m) not in port}
    assert missing == set(), missing


def test_forbidden_matches_the_package_not_the_port():
    assert _forbidden("roadsurf_tpu") and _forbidden("roadsurf_tpu.ops.nms")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("roadsurf_tpu_torch")
    assert not _forbidden("roadsurf_tpu_torch.ops")
    assert not _forbidden("jaxlib_free_module")


@pytest.fixture(scope="module")
def state_and_cfg():
    cfg = fast_profile(post_nms_topk=32)
    return from_jax_params(init_params(cfg, torch.Generator().manual_seed(0))
                           ), cfg


def _detections_config(wd) -> str:
    """A make_detections config over an empty ``tst`` dataset in ``wd``
    (no checkpoint: random weights; no detectron2 YAML: the fast profile)."""
    os.makedirs(wd / "tst-images")
    (wd / "COCO_tst.json").write_text('{"images": []}')
    (wd / "img_metadata.json").write_text("{}")
    path = wd / "config.yaml"
    path.write_text(
        "make_detections.py:\n"
        f"  working_directory: {wd}\n"
        "  image_metadata_json: img_metadata.json\n"
        "  COCO_files: {tst: COCO_tst.json}\n"
        "  detectron2_config_file: absent.yaml\n"
        "  model_weights: {pth_file: logs/model_0005999.pth}\n")
    return str(path)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(state_and_cfg,
                                                           tmp_path):
    from roadsurf_tpu_torch.pipeline import detections

    state, cfg = state_and_cfg
    imgs = np.zeros((1, 256, 256, 3), np.uint8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward_inference(state, imgs, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TileInferenceEngine(state, cfg, batch_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_quantized(state, imgs, replace(cfg, int8_scope="full"))
    out = forward_inference(state, imgs, cfg, device="cpu")
    assert out["boxes"].device.type == "cpu"
    eng = TileInferenceEngine(state, cfg, batch_size=1, device="cpu")
    assert next(eng.run([imgs]))["boxes"].shape == (1, 8, 4)
    # python -m roadsurf_tpu_torch.pipeline.detections <config> [--device]
    config = _detections_config(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detections.main([config])
    assert not (tmp_path / "tst_detections_at_0dot05_threshold.gpkg").exists()
    assert detections.main([config, "--device", "cpu"]) == 0
    assert (tmp_path / "tst_detections_at_0dot05_threshold.gpkg").exists()
    # python -m roadsurf_tpu_torch.pipeline.training <config> [--device]
    # (tests/test_torch_train_loop.py trains with --device cpu)
    from roadsurf_tpu_torch.pipeline import training

    train_cfg = tmp_path / "train.yaml"
    train_cfg.write_text(
        "train_model.py:\n"
        f"  working_directory: {tmp_path / 'train'}\n"
        "  COCO_files: {trn: COCO_trn.json}\n"
        "  detectron2_config_file: absent.yaml\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.main([str(train_cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.main([str(train_cfg), "--n-devices", "2"])
    assert not (tmp_path / "train").exists()
    # python -m roadsurf_tpu_torch.pipeline.cog_pipeline <config> [--device]
    # (tests/test_torch_cog.py runs it with --device cpu)
    from roadsurf_tpu_torch.pipeline import cog_pipeline

    cog_cfg = tmp_path / "cog.yaml"
    cog_cfg.write_text(
        "tif2cog.py:\n"
        "  S3_PREFIX_IN: in\n  S3_PREFIX_TIF: tif\n  S3_PREFIX_COG: cog\n"
        f"  WORKDIR: {tmp_path / 'work'}\n"
        f"  LOCAL_STORE_ROOT: {tmp_path / 'store'}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cog_pipeline.main([str(cog_cfg)])
    assert not (tmp_path / "store").exists()
    # python -m roadsurf_tpu_torch.pipeline.stats_analysis <config>
    # [--device] (the PCAs; tests/test_torch_stats*.py pass device="cpu")
    from roadsurf_tpu_torch.pipeline import stats_analysis
    from roadsurf_tpu_torch.stats import calculate_pca, pca_procedure

    stats_cfg = tmp_path / "stats.yaml"
    stats_cfg.write_text(
        "statistical_analysis.py:\n"
        "  processed: {processed_folder: absent, input_files: {}}\n"
        f"  final_folder: {tmp_path / 'final'}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stats_analysis.main([str(stats_cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stats_analysis.run({})
    assert not (tmp_path / "final").exists()
    import pandas as pd

    frame = pd.DataFrame({"a": [1.0, 2.0, 4.0], "b": [0.0, 1.0, 0.0],
                          "c": ["x", "y", "x"]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calculate_pca(frame, ["a", "b"], "c", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pca_procedure(frame, ["a", "b"], "c", str(tmp_path / "t"),
                      str(tmp_path / "i"))
    pca, coor = calculate_pca(frame, ["a", "b"], "c", None, device="cpu")
    assert coor.shape == (3, 2) and pca.solver == "full"


def _module_level(body):
    """The statements a module runs when it is imported: its body, and
    the bodies of its top-level if, try and with blocks, but not those of
    its functions and classes."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                yield from _module_level(getattr(node, field, []))
            for h in getattr(node, "handlers", []):
                yield from _module_level(h.body)


def test_port_imports_no_pil_at_module_level():
    """The port's resizes (pipeline/resize.py) and its PNG and TIFF tile
    decoding (tiles/fetch.py) are its own, so neither needs Pillow. Only
    the best-effort sample drawing of the eval, the fetcher's decoding of
    JPEG and of the PNG kinds its own decoder does not take, and the
    quality chain's synthetic tile service (tools/quality.py, which writes
    PNG as the reference's does), the statistical branch's .webp figures
    (stats/pca.py, as the reference's) and chip_smoke.py's check that
    those figures decode import Pillow, inside the function that needs
    it."""
    bad, inside = [], []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = set(map(id, _module_level(tree.body)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            pil = [n for n in names if n == "PIL" or n.startswith("PIL.")]
            (bad if id(node) in top else inside).extend(
                f"{path}:{node.lineno}" for _ in pil)
    assert not bad, bad
    assert sorted(os.path.relpath(p.split(":")[0], ROOT).replace(
        "roadsurf_tpu_torch/", "") for p in inside) == [
        "chip_smoke.py", "engine/coco_eval.py", "stats/pca.py",
        "tiles/fetch.py", "tools/quality.py"]


# the modules that import pandas: the GeoDataFrame layer (a pandas frame,
# as the reference's is), the vector I/O that reads and writes it, the
# label preparation that joins road tables, the classify, evaluate and
# assess stages (pandas group-bys and metric tables, as the reference's),
# the quality chain that reads their CSVs and the statistical branch (pixel
# frames, per-road statistics and the PCA's tables, the DEM chain's URL
# list, the sandbox's joins, as the reference's); chip_smoke.py reads
# labels_id.json with pd.read_json, as the pipeline's users do
PANDAS_MODULES = {"geom/table.py", "geom/cleanup.py", "io/geojson.py",
                  "io/shapefile.py", "io/xlsx.py", "io/gpkg.py",
                  "pipeline/label_prep.py", "pipeline/classify.py",
                  "pipeline/evaluate.py", "pipeline/assess.py",
                  "tools/quality.py", "stats/descriptive.py",
                  "stats/pixels.py", "stats/pca.py", "tiles/rasters.py",
                  "pipeline/stats_prep.py", "pipeline/stats_analysis.py",
                  "pipeline/sandbox.py", "chip_smoke.py"}


def test_port_imports_no_pandas():
    """No module imports pandas but those of PANDAS_MODULES: the kernels,
    the models, the engine, training and the detection host stage (whose
    records become a GeoDataFrame only as it returns) carry their data as
    tensors, arrays and lists."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            rel = os.path.relpath(path, ROOT).replace("roadsurf_tpu_torch/",
                                                      "")
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if (n == "pandas" or n.startswith("pandas."))
                    and rel not in PANDAS_MODULES]
    assert not bad, bad


@pytest.fixture(scope="module")
def quant_64(state_and_cfg):
    """The port's own calibration of the random full-width state on two
    64 px tiles (int8 full + pyramid), and those tiles."""
    state, cfg = state_and_cfg
    imgs = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3),
                                             np.uint8)
    cfg = replace(cfg, int8_scope="full", int8_pyramid=True)
    return prepare_quantized(state, imgs, cfg, device="cpu"), imgs


@pytest.mark.parametrize("knob", [{"int8_scope": "full"},
                                  {"int8_backbone": True},
                                  {"int8_pyramid": True}])
def test_int8_configs_follow_the_quant_tree(knob, state_and_cfg, quant_64,
                                            monkeypatch):
    """An int8 config whose state has no quant tree runs in the compute
    dtype, as the reference's _quant_tree decides; with one it runs the
    int8 backbone (``int8_pyramid`` alone asks for no int8 group)."""
    from roadsurf_tpu_torch.models import mask_rcnn

    state, cfg = state_and_cfg
    quant, imgs = quant_64
    calls = []
    orig = mask_rcnn.resnet_forward_int8
    monkeypatch.setattr(mask_rcnn, "resnet_forward_int8",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    icfg = replace(cfg, **knob)
    plain = forward_inference(state, imgs, cfg, device="cpu")
    bare = forward_inference(state, imgs, icfg, device="cpu")
    assert not calls
    for k, v in plain.items():
        torch.testing.assert_close(bare[k], v, rtol=0, atol=0, msg=k)
    with_tree = dict(state, quant=quant)
    out = forward_inference(with_tree, imgs, icfg, device="cpu")
    assert len(calls) == (0 if "int8_pyramid" in knob else 1)
    assert out["boxes"].shape == plain["boxes"].shape
    assert bool(torch.isfinite(out["mask_logits"]).all())


def test_dispatcher_routes_fixed_small_maps_to_k1_and_the_rest_to_k2(
        monkeypatch):
    """sampling > 0 on maps of at most 160² cells at P2 reaches K1's
    wrapper; sampling == 0 at any size, and fixed sampling on larger maps,
    reach K2's (the reference's dispatcher, ops/roi_align.py:491-529). On
    CPU tensors each wrapper runs its plain version: no launch."""
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked

    calls = []

    def recorder(name, fn):
        def wrapped(feats, boxes, lvl, out_size, sampling, min_level,
                    feat_scales=None):
            calls.append((name, feats[0].shape[1], sampling))
            return fn(feats, boxes, lvl, out_size, sampling, min_level,
                      feat_scales)
        return wrapped

    monkeypatch.setattr(tra, "roi_align_fused",
                        recorder("K1", tra.roi_align_fused))
    monkeypatch.setattr(tra, "roi_align_fused_blocked",
                        recorder("K2", tra.roi_align_fused_blocked))

    def pyramid(side):
        return [torch.ones((1, side // 2 ** i, side // 2 ** i, 2))
                for i in range(4)]

    boxes = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [8.0, 4.0, 9.0, 70.0]]])
    before = (roi_align_fused.launches, roi_align_fused_blocked.launches)
    for side, sampling, want in ((64, 2, "K1"), (160, 2, "K1"),
                                 (64, 0, "K2"), (161, 2, "K2"),
                                 (200, 0, "K2"), (200, 2, "K2")):
        calls.clear()
        out = tra.roi_align_multilevel(pyramid(side), boxes, 7,
                                       sampling=sampling)
        assert calls == [(want, side, sampling)]
        assert out.shape == (1, 2, 7, 7, 2)
        # a constant map pools to its constant, whichever route
        torch.testing.assert_close(out, torch.ones_like(out))
    assert (roi_align_fused.launches, roi_align_fused_blocked.launches) \
        == before
    with pytest.raises(ValueError, match="sampling"):
        tra.roi_align_multilevel(pyramid(64), boxes, 7, sampling=-1)


@pytest.mark.parametrize("side,sampling,want", [(64, 2, "K1"), (64, 0, "K2"),
                                                (200, 2, "K2")])
def test_dispatcher_routes_int8_levels_like_bf16_ones(side, sampling, want,
                                                      monkeypatch):
    """Int8 pyramid levels with their scales take the bf16 levels' route,
    and a constant int8 map pools to its dequantized constant."""
    calls = []

    def recorder(name, fn):
        def wrapped(feats, boxes, lvl, out_size, sampling, min_level,
                    feat_scales=None):
            calls.append((name, feats[0].dtype, feat_scales is not None))
            return fn(feats, boxes, lvl, out_size, sampling, min_level,
                      feat_scales)
        return wrapped

    monkeypatch.setattr(tra, "roi_align_fused",
                        recorder("K1", tra.roi_align_fused))
    monkeypatch.setattr(tra, "roi_align_fused_blocked",
                        recorder("K2", tra.roi_align_fused_blocked))
    feats = [torch.full((1, side // 2 ** i, side // 2 ** i, 2), 3,
                        dtype=torch.int8) for i in range(4)]
    scales = torch.tensor([0.5, 0.25, 0.125, 1.0, 1.0])
    boxes = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [8.0, 4.0, 9.0, 60.0]]])
    out = tra.roi_align_multilevel(feats, boxes, 7, sampling=sampling,
                                   feat_scales=scales)
    assert calls == [(want, torch.int8, True)]
    assert out.dtype == torch.float32
    lvl = tra.level_assignment(boxes, 224, 4, 2, 2 + tra.reachable_levels(
        feats) - 1)
    want_vals = (3 * scales[lvl.long()])[..., None, None, None]
    torch.testing.assert_close(out, want_vals.expand_as(out))


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks a CUDA call goes through, exercised on meta tensors (no
    data, no device): dtype, layout and shapes are refused with an error."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import _check

    B, R, C = 2, 4, 8
    feats = tuple(torch.empty((B, s, s, C), dtype=torch.bfloat16,
                              device="meta") for s in (16, 8))
    boxes = torch.empty((B, R, 4), device="meta")
    lvl = torch.empty((B, R), dtype=torch.int32, device="meta")
    _check(feats, boxes, lvl, 7, 2)
    _check(tuple(f.float() for f in feats), boxes, lvl, 7, 2)
    with pytest.raises(TypeError):
        _check(tuple(f.double() for f in feats), boxes, lvl, 7, 2)
    with pytest.raises(TypeError):
        _check((feats[0], feats[1].float()), boxes, lvl, 7, 2)
    with pytest.raises(ValueError):
        _check((feats[0].permute(0, 2, 1, 3),), boxes, lvl, 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl.long(), 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes[:, :, :2], lvl, 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl, 7, 0)
    with pytest.raises(ValueError):
        _check(feats * 3, boxes, lvl, 7, 2)
    assert roi_align_fused.launches == 0


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_pooler_wrappers_take_int8_levels_only_with_their_scales(kernel):
    """The int8 mode's checks, on meta tensors: int8 levels need float32
    scales, one a level or more, on the boxes' device; bf16 levels take
    none."""
    from roadsurf_tpu_torch.ops import roi_align_blocked_kernel as k2
    from roadsurf_tpu_torch.ops import roi_align_kernel as k1

    mod = k1 if kernel == "K1" else k2
    B, R, C = 2, 4, 16
    q = tuple(torch.empty((B, s, s, C), dtype=torch.int8, device="meta")
              for s in (16, 8, 4))
    boxes = torch.empty((B, R, 4), device="meta")
    lvl = torch.empty((B, R), dtype=torch.int32, device="meta")
    scales = torch.empty(5, device="meta")
    mod._check(q, boxes, lvl, 7, 2, scales)
    with pytest.raises(TypeError):
        mod._check(q, boxes, lvl, 7, 2)
    with pytest.raises(TypeError):
        mod._check(tuple(f.to(torch.bfloat16) for f in q), boxes, lvl, 7, 2,
                   scales)
    for bad in (scales.double(), scales[:2], scales.reshape(5, 1),
                torch.empty(5)):
        with pytest.raises(ValueError, match="feat_scales"):
            mod._check(q, boxes, lvl, 7, 2, bad)
    assert mod.roi_align_fused.launches_int8 == 0 if kernel == "K1" \
        else mod.roi_align_fused_blocked.launches_int8 == 0


def test_blocked_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """K2's checks on meta tensors: as K1's, plus sampling 0 (adaptive)
    taken, and out sizes or level sides whose weight tables overflow a
    block's shared memory refused."""
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import _check, \
        roi_align_fused_blocked

    B, R, C = 2, 4, 8
    feats = tuple(torch.empty((B, s, s, C), dtype=torch.bfloat16,
                              device="meta") for s in (200, 100, 50, 25))
    boxes = torch.empty((B, R, 4), device="meta")
    lvl = torch.empty((B, R), dtype=torch.int32, device="meta")
    for P, s in ((7, 0), (14, 0), (7, 2)):
        _check(feats, boxes, lvl, P, s)
        _check(tuple(f.float() for f in feats), boxes, lvl, P, s)
    with pytest.raises(TypeError):
        _check(tuple(f.double() for f in feats), boxes, lvl, 7, 0)
    with pytest.raises(ValueError):
        _check((feats[0].permute(0, 2, 1, 3),), boxes, lvl, 7, 0)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl.long(), 7, 0)
    with pytest.raises(ValueError):
        _check(feats, boxes.double(), lvl, 7, 0)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl, 7, -1)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl, 33, 0)
    with pytest.raises(ValueError):
        _check(feats * 2, boxes, lvl, 7, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _check((torch.empty((B, 200, 4000, C), dtype=torch.bfloat16,
                            device="meta"),), boxes, lvl, 14, 0)
    assert roi_align_fused_blocked.launches == 0


def test_nms_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from roadsurf_tpu_torch.ops.nms_kernel import MAX_N, _check, \
        nms_keep_mask

    boxes = torch.empty((2, 5, 1000, 4), device="meta")
    scores = torch.empty((2, 5, 1000), device="meta")
    _check(boxes, scores)
    with pytest.raises(TypeError):
        _check(boxes.half(), scores)
    with pytest.raises(ValueError):
        _check(boxes[..., :3], scores)
    with pytest.raises(ValueError):
        _check(boxes, scores[..., :999])
    with pytest.raises(ValueError):
        _check(boxes.transpose(0, 1), scores.transpose(0, 1))
    with pytest.raises(ValueError, match="at most"):
        _check(torch.empty((1, MAX_N + 1, 4), device="meta"),
               torch.empty((1, MAX_N + 1), device="meta"))
    assert nms_keep_mask.launches == 0
