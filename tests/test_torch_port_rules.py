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


# the reference's public top-level names that are JAX idiom, each with
# the port's counterpart ("module::name" in the port, checked to exist)
JAX_ONLY = {
    "models/mask_rcnn.py": {
        "jitted_inference_fn": "models/mask_rcnn.py::forward_prepared",
        "make_inference_fn": "models/mask_rcnn.py::forward_prepared"},
    "engine/train.py": {"jitted_train_step": "engine/train.py::train_step"},
    "parallel/mesh.py": {
        # devices=[...] of the engine, one process a rank in training
        "batch_sharding": "parallel/mesh.py::shard_batch",
        "data_parallel_mesh": "parallel/mesh.py::DataParallelGroup"},
    "models/resnet.py": {"init_resnet": "models/mask_rcnn.py::init_params",
                         "stop_gradient_frozen":
                             "engine/train.py::_is_frozen",
                         # the conv and FrozenBN unit with its ReLU: the
                         # port's conv takes ``relu``
                         "conv_bn": "models/resnet.py::conv"},
    "models/fpn.py": {"init_fpn": "models/mask_rcnn.py::init_params"},
    "models/rpn.py": {"init_rpn": "models/mask_rcnn.py::init_params"},
    "models/roi_heads.py": {
        "init_box_head": "models/mask_rcnn.py::init_params",
        "init_mask_head": "models/mask_rcnn.py::init_params"},
    # the TPU's int8 conv compute switch (bf16 or int8 on the MXU); the
    # port's int8 convs take one mode, f32 sums of int8 operands
    "models/quant.py": {
        "QCONV_COMPUTE": "models/quant.py::resnet_forward_int8"},
    # the Pallas modules: their kernels' wrappers are ops/*_kernel.py
    # (PALLAS below); the TPU's batched entry points and VMEM block pickers
    "ops/nms_pallas.py": {"nms_fixed_batch": "ops/nms.py::nms_fixed",
                          "batched_nms_batch":
                              "ops/nms.py::batched_nms_fixed"},
    "ops/roi_align_pallas.py": {
        "pick_rb": "ops/roi_align_kernel.py::check_staged_layout",
        "pick_gb": "ops/roi_align_kernel.py::check_staged_layout"},
    # the reference's wall-clock stage timer: the port names its stages
    # as ranges in the profiler's trace, on the device events' clock
    "utils/profiling.py": {"StageTimer": "utils/profiling.py::span"},
}
PALLAS = ("ops/nms_pallas.py", "ops/roi_align_pallas.py")


def _top_level_names(path: str, with_imports: bool) -> set:
    """The public names a module defines at its top level (functions,
    classes, assignments), and with ``with_imports`` those it imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if not with_imports \
        else out


def test_every_public_name_of_the_reference_has_its_counterpart():
    """Each public top-level name of a reference module is defined or
    imported by its counterpart in the port (``RENAMED``; for the Pallas
    modules, any of ``ops/*_kernel.py``), or is JAX idiom listed in
    ``JAX_ONLY`` with a counterpart that exists."""
    ref_root = os.path.join(ROOT, "roadsurf_tpu")
    port_root = os.path.join(ROOT, "roadsurf_tpu_torch")

    def port_names(rel):
        if rel in PALLAS:
            kernels = os.path.join(port_root, "ops")
            return set().union(*(
                _top_level_names(os.path.join(kernels, f), True)
                for f in os.listdir(kernels) if f.endswith("_kernel.py")))
        return _top_level_names(os.path.join(port_root,
                                             RENAMED.get(rel, rel)), True)

    missing, listed = [], 0
    for d, _, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), ref_root)
            jax_only = JAX_ONLY.get(rel, {})
            have = port_names(rel)
            for name in sorted(_top_level_names(os.path.join(d, f), False)):
                if name in have:
                    continue
                if name in jax_only:
                    listed += 1
                    continue
                missing.append(f"{rel}::{name}")
    assert missing == [], missing
    assert listed == sum(len(v) for v in JAX_ONLY.values())
    for names in JAX_ONLY.values():
        for counterpart in names.values():
            module, name = counterpart.split("::")
            assert name in _top_level_names(os.path.join(port_root, module),
                                            True), counterpart


# each script of the reference (scripts/*.py) and the port's entry point
# that does its work (python -m roadsurf_tpu_torch.<module>)
SCRIPTS = {
    "RS_images_to_S3.py": "pipeline/upload.py",
    "ablate_fast_profile.py": "tools/ablate_fast_profile.py",
    "ablate_mask_bits.py": "tools/ablate_mask_bits.py",
    "ablate_seeded.py": "tools/ablate_seeded.py",
    "add_tile_mask.py": "pipeline/sandbox.py",
    "assess_detections.py": "pipeline/assess.py",
    "bench_conv_dtypes.py": "tools/bench_conv_dtypes.py",
    "bench_int8_gemm.py": "tools/bench_int8_gemm.py",
    "bench_pooler.py": "tools/bench_pooler.py",
    "bench_pooler_variants.py": "tools/bench_pooler_variants.py",
    "bench_proposals.py": "tools/bench_proposals.py",
    "bench_training.py": "tools/bench_training.py",
    "calculate_statistics.py": "pipeline/assess.py",
    "correct_gt.py": "pipeline/sandbox.py",
    "dem_zonal_stats.py": "tiles/rasters.py",
    "determine_class.py": "pipeline/classify.py",
    "e2e_synthetic_quality.py": "tools/quality.py",
    "final_metrics.py": "pipeline/evaluate.py",
    "generate_tilesets.py": "pipeline/tilesets.py",
    "limit_used_tiles.py": "pipeline/sandbox.py",
    "make_detections.py": "pipeline/detections.py",
    "measure_detections.py": "tools/measure_detections.py",
    "prepare_data.py": "pipeline/stats_prep.py",
    "prepare_data_obj_detec.py": "pipeline/label_prep.py",
    "profile_heads.py": "tools/profile_heads.py",
    "profile_proposals.py": "tools/profile_proposals.py",
    "profile_stages.py": "tools/profile_stages.py",
    "profile_training.py": "tools/profile_training.py",
    "smoke_learning.py": "tools/learning_smoke.py",
    "statistical_analysis.py": "pipeline/stats_analysis.py",
    "tif2cog.py": "pipeline/cog_pipeline.py",
    "train_model.py": "pipeline/training.py",
}
# the reference's checks of its TPU kernels on the TPU, and the cases of
# chip_smoke.py that hold the port's kernels to the same settings on the
# card: script -> (phase function, table of cases, the cases' names)
TPU_CHECKS = {
    # the blocked pooler at the parity shapes, adaptive and at s=2
    # (--samplings 0,2), bf16 and int8 levels (phase_kernels_k2("int8"))
    "check_blocked_pooler_tpu.py": ("phase_kernels_k2", "PPOOLERS",
                                    ("box", "mask", "box_s2")),
    # the fused pooler on int8 pyramid levels, P5's 8x8xC block included,
    # at P = 7 and 14
    "check_int8_pyramid_pooler_tpu.py": ("phase_kernels_k1_p5",
                                         "P5_POOLERS", ("box", "mask")),
}


def test_every_script_of_the_reference_has_its_counterpart():
    """Each ``scripts/*.py`` of the reference maps to an entry point of the
    port (a module with ``main`` run under ``__main__``), or is one of
    its TPU checks, which ``chip_smoke.py``'s cases stand in for; a script
    in neither fails, and so does a name in either that is no script."""
    import re

    scripts = {f for f in os.listdir(os.path.join(ROOT, "scripts"))
               if f.endswith(".py")}
    assert scripts - set(SCRIPTS) - set(TPU_CHECKS) == set()
    assert set(SCRIPTS) | set(TPU_CHECKS) <= scripts
    assert not set(SCRIPTS) & set(TPU_CHECKS)
    assert all(re.fullmatch(r"check_.*_tpu\.py", f) for f in TPU_CHECKS)
    for script, module in SCRIPTS.items():
        with open(os.path.join(ROOT, "roadsurf_tpu_torch", module)) as f:
            tree = ast.parse(f.read(), module)
        assert "main" in _top_level_names(
            os.path.join(ROOT, "roadsurf_tpu_torch", module), False), script
        assert any(isinstance(n, ast.If) and "__main__" in ast.unparse(
            n.test) for n in tree.body), script


def test_each_tpu_check_has_its_cases_on_the_card():
    """The ``chip_smoke.py`` phase and cases each TPU check maps to
    exist: the phase is a function of the script, and its table names
    every case."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_rules_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for script, (phase, table, names) in TPU_CHECKS.items():
        assert callable(getattr(cs, phase, None)), script
        assert set(names) <= {case[0] for case in getattr(cs, table)}, script


# each public top-level function of a repo-root file that imports the JAX
# package, and its counterpart in the port (module::name)
ROOT_ENTRIES = {
    "bench.py::main": "tools/bench.py::main",
    "__graft_entry__.py::entry": "entry.py::entry",
    "__graft_entry__.py::dryrun_multichip":
        "parallel/dryrun.py::dryrun_multigpu",
}


def _imports_the_jax_package(path: str) -> bool:
    """Whether a file imports ``roadsurf_tpu`` anywhere (at its top level
    or inside a function)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        if any(n == "roadsurf_tpu" or n.startswith("roadsurf_tpu.")
               for n in names):
            return True
    return False


def test_every_entry_point_of_the_repo_root_has_its_counterpart():
    """Each public top-level function of a ``*.py`` at the repo's root
    that imports the JAX package (``bench.py``, ``__graft_entry__.py``)
    maps to a function of the port (``ROOT_ENTRIES``) that exists; a new
    root file fails until it is ported, and so does a name in the table
    that no root file defines."""
    found = set()
    for f in sorted(os.listdir(ROOT)):
        path = os.path.join(ROOT, f)
        if not f.endswith(".py") or not _imports_the_jax_package(path):
            continue
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        found |= {f"{f}::{n.name}" for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and not n.name.startswith("_")}
    assert {"bench.py::main", "__graft_entry__.py::entry"} <= found
    assert found == set(ROOT_ENTRIES)
    for counterpart in ROOT_ENTRIES.values():
        module, name = counterpart.split("::")
        path = os.path.join(ROOT, "roadsurf_tpu_torch", module)
        assert os.path.exists(path), counterpart
        assert name in _top_level_names(path, True), counterpart


def test_run_steps_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """``parallel/dryrun.py::run_steps`` without a group runs on the card
    by default and raises without one, before it makes any weights."""
    from roadsurf_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "init_params", lambda *a: pytest.fail(
        "weights made without a card"))
    case = {"cfg": fast_profile(), "image_size": 64, "init_seed": 0,
            "batch": dryrun.dryrun_batch(1, 64)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_steps(case)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_steps(case, None, "cuda:0")


def test_the_scan_dispatch_and_the_small_names_are_the_references():
    """The names the counterpart test found missing before the scan
    dispatch was ported: ``crs.Transformer`` and ``utils.logging.
    format_logger`` against the reference's."""
    from roadsurf_tpu.crs import Transformer as JTransformer
    from roadsurf_tpu.utils.logging import format_logger as j_format
    from roadsurf_tpu_torch.crs import Transformer
    from roadsurf_tpu_torch.utils import logging as tlog

    x = np.array([2600000.0, 2612345.5, 2700000.25])
    y = np.array([1200000.0, 1187654.5, 1100000.75])
    for src, dst in ((2056, 4326), (2056, 3857), ("EPSG:3857", 4326)):
        got = Transformer.from_crs(src, dst, always_xy=True).transform(x, y)
        ref = JTransformer.from_crs(src, dst, always_xy=True).transform(x, y)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    assert tlog.format_logger() is tlog.logger
    assert tlog.format_logger(object()) is tlog.get_logger()
    assert j_format() is not None


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
        TileInferenceEngine(state, cfg, batch_size=1, scan_k=3)
    from roadsurf_tpu_torch.engine.train import make_train_scan_step

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_scan_step(cfg, 64, 2)
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
    # python -m roadsurf_tpu_torch.tools.{ablate_seeded, ablate_mask_bits,
    # ablate_fast_profile, measure_detections} [--device]
    # (tests/test_torch_ablations*.py run them with device="cpu")
    from roadsurf_tpu_torch.tools import (ablate_fast_profile,
                                          ablate_mask_bits, ablate_seeded,
                                          measure_detections)

    abl = str(tmp_path / "ablate")
    for call in (lambda: ablate_seeded.run(abl),
                 lambda: ablate_seeded.main(["--workdir", abl]),
                 lambda: ablate_mask_bits.run(abl),
                 lambda: ablate_mask_bits.main(["--workdir", abl]),
                 lambda: ablate_fast_profile.run(abl),
                 lambda: ablate_fast_profile.main(["--workdir", abl]),
                 lambda: measure_detections.run(abl),
                 lambda: measure_detections.main(["--images", abl])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "ablate").exists()


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
