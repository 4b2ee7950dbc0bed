"""ViTDet-B Mask R-CNN (``config.vitdet_b``, ``models/vit.py``) on the CPU:
the configuration, the program's plain path against the family's plain
reference (``portbench/vitdet_reference.py``) on seeded random weights in
float32 at narrow widths, the position embedding resized once, the spans,
the work counts against the reference's products, and the new benchmark
cell run narrow through the harness, right and then broken underneath the
engine.

Narrow: 128 px input (64 px tiles), an 8x8 patch grid, windows of 3
(padded to 9), width 32, 2 heads, MLP 128, 6 blocks with global blocks 2
and 5, pyramid 16 channels (``families/vitdet_b.py``'s ``NARROW``), and
the budgets of the benchmark's CPU runs. Tolerances are the port's float32
forward's, boxes 1e-4 px and mask logits 1e-4, but scores 1e-5 (not 1e-6):
the ViT's output is bit for bit the reference's, but the pyramid's eight
convs and the box head's four, each followed by a channel LayerNorm
(ATen's fused kernel on channels_last maps in the program, detectron2's
mean-and-variance formula on contiguous ones in the reference), leave
~4e-7 of float32 rounding on each pyramid level, which the box head's four
conv-LN layers carry to the class logits: scores differ by up to 2.1e-6
on these seeds.
"""

import time
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, modelgen, spec
from portbench import reference as R
from portbench import vitdet_reference as V
from roadsurf_tpu_torch.engine.coco_eval import evaluate_dataset
from roadsurf_tpu_torch.engine.infer import TileInferenceEngine
from roadsurf_tpu_torch.models import vit
from roadsurf_tpu_torch.models.config import ModelConfig, vitdet_b
from roadsurf_tpu_torch.models.mask_rcnn import forward_inference, \
    forward_prepared, prepare_state
from roadsurf_tpu_torch.ops import attention as att
from roadsurf_tpu_torch.tools.profile_stages import model_state
from roadsurf_tpu_torch.utils.weights import state_to

torch.set_num_threads(1)

CELL = spec.cell("vitdet-b-1024.detect-b16")
FAM = CELL.family
PUBLISHED = CELL.config["settings"]
SMALL = {"rpn_pre_nms_topk_test": 120, "rpn_post_nms_topk_test": 60,
         "detections_per_image": 12, "compute_dtype": "float32"}
TRAFFIC = {"batch": 2, "tile_px": 64, "pool_tiles": 8, "check_tiles": 256,
           "check_block": 4, "trace_dispatches": 1}
T = 64


def narrow_settings() -> dict:
    return dict(PUBLISHED, **FAM.NARROW, **SMALL)


def overrides() -> dict:
    return {"settings": narrow_settings(), "precision": "float32",
            "traffic": dict(TRAFFIC)}


@pytest.fixture(scope="module")
def narrow():
    """(settings, config, state pinned on its tiles, tiles)."""
    st = narrow_settings()
    cfg = harness.port_config(CELL.config, st)
    g = modelgen.generator(2 ** 31 + 5, "cpu")
    state = FAM.weights(st, g, "cpu", torch.float32)
    tiles = modelgen.tiles(8, T, g, "cpu")
    FAM.pin_classes(state, st, tiles[:FAM.PIN_TILES], "cpu")
    return st, cfg, state, tiles


def test_vitdet_b_is_the_published_configuration():
    cfg = vitdet_b()
    assert (cfg.backbone, cfg.vit_patch, cfg.vit_dim, cfg.vit_depth,
            cfg.vit_heads, cfg.vit_mlp_ratio, cfg.vit_window,
            cfg.vit_global_blocks, cfg.vit_pretrain_grid, cfg.ln_eps,
            cfg.sfp_scales) == ("vit", 16, 768, 12, 12, 4.0, 14,
                                (2, 5, 8, 11), 14, 1e-6,
                                (4.0, 2.0, 1.0, 0.5))
    assert (cfg.min_size_test, cfg.pixel_mean, cfg.pixel_std) == (
        1024, (123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
    assert (cfg.rpn_num_conv, cfg.box_num_conv, cfg.box_num_fc,
            cfg.box_fc_dim, cfg.head_norm, cfg.fpn_channels) == (
        2, 4, 1, 1024, "LN", 256)
    # parity's test budgets
    base = ModelConfig()
    for k in ("rpn_pre_nms_topk_test", "rpn_post_nms_topk_test",
              "detections_per_image", "pooler_sampling_ratio", "fast_nms",
              "nms_thresh_test", "score_thresh_test", "num_classes"):
        assert getattr(cfg, k) == getattr(base, k), k
    # the configuration file states what the constructor gives
    assert harness.port_config(CELL.config, PUBLISHED) == cfg


def test_the_r50_fpn_defaults_are_unchanged():
    cfg = ModelConfig()
    assert (cfg.backbone, cfg.rpn_num_conv, cfg.box_num_conv,
            cfg.box_num_fc, cfg.head_norm) == ("resnet50", 1, 0, 2, "")


@pytest.mark.parametrize("field, value", [("int8_backbone", True),
                                          ("int8_scope", "full"),
                                          ("int8_pyramid", True)])
def test_the_int8_stack_with_the_vit_raises(field, value):
    with pytest.raises(ValueError, match="int8_backbone, int8_scope, "
                                         "int8_pyramid"):
        replace(vitdet_b(), **{field: value})
    with pytest.raises(ValueError, match="backbone"):
        replace(ModelConfig(), backbone="vit_b")
    replace(ModelConfig(), **{field: value})       # R50: no error


def test_the_program_matches_the_reference(narrow):
    """The program's plain path (float32, CPU) against the family's
    reference on 4 tiles: the same detections slot for slot, boxes within
    1e-4 px, scores within 1e-5 (the module's docstring says why), mask
    logits within 1e-4 (the reference's mask head on the program's
    boxes)."""
    st, cfg, state, tiles = narrow
    images = torch.from_numpy(tiles[:4])
    got = forward_inference(state, images, cfg, mask_format="logits",
                            device="cpu")
    valid = got["valid"].numpy()
    given = [(got["boxes"][i][valid[i]], got["classes"][i][valid[i]].long())
             for i in range(4)]
    ref = FAM.run(state, images, st, given, block=4)
    assert valid.sum() > 0
    for i, r in enumerate(ref):
        v = valid[i]
        assert v.sum() == len(r["scores"])
        assert (got["classes"][i][v].long() == r["classes"]).all()
        torch.testing.assert_close(got["boxes"][i][v], r["boxes"],
                                   atol=1e-4, rtol=0)
        torch.testing.assert_close(got["scores"][i][v], r["scores"],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(got["mask_logits"][i][v],
                                   r["given_mask_logits"], atol=1e-4,
                                   rtol=0)


def test_the_engine_runs_the_vit(narrow):
    st, cfg, state, tiles = narrow
    eng = TileInferenceEngine(state, cfg, batch_size=2, device="cpu",
                              mask_format="bits")
    out = list(eng.run(tiles[i:i + 2] for i in range(0, 4, 2)))
    want = forward_inference(state, torch.from_numpy(tiles[:4]), cfg,
                             mask_format="bits", device="cpu")
    for k in ("boxes", "scores", "classes", "valid", "mask_bits"):
        np.testing.assert_array_equal(np.concatenate([o[k] for o in out]),
                                      want[k].numpy())


def test_the_position_embedding_is_resized_once(narrow, monkeypatch):
    """``prepare_state`` resizes it (bicubic, as ``get_abs_pos``) to the
    8x8 grid; a forward on the prepared state does not, and a prepared
    state passes through ``prepare`` as it is."""
    st, cfg, state, tiles = narrow
    prepared = prepare_state(state, cfg, "cpu")
    pos = prepared["backbone"]["pos_grid"]
    want = V.get_abs_pos(state["backbone"]["pos_embed"], (8, 8))
    torch.testing.assert_close(pos.view(1, 8, 8, -1), want, atol=1e-6,
                               rtol=0)
    assert vit.prepare(prepared, cfg) is prepared

    def never(*a, **k):
        raise AssertionError("resized in the forward")

    monkeypatch.setattr(vit, "abs_pos", never)
    with torch.inference_mode():
        forward_prepared(prepared, torch.from_numpy(tiles[:2]), cfg, True,
                         "bits")


def test_a_forward_on_an_unprepared_state_raises(narrow):
    """The forward reads the embedding at the input's grid from the
    prepared state only: a state placed without ``prepare_state`` is
    refused, not resized on every forward."""
    st, cfg, state, tiles = narrow
    placed = state_to(state, "cpu", torch.float32)
    assert "pos_grid" not in placed["backbone"]
    with pytest.raises(ValueError, match="prepare_state"), \
            torch.inference_mode():
        forward_prepared(placed, torch.from_numpy(tiles[:2]), cfg, True,
                         "bits")


class _Tiles:
    """A dataset of the narrow tiles, one ground-truth box each, as
    ``coco_eval.evaluate_dataset`` loads it."""

    def __init__(self, tiles):
        self.tiles = tiles

    def __len__(self):
        return len(self.tiles)

    def load(self, i):
        masks = np.zeros((1, T, T), np.uint8)
        masks[0, 8:40, 8:40] = 1
        return (self.tiles[i], np.array([[8.0, 8.0, 40.0, 40.0]],
                                        np.float32),
                np.array([0]), np.array([True]), masks)


def test_the_coco_evaluation_and_the_stage_profile_prepare_the_state(narrow):
    """``coco_eval.evaluate_dataset`` and ``profile_stages.model_state``
    place the ViT's state with ``prepare_state``."""
    st, cfg, state, tiles = narrow
    res = evaluate_dataset(state, cfg, _Tiles(tiles[:3]), image_size=T,
                           batch_size=2, device="cpu")
    assert "bbox/AP" in res and "segm/AP" in res
    prepared = model_state(cfg, torch.device("cpu"), tile=T, state=state)
    torch.testing.assert_close(prepared["backbone"]["pos_grid"],
                               prepare_state(state, cfg, "cpu")[
                                   "backbone"]["pos_grid"], atol=0, rtol=0)


def test_the_box_convs_run_with_layer_norm_only():
    with pytest.raises(ValueError, match="head_norm='LN'"):
        replace(vitdet_b(), head_norm="")
    with pytest.raises(ValueError, match="head_norm='LN'"):
        replace(ModelConfig(), box_num_conv=2)
    replace(ModelConfig(), box_num_conv=2, head_norm="LN")


def test_the_attention_spans_sit_in_the_backbone(narrow):
    """Each block's attention (qkv to proj) is a span of its kind inside
    ``forward.backbone``; the pyramid is ``forward.fpn``."""
    st, cfg, state, tiles = narrow
    prepared = prepare_state(state, cfg, "cpu")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        forward_prepared(prepared, torch.from_numpy(tiles[:2]), cfg, True,
                         "bits")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name.startswith("forward.")]
    names = [n for n, _, _ in spans]
    assert names.count("forward.attention.window") == 4
    assert names.count("forward.attention.global") == 2
    for stage in ("forward.preprocess", "forward.backbone", "forward.fpn",
                  "forward.rpn", "forward.box_head", "forward.mask_head"):
        assert names.count(stage) == 1, stage
    (b0, b1), = [(s, e) for n, s, e in spans if n == "forward.backbone"]
    for n, s, e in spans:
        if n.startswith("forward.attention."):
            assert b0 <= s and e <= b1


def test_the_weights_move_what_a_dropped_term_would_hide():
    """The relative-position tables, the position embedding, the qkv bias
    and the LN affines are drawn away from their initial values; the
    seed alone decides them."""
    st = narrow_settings()
    a, b = (FAM.weights(st, modelgen.generator(9, "cpu"), "cpu",
                        torch.float32) for _ in range(2))
    blk = a["backbone"]["blocks"][0]
    for t in (blk["rel_pos_h"], blk["rel_pos_w"], blk["qkv"]["b"],
              blk["norm1"]["b"], a["backbone"]["pos_embed"]):
        assert t.abs().min() > 0 and t.std() > 0.05
    assert (blk["norm1"]["w"] - 1).abs().max() > 0.05
    assert torch.equal(a["fpn"]["p2"]["deconv1"]["w"],
                       b["fpn"]["p2"]["deconv1"]["w"])
    assert a["backbone"]["blocks"][2]["rel_pos_h"].shape == (15, 16)
    assert blk["rel_pos_h"].shape == (5, 16)


def test_forward_flops_are_the_references():
    """The count equals what FlopCounterMode sees of the reference's
    convolutions and products (the resize, the ViT, the pyramid, the RPN
    head, the box head on the proposal budget and the mask head on the
    detection budget), narrow; the attention kernel's FLOPs are the
    reference's attention products among them."""
    st = narrow_settings()
    W = FAM.weights(st, modelgen.generator(1, "cpu"), "cpu", torch.float32)
    Rb, D = st["rpn_post_nms_topk_test"], st["detections_per_image"]
    C, P, Pm = st["fpn_channels"], st["box_pooler_resolution"], \
        st["mask_pooler_resolution"]
    x = torch.zeros(1, T, T, 3, dtype=torch.uint8)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        feats = V.backbone_sfp(W, R.preprocess(x, st), st)
        V.rpn(W, feats, st)
        V.box_head(W, torch.zeros(Rb, C, P, P), st)
        m = V._head_convs(W["mask_head"], torch.zeros(D, C, Pm, Pm),
                          st["mask_num_conv"], st["ln_eps"])
        m = V._deconv(m, W["mask_head"]["deconv"])
        V._conv(m, W["mask_head"]["predictor"])
    assert counter.get_total_flops() == FAM.forward_flops(st, T)
    vit_counter = FlopCounterMode(display=False)
    with vit_counter, torch.no_grad():
        V.vit(W, torch.zeros(1, 3, 128, 128), st)
    bmm = sum(n for op, n in vit_counter.get_flop_counts()["Global"].items()
              if "bmm" in str(op))
    hd = st["vit_dim"] // st["vit_heads"]
    # the relative-position einsums, 4·N·side·hd a head and window: 4
    # windowed blocks of 9 windows of 9 tokens (side 3), 2 global of 64
    rel = st["vit_heads"] * (4 * 9 * (4 * 9 * 3 * hd) + 2 * (4 * 64 * 8 * hd))
    flops, nbytes = FAM.attention_work(st, T)
    assert bmm == flops + rel
    assert nbytes == st["vit_heads"] * 2 * (
        4 * 9 * (4 * 9 * hd + 2 * 9 * 3) + 2 * (4 * 64 * hd + 2 * 64 * 8))


def test_the_counts_at_the_published_shapes():
    """ViTDet-B at 1024 px from 256 px tiles, the budgets of parity:
    1.677 TFLOP a tile, the ViT's linears ≈731 GFLOP with the windows'
    padded 4900 tokens; the attention kernel's FLOPs 4·N²·64 a head and
    window, 4 global blocks of 51.5 and 8 windowed of 2.95 GFLOP."""
    st = PUBLISHED
    D, hidden = 768, 3072
    linears = 2 * 3 * D * 16 * 16 * 64 * 64
    linears += 4 * (2 * 4096 * D * 4 * D + 2 * 2 * 4096 * D * hidden)
    linears += 8 * (2 * 4900 * D * 4 * D + 2 * 2 * 4096 * D * hidden)
    assert linears / 1e9 == pytest.approx(731.0, abs=0.1)
    flops, nbytes = FAM.attention_work(st, 256)
    assert flops == 4 * 12 * 4 * 4096 ** 2 * 64 \
        + 8 * 25 * 12 * 4 * 196 ** 2 * 64
    assert nbytes == 4 * 12 * (4 * 4096 * 64 + 2 * 4096 * 64) * 2 \
        + 8 * 25 * 12 * (4 * 196 * 64 + 2 * 196 * 14) * 2
    # with the resize (2.0 GFLOP) and the relative-position products (3.3)
    assert FAM.forward_flops(st, 256) / 1e12 == pytest.approx(1.6774,
                                                              abs=1e-4)
    # the poolers' and the NMS's counts are work.py's, at parity's budgets
    parity = spec.cell("parity-800.detect-b16").config["settings"]
    assert FAM.pooler_bytes(st, "bfloat16") == \
        FAM.pooler_bytes(parity, "bfloat16")
    assert FAM.level_sizes(st) == [256, 128, 64, 32, 16]


def _run(prepare=None, fault=None, monkeypatch=None):
    if fault is not None:
        import roadsurf_tpu_torch.engine.infer as infer

        real = infer.forward_prepared
        monkeypatch.setattr(infer, "forward_prepared",
                            lambda *a, **k: fault(real(*a, **k)))
    return harness.run_cell(CELL, 2 ** 31 + 99, 0.3, False,
                            time.perf_counter(), device="cpu",
                            overrides=overrides(), prepare=prepare)


def test_the_cell_runs_narrow_and_is_correct():
    before = att.counts["plain"]
    res = _run()
    assert res["correct"], res["checks"]
    r = res["readings"]
    assert r["detections_program"] == r["detections_reference"] > 0
    assert r["unmatched"] == 0 and r["mask_err"] == 0
    assert r["box_err"] < 1e-5 and r["score_err"] < 1e-4
    assert set(res["metrics"]) == {"tiles_per_s", "setup_s"}
    # every attention call of the window and the warm-up: plain on the CPU
    assert att.counts["plain"] > before


def _half_left_out(dets):
    h = dets["valid"].shape[0] // 2
    dets["valid"][h:] = False
    dets["scores"][h:] = 0
    return dets


def _boxes_moved(dets):
    dets["boxes"] = dets["boxes"] + 2.0
    return dets


def _classes_swapped(dets):
    dets["classes"] = 1 - dets["classes"]
    return dets


def _masks_inverted(dets):
    dets["mask_bits"] = 255 - dets["mask_bits"]
    return dets


@pytest.mark.parametrize("fault", [_half_left_out, _boxes_moved,
                                   _classes_swapped, _masks_inverted])
def test_a_fault_under_the_engine_fails_the_cell(fault, monkeypatch):
    res = _run(fault=fault, monkeypatch=monkeypatch)
    assert res["readings"]["tiles"] == res["attempted"]
    assert res["readings"]["detections_reference"] > 0
    assert not res["correct"], res["checks"]


def test_the_control_rounds_the_programs_weights_only():
    """The control gives the program every weight through float8_e4m3fn
    at a per-tensor scale, and the reference the weights as drawn."""
    st = narrow_settings()
    state = FAM.weights(st, modelgen.generator(4, "cpu"), "cpu",
                        torch.float32)
    cfg = harness.port_config(CELL.config, st)
    got_cfg, got = FAM.control(cfg, state, None, "cpu")
    assert got_cfg == cfg and got["reference"] is state
    w = state["backbone"]["blocks"][0]["qkv"]["w"]
    r = got["backbone"]["blocks"][0]["qkv"]["w"]
    s = w.abs().max() / 448.0
    assert torch.equal(r, (w / s).to(torch.float8_e4m3fn).float() * s)
    assert 0 < (r - w).abs().max() < 0.1 * w.abs().max()
    assert asdict(got_cfg) == asdict(cfg)
