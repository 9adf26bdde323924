"""The yardstick's arithmetic: B2's bounds pinned to the recorded ones,
the operation counter against a hand count, the numbers' rules."""

import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import check
from portbench.reference import bounds, flops, pix2pix
from portbench.harness import Cell


def test_stage_bounds_match_the_recorded_b2_bf16_bounds():
    # B2-fwd bf16 at B 4, C = M = 256, 64x64, relu: 0.0051 ms by bytes,
    # 0.0101 with a-hat, b-hat and 1/std saved; the depthwise backward
    # 0.0075 ms by bytes, 0.0100 saved
    b = bounds.stage_bounds(4, 256, 256, 64 * 64, True, False, act=2,
                            mma=bounds.BF16_FLOPS)
    assert b["stage_fwd"][1] == "bytes"
    assert round(b["stage_fwd"][0], 4) == 0.0051
    assert round(b["stage_fwd_saved"][0], 4) == 0.0101
    assert round(b["stage_bwd_dw"][0], 4) == 0.0075
    assert round(b["stage_bwd_dw_saved"][0], 4) == 0.0100
    assert round(b["stage_bwd_pw"][0], 4) == 0.0077


def test_cyclegan_b2_calls_follow_the_recorded_launch_counts():
    cfg = Cell("cyclegan_train_b16").cfg
    calls = bounds.cyclegan_b2_calls(
        [cfg["student"]["cfg_AtoB"], cfg["student"]["cfg_BtoA"]]
        + [pix2pix.N.mobile_resnet_default_cfg(64)] * 2, 8, 256)
    per = {}
    for kind, n, _ in calls:
        per[kind] = per.get(kind, 0) + n
    # 288 / 216 / 216 an iteration (PERF.md's kernel table)
    assert per == {"stage_fwd": 288, "stage_bwd_pw": 216,
                   "stage_bwd_dw": 216}


def test_flop_counter_against_a_hand_count():
    x, w = torch.randn(2, 6, 16, 16), torch.randn(8, 6, 4, 4)
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x, w, stride=2, padding=1)
    assert counter.get_total_flops() == 2 * 2 * 8 * 8 * 8 * 6 * 4 * 4


def test_iteration_flops_scale_with_the_batch():
    c = Cell("unet_train_b128", smoke=True)
    one = flops.iteration_flops(pix2pix, c.cfg, 1, 64)
    four = flops.iteration_flops(pix2pix, c.cfg, 4, 64)
    assert one > 0
    # the grams' products scale with the batch as the convolutions do
    assert four == 4 * one


def test_leaf_numbers():
    ref = {"g": {("g", "a"): 1.0, ("g", "b"): 2.0, ("g", "c"): 1e-6}}
    prog = {"g": {("g", "a"): 1.1, ("g", "b"): 2.0, ("g", "c"): 3.0}}
    moved = check.moved_leaves(ref)
    assert moved == {"g": [("g", "a"), ("g", "b")]}
    assert math.isclose(check.leaf_gap(prog, ref, moved), 0.1)
    assert check.leaf_gap(prog, ref) > 1.0
    assert check.leaf_gap({"g": {}}, ref) == math.inf
    assert not check.judge({"x": math.nan}, {"x": {"limit": 1.0}})
