"""The operation and byte counts behind ``mfu`` and the rooflines, against
hand counts on a tiny net."""

from __future__ import annotations

import pytest

from benchmark import flops, harness, peaks


def test_unet_multiply_adds_match_a_hand_count():
    # widths (4, 8) on a 8 x 8 frame: the net runs at 4 x 4 (level 0) and
    # 2 x 2 (level 1); in_ch 4 -> 16 channels after the unshuffle
    #   enc_0 16 -> 4 at 16 px:  16 * (9*16*16 + 16*4)
    #   enc_1  4 -> 8 at  4 px:   4 * (9*4*4 + 4*8)
    #   dec_0  8 -> 4 at 16 px:  16 * (9*8*8 + 8*4)
    #   dec_final 4 -> 16 at 16: 16 * (9*4*4 + 4*16)
    #   head 16 -> 4 at 16 px:   16 * 16 * 4
    hand = (16 * (9 * 256 + 64) + 4 * (144 + 32) + 16 * (576 + 32)
            + 16 * (144 + 64) + 16 * 64)
    assert flops.unet_macs((4, 8), 8, 8) == hand


def test_the_reference_nets_counts():
    # 1,562 GFLOP a 1088 x 1920 frame of the reference net: the mfu's base
    assert flops.unet_macs((64, 128, 512, 1024), 1088, 1920) == 780_936_806_400
    assert flops.vgg_macs(32, 32) == sum(
        (32 >> p) ** 2 * 9 * cin * cout for _, cin, cout, p in flops.VGG_TO_30)


def test_roofline_bounds_match_hand_counts():
    roof = harness.rooflines()
    assert set(roof) >= {"K1", "K2", "K3", "K4", "K5", "K6"}

    def t(shape, dtype="bfloat16"):
        return {"shape": list(shape), "dtype": dtype}

    # K2 channels-major: x [1, 16, 4, 128] with 64 true columns, 16 -> 16 -> 32
    call = {"args": [t((1, 16, 4, 128)), t((9, 16, 16)), t((16, 1), "float32"),
                     t((32, 16)), t((32, 1), "float32")],
            "kwargs": {"true_w": 64, "residual": None}}
    px = 4 * 64
    macs = px * (9 * 16 * 16 + 16 * 32)
    nbytes = px * 16 * 2 + 4 * 128 * 32 * 2 + (9 * 16 * 16 + 32 * 16) * 2 + 4 * 48
    assert roof["K2"].bound_s(call) == pytest.approx(
        max(2 * macs / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES))
    # K3: x [1, 8, 16, 256] bf16, 256 -> 256 -> 128 in int8
    call = {"args": [t((1, 8, 16, 256)), t((9, 256, 256), "int8"), t((256,), "float32"),
                     t((256,), "float32"), t((256, 128), "int8"), t((128,), "float32"),
                     t((128,), "float32")], "kwargs": {"k_rows": 8}}
    px = 8 * 16
    macs = px * (9 * 256 * 256 + 256 * 128)
    nbytes = px * 256 * 2 + px * 128 * 2 + 9 * 256 * 256 + 256 * 128 + 4 * (256 * 2 + 128 * 2)
    want = max(2 * macs / peaks.INT8_OPS, nbytes / peaks.HBM_BYTES)
    assert roof["K3"].bound_s(call) == pytest.approx(want)
    assert roof["K5"].bound_s(call) == pytest.approx(want)
    # K4: bytes only, 4 in and 1 out a pixel
    assert roof["K4"].bound_s({"args": [t((1, 64, 64, 1), "float32")], "kwargs": {}}) == \
        pytest.approx(64 * 64 * 5 / peaks.HBM_BYTES)
