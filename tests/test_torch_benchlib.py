"""The port's bench harness (``pcss_unet_tpu_torch.utils.benchlib``) and
bench (``python -m pcss_unet_tpu_torch.bench``) on the CPU, against the
JAX package's ``utils/benchlib.py``: the plumbing tests of
``tests/test_benchlib.py`` (the chain reaches the input, the estimate is
finite and positive, the noise fallback engages), the FLOP count of a
small plain UNet against the analytic count, and the bench's one JSON line
on shrunk frames."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.utils import benchlib as jbench
from pcss_unet_tpu_torch import bench
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.ops.resize import resize_chain
from pcss_unet_tpu_torch.utils.benchlib import (forward_flops, make_stream,
                                                measure_ms_per_frame)

PARAMS = {"w": 1.5, "b": 0.25}


def _apply(v, x):
    # a stand-in "model": params scale the input
    return torch.tanh(x * v["params"]["w"] + v["params"]["b"])


def _japply(v, x):
    return jnp.tanh(x * v["params"]["w"] + v["params"]["b"])


def test_measure_returns_finite_positive():
    x = torch.from_numpy(np.random.default_rng(0)
                         .standard_normal((2, 8, 8, 4)).astype(np.float32))
    ms = measure_ms_per_frame(_apply, PARAMS, {}, x, scan_len=4, reps=2)
    assert np.isfinite(ms) and ms > 0


def test_chain_is_input_dependent():
    """Each forward's input is the frame plus the previous output's mean ×
    1e-12: on a zero frame the second input is exactly that, and the
    stream's result is the JAX stream's."""
    seen = []

    def spy(v, x):
        seen.append(x.clone())
        return _apply(v, x)

    x = torch.zeros((1, 4, 4, 4))
    chained = float(make_stream(spy, PARAMS, {}, scan_len=3)(x))
    assert len(seen) == 3 and not seen[0].any()
    carry = torch.tanh(torch.tensor(0.25)).float()
    torch.testing.assert_close(seen[1], torch.full_like(x, float(carry * 1e-12)),
                               rtol=1e-6, atol=0)
    jstream, leaves = jbench.make_stream(_japply, PARAMS, {}, scan_len=3)
    assert chained == pytest.approx(float(jstream(leaves, {}, jnp.zeros((1, 4, 4, 4)))),
                                    abs=1e-6)
    single = float(_apply({"params": PARAMS}, torch.ones((1, 4, 4, 4))).mean())
    assert float(make_stream(_apply, PARAMS, {}, 3)(torch.ones((1, 4, 4, 4)))) \
        == pytest.approx(single, abs=1e-6)


def test_noise_fallback_is_sane():
    # at trivially small shapes the two-point difference sits below
    # dispatch noise; the harness must fall back to the single-dispatch
    # bound, never emit clamped garbage
    x = torch.ones((1, 2, 2, 1))
    ms = measure_ms_per_frame(_apply, PARAMS, {}, x, scan_len=2, reps=2)
    assert 1e-6 < ms < 1e5


def test_forward_flops_best_effort():
    """Pointwise work only: FlopCounterMode counts nothing, so None (JAX's
    cost analysis may count the pointwise ops)."""
    x = torch.ones((1, 8, 8, 4))
    assert forward_flops(_apply, PARAMS, {}, x) is None
    fl = jbench.forward_flops(_japply, PARAMS, {}, jnp.ones((1, 8, 8, 4)))
    assert fl is None or fl > 0


def _analytic_flops(widths, h, w, in_ch=4, out_ch=1):
    """2 × the multiply-adds of a plain UNet forward on an [1, h, w, in_ch]
    frame: each block's 3×3 (cin→cin) and 1×1 (cin→cout), the head's 1×1,
    and the dense resize matmuls (an [out, in] matrix along one axis)."""
    convs, resizes = 0, 0
    hh, ww, cin = h // 2, w // 2, in_ch * 4
    sizes = []
    for i, width in enumerate(widths):
        convs += hh * ww * (9 * cin * cin + cin * width)
        sizes.append((hh, ww))
        cin = width
        if i < len(widths) - 1:
            hh, ww = hh // 2, ww // 2
    for width, (sh, sw) in zip(reversed(widths[:-1]), reversed(sizes[:-1])):
        resizes += cin * sh * hh * ww + cin * sh * ww * sw   # H, then W
        hh, ww = sh, sw
        convs += hh * ww * (9 * cin * cin + cin * width)
        cin = width
    for n in (hh, ww):                     # the head's folded resize pair
        if not np.array_equal(resize_chain((n, 2 * n, n)), np.eye(n)):
            resizes += cin * hh * ww * n
    convs += hh * ww * (9 * cin * cin + cin * in_ch * 4)    # dec_final
    convs += hh * ww * in_ch * 4 * out_ch * 4                # head
    return 2 * convs, 2 * resizes


def test_forward_flops_of_a_plain_unet_is_the_analytic_count():
    widths, h, w = (8, 16, 32), 32, 48
    model = UNet(encoder_widths=widths, normalization="none").eval()
    x = torch.zeros((1, h, w, 4))
    got = forward_flops(lambda v, xx: model(xx), None, {}, x)
    convs, resizes = _analytic_flops(widths, h, w)
    jmodel = JUNet(encoder_widths=widths, normalization="none", dtype=jnp.float32)
    jv = jax.jit(lambda k: jmodel.init({"params": k, "dropout": k},
                                       jnp.zeros((1, h, w, 4)), False))(jax.random.PRNGKey(0))
    jflops = jbench.forward_flops(lambda v, xx: jmodel.apply(v, xx, False),
                                  jv["params"], {}, jnp.zeros((1, h, w, 4)))
    print(f"port {got:.0f} = convs {convs} + resize matmuls {resizes} "
          f"({resizes / convs:.1%} of the convs); JAX cost analysis {jflops}")
    assert got == convs + resizes


@pytest.fixture
def one_thread():
    """The bench runs thousands of tiny ops; with every worker of a parallel
    test run holding a full thread pool, their barriers stall (seconds for
    what one thread does in milliseconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_cli_on_the_cpu(monkeypatch, capsys, one_thread):
    """Shrunk frames, the shortest streams (``SCAN`` and ``REPS`` 1): one
    JSON line with every configuration, the root bench's keys, and the
    device named.  The nets
    are narrowed too (the w64 slot gets the w16 widths, whose ``dec_0``
    still takes the int8 block, and the w16 slot (8, 16, 32, 64)): at the
    real w64 widths a 16×16 frame still pads each channels-major level to
    128 columns, ~0.3 s a CPU forward, and the bench runs hundreds."""
    for k in ("PCSS_BENCH_H", "PCSS_BENCH_W", "PCSS_BENCH_2K_H", "PCSS_BENCH_2K_W"):
        monkeypatch.setenv(k, "16")
    monkeypatch.setattr(bench, "WIDTHS", {"w64": (16, 32, 128, 256),
                                          "w16": (8, 16, 32, 64)})
    monkeypatch.setattr(bench, "SCAN", 1)
    monkeypatch.setattr(bench, "REPS", 1)
    result = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result["postures"]) == {c.name for c in bench.CONFIGS}
    assert len(bench.CONFIGS) == 12
    for row in result["postures"].values():
        assert len(row["runs_ms"]) == 3 and row["min_ms"] <= row["median_ms"] <= row["max_ms"]
        assert row["spread"] >= 0 and (row["scan_lo"], row["scan_hi"]) == (2, 3)
        # 3 measurements of a warm and one timed dispatch per stream length;
        # on the CPU every wrapper runs its plain version and counts nothing
        assert row["forwards"] == 3 * 2 * (2 + 3) and row["launches_per_forward"] == {}
    assert result["metric"] == "1080p_inference_frames_per_sec_per_chip"
    assert result["frame"] == "16x16" and result["dtype"] == "bfloat16"
    assert result["device"] == "cpu" and result["mfu"] is None
    assert result["flops_per_frame"] > 0 and result["value"] > 0
    assert result["trimmed_2k_impl"] == "chw_int8"
    assert result["trimmed_2k_ms_per_frame"] == result["postures"][bench.TRIMMED_2K]["median_ms"]
    for key in ("trimmed_2k_ms_per_frame", "trimmed_2k_impl",
                "trimmed_2k_vs_paper_optimized_5.8ms",
                "trimmed_2k_throughput_ms_per_frame",
                "trimmed_2k_throughput_batch", "trimmed_2k_throughput_fps"):
        assert key in result


def test_bench_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 2
