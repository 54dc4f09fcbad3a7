"""The port's streaming server and ``serve`` CLI against the JAX package's,
on the CPU: the same EXRs through ``pcss_unet_tpu_torch.infer.server`` and
``pcss_unet_tpu.infer.server`` (the (8, 16) float32 engine of
``tests/test_server.py``, batches of 2 and 3), masks within one code;
ordering, stats, the skip of an unreadable file; the CLI against the JAX
CLI; and the served deploy_w16 golden through the port's NHWC fused+int8
engine in float32, held to the committed quality as
``tests/test_serve_golden.py`` holds the JAX server."""

import functools
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import pcss_unet_tpu.infer as jinfer
from pcss_unet_tpu.infer.server import ShadowServer as JShadowServer
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu_torch.infer import InferenceEngine, ShadowServer
from pcss_unet_tpu_torch.infer.server import ServerStats
from pcss_unet_tpu_torch.io.exr import read_exr_stack, write_exr

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
WEIGHTS = os.path.join(GOLDEN, "deploy_w16.npz")


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    for i in range(7):
        write_exr(str(root / f"f{i:03d}.exr"),
                  {n: rng.standard_normal((24, 40)).astype(np.float32)
                   for n in "RGBA"})
    with open(root / "f099.exr", "wb") as f:
        f.write(b"garbage")
    return str(root)


def _paths(frames_dir, garbage=False):
    return sorted(os.path.join(frames_dir, f) for f in os.listdir(frames_dir)
                  if garbage or f != "f099.exr")


@pytest.fixture(scope="module")
def engines():
    """The JAX (8, 16) float32 engine of tests/test_server.py and the
    port's engine on the same variables."""
    model = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    # jitted: the same tree as the eager init, a fraction of its time
    v = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                     jnp.zeros((1, 32, 32, 4)), True))(key)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), dict(v))
    jeng = jinfer.InferenceEngine(model, v, dtype=jnp.float32)
    import torch
    peng = InferenceEngine(None, v, dtype=torch.float32, device="cpu")
    return jeng, peng


def _serve(server, paths):
    got, order = {}, []

    def sink(p, m):
        got[p] = m
        order.append(p)
    return server.run(paths, sink), got, order


@pytest.mark.parametrize("batch,workers", [(2, 3), (3, 2)])
def test_server_matches_jax_server(frames_dir, engines, batch, workers):
    jeng, peng = engines
    paths = _paths(frames_dir)
    stats, got, _ = _serve(ShadowServer(peng, batch_size=batch,
                                        decode_workers=workers), paths)
    _, want, _ = _serve(JShadowServer(jeng, batch_size=batch,
                                      decode_workers=workers), paths)
    assert isinstance(stats, ServerStats)
    assert stats.frames == 7 and stats.fps > 0
    assert set(got) == set(want) == set(paths)
    # one decode-start → sink latency per served frame, percentiles ordered
    # and bounded by the wall time
    assert len(stats.latencies) == 7
    assert 0 < stats.p50_ms <= stats.p99_ms <= stats.wall_seconds * 1e3
    assert stats.latency_ms(0) <= stats.p50_ms
    assert stats.sync_seconds >= 0 and stats.compute_seconds > 0
    assert stats.decode_seconds > 0
    for p in paths:
        assert got[p].dtype == np.uint8 and got[p].shape == (24, 40, 1)
        assert np.abs(got[p].astype(int) - want[p].astype(int)).max() <= 1
        # and exactly the port engine's own codes for that frame
        ref = peng(read_exr_stack(p))
        ref_u8 = np.round(np.clip(ref, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(got[p], ref_u8)


def test_server_keeps_input_order_with_one_decoder(frames_dir, engines):
    """Sink order is completion order; with one decode worker that is the
    order of the paths, as in the JAX server."""
    jeng, peng = engines
    paths = _paths(frames_dir)
    _, _, order = _serve(ShadowServer(peng, batch_size=2, decode_workers=1), paths)
    _, _, jorder = _serve(JShadowServer(jeng, batch_size=2, decode_workers=1), paths)
    assert order == jorder == paths


def test_server_skips_bad_files(frames_dir, engines, caplog):
    _, peng = engines
    paths = _paths(frames_dir, garbage=True)
    with caplog.at_level(logging.WARNING):
        stats, got, _ = _serve(ShadowServer(peng, batch_size=3), paths)
    assert stats.frames == 7           # garbage skipped, the others served
    assert not any(p.endswith("f099.exr") for p in got)
    assert any("skipping" in r.getMessage() and "f099.exr" in r.getMessage()
               for r in caplog.records)


def test_server_stats_empty():
    s = ServerStats()
    assert s.fps == 0.0 and s.p50_ms == 0.0 and s.p99_ms == 0.0


@pytest.fixture(scope="module")
def cli_work(tmp_path_factory):
    """Four EXR frames in [0, 1) and a train_stats.npy from deploy_w16's
    statistics."""
    root = tmp_path_factory.mktemp("serve_cli")
    with open(os.path.join(GOLDEN, "deploy_w16.json")) as f:
        meta = json.load(f)
    np.save(root / "train_stats.npy",
            {"means": meta["means"], "stds": meta["stds"]}, allow_pickle=True)
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        x = rng.random((48, 64, 4)).astype(np.float32)
        write_exr(str(frames / f"f{i}.exr"), {c: x[..., k] for k, c in enumerate("RGBA")})
    return root


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"], ["--no_fold_bn"]],
                         ids=["fold_bn", "int8", "no_fold_bn"])
def test_serve_cli_matches_jax_cli(cli_work, monkeypatch, extra):
    """``python -m pcss_unet_tpu_torch serve --device cpu`` writes one PNG
    per EXR with the codes of the JAX CLI's (within one; bf16 on both
    sides; the JAX engine's Pallas kernels interpreted, so both route the
    same blocks to kernels)."""
    import pcss_unet_tpu.__main__ as jmain
    import pcss_unet_tpu_torch.__main__ as pmain

    monkeypatch.setattr(jinfer, "InferenceEngine", functools.partial(
        jinfer.InferenceEngine, pallas_interpret=True))
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    common = ["--frames_dir", str(cli_work / "frames"), "--weights", WEIGHTS,
              "--stats_dir", str(cli_work), "--batch", "2", *extra]
    out_p, out_j = cli_work / ("p" + "".join(extra)), cli_work / ("j" + "".join(extra))
    for mod, argv in ((pmain, ["--out_dir", str(out_p), "--device", "cpu"]),
                      (jmain, ["--out_dir", str(out_j)])):
        monkeypatch.setattr(sys, "argv", [mod.__name__, "serve", *common, *argv])
        mod.main()
    names = sorted(os.listdir(out_p))
    assert names == sorted(os.listdir(out_j)) == [f"f{i}.png" for i in range(4)]
    for n in names:
        got = np.asarray(Image.open(out_p / n)).astype(int)
        want = np.asarray(Image.open(out_j / n)).astype(int)
        assert got.shape == want.shape == (48, 64)
        assert np.abs(got - want).max() <= 1
        assert got.min() < got.max()


def test_serve_cli_writes_the_served_codes(cli_work):
    """The sink writes the uint8 codes it receives unchanged (K4's rounding,
    not the infer CLI's truncation): each PNG equals ``render_u8`` of the
    engine built the same way."""
    import torch

    from pcss_unet_tpu_torch.cli import serve as cli_serve
    from pcss_unet_tpu_torch.infer import load_variables
    from pcss_unet_tpu_torch.io.png import decode_png_l

    out = cli_work / "codes"
    res = cli_serve.main(["--frames_dir", str(cli_work / "frames"), "--out_dir",
                          str(out), "--weights", WEIGHTS, "--stats_dir",
                          str(cli_work), "--batch", "3", "--device", "cpu"])
    assert res["stats"].frames == 4 and res["write_seconds"] > 0
    with open(os.path.join(GOLDEN, "deploy_w16.json")) as f:
        meta = json.load(f)
    engine = InferenceEngine(None, load_variables(WEIGHTS), fold_bn=True,
                             dtype=torch.bfloat16, device="cpu",
                             means=np.asarray(meta["means"], np.float32),
                             stds=np.asarray(meta["stds"], np.float32))
    for i in range(4):
        x = read_exr_stack(str(cli_work / "frames" / f"f{i}.exr"))
        want = engine.render_u8(x[None]).numpy()[0, ..., 0]
        with open(out / f"f{i}.png", "rb") as f:
            np.testing.assert_array_equal(decode_png_l(f.read()), want)


def test_served_golden_reaches_committed_quality(tmp_path):
    """deploy_w16's 8 validation frames as ZIP EXRs through the port's
    server and its NHWC fused+int8 engine in float32 reach the committed
    label-PSNR less 0.6 dB (``tests/test_serve_golden.py``'s slack)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    from make_deployment_golden import make_frames

    from pcss_unet_tpu_torch.infer import load_variables

    with open(os.path.join(GOLDEN, "deploy_w16.json")) as f:
        meta = json.load(f)
    engine = InferenceEngine(None, load_variables(WEIGHTS), fold_bn=True,
                             quantize="int8", dtype=torch.float32, device="cpu",
                             means=np.asarray(meta["means"], np.float32),
                             stds=np.asarray(meta["stds"], np.float32))
    xv, yv = make_frames(meta["seed_val"], meta["n_val"])
    paths = []
    for i, x in enumerate(xv):
        p = str(tmp_path / f"val{i:02d}.exr")
        write_exr(p, {c: x[..., k] for k, c in enumerate("RGBA")}, compression="ZIP")
        paths.append(p)
    stats, masks, _ = _serve(ShadowServer(engine, batch_size=2, decode_workers=2), paths)
    assert stats.frames == len(paths)
    assert set(engine.model.routes().values()) - {"plain"}
    psnrs = []
    for p, y in zip(paths, yv):
        m = masks[p]
        assert m.dtype == np.uint8 and m.shape == y.shape
        mse = float(np.mean((m.astype(np.float32) / 255.0 - y[..., 0:1]) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
    assert float(np.mean(psnrs)) >= meta["val_psnr_db"] - 0.6


def test_kernel_wrappers_bound_the_batch_extent():
    """The kernels take 32-bit shapes: their wrappers refuse a tensor of 2^31
    elements or more before any launch, and take the serving batch's
    largest activation (w64 enc_0 at N = 4: 133.7 M elements)."""
    import torch

    from pcss_unet_tpu_torch.ops.kernels import _build

    _build.check_extent(torch.empty((4, 64, 544, 960), device="meta"), None)
    with pytest.raises(ValueError, match="2\\^31"):
        _build.check_extent(torch.empty((17, 64, 1088, 1920), device="meta"))
