"""The port's CLIs against the JAX package's, at test time, on the CPU:
``python -m pcss_unet_tpu_torch infer|validate --device cpu`` and
``python -m pcss_unet_tpu infer|validate`` on the same EXR and weights
(``tests/golden/deploy_w16.npz``), in process through both dispatchers.

PNG codes agree within one: the int8 postures are not continuous in their
input, and the JAX engine, jitted, moves an int8 tie by itself
(``tests/test_torch_nhwc_posture.py``).  The JAX CLI's channels-major
posture needs its Pallas kernels, which run here in interpret mode."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import pcss_unet_tpu.__main__ as jmain
import pcss_unet_tpu.infer as jinfer
import pcss_unet_tpu_torch.__main__ as pmain
from pcss_unet_tpu.io.exr import write_exr

HERE = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(HERE, "golden", "deploy_w16.npz")
W8_PTH = os.path.join(HERE, "golden", "torch_trained_w8.pth")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """An EXR frame and a train_stats.npy from deploy_w16's statistics."""
    root = tmp_path_factory.mktemp("torch_cli")
    with open(os.path.join(HERE, "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    np.save(root / "train_stats.npy",
            {"means": meta["means"], "stds": meta["stds"]}, allow_pickle=True)
    rng = np.random.default_rng(7)
    x = rng.random((96, 128, 4)).astype(np.float32)
    write_exr(str(root / "frame.exr"), {c: x[..., i] for i, c in enumerate("RGBA")})
    return root


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The JAX CLI would turn on its on-disk compilation cache under HOME."""
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")


def _run(main_mod, argv, monkeypatch):
    """``python -m <package> <argv>`` in process."""
    monkeypatch.setattr(sys, "argv", [main_mod.__name__, *argv])
    main_mod.main()


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX CLI's engine with its Pallas kernels in interpret mode (the
    CLI imports InferenceEngine from ``pcss_unet_tpu.infer`` when it runs)."""
    monkeypatch.setattr(jinfer, "InferenceEngine", functools.partial(
        jinfer.InferenceEngine, pallas_interpret=True))


def _codes(path):
    return np.asarray(Image.open(path)).astype(int)


@pytest.mark.parametrize("extra", [
    [], ["--fold_bn", "--quantize", "int8", "--layout", "chw"],
    ["--tile", "64", "--halo", "8"], ["--save_format", "RGB"],
    ["--fold_bn", "--quantize", "int8", "--tile", "64", "--halo", "8"]],
    ids=["nhwc", "chw_int8", "tiled", "rgb", "nhwc_int8_tiled"])
def test_infer_matches_jax_cli(work, monkeypatch, jax_interpret, capsys, extra):
    common = ["--input", str(work / "frame.exr"), "--weights", WEIGHTS,
              "--stats_dir", str(work), "--dtype", "float32", *extra]
    _run(pmain, ["infer", "--output", str(work / "p.png"), "--device", "cpu",
                 *common], monkeypatch)
    assert "wrote" in capsys.readouterr().out
    _run(jmain, ["infer", "--output", str(work / "j.png"), *common], monkeypatch)
    got, want = _codes(work / "p.png"), _codes(work / "j.png")
    assert got.shape == want.shape
    assert got.shape[:2] == (96, 128)
    assert np.abs(got - want).max() <= 1
    assert got.min() < got.max()


@pytest.mark.parametrize("extra", [[], ["--fold_bn"],
                                   ["--fold_bn", "--quantize", "int8"]],
                         ids=["plain", "fold_bn", "fold_bn_int8"])
def test_validate_matches_jax_cli(work, monkeypatch, capsys, extra):
    common = ["--weights", WEIGHTS, "--input", str(work / "frame.exr"),
              "--stats_dir", str(work), *extra]
    _run(pmain, ["validate", "--output_dir", str(work / "pv"), "--device",
                 "cpu", *common], monkeypatch)
    got = capsys.readouterr().out
    _run(jmain, ["validate", "--output_dir", str(work / "jv"), *common],
         monkeypatch)
    want = capsys.readouterr().out

    def parse(out):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("MSE", "PSNR", "verdict"))]
        assert len(lines) == 3, out
        return float(lines[0].split("=")[1]), lines[2].split(":")[1].strip()

    (mse_p, verdict_p), (mse_j, verdict_j) = parse(got), parse(want)
    assert verdict_p == verdict_j
    assert abs(mse_p - mse_j) <= 1e-6
    for name in ("train_pathway.png", "infer_pathway.png", "abs_diff.png"):
        assert _codes(work / "pv" / name).shape == (96, 128)


def test_validate_returns_the_comparison(work):
    from pcss_unet_tpu_torch.cli import validate

    res = validate.main(["--weights", WEIGHTS, "--input", str(work / "frame.exr"),
                         "--output_dir", str(work / "pv2"), "--device", "cpu"])
    assert res["verdict"] == "exact" and res["mse"] < 1e-6


@pytest.mark.parametrize("cli", ["infer", "validate"])
@pytest.mark.parametrize("weights", [WEIGHTS, W8_PTH], ids=["npz", "pth"])
def test_ema_on_an_export_raises_as_jax(work, monkeypatch, cli, weights):
    argv = [cli, "--input", str(work / "frame.exr"), "--weights", weights,
            "--ema"]
    argv += (["--output", str(work / "e.png")] if cli == "infer"
             else ["--output_dir", str(work / "ev")])
    with pytest.raises(ValueError) as pe:
        _run(pmain, [*argv, "--device", "cpu"], monkeypatch)
    with pytest.raises(ValueError) as je:
        _run(jmain, argv, monkeypatch)
    assert str(pe.value) == str(je.value)


def test_checkpoint_overrides_config_architecture(work, monkeypatch):
    """As tests/test_cli.py: with no --config the defaults say base_width=64,
    model_depth=4, and the .pth is an (8, 16, 32, 64) net; the model
    follows the checkpoint, and the mask matches the JAX CLI's."""
    common = ["infer", "--input", str(work / "frame.exr"), "--weights",
              W8_PTH, "--dtype", "float32"]
    _run(pmain, [*common, "--output", str(work / "w8p.png"), "--device", "cpu"],
         monkeypatch)
    _run(jmain, [*common, "--output", str(work / "w8j.png")], monkeypatch)
    got, want = _codes(work / "w8p.png"), _codes(work / "w8j.png")
    assert got.shape == (96, 128)
    assert np.abs(got - want).max() <= 1


def test_unported_model_options_raise(work, monkeypatch):
    """Nothing refuses a model option any more: a gelu config (flax's tanh
    approximation) runs and matches the JAX CLI within one code."""
    ini = work / "gelu.ini"
    ini.write_text("[base]\nactivation=gelu\n")
    common = ["infer", "--input", str(work / "frame.exr"), "--weights", WEIGHTS,
              "--stats_dir", str(work), "--dtype", "float32", "--config", str(ini)]
    _run(pmain, [*common, "--output", str(work / "g.png"), "--device", "cpu"],
         monkeypatch)
    _run(jmain, [*common, "--output", str(work / "gj.png")], monkeypatch)
    got, want = _codes(work / "g.png"), _codes(work / "gj.png")
    assert got.shape == (96, 128)
    assert np.abs(got - want).max() <= 1


def test_orbax_directory_refused(work, monkeypatch):
    with pytest.raises(ValueError, match="export_torch_checkpoint"):
        _run(pmain, ["infer", "--input", str(work / "frame.exr"), "--weights",
                     str(work), "--output", str(work / "o.png"), "--device",
                     "cpu"], monkeypatch)


def test_default_device_is_the_card(work, monkeypatch):
    """Without ``--device cpu`` the CLI targets the card; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(pmain, ["infer", "--input", str(work / "frame.exr"), "--weights",
                     WEIGHTS, "--output", str(work / "c.png")], monkeypatch)


@pytest.mark.parametrize("argv,code", [
    (["train", "--help"], 0), (["inspect", "--help"], 0), (["bogus"], 2), ([], 2),
    (["--help"], 0), (["organize", "--help"], 0), (["prepare", "--help"], 0),
    (["stats", "--help"], 0), (["check", "--help"], 0),
    (["temporal", "--help"], 0)])
def test_dispatcher_exit_codes(monkeypatch, capsys, argv, code):
    with pytest.raises(SystemExit) as e:
        _run(pmain, argv, monkeypatch)
    assert e.value.code == code
    out = capsys.readouterr()
    if argv[:1] == ["inspect"]:        # ported: its own parser's help
        assert "--latency" in out.out and "--device" in out.out
    if argv[:1] == ["train"]:          # ported: its own parser's help
        assert "--allow_random_vgg" in out.out and "--device" in out.out
    if argv[:1] == ["temporal"]:
        assert "--motion_vectors" in out.out and "--device" in out.out
    if argv[:1] in (["organize"], ["prepare"], ["stats"], ["check"]):
        assert out.out.startswith("usage:") and "--device" not in out.out
