"""``python -m pcss_unet_tpu_torch temporal`` against the JAX package's
``temporal`` CLI on the same frames, in process: the committed deploy_w16
net on its golden sequence (the frames and motion vectors behind its
temporal-instability pin) in each posture, and the synthetic animated
scene with its motion vectors, as ``tests/test_cli_tools.py`` and
``tests/test_temporal_postures.py`` set them up.  Both engines run in
float32, the JAX one op by op (``jax.disable_jit``) with its Pallas kernels
in interpret mode; the scores agree within 1e-5."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcss_unet_tpu.__main__ as jmain
import pcss_unet_tpu.infer as jinfer
import pcss_unet_tpu_torch.__main__ as pmain
import pcss_unet_tpu_torch.infer as pinfer
from pcss_unet_tpu.io.exr import write_exr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WEIGHTS = os.path.join(HERE, "golden", "deploy_w16.npz")
N_FRAMES = 3


def _score(out: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("temporal instability")]
    assert len(line) == 1, out
    return float(line[0].rsplit(":", 1)[1])


@pytest.fixture
def float32_engines(monkeypatch):
    """Both CLIs' engines in float32 (the CLIs take no dtype flag; they
    import ``InferenceEngine`` from their ``infer`` package as they run),
    the JAX one with its Pallas kernels interpreted."""
    monkeypatch.setattr(jinfer, "InferenceEngine", functools.partial(
        jinfer.InferenceEngine, dtype=jnp.float32, pallas_interpret=True))
    monkeypatch.setattr(pinfer, "InferenceEngine", functools.partial(
        pinfer.InferenceEngine, dtype=torch.float32))


def _run_both(argv, monkeypatch, capsys):
    """The port's CLI (``--device cpu``) and the JAX CLI under
    ``jax.disable_jit`` → (port score, returned dict, JAX score)."""
    monkeypatch.setattr(sys, "argv", [pmain.__name__, "temporal", *argv,
                                      "--device", "cpu"])
    got = pmain.main()
    mine = _score(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", [jmain.__name__, "temporal", *argv])
    with jax.disable_jit():
        jmain.main()
    return mine, got, _score(capsys.readouterr().out)


@pytest.fixture(scope="module")
def golden_sequence(tmp_path_factory):
    """The first frames of deploy_w16's golden sequence as EXRs, their
    motion vectors, and a stats dir with the net's train stats."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_deployment_golden as g

    with open(os.path.join(HERE, "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    seq, motion = g.make_sequence(meta["seed_seq"], meta["n_seq"])
    root = tmp_path_factory.mktemp("seq")
    (root / "frames").mkdir()
    for t, frame in enumerate(seq[:N_FRAMES]):
        write_exr(str(root / "frames" / f"t{t:03d}.exr"),
                  {n: frame[..., i] for i, n in enumerate("RGBA")})
    np.save(root / "motion.npy", motion[:N_FRAMES - 1])
    np.save(root / "train_stats.npy", {"means": meta["means"],
                                       "stds": meta["stds"]})
    return root


@pytest.mark.parametrize("posture", [[], ["--fold_bn"],
                                     ["--fold_bn", "--quantize", "int8"]],
                         ids=["plain", "fold_bn", "fold_bn_int8"])
def test_golden_sequence_matches_jax_cli(golden_sequence, float32_engines,
                                         monkeypatch, capsys, tmp_path,
                                         posture):
    root = golden_sequence
    argv = ["--frames_dir", str(root / "frames"), "--weights", WEIGHTS,
            "--stats_dir", str(root), "--motion_vectors",
            str(root / "motion.npy"), "--alpha", "5", *posture]
    mine, got, theirs = _run_both(
        argv + ["--save_masks_dir", str(tmp_path / "m")], monkeypatch, capsys)
    assert got == {"frames": N_FRAMES, "score": pytest.approx(mine, abs=1e-6)}
    assert abs(mine - theirs) <= 1e-5, (mine, theirs)
    assert sorted(os.listdir(tmp_path / "m")) == [
        f"t{t:03d}.png" for t in range(N_FRAMES)]
    assert 0.0 < mine < 0.05


def test_animated_sequence_with_motion_vectors_matches_jax_cli(
        tmp_path, float32_engines, monkeypatch, capsys):
    """scripts/make_synthetic_scene.py --animate: the sequence and its
    ground-truth motion vectors, through both CLIs; warping by the motion
    changes the score."""
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/make_synthetic_scene.py"),
         "--out", str(tmp_path / "scene"), "--frames", str(N_FRAMES),
         "--height", "48", "--width", "64", "--animate"],
        check=True, cwd=REPO, capture_output=True)
    seq = tmp_path / "scene" / "sequence"
    mv = tmp_path / "scene" / "motion.npy"
    argv = ["--frames_dir", str(seq), "--weights", WEIGHTS, "--fold_bn",
            "--quantize", "int8"]
    warped, _, theirs = _run_both(argv + ["--motion_vectors", str(mv)],
                                  monkeypatch, capsys)
    assert abs(warped - theirs) <= 1e-5, (warped, theirs)
    monkeypatch.setattr(sys, "argv", [pmain.__name__, "temporal", *argv,
                                      "--device", "cpu"])
    assert pmain.main()["score"] != pytest.approx(warped, abs=1e-6)


def test_needs_two_frames(tmp_path, monkeypatch):
    (tmp_path / "f").mkdir()
    write_exr(str(tmp_path / "f" / "a.exr"),
              {n: np.zeros((16, 16), np.float32) for n in "RGBA"})
    monkeypatch.setattr(sys, "argv", [pmain.__name__, "temporal", "--frames_dir",
                                      str(tmp_path / "f"), "--weights", WEIGHTS,
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="at least 2 frames"):
        pmain.main()


def test_default_device_is_the_card(golden_sequence, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", [pmain.__name__, "temporal", "--frames_dir",
                                      str(golden_sequence / "frames"),
                                      "--weights", WEIGHTS])
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        pmain.main()
