"""``python -m pcss_unet_tpu_torch train`` (``cli/train.py``) on the CPU:
it trains on a tiny pack and writes the resolved config the JAX CLI
writes; what the port cannot do yet exits 2; without a card the default
device raises."""

import json
import os

import numpy as np
import pytest
import torch

from pcss_unet_tpu_torch.cli.train import main


@pytest.fixture
def work(tmp_path, monkeypatch):
    """A tiny pack and a w4 config, in a working directory of its own."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
    y = (x.mean(axis=-1, keepdims=True) > 0).astype(np.float32)
    d = tmp_path / "d"
    d.mkdir()
    np.save(d / "train_inputs.npy", x)
    np.save(d / "train_labels.npy", y)
    np.save(d / "val_inputs.npy", x[:4])
    np.save(d / "val_labels.npy", y[:4])
    (tmp_path / "cfg.ini").write_text(
        "[base]\nbase_width=4\nbatch_size=4\nnum_epochs=2\nwarmup_epochs=1\n"
        "save_frequency=1\nlog_dir=logs\nsave_dir=ck\nprocessed_data_dir=d\n")
    return tmp_path


def test_train_on_cpu_writes_config_and_checkpoints(work):
    result = main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
                   "--loss_type", "perturb", "--ema_decay", "0.9"])
    assert [h["epoch"] for h in result.history] == [0, 1]
    assert np.isfinite(result.best_val_loss)
    resolved = json.loads((work / "ck" / "resolved_config.json").read_text())
    assert resolved["vgg_weights"] == "random-seeded-fallback"
    assert resolved["loss_type"] == "perturb" and resolved["base_width"] == 4
    assert resolved["ema_decay"] == 0.9
    assert {"ckpt_0.pt", "ckpt_1000.pt"} <= set(os.listdir(work / "ck"))
    # a rerun resumes after the last epoch and trains no more
    again = main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
                  "--loss_type", "perturb", "--ema_decay", "0.9"])
    assert again.history == []


def test_resolved_config_matches_the_jax_cli(work, monkeypatch):
    """The same flags give the JAX CLI's resolved config, key for key.
    Both CLIs write it before they train, so both ``fit``s are stubbed
    here (the first test trains for real)."""
    import pcss_unet_tpu.cli.train as jcli
    import pcss_unet_tpu_torch.train.loop as loop

    class Done:
        best_val_loss = 0.0

    monkeypatch.setattr(jcli, "fit", lambda *a, **k: Done())
    monkeypatch.setattr(loop, "fit", lambda *a, **k: Done())
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    flags = ["--config", "cfg.ini", "--allow_random_vgg", "--num_epochs", "3",
             "--grad_accum_steps", "2", "--no_shuffle", "--ema_decay", "0.5",
             "--loss_type", "perturb", "--seed", "5"]
    main(flags + ["--save_dir", "p", "--device", "cpu"])
    jcli.main(flags + ["--save_dir", "j"])
    mine = json.loads((work / "p" / "resolved_config.json").read_text())
    theirs = json.loads((work / "j" / "resolved_config.json").read_text())
    assert mine.pop("save_dir") == "p" and theirs.pop("save_dir") == "j"
    assert mine == theirs


@pytest.mark.parametrize("flags", [
    ["--multihost"], ["--grain"], ["--data_parallel", "2"],
    ["--spatial_parallel", "2"], ["--batch_size", "0"],
    ["--grad_accum_steps", "0"], ["cache_on"]])
def test_unported_flags_exit_2(work, capsys, flags):
    if flags == ["cache_on"]:
        with open(work / "cfg.ini", "a") as f:
            f.write("device_data_cache=on\n")
        flags = []
    with pytest.raises(SystemExit) as e:
        main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err and "pcss_unet_tpu train" in err


def test_data_parallel_auto_is_one_device(work):
    result = main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
                   "--data_parallel", "-1", "--num_epochs", "1"])
    assert len(result.history) == 1


def test_random_vgg_needs_consent(work):
    with pytest.raises(SystemExit, match="allow_random_vgg"):
        main(["--config", "cfg.ini", "--device", "cpu"])


def test_default_device_is_the_card(work):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", "cfg.ini", "--allow_random_vgg"])
