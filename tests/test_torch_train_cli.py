"""``python -m pcss_unet_tpu_torch train`` (``cli/train.py``) on the CPU:
it trains on a tiny pack and writes the resolved config the JAX CLI
writes, with the memory governor's auto modes, the ``--grain`` loader and
the device cache too; ``--spatial_parallel`` trains on row shards, and a
misaligned frame height is refused; without a card the default device
raises."""

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


@pytest.fixture
def tall(tmp_path, monkeypatch):
    """A pack of 32-row frames (two shards of 16 rows: the reference net's
    row alignment) and a w4 config, in a working directory of its own;
    the ranks the CLI starts take one thread each."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 16, 4)).astype(np.float32)
    y = (x.mean(axis=-1, keepdims=True) > 0).astype(np.float32)
    d = tmp_path / "d"
    d.mkdir()
    np.save(d / "train_inputs.npy", x)
    np.save(d / "train_labels.npy", y)
    np.save(d / "val_inputs.npy", x[:4])
    np.save(d / "val_labels.npy", y[:4])
    (tmp_path / "cfg.ini").write_text(
        "[base]\nbase_width=4\nbatch_size=4\nnum_epochs=1\nwarmup_epochs=1\n"
        "save_frequency=1\nlog_dir=logs\nsave_dir=ck\nprocessed_data_dir=d\n"
        "compute_dtype=float64\n")
    return tmp_path


def test_spatial_parallel_trains_with_the_jax_cli_config(tall, monkeypatch):
    """``train --spatial_parallel 2 --device cpu`` starts two ranks, each on
    16 of the 32 rows, and trains: one set of checkpoints, written by rank
    0; its ``resolved_config.json`` is the JAX CLI's, key for key (the JAX
    CLI's ``fit`` is stubbed: it writes the config before it trains)."""
    import pcss_unet_tpu.cli.train as jcli

    class Done:
        best_val_loss = 0.0

    monkeypatch.setattr(jcli, "fit", lambda *a, **k: Done())
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    flags = ["--config", "cfg.ini", "--allow_random_vgg", "--spatial_parallel", "2"]
    assert main(flags + ["--save_dir", "p", "--device", "cpu"]) is None
    jcli.main(flags + ["--save_dir", "j"])
    mine = json.loads((tall / "p" / "resolved_config.json").read_text())
    theirs = json.loads((tall / "j" / "resolved_config.json").read_text())
    assert mine.pop("save_dir") == "p" and theirs.pop("save_dir") == "j"
    assert mine == theirs and mine["spatial_parallel"] == 2
    files = sorted(f for f in os.listdir(tall / "p") if not f.startswith("."))
    assert files == ["checkpoints.json", "ckpt_0.pt", "resolved_config.json"]


def test_data_and_spatial_parallel_match_one_process(tall):
    """``--data_parallel 2 --spatial_parallel 2`` (four ranks, a 2×2 grid)
    trains what ``--spatial_parallel 1`` trains, float64 compute: the saved
    train and validation losses."""
    common = ["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
              "--loss_type", "perturb"]
    one = main(common + ["--spatial_parallel", "1", "--save_dir", "one"])
    assert main(common + ["--data_parallel", "2", "--spatial_parallel", "2",
                          "--save_dir", "grid"]) is None
    m1 = json.loads((tall / "one" / "checkpoints.json").read_text())
    m2 = json.loads((tall / "grid" / "checkpoints.json").read_text())
    assert m1.keys() == m2.keys() == {"0"} and len(one.history) == 1
    for name, v in m1["0"].items():
        assert m2["0"][name] == pytest.approx(v, rel=1e-6), name


def test_misaligned_height_exits_naming_the_alignment(work):
    """16-row frames over two shards give 8 rows, not a multiple of the
    reference net's row alignment 16: refused before any rank starts."""
    with pytest.raises(SystemExit) as e:
        main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
              "--spatial_parallel", "2"])
    assert e.value.code not in (0, None)
    assert "row alignment 16" in str(e.value.code)
    assert not (work / "ck").exists()


@pytest.mark.parametrize("flags", [
    ["--grain", "--grain_workers", "2"], ["--batch_size", "0"],
    ["--grad_accum_steps", "0", "--data_parallel", "1"], ["cache_on"]],
    ids=["grain", "batch_size_0", "grad_accum_steps_0", "cache_on"])
def test_governor_grain_and_cache_options_match_the_jax_cli(work, monkeypatch,
                                                            flags):
    """Each option the port used to refuse now trains on the CPU, and the
    resolved config (the picked batch and accumulation included) is the
    JAX CLI's, key for key (the JAX CLI's ``fit`` is stubbed: it writes the
    config before it trains)."""
    import pcss_unet_tpu.cli.train as jcli
    import pcss_unet_tpu_torch.train.loop as loop
    from pcss_unet_tpu_torch.data import device_cache
    from pcss_unet_tpu_torch.data.grain_pipeline import GrainLoader

    class Done:
        best_val_loss = 0.0

    if flags == ["cache_on"]:
        with open(work / "cfg.ini", "a") as f:
            f.write("device_data_cache=on\ndevice_cache_budget_mb=0\n")
        flags = []
    seen = {"caches": 0}
    real_fit, real_cache = loop.fit, device_cache.DeviceCache

    def spy_fit(cfg, model, train_loader, *a, **k):
        seen["loader"] = train_loader
        return real_fit(cfg, model, train_loader, *a, **k)

    def spy_cache(*a, **k):
        seen["caches"] += 1
        return real_cache(*a, **k)

    monkeypatch.setattr(loop, "fit", spy_fit)
    monkeypatch.setattr(loop, "DeviceCache", spy_cache)
    monkeypatch.setattr(jcli, "fit", lambda *a, **k: Done())
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    common = ["--config", "cfg.ini", "--allow_random_vgg", "--num_epochs", "1",
              *flags]
    result = main(common + ["--save_dir", "p", "--device", "cpu"])
    jcli.main(common + ["--save_dir", "j"])
    mine = json.loads((work / "p" / "resolved_config.json").read_text())
    theirs = json.loads((work / "j" / "resolved_config.json").read_text())
    assert mine.pop("save_dir") == "p" and theirs.pop("save_dir") == "j"
    assert mine == theirs
    assert mine["batch_size"] > 0 and mine["grad_accum_steps"] > 0
    assert len(result.history) == 1
    assert np.isfinite(result.history[0]["train"]["total_loss"])
    assert isinstance(seen["loader"], GrainLoader) == ("--grain" in flags)
    # config.ini's default (auto, 6144 MB) caches the tiny pack too; a
    # budget of 0 MB with "on" still caches (train and val packs)
    assert seen["caches"] == 2


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


def _leaves(tree, prefix=""):
    """A nested dict of arrays → {path: array}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for name, sub in tree.items()
            for k, v in _leaves(sub, f"{prefix}/{name}").items()}


def test_save_dir_loads_as_weights(work):
    """``load_variables`` (what ``infer --weights`` calls) reads a run's
    checkpoint directory: its best checkpoint's parameters and statistics
    as JAX-layout variables, the EMA parameters with ``ema=True``; a run
    without EMA raises there."""
    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.infer import load_variables
    from pcss_unet_tpu_torch.models.torch_import import to_flax_variables
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.train import create_train_state
    from pcss_unet_tpu_torch.train.checkpoint import CheckpointManager

    torch.manual_seed(0)
    model = UNet(encoder_widths=(4, 8))
    state = create_train_state(model, Config(ema_decay=0.5), 1)
    with torch.no_grad():
        for e in state.ema_params:
            e.mul_(0.5)
    manager = CheckpointManager(str(work / "ck"))
    manager.save(state, {"val_loss": 1.0}, 0)
    manager.save(state, {"val_loss": 2.0}, 1)
    w = {k: v.copy() for k, v in _leaves(to_flax_variables(model)).items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    manager.save(state, {"val_loss": 3.0}, 2)     # the latest, not the best
    g = _leaves(load_variables(str(work / "ck")))
    assert g.keys() == w.keys() and len(g) > 10
    for k in g:
        assert np.array_equal(g[k], w[k]), k
    ema = _leaves(load_variables(str(work / "ck"), ema=True))
    assert any(not np.array_equal(ema[k], w[k]) for k in ema if "/params/" in k)
    state.ema_params = None
    manager.save(state, {"val_loss": 0.5}, 3)
    with pytest.raises(ValueError, match="EMA"):
        load_variables(str(work / "ck"), ema=True)
