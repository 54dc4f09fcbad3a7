"""The port's ``fit`` loop and checkpoints (``pcss_unet_tpu_torch.train``),
mirroring ``tests/test_fit.py``, ``test_midepoch_resume.py``,
``test_preemption.py`` and ``test_trained_cycle.py``, and held against the
JAX package's ``fit`` on one tiny pack."""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.data import Loader as JLoader
from pcss_unet_tpu.data import PackedDataset as JPacked
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.models.vgg import init_vgg_params

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
from pcss_unet_tpu_torch.models.torch_import import from_flax_variables
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.train import fit
from pcss_unet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  check_resume_compat,
                                                  export_reference_checkpoint)


class NullWriter:
    def scalar(self, *a, **k): pass
    def image(self, *a, **k): pass
    def flush(self): pass


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Synthetic learnable task (test_fit.py's): label = sign of the
    channel mean; and the JAX package's seeded VGG parameters as the
    ``.npz`` both packages read."""
    out = str(tmp_path_factory.mktemp("fitdata"))
    rng = np.random.default_rng(0)
    n, h, w = 8, 16, 16
    x = rng.standard_normal((n, h, w, 4)).astype(np.float32)
    y = (x.mean(axis=-1, keepdims=True) > 0).astype(np.float32)
    np.save(os.path.join(out, "train_inputs.npy"), x)
    np.save(os.path.join(out, "train_labels.npy"), y)
    np.save(os.path.join(out, "val_inputs.npy"), x[:4])
    np.save(os.path.join(out, "val_labels.npy"), y[:4])
    np.save(os.path.join(out, "train_stats.npy"),
            {"means": x.mean(axis=(0, 1, 2)), "stds": x.std(axis=(0, 1, 2))})
    flat = {}
    for name, leaf in init_vgg_params().items():
        flat[f"{name}_kernel"] = np.asarray(leaf["kernel"])
        flat[f"{name}_bias"] = np.asarray(leaf["bias"])
    np.savez(os.path.join(out, "vgg.npz"), **flat)
    return out


def _model(widths=(8, 16), dropout=0.0, seed=0):
    torch.manual_seed(seed)
    return UNet(encoder_widths=widths, dropout_rate=dropout)


def test_fit_matches_jax_fit(packs, cpus):
    """The same pack, loader order, initial variables (the JAX package's
    init for ``cfg.seed``, carried across), VGG parameters and config,
    float32, dropout 0: the port's epoch losses (train and val) follow the
    JAX package's within 3e-4 relative over 3 epochs of Adam (6.5e-5
    measured): float32 rounding of the two frameworks' convolutions, which
    Adam's normalized first steps amplify."""
    kw = dict(batch_size=4, num_epochs=3, warmup_epochs=1, learning_rate=3e-3,
              validation_frequency=1, data_parallel=1, spatial_parallel=1,
              dropout_rate=0.0, save_dir="", log_dir="",
              vgg_weights_path=os.path.join(packs, "vgg.npz"),
              device_data_cache="off")
    jcfg = JConfig(**kw)
    jmodel = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    from pcss_unet_tpu.train import fit as jfit

    jr = jfit(jcfg, jmodel, JLoader(JPacked(packs, "train"), 4, shuffle=True, seed=0),
              JLoader(JPacked(packs, "val"), 4, shuffle=False), devices=cpus[:1],
              writer=NullWriter(), install_preemption_handler=False,
              log_every=1000)
    key = jax.random.PRNGKey(jcfg.seed)
    v = jmodel.init({"params": key, "dropout": key}, jnp.zeros((4, 16, 16, 4)), True)
    model = _model()
    model.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, dict(v))))
    pr = fit(Config(**kw), model,
             Loader(PackedDataset(packs, "train"), 4, shuffle=True, seed=0),
             Loader(PackedDataset(packs, "val"), 4, shuffle=False),
             writer=NullWriter(), install_preemption_handler=False, log_every=1000)
    assert [h["epoch"] for h in pr.history] == [0, 1, 2]
    for jh, ph in zip(jr.history, pr.history):
        for split in ("train", "val"):
            assert set(ph[split]) == set(jh[split]), split
            for k in ("total_loss", "l1_loss", "vgg_loss"):
                np.testing.assert_allclose(ph[split][k], jh[split][k], rtol=3e-4,
                                           err_msg=f"epoch {jh['epoch']} {split} {k}")
    assert pr.best_val_loss == pytest.approx(jr.best_val_loss, rel=3e-4)


def test_fit_end_to_end_and_resume(packs, tmp_path):
    cfg = Config(batch_size=4, num_epochs=3, warmup_epochs=1, learning_rate=3e-3,
                 validation_frequency=1, save_frequency=1, save_dir="",
                 log_dir=str(tmp_path / "logs"),
                 vgg_weights_path=os.path.join(packs, "vgg.npz"))
    loaders = (Loader(PackedDataset(packs, "train"), 4, shuffle=True, seed=0),
               Loader(PackedDataset(packs, "val"), 4, shuffle=False))
    model = _model(dropout=0.1)
    result = fit(cfg, model, *loaders, checkpoint_dir=str(tmp_path / "ckpt"),
                 log_every=1, install_preemption_handler=False)
    assert len(result.history) == 3
    assert result.history[-1]["train"]["total_loss"] < result.history[0]["train"]["total_loss"]
    assert result.history[0]["val"] is not None and np.isfinite(result.best_val_loss)
    assert os.path.exists(tmp_path / "logs")
    saved = sorted(os.listdir(tmp_path / "ckpt"))
    assert "ckpt_0.pt" in saved and "checkpoints.json" in saved
    # resume: continuing picks up at epoch 3 with the restored state
    result2 = fit(cfg.replace(num_epochs=4), model, *loaders,
                  checkpoint_dir=str(tmp_path / "ckpt"), log_every=1,
                  install_preemption_handler=False)
    assert [h["epoch"] for h in result2.history] == [3]
    assert int(result2.state.step) == 8


def test_profile_dir_traces_the_step_spans(packs, tmp_path):
    """``train --profile_dir``: ``utils/profiling.py::trace`` over the first
    4 batches, with the program's spans on, then off again."""
    from pcss_unet_tpu_torch.utils import profiling

    cfg = Config(batch_size=2, num_epochs=1, warmup_epochs=1, save_dir="",
                 log_dir="", vgg_weights_path=os.path.join(packs, "vgg.npz"))
    fit(cfg, _model(), Loader(PackedDataset(packs, "train"), 2, shuffle=True),
        None, writer=NullWriter(), profile_dir=str(tmp_path / "prof"),
        install_preemption_handler=False)
    assert not profiling._SPANS_ON
    with open(tmp_path / "prof" / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("pcss.step") == 4
    assert names.count("pcss.step.backward") == 4
    assert names.count("pcss.data.batch") >= 4


def _run(packs, ck, hook=None, epochs=2, dropout=0.2):
    cfg = Config(batch_size=2, num_epochs=epochs, warmup_epochs=1,
                 save_frequency=1000, save_dir="", log_dir="",
                 loss_type="perturb", perturbation_count=2, ema_decay=0.9,
                 vgg_weights_path=os.path.join(packs, "vgg.npz"))
    model = _model(dropout=dropout)
    r = fit(cfg, model, Loader(PackedDataset(packs, "train"), 2, shuffle=True, seed=7),
            None, checkpoint_dir=ck, writer=NullWriter(), log_every=1000,
            install_preemption_handler=False, step_hook=hook)
    return model, r


def test_stop_and_resume_equals_uninterrupted_run(packs, tmp_path):
    """Dropout and the perturbation loss on: a run stopped mid-epoch (the
    step_hook, the preemption path) and resumed ends on exactly the state
    of a run that never stopped — the same batches, the same dropout masks
    and noise (each step's generator is seeded from (seed, step)), the
    same optimizer, BatchNorm and EMA state."""
    full, rf = _run(packs, str(tmp_path / "a"))
    _, r1 = _run(packs, str(tmp_path / "b"), hook=lambda step, e, b: step == 3)
    assert [h["epoch"] for h in r1.history] == [0] and int(r1.state.step) == 3
    resumed, r2 = _run(packs, str(tmp_path / "b"))
    assert [h["epoch"] for h in r2.history] == [0, 1]
    assert int(r2.state.step) == int(rf.state.step) == 8
    for (n, a), (_, b) in zip(full.state_dict().items(), resumed.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(rf.state.ema_params, r2.state.ema_params):
        assert torch.equal(a, b)
    for k, v in rf.state.opt_state.items():
        w = r2.state.opt_state[k]
        assert all(torch.equal(a, b) for a, b in zip(v, w)) \
            if isinstance(v, list) else torch.equal(v, w)


class RecordingDataset(PackedDataset):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.gathered = []

    def gather(self, idx):
        self.gathered.append(np.asarray(idx).copy())
        return super().gather(idx)


def test_no_replayed_or_skipped_batches(packs, tmp_path):
    """The mid-epoch cursor: run 1 trains on plan[:2] of epoch 0, run 2
    on plan[2:], then epoch 1's whole plan (test_midepoch_resume.py).  The
    device cache is off, as in the JAX test: its one-time upload gathers
    every sample, which the recording dataset would count as batches."""
    cfg = Config(batch_size=2, num_epochs=2, warmup_epochs=1, save_frequency=1000,
                 log_dir="", save_dir="", alpha=1.0, device_data_cache="off")
    ds1 = RecordingDataset(packs, "train")
    loader1 = Loader(ds1, 2, shuffle=True, seed=7)
    r1 = fit(cfg, _model(), loader1, None, checkpoint_dir=str(tmp_path / "ck"),
             writer=NullWriter(), install_preemption_handler=False,
             step_hook=lambda step, epoch, batch: batch >= 1)
    assert len(r1.history) == 1
    ds2 = RecordingDataset(packs, "train")
    loader2 = Loader(ds2, 2, shuffle=True, seed=7)
    r2 = fit(cfg, _model(), loader2, None, checkpoint_dir=str(tmp_path / "ck"),
             writer=NullWriter(), install_preemption_handler=False)
    assert [h["epoch"] for h in r2.history] == [0, 1]
    plan0 = loader1.epoch_indices(0)
    np.testing.assert_array_equal(np.concatenate(ds1.gathered[:2]), plan0[:2].ravel())
    np.testing.assert_array_equal(np.concatenate(ds2.gathered[:2]), plan0[2:].ravel())
    np.testing.assert_array_equal(np.concatenate(ds2.gathered[2:6]),
                                  loader2.epoch_indices(1).ravel())


def test_loader_plan_matches_jax(packs):
    """The Loader is a copy: the same (seed, epoch) gives the JAX Loader's
    batches and crops, bit for bit, also from a mid-epoch start."""
    for kw in (dict(shuffle=True, seed=3, crop_hw=(8, 12)), dict(shuffle=False)):
        mine = Loader(PackedDataset(packs, "train"), 2, **kw)
        theirs = JLoader(JPacked(packs, "train"), 2, **kw)
        for epoch in (0, 5):
            np.testing.assert_array_equal(mine.epoch_indices(epoch),
                                          theirs.epoch_indices(epoch))
            for (a, b), (c, d) in zip(mine.epoch(epoch, start_batch=1),
                                      theirs.epoch(epoch, start_batch=1)):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)


def test_sigterm_checkpoints_and_stops(packs, tmp_path):
    """SIGTERM mid-training → the step finishes, a checkpoint is written
    and fit returns (test_preemption.py; here the signal is sent from the
    step hook, deterministically); the rerun resumes."""
    cfg = Config(batch_size=2, num_epochs=50, warmup_epochs=1, save_frequency=1000,
                 log_dir="", save_dir="", alpha=1.0)
    result = fit(cfg, _model(), Loader(PackedDataset(packs, "train"), 2), None,
                 checkpoint_dir=str(tmp_path / "ckpt"), writer=NullWriter(),
                 step_hook=lambda step, e, b: (step == 6 and os.kill(
                     os.getpid(), signal.SIGTERM)) and False)
    assert len(result.history) == 2 and int(result.state.step) == 6
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_epoch() == 1 and mgr.load()["cursor_batch"] == 2
    result2 = fit(cfg.replace(num_epochs=3), _model(),
                  Loader(PackedDataset(packs, "train"), 2), None,
                  checkpoint_dir=str(tmp_path / "ckpt"), writer=NullWriter(),
                  install_preemption_handler=False)
    assert [h["epoch"] for h in result2.history] == [1, 2]
    assert int(result2.state.step) == 12


def test_fit_logs_ema_validation(packs, tmp_path):
    cfg = Config(batch_size=4, num_epochs=2, warmup_epochs=1, ema_decay=0.9,
                 log_dir=str(tmp_path / "logs"), save_dir="",
                 vgg_weights_path=os.path.join(packs, "vgg.npz"))
    from pcss_unet_tpu_torch.train.metrics import JsonlWriter

    writer = JsonlWriter(str(tmp_path / "logs"))
    r = fit(cfg, _model(), Loader(PackedDataset(packs, "train"), 4, shuffle=True),
            Loader(PackedDataset(packs, "val"), 4), writer=writer, log_every=1,
            install_preemption_handler=False)
    v = r.history[0]["val"]
    assert v is not None and np.isfinite(v["total_loss_ema"])
    writer.flush()
    tags = {json.loads(ln)["tag"] for ln in open(writer.path)}
    assert {"Loss/train_total", "Loss/val_total", "LR/learning_rate",
            "Grad/global_norm", "Loss/val_total_loss_ema"} <= tags


# ------------------------------------------------------------- checkpoints
def _state(cfg, widths=(8, 16)):
    from pcss_unet_tpu_torch.train import create_train_state

    return create_train_state(_model(widths), cfg, 4)


def test_best_retention_matches_orbax_wrapper(tmp_path):
    """The same sequence of saves through the port's manager and the JAX
    package's Orbax wrapper keeps the same epochs: the best
    ``max_to_keep`` by metric, every metric-less mid-epoch save, a re-save
    of an epoch replacing the older one."""
    from pcss_unet_tpu.train.checkpoint import CheckpointManagerWrapper
    from pcss_unet_tpu.train.state import create_train_state as j_create

    seq = [(0, 0.9, None), (1, 0.5, None), (2, 0.7, 3), (2, 0.6, None),
           (3, 0.4, None), (4, 0.8, None), (5, 0.45, 1)]
    state = _state(Config())
    mine = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    jstate = j_create(JUNet(encoder_widths=(4, 8), dtype=jnp.float32),
                      JConfig(), 4, (1, 8, 8, 4))
    theirs = CheckpointManagerWrapper(str(tmp_path / "jax"), max_to_keep=2)
    for epoch, loss, cursor in seq:
        mine.save(state, {"val_loss": loss}, epoch, cursor_batch=cursor)
        theirs.save(jstate, {"val_loss": loss}, epoch, cursor_batch=cursor)
    theirs.wait()
    assert mine.all_steps() == sorted(theirs.manager.all_steps())
    assert mine.latest_epoch() == theirs.latest_epoch() == 5
    assert mine.best_epoch() == theirs.best_epoch() == 3
    theirs.close()
    kept = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".pt"))
    assert kept == sorted(f"ckpt_{k}.pt" for k in mine.all_steps())
    assert not [f for f in os.listdir(tmp_path / "port") if f.endswith(".tmp")]
    # a new manager reads the same index
    assert CheckpointManager(str(tmp_path / "port"), 2).all_steps() == mine.all_steps()


def test_restore_is_exact_and_handles_ema(tmp_path):
    cfg = Config(ema_decay=0.5)
    state = _state(cfg)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(torch.randn_like(p))
        state.ema_params[0].fill_(3.0)
    state.step.fill_(7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, {"train_loss": 1.0}, epoch=0)
    fresh = _state(cfg)
    restored, cursor = mgr.restore(fresh)
    assert cursor == -1 and int(restored.step) == 7
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(restored.ema_params[0], state.ema_params[0])
    # EMA newly on: seeded from the restored parameters; EMA off: dropped
    off = Config()
    mgr2 = CheckpointManager(str(tmp_path / "off"))
    mgr2.save(_state(off), {"train_loss": 1.0}, epoch=0)
    on, _ = mgr2.restore(_state(cfg))
    assert all(torch.equal(e, p) for e, p in zip(on.ema_params, on.model.parameters()))
    none, _ = mgr.restore(_state(off))
    assert none.ema_params is None


def test_orbax_directory_refused_on_resume(tmp_path):
    (tmp_path / "0").mkdir()                  # an Orbax step directory
    with pytest.raises(ValueError, match="Orbax"):
        check_resume_compat(Config(), str(tmp_path))
    with pytest.raises(ValueError, match="Orbax"):
        CheckpointManager(str(tmp_path)).restore(_state(Config()))


def test_resume_compat_guard(tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    prev = Config(base_width=16, normalization="group_norm")
    with open(ckdir / "resolved_config.json", "w") as f:
        json.dump(prev.to_dict(), f)
    cur = Config(base_width=64, normalization="batch_norm")
    check_resume_compat(cur, str(ckdir))      # nothing to resume from
    (ckdir / "ckpt_0.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="base_width.*16.*64"):
        check_resume_compat(cur, str(ckdir))
    check_resume_compat(prev.replace(learning_rate=1e-3, batch_size=2), str(ckdir))


def test_exported_npz_through_jax_loader_gives_the_ports_forward(packs, tmp_path):
    """train → ``export_reference_checkpoint`` → the JAX package's
    ``load_reference_checkpoint`` → its eval forward equals the port's on
    the trained weights (test_trained_cycle.py at toy scale, depth 4)."""
    from pcss_unet_tpu.train.checkpoint import load_reference_checkpoint

    widths = (8, 16, 32, 64)
    cfg = Config(batch_size=4, num_epochs=2, warmup_epochs=1, dropout_rate=0.0,
                 save_dir="", log_dir="", alpha=1.0)
    model = _model(widths)
    r = fit(cfg, model, Loader(PackedDataset(packs, "train"), 4, shuffle=True),
            None, writer=NullWriter(), install_preemption_handler=False)
    path = str(tmp_path / "trained.npz")
    export_reference_checkpoint(r.state, path)
    variables = load_reference_checkpoint(path)
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 4)).astype(np.float32)
    want = np.asarray(JUNet(encoder_widths=widths, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
