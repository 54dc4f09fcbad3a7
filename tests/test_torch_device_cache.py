"""The port's device-resident dataset cache (``data/device_cache.py``)
against the host path and the JAX package's policy, as
``tests/test_device_cache.py``: batches gathered by the cache equal the
loader's bit for bit (both consume ``Loader.epoch_indices`` /
``crop_offsets``), and ``fit`` gives the same parameters either way."""

import json
import os

import numpy as np
import pytest
import torch

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.data.device_cache import cache_eligible as j_eligible
from pcss_unet_tpu.data.device_cache import dataset_nbytes as j_nbytes
from pcss_unet_tpu.data.pipeline import PackedDataset as JPacked
from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.data.device_cache import (DeviceCache, cache_eligible,
                                                   dataset_nbytes)
from pcss_unet_tpu_torch.data.grain_pipeline import GrainLoader
from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.train import fit


def _make_packs(root, n=10, h=32, w=48, layout="nhwc"):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, h, w, 4)).astype(np.float32)
    y = rng.random((n, h, w, 1)).astype(np.float32)
    if layout == "nchw":
        np.save(os.path.join(root, "train_inputs.npy"), x.transpose(0, 3, 1, 2))
        np.save(os.path.join(root, "train_labels.npy"), y.transpose(0, 3, 1, 2))
    else:
        np.save(os.path.join(root, "train_inputs.npy"), x)
        np.save(os.path.join(root, "train_labels.npy"), y)
    with open(os.path.join(root, "train_meta.json"), "w") as f:
        json.dump({"layout": layout}, f)
    np.save(os.path.join(root, "train_stats.npy"),
            {"means": [0.0] * 4, "stds": [1.0] * 4}, allow_pickle=True)


def _equal(host, dev):
    assert len(host) == len(dev)
    for (hx, hy), (dx, dy) in zip(host, dev):
        assert dx.device.type == "cpu" and dx.dtype == torch.float32
        assert dx.is_contiguous() and dy.is_contiguous()
        assert np.array_equal(hx, dx.numpy()) and np.array_equal(hy, dy.numpy())


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_cached_batches_match_host_path(tmp_path, layout):
    _make_packs(tmp_path, layout=layout)
    ds = PackedDataset(str(tmp_path), "train")
    loader = Loader(ds, batch_size=4, shuffle=True, seed=3)
    cache = DeviceCache(ds, upload_chunk=3, device="cpu")
    assert cache.nbytes == dataset_nbytes(ds)
    host = list(loader.epoch(1))
    dev = list(cache.batches(loader, 1))
    assert len(dev) == 2
    _equal(host, dev)
    # mid-epoch resume: the tail of the same plan
    _equal(list(loader.epoch(1, start_batch=1)),
           list(cache.batches(loader, 1, start_batch=1)))


def test_cached_crop_batches_match_host_path(tmp_path):
    _make_packs(tmp_path)
    ds = PackedDataset(str(tmp_path), "train")
    loader = Loader(ds, batch_size=4, shuffle=True, seed=9, crop_hw=(16, 16))
    cache = DeviceCache(ds, crop_hw=(16, 16), device="cpu")
    for epoch in (0, 2):
        _equal(list(loader.epoch(epoch)), list(cache.batches(loader, epoch)))
    with pytest.raises(ValueError, match="crop"):
        next(DeviceCache(ds, device="cpu").batches(loader, 0))


def test_cached_batches_match_the_grain_loader(tmp_path):
    _make_packs(tmp_path)
    ds = PackedDataset(str(tmp_path), "train")
    loader = GrainLoader(ds, batch_size=3, shuffle=True, seed=2,
                         read_workers=2)
    _equal(list(loader.epoch(1)),
           list(DeviceCache(ds, device="cpu").batches(loader, 1)))


def test_cache_eligibility_policy_equals_jax(tmp_path):
    _make_packs(tmp_path)
    ds = PackedDataset(str(tmp_path), "train")
    jds = JPacked(str(tmp_path), "train")
    assert dataset_nbytes(ds) == j_nbytes(jds) == 10 * 32 * 48 * 5 * 4
    for kw in (dict(device_data_cache="auto"), dict(device_data_cache="off"),
               dict(device_data_cache="auto", device_cache_budget_mb=0),
               dict(device_data_cache="on", device_cache_budget_mb=0),
               dict(device_data_cache="auto", device_cache_budget_mb=1)):
        assert cache_eligible(Config(**kw), ds) == j_eligible(JConfig(**kw), jds), kw
    assert cache_eligible(Config(device_data_cache="auto"), ds)
    assert not cache_eligible(Config(device_data_cache="off"), ds)
    assert cache_eligible(Config(device_data_cache="on",
                                 device_cache_budget_mb=0), ds)
    with pytest.raises(ValueError):
        cache_eligible(Config(device_data_cache="sometimes"), ds)


class NullWriter:
    def scalar(self, *a, **k): pass
    def image(self, *a, **k): pass
    def flush(self): pass


def test_fit_trajectory_identical_cached_vs_streamed(tmp_path, monkeypatch):
    """Two fit() runs — cache on vs off — end on the same parameters and
    BatchNorm statistics, bit for bit, with crops and validation."""
    from pcss_unet_tpu_torch.data import device_cache
    from pcss_unet_tpu_torch.train import loop

    _make_packs(tmp_path, n=8, h=32, w=32)
    built = []
    monkeypatch.setattr(loop, "DeviceCache", lambda *a, **k: built.append(1)
                        or device_cache.DeviceCache(*a, **k))

    def run(cache_mode):
        ds = PackedDataset(str(tmp_path), "train")
        loader = Loader(ds, batch_size=4, shuffle=True, seed=1,
                        crop_hw=(16, 16))
        val = Loader(PackedDataset(str(tmp_path), "train"), batch_size=4)
        cfg = Config(batch_size=4, num_epochs=2, warmup_epochs=1,
                     loss_type="perturb", perturbation_count=2,
                     device_data_cache=cache_mode, save_dir="", log_dir="",
                     dropout_rate=0.1)
        torch.manual_seed(0)
        model = UNet(encoder_widths=(8, 16), dropout_rate=0.1)
        res = fit(cfg, model, loader, val, writer=NullWriter(),
                  install_preemption_handler=False)
        return res, model.state_dict()

    (r_on, on), n_on = run("on"), len(built)
    (r_off, off), n_off = run("off"), len(built) - n_on
    assert (n_on, n_off) == (2, 0)         # train and val cached, then none
    assert [h["train"] for h in r_on.history] == [h["train"] for h in r_off.history]
    assert [h["val"] for h in r_on.history] == [h["val"] for h in r_off.history]
    for k in on:
        assert torch.equal(on[k], off[k]), k
