"""The port's data layer (``pcss_unet_tpu_torch/data``) against the JAX
package's on the same synthetic scene: organize → pack → stats → load, case
for case as ``tests/test_data.py`` and ``tests/test_pair_dataset.py``.
Packs are held equal byte for byte (``np.array_equal``), stats within 1e-12
relative, splits file for file."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

import pcss_unet_tpu.data as jdata
import pcss_unet_tpu_torch.data as pdata
from pcss_unet_tpu.data.records import export_per_file as j_export
from pcss_unet_tpu.io.exr import write_exr
from pcss_unet_tpu_torch.data.records import export_per_file as p_export

H, W, N = 16, 24, 12


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    exr_dir = root / "conditioning_images"
    png_dir = root / "images"
    exr_dir.mkdir()
    png_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N):
        chans = {n: rng.standard_normal((H, W)).astype(np.float32) * (k + 1)
                 for k, n in enumerate("RGBA")}
        write_exr(str(exr_dir / f"frame{i:03d}.exr"), chans)
        label = (rng.random((H, W)) * 255).astype(np.uint8)
        Image.fromarray(label, "L").save(png_dir / f"frame{i:03d}.png")
    # an unpaired file on each side: warned about and skipped by both
    shutil.copy(exr_dir / "frame000.exr", exr_dir / "lonely.exr")
    Image.fromarray(label, "L").save(png_dir / "orphan.png")
    return str(root)


@pytest.fixture(scope="module")
def split_dir(scene, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("splits"))
    counts = pdata.organize_dataset(scene, out, train_fraction=0.75, seed=1)
    assert counts == {"train": 9, "val": 3}
    return out


def _tree(root):
    return {split: sorted(os.listdir(os.path.join(root, split)))
            for split in ("train", "val")}


def test_organize_split_equals_jax(scene, split_dir, tmp_path):
    theirs = str(tmp_path / "j")
    assert jdata.organize_dataset(scene, theirs, train_fraction=0.75,
                                  seed=1) == {"train": 9, "val": 3}
    assert _tree(split_dir) == _tree(theirs)
    for split, names in _tree(split_dir).items():
        for name in names:
            assert filecmp.cmp(os.path.join(split_dir, split, name),
                               os.path.join(theirs, split, name), shallow=False)


def test_organize_naming(split_dir):
    pairs = pdata.discover_pairs(os.path.join(split_dir, "train"))
    assert len(pairs) == 9
    for exr, png in pairs:
        assert exr.endswith("_input.exr") and png.endswith("_gt.png")
    assert pairs == jdata.discover_pairs(os.path.join(split_dir, "train"))


def test_replace_exr(split_dir, scene, tmp_path):
    for name, replace in (("p", pdata.replace_exr_files),
                          ("j", jdata.replace_exr_files)):
        dest = tmp_path / name
        shutil.copytree(os.path.join(split_dir, "val"), dest)
        for f in os.listdir(dest):          # stale inputs to be replaced
            if f.endswith("_input.exr"):
                (dest / f).write_bytes(b"stale")
        (dest / "gone_input.exr").write_bytes(b"no source for this stem")
        assert replace(str(dest), os.path.join(scene, "conditioning_images")) == 3
    assert _dir_equal(tmp_path / "p", tmp_path / "j")


def _dir_equal(a, b):
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


@pytest.fixture(scope="module")
def packs(split_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("processed"))
    meta_t = pdata.build_packs(os.path.join(split_dir, "train"), out, "train")
    meta_v = pdata.build_packs(os.path.join(split_dir, "val"), out, "val")
    assert meta_t["count"] == 9 and meta_v["count"] == 3
    return out


def test_pack_shapes(packs):
    x = np.load(os.path.join(packs, "train_inputs.npy"), mmap_mode="r")
    y = np.load(os.path.join(packs, "train_labels.npy"), mmap_mode="r")
    assert x.shape == (9, H, W, 4) and y.shape == (9, H, W, 1)
    assert y.min() >= 0.0 and y.max() <= 1.0


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_packs_equal_jax(split_dir, tmp_path, layout):
    src = os.path.join(split_dir, "train")
    meta_p = pdata.build_packs(src, str(tmp_path / "p"), "train", layout=layout,
                               num_workers=3)
    meta_j = jdata.build_packs(src, str(tmp_path / "j"), "train", layout=layout)
    assert meta_p == meta_j == {"count": 9, "height": H, "width": W,
                                "layout": layout}
    for name in ("train_inputs.npy", "train_labels.npy"):
        got = np.load(tmp_path / "p" / name)
        want = np.load(tmp_path / "j" / name)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with open(tmp_path / "p" / "train_meta.json") as f, \
            open(tmp_path / "j" / "train_meta.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("with_meta", [True, False])
def test_stats_match_jax(split_dir, tmp_path, layout, with_meta):
    out = str(tmp_path)
    pdata.build_packs(os.path.join(split_dir, "train"), out, "train",
                      layout=layout)
    if not with_meta:       # the layout is autodetected from the shape
        os.remove(os.path.join(out, "train_meta.json"))
    mine = pdata.compute_channel_stats(out, "train", chunk=4)
    with open(os.path.join(out, "train_stats.json")) as f:
        mine_json = json.load(f)
    theirs = jdata.compute_channel_stats(out, "train", chunk=4)
    with open(os.path.join(out, "train_stats.json")) as f:
        theirs_json = json.load(f)
    for k in ("means", "stds"):
        assert mine[k].dtype == np.float64
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-12, atol=0)
    assert mine_json["layout"] == theirs_json["layout"] == layout
    assert mine_json["count_per_channel"] == theirs_json["count_per_channel"]
    # numpy float64 over the whole pack
    x = np.load(os.path.join(out, "train_inputs.npy")).astype(np.float64)
    axes = (0, 2, 3) if layout == "nchw" else (0, 1, 2)
    np.testing.assert_allclose(mine["means"], x.mean(axis=axes), rtol=1e-12)
    np.testing.assert_allclose(mine["stds"], x.std(axis=axes), rtol=1e-12)
    # the port's artifact loads in both packages
    pdata.compute_channel_stats(out, "train", chunk=4)
    for load in (pdata.load_channel_stats, jdata.load_channel_stats):
        means, stds = load(out)
        assert means.dtype == np.float32
        np.testing.assert_array_equal(means, mine["means"].astype(np.float32))
        np.testing.assert_array_equal(stds, mine["stds"].astype(np.float32))


def test_loader_shuffles_and_shards(packs):
    ds = pdata.PackedDataset(packs, "train")
    jds = jdata.PackedDataset(packs, "train")
    loader = pdata.Loader(ds, batch_size=2, shuffle=True, seed=3)
    e0 = [x[0, 0, 0, 0] for x, _ in loader.epoch(0)]
    e1 = [x[0, 0, 0, 0] for x, _ in loader.epoch(1)]
    assert e0 != e1, "epochs should reshuffle"
    assert e0 == [x[0, 0, 0, 0] for x, _ in loader.epoch(0)]
    for (x, y), (jx, jy) in zip(loader.epoch(1), jdata.Loader(
            jds, batch_size=2, shuffle=True, seed=3).epoch(1)):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    l0 = pdata.Loader(ds, batch_size=2, shuffle=False, shard_index=0,
                      shard_count=2)
    l1 = pdata.Loader(ds, batch_size=2, shuffle=False, shard_index=1,
                      shard_count=2)
    n0 = sum(x.shape[0] for x, _ in l0.epoch(0))
    n1 = sum(x.shape[0] for x, _ in l1.epoch(0))
    assert n0 == n1 == 4  # 9 samples → 4 each after drop_remainder


def test_nchw_pack_compat(split_dir, tmp_path):
    """Reference-layout packs load identically (artifact compatibility)."""
    out = str(tmp_path / "nchw")
    pdata.build_packs(os.path.join(split_dir, "train"), out, "train",
                      layout="nchw")
    x = np.load(os.path.join(out, "train_inputs.npy"), mmap_mode="r")
    assert x.shape == (9, 4, H, W)
    ds = pdata.PackedDataset(out, "train")
    xi, yi = ds[0]
    assert xi.shape == (H, W, 4) and yi.shape == (H, W, 1)
    jx, jy = jdata.PackedDataset(out, "train")[0]
    assert np.array_equal(xi, jx) and np.array_equal(yi, jy)


def test_nchw_autodetect_without_meta(split_dir, tmp_path):
    out = str(tmp_path / "nometa")
    pdata.build_packs(os.path.join(split_dir, "train"), out, "train",
                      layout="nchw")
    os.remove(os.path.join(out, "train_meta.json"))
    ds = pdata.PackedDataset(out, "train")
    assert ds.layout == "nchw"
    assert ds.sample_hw == (H, W)


def test_loader_random_crop(packs):
    """Crops as the JAX Loader cuts them: the same window from input and
    label, seeded per epoch."""
    ds = pdata.PackedDataset(packs, "train")
    loader = pdata.Loader(ds, batch_size=2, shuffle=False, crop_hw=(8, 8),
                          seed=5)
    jloader = jdata.Loader(jdata.PackedDataset(packs, "train"), batch_size=2,
                           shuffle=False, crop_hw=(8, 8), seed=5)
    for epoch in (0, 1):
        for (x, y), (jx, jy) in zip(loader.epoch(epoch), jloader.epoch(epoch)):
            assert x.shape == (2, 8, 8, 4) and y.shape == (2, 8, 8, 1)
            assert np.array_equal(x, jx) and np.array_equal(y, jy)
    x0, _ = next(iter(loader.epoch(0)))
    x1, _ = next(iter(loader.epoch(1)))
    assert not np.array_equal(x0, x1)
    with pytest.raises(ValueError):
        pdata.Loader(ds, 2, crop_hw=(999, 8))


@pytest.mark.parametrize("normalize", ["none", "minmax"])
def test_per_file_export_equals_jax(split_dir, tmp_path, normalize):
    """One ``.npz`` per pair, with optional min-max normalization (the
    orphan preprocess.py capability), equal to the JAX package's."""
    src = os.path.join(split_dir, "train")
    assert p_export(src, str(tmp_path / "p"), normalize=normalize) == 9
    assert j_export(src, str(tmp_path / "j"), normalize=normalize) == 9
    files = sorted(os.listdir(tmp_path / "p"))
    assert files == sorted(os.listdir(tmp_path / "j")) and len(files) == 9
    for name in files:
        got, want = np.load(tmp_path / "p" / name), np.load(tmp_path / "j" / name)
        assert got["input"].shape == (H, W, 4)
        assert got["label"].shape == (H, W, 1)
        for k in ("input", "label"):
            assert np.array_equal(got[k], want[k])
    if normalize == "minmax":
        data = np.load(tmp_path / "p" / files[0])
        assert data["input"].min() >= 0.0 and data["input"].max() <= 1.0 + 1e-6
    with pytest.raises(ValueError):
        p_export(src, str(tmp_path / "x"), normalize="zscore")


def test_corrupt_file_skipped(split_dir, tmp_path):
    """Error-skip policy: one bad EXR doesn't kill the pack, which is
    shrunk to the good samples (prepare_dataset.py:59-61), as JAX's."""
    bad_dir = str(tmp_path / "bad")
    shutil.copytree(os.path.join(split_dir, "train"), bad_dir)
    with open(os.path.join(bad_dir, "aa_input.exr"), "wb") as f:
        f.write(b"not an exr file at all")
    with open(os.path.join(bad_dir, "aa_gt.png"), "wb") as f:
        f.write(b"nor a png")
    meta = pdata.build_packs(bad_dir, str(tmp_path / "p"), "train")
    assert meta["count"] == 9
    jdata.build_packs(bad_dir, str(tmp_path / "j"), "train")
    for name in ("train_inputs.npy", "train_labels.npy"):
        got = np.load(tmp_path / "p" / name)
        assert got.shape[0] == 9
        assert np.array_equal(got, np.load(tmp_path / "j" / name))
    assert not os.path.exists(tmp_path / "p" / "train_inputs.npy.tmp")


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for i in range(6):
        chans = {n: rng.standard_normal((20, 28)).astype(np.float32)
                 for n in "RGBA"}
        write_exr(str(root / f"s{i}_input.exr"), chans)
        # label PNG at a DIFFERENT size → NEAREST resize path
        # (setdata.py:164-168)
        lbl = (rng.random((10, 14)) * 255).astype(np.uint8)
        Image.fromarray(lbl, "L").save(root / f"s{i}_gt.png")
    write_exr(str(root / "nolabel_input.exr"), chans)   # skipped
    np.save(root / "train_stats.npy", {"means": [1.0] * 4, "stds": [2.0] * 4})
    return str(root)


def test_pair_dataset_basic(pair_dir):
    ds = pdata.PairDataset(pair_dir)
    jds = jdata.PairDataset(pair_dir)
    assert len(ds) == len(jds) == 6
    assert ds.pairs == jds.pairs
    x, y = ds[0]
    assert x.shape == (20, 28, 4) and y.shape == (20, 28, 1)
    assert 0.0 <= y.min() and y.max() <= 1.0
    assert ds.sample_hw == jds.sample_hw == (20, 28)
    assert ds.layout == "nhwc"
    np.testing.assert_array_equal(ds.means, jds.means)
    np.testing.assert_array_equal(ds.stds, jds.stds)
    idx = np.array([3, 0, 5])
    for got, want in zip(ds.gather(idx), jds.gather(idx)):
        assert np.array_equal(got, want)


def test_pair_dataset_with_loader(pair_dir):
    loader = pdata.Loader(pdata.PairDataset(pair_dir), batch_size=2,
                          shuffle=True, seed=0)
    jloader = jdata.Loader(jdata.PairDataset(pair_dir), batch_size=2,
                           shuffle=True, seed=0)
    batches = list(loader.epoch(0))
    assert len(batches) == 3
    x, y = batches[0]
    assert x.shape == (2, 20, 28, 4) and y.shape == (2, 20, 28, 1)
    for (x, y), (jx, jy) in zip(batches, jloader.epoch(0)):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)


def test_pair_dataset_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        pdata.PairDataset(str(tmp_path))
