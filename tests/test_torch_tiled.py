"""The port's halo-tiled inference (``infer/tiled.py``, ``ops/blend.py``)
against the JAX package's at test time, on the CPU at float32: the tile plan
and feather weights, the device blend, and ``infer_tiled`` on the committed
``deploy_w16`` net, plus the JAX suite's own tiled checks
(``tests/test_infer.py``) on the port."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.infer import InferenceEngine as JEngine
from pcss_unet_tpu.infer import infer_tiled as j_infer_tiled
from pcss_unet_tpu.infer import load_variables as j_load_variables
from pcss_unet_tpu.infer.tiled import _feather_weights as j_feather
from pcss_unet_tpu.infer.tiled import plan_tiles as j_plan_tiles
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.models import unet_for_variables as j_unet_for_variables
from pcss_unet_tpu.config import load_config as j_load_config
from pcss_unet_tpu.ops.pallas.blend import blend_tiles_device as j_blend
from pcss_unet_tpu.parity import compare_outputs
from pcss_unet_tpu_torch.infer import InferenceEngine, infer_tiled, load_variables
from pcss_unet_tpu_torch.infer.tiled import _feather_weights, plan_tiles
from pcss_unet_tpu_torch.ops.blend import blend_tiles_device

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURE = os.path.join(GOLDEN, "deploy_w16.npz")

# the whole-forward tolerance of the port's tests against the JAX engine
# (the JAX suite's chw-vs-plain rtol/atol, tests/test_chw_engine.py:46)
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _stats():
    with open(os.path.join(GOLDEN, "deploy_w16.json")) as f:
        meta = json.load(f)
    return (np.asarray(meta["means"], np.float32),
            np.asarray(meta["stds"], np.float32))


@functools.lru_cache(maxsize=None)
def _engines(posture):
    """(JAX engine, port engine) at float32.  On deploy_w16: 'plain' is the
    default NHWC posture, 'chw' the folded channels-major one (the JAX
    engine with its Pallas kernels in interpret mode).  'w8' is the JAX
    suite's tiled-test net (tests/test_infer.py's fixture): widths (8, 16),
    initialized as there; its receptive field is small enough for the
    suite's PSNR bars at tile 64 (deploy_w16's four levels reach further
    than a halo of 8-16)."""
    if posture == "w8":
        jmodel = JUNet(encoder_widths=(8, 16), dtype=jnp.float32,
                       dropout_rate=0.0)
        key = jax.random.PRNGKey(0)
        v = jmodel.init({"params": key, "dropout": key},
                        jnp.zeros((1, 32, 32, 4)), True)
        v = jax.tree.map(np.asarray, {"params": v["params"],
                                      "batch_stats": v["batch_stats"]})
        return (JEngine(jmodel, v, dtype=jnp.float32),
                InferenceEngine(None, v, dtype=torch.float32, device="cpu"))
    means, stds = _stats()
    kw = dict(means=means, stds=stds) if posture == "plain" else dict(
        means=means, stds=stds, fold_bn=True, layout="chw")
    jv = j_load_variables(FIXTURE)
    jmodel = j_unet_for_variables(j_load_config(None), jv)
    jeng = JEngine(jmodel, jv, dtype=jnp.float32,
                   pallas_interpret=posture == "chw", **kw)
    eng = InferenceEngine(None, load_variables(FIXTURE), dtype=torch.float32,
                          device="cpu", **kw)
    return jeng, eng


@pytest.mark.parametrize("size,tile,overlap", [
    (100, 40, 8), (30, 40, 8), (40, 40, 8), (41, 40, 8), (1024, 512, 64),
    (2048, 512, 64), (1080, 512, 64), (100, 64, 16), (97, 16, 15)])
def test_plan_tiles_matches_jax(size, tile, overlap):
    got = plan_tiles(size, tile, overlap)
    assert got == j_plan_tiles(size, tile, overlap)
    covered = np.zeros(size, bool)
    for s in got:
        covered[s:s + tile] = True
    assert covered.all() or tile >= size


def test_plan_tiles_rejects_a_non_positive_stride():
    for overlap in (40, 48):
        with pytest.raises(ValueError, match="2\\*halo"):
            plan_tiles(100, 40, overlap)
        with pytest.raises(ValueError, match="2\\*halo"):
            j_plan_tiles(100, 40, overlap)


@pytest.mark.parametrize("tile,halo", [(64, 8), (64, 16), (512, 32), (32, 8),
                                       (16, 4), (8, 6), (64, 0)])
def test_feather_weights_match_jax(tile, halo):
    w = _feather_weights(tile, halo)
    np.testing.assert_array_equal(w, j_feather(tile, halo))
    ramp = min(2 * halo, tile // 2)
    if ramp == 2 * halo and halo:     # adjacent ramps sum to one
        np.testing.assert_allclose(w[:ramp] + w[-ramp:], 1.0, rtol=1e-6)


@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("fh,fw,tile,halo", [(32, 48, 16, 4), (96, 100, 64, 8)])
def test_blend_tiles_device_matches_jax(rng, fh, fw, tile, halo, with_norm):
    ys = plan_tiles(fh, tile, 2 * halo)
    xs = plan_tiles(fw, tile, 2 * halo)
    offsets = np.array([(y, x) for y in ys for x in xs], np.int32)
    tiles = rng.random((len(offsets), tile, tile, 1)).astype(np.float32)
    w2d = np.outer(_feather_weights(tile, halo),
                   _feather_weights(tile, halo)).astype(np.float32)[..., None]
    norm = np.zeros((fh, fw, 1), np.float32)
    for y, x in offsets:
        norm[y:y + tile, x:x + tile] += w2d
    got = blend_tiles_device(torch.from_numpy(tiles), torch.from_numpy(w2d),
                             offsets, (fh, fw),
                             norm=torch.from_numpy(norm) if with_norm else None)
    want = np.asarray(j_blend(jnp.asarray(tiles), jnp.asarray(w2d),
                              jnp.asarray(offsets), (fh, fw),
                              norm=jnp.asarray(norm) if with_norm else None))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("posture", ["plain", "chw", "w8"])
@pytest.mark.parametrize("hw", [(96, 128), (96, 100)])
def test_infer_tiled_matches_jax(rng, posture, hw):
    """The port's infer_tiled ≡ the JAX package's (tile 64, halo 8: at
    96×100 the last column of tiles overlaps its neighbour by 28 >
    2·halo)."""
    jeng, eng = _engines(posture)
    frame = rng.standard_normal((*hw, 4)).astype(np.float32)
    want = np.asarray(j_infer_tiled(jeng, frame, tile=64, halo=8))
    got = infer_tiled(eng, frame, tile=64, halo=8)
    assert got.shape == want.shape == (*hw, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_host_blend_equals_device_blend(rng):
    _, eng = _engines("plain")
    frame = rng.standard_normal((96, 100, 4)).astype(np.float32)
    host = infer_tiled(eng, frame, tile=64, halo=8, blend="host")
    dev = infer_tiled(eng, frame, tile=64, halo=8, blend="device")
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-6)


def test_chunked_matches_unchunked(rng):
    """tile_batch bounds peak memory without changing the result: chunked
    forwards (incl. a padded final chunk) equal the all-at-once batch."""
    _, eng = _engines("plain")
    frame = rng.standard_normal((96, 160, 4)).astype(np.float32)
    all_at_once = infer_tiled(eng, frame, tile=64, halo=8, tile_batch=0)
    chunked = infer_tiled(eng, frame, tile=64, halo=8, tile_batch=4)
    np.testing.assert_allclose(chunked, all_at_once, rtol=0, atol=2e-6)


def test_tiled_close_to_full(rng):
    """The JAX suite's bar: the tiled mask within 35 dB PSNR of the
    full-frame pass."""
    _, eng = _engines("w8")
    frame = rng.standard_normal((96, 128, 4)).astype(np.float32)
    full = eng(frame)
    tiled = infer_tiled(eng, frame, tile=64, halo=16)
    assert tiled.shape == full.shape
    res = compare_outputs(tiled, full, psnr_pass=35.0)
    assert res["verdict"] in ("exact", "pass"), res


@pytest.mark.parametrize("blend", ["host", "auto"])
def test_tiled_last_tile_over_overlap(rng, blend):
    """The seam case of tests/test_infer.py: W=100, tile=64, halo=8 puts
    the tiles at x = 0 and 36, overlapping by 28 > 2·halo; the norm
    division must renormalize the contested strip, on both blend paths."""
    _, eng = _engines("w8")
    frame = rng.standard_normal((96, 100, 4)).astype(np.float32)
    assert plan_tiles(100, 64, 16) == [0, 36]
    full = eng(frame)
    tiled = infer_tiled(eng, frame, tile=64, halo=8, blend=blend)
    assert tiled.shape == full.shape
    res = compare_outputs(tiled[:, 30:70], full[:, 30:70], psnr_pass=35.0)
    assert res["verdict"] in ("exact", "pass"), res


@pytest.mark.parametrize("kw,match", [
    (dict(tile=64, halo=32), "2\\*halo"), (dict(tile=64, halo=40), "2\\*halo"),
    (dict(tile=40, halo=4), "pad_multiple"),
    (dict(tile=64, halo=8, blend="hots"), "blend")])
def test_infer_tiled_input_guards(rng, kw, match):
    _, eng = _engines("plain")
    frame = rng.standard_normal((96, 100, 4)).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        infer_tiled(eng, frame, **kw)
