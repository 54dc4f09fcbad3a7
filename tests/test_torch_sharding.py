"""Spatially sharded inference in the port (``ops/resize.py``'s window
resizes, ``UNet``'s window mode, ``InferenceEngine.build_sharded_forward``,
``infer/tiled.py::infer_sharded`` / ``infer_sharded_halo``) against the
JAX package on the CPU, mirroring ``tests/test_sharding.py:155-263`` case
for case and ``tests/test_infer.py::test_sharded_matches_plain``.

The JAX side runs on the 8 virtual CPU devices, its Pallas kernels in
interpret mode; the port's mesh is 8 CPU devices too (one device repeated),
its kernels on their plain versions.  Bars: float32 within 5e-7 (the JAX
tests'), the kernel postures' windows equal to the port's unsharded forward
bit for bit (the JAX tests' bar for their own sharded forward), and the
port against JAX in float32 within 5e-7 and in bfloat16 within the
bf16 postures' 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.infer.frame import InferenceEngine as JEngine
from pcss_unet_tpu.infer.tiled import infer_sharded as j_infer_sharded
from pcss_unet_tpu.infer.tiled import infer_sharded_halo as j_halo
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.models.unet import spatial_align as j_align
from pcss_unet_tpu.models.unet import spatial_halo as j_halo_rows
from pcss_unet_tpu.ops import resize as jresize
from pcss_unet_tpu.parallel import make_mesh as j_make_mesh

from pcss_unet_tpu_torch.infer import (InferenceEngine, infer_sharded,
                                       infer_sharded_halo)
from pcss_unet_tpu_torch.models.init import seeded_variables
from pcss_unet_tpu_torch.models.unet import UNet, spatial_align, spatial_halo
from pcss_unet_tpu_torch.ops import resize
from pcss_unet_tpu_torch.parallel import make_mesh

CPUS = ["cpu"] * 8
ZEROS, ONES = np.zeros(4, np.float32), np.ones(4, np.float32)


def _variables(widths, seed=0, hw=64):
    model = JUNet(encoder_widths=widths, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    v = model.init({"params": key, "dropout": key},
                   jnp.zeros((1, hw, hw, 4), jnp.float32), False)
    return model, jax.tree.map(np.asarray, dict(v))


def _engines(widths=(8, 16, 32), seed=0, **kw):
    """The JAX test's ``_make_engine`` and the port's engine on the same
    variables."""
    jdtype = kw.pop("dtype", "float32")
    model, v = _variables(widths, seed)
    jkw = {k: v_ for k, v_ in kw.items() if k in ("fold_bn", "quantize")}
    jeng = JEngine(model.clone(dtype=getattr(jnp, jdtype)), v, means=ZEROS,
                   stds=ONES, dtype=getattr(jnp, jdtype),
                   use_pallas=False, pallas_interpret=bool(kw.get("fold_bn")),
                   **jkw)
    eng = InferenceEngine(None, v, means=ZEROS, stds=ONES,
                          dtype=getattr(torch, jdtype), device="cpu", **kw)
    return jeng, eng


def _unsharded(eng, frames):
    """The port's single-device forward of already-padded frames."""
    return eng.run_padded(frames).numpy()


# ------------------------------------------------------------ the pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_resizes_match_jax(dtype):
    """``upsample2x_window`` and ``resize_rows_window`` equal the JAX
    package's on the same window of the same global image, at several
    offsets, NHWC: float32 to sum-order noise (5e-7), bfloat16 to one
    rounding of the bf16 result."""
    tol = 5e-7 if dtype == "float32" else 2 ** -7    # one bf16 ulp at 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    for off in (0, 3, 7, 10):
        got = resize.upsample2x_window(tx, 16, off).float().numpy()
        want = np.asarray(jresize.upsample2x_window(jx, 16, off)
                          .astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        m_h, m_w = jresize.compose_resize_matrices((16, 32, 16), (5, 10, 5))
        got = resize.resize_rows_window(tx, (16, 32, 16), (5, 10, 5), off,
                                        off).float().numpy()
        want = np.asarray(jresize.resize_rows_window(jx, m_h, m_w, off, off)
                          .astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("dilation", [False, True])
def test_spatial_align_and_halo_match_jax(depth, dilation):
    widths = tuple(8 * 2 ** i for i in range(depth))
    port = UNet(encoder_widths=widths, apply_dilation=dilation)
    ref = JUNet(encoder_widths=widths, apply_dilation=dilation)
    assert spatial_align(port) == j_align(ref)
    assert spatial_halo(port) == j_halo_rows(ref)
    if depth == 4 and not dilation:      # w16 and w64
        assert (spatial_align(port), spatial_halo(port)) == (16, 64)


def test_window_mode_refuses_odd_sizes():
    model = UNet(encoder_widths=(8, 16))
    with pytest.raises(ValueError, match="even"):
        model(torch.zeros((1, 32, 31, 4)), window=(64, 0))
    with pytest.raises(ValueError, match="even"):
        model(torch.zeros((1, 32, 30, 4)), window=(63, 0))


# ----------------------------------------- tests/test_sharding.py, mirrored
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
def test_halo_sharded_matches_single_device(cpus, mesh_shape):
    """float32: the windows with global-coefficient resizes reproduce the
    unsharded forward, and the JAX package's sharded forward, within
    5e-7."""
    jeng, eng = _engines()
    frames = np.random.default_rng(0).standard_normal((2, 256, 96, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(*mesh_shape, devices=CPUS))
    want = j_halo(jeng, frames, j_make_mesh(*mesh_shape, devices=cpus))
    np.testing.assert_allclose(got, _unsharded(eng, frames), atol=5e-7, rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)


def test_halo_sharded_fused_int8_bitexact(cpus):
    """The kernel posture (folded BN, fused, int8; bf16) survives sharding
    bit for bit, as the JAX package's does; against the JAX package's
    sharded forward within the bf16 bar."""
    jeng, eng = _engines(dtype="bfloat16", fold_bn=True, quantize="int8")
    frames = np.random.default_rng(1).standard_normal((2, 256, 96, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(4, 2, devices=CPUS))
    np.testing.assert_array_equal(got, _unsharded(eng, frames))
    want = j_halo(jeng, frames, j_make_mesh(4, 2, devices=cpus))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_infer_sharded_dispatches_to_halo_path(cpus):
    """A kernel posture keeps its kernels: ``infer_sharded`` equals the
    unsharded fused forward bit for bit (not the plain graph's), and the
    JAX package's ``infer_sharded`` within the bf16 bar."""
    jeng, eng = _engines(dtype="bfloat16", fold_bn=True)
    assert eng.sharding_model() is eng.model is not eng.plain_model
    frames = np.random.default_rng(2).standard_normal((2, 128, 64, 4)).astype(np.float32)
    got = infer_sharded(eng, frames, make_mesh(4, 2, devices=CPUS))
    unsharded = _unsharded(eng, frames)
    np.testing.assert_array_equal(got, unsharded)
    assert np.abs(eng.run_padded(frames, plain=True).numpy() - unsharded).max() > 0
    want = j_infer_sharded(jeng, frames, j_make_mesh(4, 2, devices=cpus))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_halo_sharded_odd_frame_pads(cpus):
    """A 200×70 frame is padded by reflection to 224×80 (n_sp·16 rows, 16
    columns) and cropped back: the oracle is the unsharded forward of the
    same padding."""
    jeng, eng = _engines()
    frames = np.random.default_rng(3).standard_normal((1, 200, 70, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(4, 2, devices=CPUS))
    assert got.shape == (1, 200, 70, 1)
    padded = np.pad(frames, ((0, 0), (0, 24), (0, 10), (0, 0)), mode="reflect")
    np.testing.assert_allclose(got, _unsharded(eng, padded)[:, :200, :70],
                               atol=5e-7, rtol=0)
    want = j_halo(jeng, frames, j_make_mesh(4, 2, devices=cpus))
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)


def test_halo_sharded_chw_acc_shift_bitexact(cpus):
    """A ``layout="chw"`` engine (the reference's acc_shift tap strategy
    here) shards through the NHWC kernel model its reference counterpart
    holds: bit for bit that model's unsharded forward; the JAX package's
    chw engine sharded within the bf16 bar."""
    _, v = _variables((8, 16, 32))
    eng = InferenceEngine(None, v, means=ZEROS, stds=ONES, dtype=torch.bfloat16,
                          fold_bn=True, layout="chw", taps="acc_shift",
                          device="cpu")
    model = eng.sharding_model()
    assert eng.model is None and model is not eng.plain_model
    frames = np.random.default_rng(2).standard_normal((1, 256, 96, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(4, 2, devices=CPUS))
    with torch.inference_mode():
        x = eng._preprocess(torch.from_numpy(frames), fused=True)
        ref = eng._postprocess(model(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    jmodel, _ = _variables((8, 16, 32))
    jeng = JEngine(jmodel.clone(dtype=jnp.bfloat16), v, means=ZEROS, stds=ONES,
                   dtype=jnp.bfloat16, use_pallas=False, pallas_interpret=True,
                   fold_bn=True, layout="chw", taps="acc_shift")
    want = j_halo(jeng, frames, j_make_mesh(4, 2, devices=cpus))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_halo_sharded_depth5_alignment(cpus):
    """A depth-5 net's window starts are multiples of 2^5 (spatial_align):
    windows that are proper subsets of a 1024-row frame on a (2, 4) mesh
    equal the unsharded forward and the JAX package's within 5e-7."""
    widths = (8, 8, 16, 16, 32)
    model, v = _variables(widths, seed=3)
    jeng = JEngine(model, v, means=ZEROS, stds=ONES, dtype=jnp.float32)
    eng = InferenceEngine(None, v, means=ZEROS, stds=ONES, dtype=torch.float32,
                          device="cpu")
    assert spatial_align(eng.model) == 32 and spatial_halo(eng.model) % 32 == 0
    frames = np.random.default_rng(4).standard_normal((1, 1024, 64, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(2, 4, devices=CPUS))
    np.testing.assert_allclose(got, _unsharded(eng, frames), atol=5e-7, rtol=0)
    want = j_halo(jeng, frames, j_make_mesh(2, 4, devices=cpus))
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)


def test_halo_sharded_int8_routed_matches_jax(cpus):
    """Widths (16, 64, 128, 1024) route dec_0 through K5 and dec_1 through
    K6 (``routes()``) on each window: the port's sharded int8 posture in
    float32 against the JAX package's (its kernels in interpret mode).  Each window bands its int8 rows by its own height, as the
    reference's does, so the port is held to the reference's sharded
    forward, not to its own unsharded one.  The int8 postures are not
    continuous in their input (a float32 sum-order difference can move an
    int8 rounding tie), so the bar is the NHWC posture's 2e-4 or twice the
    change of the reference's own sharded forward under a one-ulp nudge of
    its input, whichever is larger (``chip_smoke.py``'s w64_vs_plain
    floor)."""
    widths = (16, 64, 128, 1024)
    v = seeded_variables(widths, seed=5)
    stats = dict(means=np.array([0.1, -0.2, 0.3, 0.0], np.float32),
                 stds=np.array([1.5, 0.8, 1.0, 2.0], np.float32))
    jmodel = JUNet(encoder_widths=widths, dtype=jnp.float32, dropout_rate=0.0)
    jeng = JEngine(jmodel, v, dtype=jnp.float32, fold_bn=True, quantize="int8",
                   pallas_interpret=True, **stats)
    eng = InferenceEngine(None, v, dtype=torch.float32, fold_bn=True,
                          quantize="int8", device="cpu", **stats)
    frames = np.random.default_rng(6).standard_normal((1, 256, 128, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(1, 4, devices=CPUS))
    routes = eng.sharding_model().routes()       # the windows' last forward
    assert routes["dec_0"] == "fused_block_int8_kchunked"
    assert routes["dec_1"] == "fused_block128_nhwc"
    mesh = j_make_mesh(1, 4, devices=cpus)
    want = j_halo(jeng, frames, mesh)
    nudged = j_halo(jeng, np.nextafter(frames, np.float32(np.inf)), mesh)
    floor = float(np.abs(nudged - want).max())
    d = float(np.abs(got - want).max())
    print(f"int8 sharded vs JAX sharded: max |d| = {d:.3g}, "
          f"one-ulp floor {floor:.3g}")
    assert d <= max(2e-4, 2 * floor)


# -------------------------------------- tests/test_infer.py, mirrored
def test_sharded_matches_plain(cpus):
    """A plain engine: ``infer_sharded`` runs the windows through the plain
    graph, the plain forward of the same frame (``engine(frames)``), as
    the JAX package's partitioned graph is."""
    model = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    v = model.init({"params": key, "dropout": key}, jnp.zeros((1, 32, 32, 4)), True)
    v = jax.tree.map(np.asarray, {"params": v["params"],
                                  "batch_stats": v["batch_stats"]})
    eng = InferenceEngine(None, v, dtype=torch.float32, device="cpu")
    frames = np.random.default_rng(42).standard_normal((2, 64, 64, 4)).astype(np.float32)
    got = infer_sharded(eng, frames, make_mesh(2, 4, devices=CPUS))
    np.testing.assert_allclose(got, eng(frames), rtol=1e-5, atol=1e-6)
    want = j_infer_sharded(JEngine(model, v, dtype=jnp.float32), frames,
                           j_make_mesh(2, 4, devices=cpus))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_small_frame_falls_back_to_one_device():
    """A frame too small to split (the padding would reach its height)
    runs through the engine's own pad and crop, as the reference's does."""
    _, eng = _engines()
    frames = np.random.default_rng(7).standard_normal((1, 40, 48, 4)).astype(np.float32)
    got = infer_sharded_halo(eng, frames, make_mesh(1, 8, devices=CPUS))
    np.testing.assert_array_equal(got, eng(frames))
