"""Port ops (pcss_unet_tpu_torch/ops) ≡ the JAX package's ops on the CPU.

Inputs are made from a seed with numpy and go through both; float32
tolerances are rtol/atol 1e-6 (float noise of a different summation
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.ops import int8 as jint8
from pcss_unet_tpu.ops import pixelshuffle as jps
from pcss_unet_tpu.ops import pooling as jpool
from pcss_unet_tpu.ops import resize as jresize
from pcss_unet_tpu_torch.ops import int8 as tint8
from pcss_unet_tpu_torch.ops import pixelshuffle as tps
from pcss_unet_tpu_torch.ops import pooling as tpool
from pcss_unet_tpu_torch.ops import resize as tresize

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(5, 10), (7, 3), (1, 4), (64, 128),
                                        (6, 1)])
def test_interp_matrix_equal(n_in, n_out):
    np.testing.assert_array_equal(tresize.interp_matrix(n_in, n_out),
                                  jresize.interp_matrix(n_in, n_out))


@pytest.mark.parametrize("sizes_h,sizes_w", [((8, 16, 8), (12, 24, 12)),
                                             ((5, 10, 6), (7, 14, 7)),
                                             ((4,), (9,))])
def test_compose_resize_matrices_equal(sizes_h, sizes_w):
    for got, want in zip(tresize.compose_resize_matrices(sizes_h, sizes_w),
                         jresize.compose_resize_matrices(sizes_h, sizes_w)):
        np.testing.assert_array_equal(got, want)


def test_upsample_and_resize_match(rng):
    x = rng.standard_normal((2, 6, 10, 3)).astype(np.float32)
    got = tresize.upsample2x_align_corners(torch.from_numpy(x)).numpy()
    want = np.asarray(jresize.upsample2x_align_corners(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    for out_hw in ((9, 13), (6, 4), (6, 10)):
        got = tresize.resize_bilinear_align_corners(torch.from_numpy(x),
                                                    out_hw).numpy()
        want = np.asarray(jresize.resize_bilinear_align_corners(
            jnp.asarray(x), out_hw))
        np.testing.assert_allclose(got, want, **TOL)


def test_resize_with_matrices_bf16_cast_points(rng):
    """At bf16 the matrix is cast to bf16 first and the product accumulates
    in float32: equal to the reference within one bf16 rounding."""
    x = rng.standard_normal((1, 8, 12, 2)).astype(np.float32)
    m_h, m_w = jresize.compose_resize_matrices((8, 16, 8), (12, 24, 12))
    got = tresize.resize_with_matrices(
        torch.from_numpy(x).to(torch.bfloat16), m_h, m_w).float().numpy()
    want = np.asarray(jresize.resize_with_matrices(
        jnp.asarray(x, jnp.bfloat16), m_h, m_w), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_pixel_shuffles_match(rng):
    x = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    un = tps.pixel_unshuffle_nhwc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(un, np.asarray(
        jps.pixel_unshuffle_nhwc(jnp.asarray(x))))
    back = tps.pixel_shuffle_nhwc(torch.from_numpy(un)).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(back, np.asarray(
        jps.pixel_shuffle_nhwc(jnp.asarray(un))))
    # torch's own NCHW op defines the channel order
    ref = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(un, ref.numpy())


@pytest.mark.parametrize("h,w", [(8, 12), (7, 9)])
def test_avg_pool_matches(rng, h, w):
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    got = tpool.avg_pool_2x(torch.from_numpy(x)).numpy()
    want = np.asarray(jpool.avg_pool_2x(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_quantize_kernel_int8_exact(rng):
    k = (rng.standard_normal((3, 3, 16, 32)) * 0.3).astype(np.float32)
    k[0, 0, 0, 0] = 0.5 * np.abs(k[..., 0]).max() / 127 * 3  # a .5 tie in q
    q, s = tint8.quantize_kernel_int8(torch.from_numpy(k))
    jq, js = jint8.quantize_kernel_int8(jnp.asarray(k))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_tensor_int8_exact(rng):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    q, s = tint8.quantize_tensor_int8(torch.from_numpy(x))
    jq, js = jint8.quantize_tensor_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# ------------------------------------------------- banded resize (tables)

def _chw_padded_chain():
    from pcss_unet_tpu_torch.infer.chw_engine import _padded_chain
    return _padded_chain((60, 120), 128, 64)


# each family of matrix that reaches apply_matrix, with its band width and
# its transpose's
_BAND_FAMILIES = {
    "interp_up": (lambda: tresize.interp_matrix(68, 136), 2, 4),
    "interp_down": (lambda: tresize.interp_matrix(137, 68), 2, 1),
    "head_chain_544": (lambda: tresize.resize_chain((544, 1088, 544)), 3, 3),
    "head_chain_960": (lambda: tresize.resize_chain((960, 1920, 960)), 3, 3),
    "window_cut": (lambda: tresize._window_of(tresize.interp_matrix, (68, 136),
                                              (20, 60), (8, 32)), 2, 4),
    "chw_padded_chain": (_chw_padded_chain, 2, 4),
}


@pytest.mark.parametrize("family", sorted(_BAND_FAMILIES))
def test_band_tables_rebuild_the_rounded_matrix(family):
    """Each table, and its transpose's, rebuilds the matrix rounded to the
    working dtype exactly (the reference's cast point), at the family's
    band widths."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    build, width, width_t = _BAND_FAMILIES[family]
    m = build()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for mm, want_width in ((m, width), (m.T, width_t)):
            start, weight = kres.band_tables(mm, dtype)
            assert start.dtype == np.int32 and weight.dtype == np.float32
            assert weight.shape == (mm.shape[0], want_width)
            assert np.all(start >= 0) and np.all(start + want_width <= mm.shape[1])
            rounded = torch.as_tensor(np.asarray(mm)).to(dtype).float().numpy()
            np.testing.assert_array_equal(kres.dense_of(start, weight, mm.shape[1]),
                                          rounded)


def test_band_widths_on_the_main_paths_sizes():
    """Up 2× on every size 68…512: band 2, transpose 4; the head's chains:
    3 and 3.  So MAX_BAND = 4 covers every matrix the cells use."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    widths = set()
    for n in range(68, 513):
        m = tresize.interp_matrix(n, 2 * n)
        widths.add((kres.band_tables(m, torch.bfloat16)[1].shape[1],
                    kres.band_tables(m.T, torch.bfloat16)[1].shape[1]))
    assert widths == {(2, 4)}
    for sizes in ((544, 1088, 544), (960, 1920, 960), (1024, 2048, 1024)):
        m = tresize.resize_chain(sizes)
        assert kres.band_tables(m, torch.bfloat16)[1].shape[1] == 3
        assert kres.band_tables(m.T, torch.bfloat16)[1].shape[1] == 3


def test_wider_band_is_refused():
    """A down-4×-then-up chain spans more than MAX_BAND columns a row: no
    tables, and ``Matrix.bands`` (what apply_matrix asks for on a card)
    raises.  A narrow matrix's tables and its transpose's are built once
    per key, float64's too; on the CPU apply_matrix takes a ``matrix_on``
    matrix as its host array."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    wide = tresize.matrix_on("cpu", tresize.resize_chain, (100, 25, 100))
    assert kres.band_tables(wide.host(), torch.bfloat16) is None
    with pytest.raises(ValueError, match="more than 4 columns"):
        wide.bands(torch.bfloat16)
    narrow = tresize.matrix_on("cpu", tresize.interp_matrix, 100, 200)
    fwd = narrow.bands(torch.bfloat16)
    assert (fwd.width, fwd.in_size, fwd.out_size) == (2, 100, 200)
    assert narrow.bands(torch.bfloat16) is fwd
    bwd = narrow.bands(torch.float64, transposed=True)
    assert (bwd.width, bwd.in_size, bwd.out_size) == (4, 200, 100)
    x = torch.randn(1, 2, 100, 3)
    assert torch.equal(tresize.apply_matrix(x, narrow, 2),
                       tresize.apply_matrix(x, narrow.host(), 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_band_weights_round_as_torch_casts(rng, dtype):
    """The tables' numpy rounding equals torch's cast to the dtype and back,
    on random values, exact ties of both dtypes and a transposed view."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    m = rng.standard_normal((64, 48)).astype(np.float32)
    m[0, :16] = 1 + np.arange(16, dtype=np.float32) * 2.0 ** -8   # bf16 ties
    m[1, :16] = 1 + np.arange(16, dtype=np.float32) * 2.0 ** -11  # fp16 ties
    for mm in (m, m.T):
        want = torch.as_tensor(np.ascontiguousarray(mm)).to(dtype).float().numpy()
        np.testing.assert_array_equal(kres.rounded(mm, dtype), want)


def test_banded_resize_plain_traces_as_on_a_card():
    """What apply_matrix runs on a card while tracing, ``Matrix.bands``
    then ``banded_resize_plain``, exports with ``torch.export`` (the tables
    built anew in the trace, none cached) and equals the eager run."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    class Up(torch.nn.Module):
        def forward(self, x):
            mat = tresize.matrix_on(x.device, tresize.resize_chain, (6, 12, 6))
            return kres.banded_resize_plain(x, mat.bands(x.dtype), 2)

    x = torch.randn(1, 3, 6, 5).to(torch.bfloat16)
    before = tresize._bands_cached.cache_info().currsize
    exported = torch.export.export(Up(), (x,))
    assert tresize._bands_cached.cache_info().currsize == before
    assert torch.equal(exported.module()(x), Up()(x))


def _ulp(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place, in ``dtype``, of each value of ``t``."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    e = torch.floor(torch.log2(t.float().abs().clamp(min=torch.finfo(dtype).tiny)))
    return torch.exp2(e - mant)


def _sum_tol(x: torch.Tensor, m: np.ndarray, axis: int) -> torch.Tensor:
    """How far two orders of the float32 sum Σ_i m[o, i]·x[.., i, ..] may
    lie apart, rounded to x's dtype: one ulp of the dtype at the sum's
    magnitude Σ|m||x|; at float32, one ulp there per addition (band width
    − 1 of them).  At float64 both round a float64 sum to float32: one
    float32 ulp there, and one more for the gradient, which the dense
    product's backward rounds to float32 on the way in, the kernel's on
    the way out."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    mr = np.abs(torch.as_tensor(m).to(x.dtype).float().numpy())
    mag = tresize.apply_matrix(x.detach().abs().float(), mr, axis)
    if x.dtype == torch.float64:
        return 2 * _ulp(mag, torch.float32)
    adds = kres.band_tables(m, x.dtype)[1].shape[1] - 1
    return _ulp(mag, x.dtype) * (max(adds, 1) if x.dtype == torch.float32 else 1)


def _layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    if layout == "sliced":                    # not dense: a copy first
        return torch.cat([x, x], dim=3)[..., : x.shape[3]]
    return x.contiguous()


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "sliced"])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_banded_resize_plain_matches_dense(rng, layout, axis, dtype):
    """The kernel's plain version ≡ the dense apply_matrix within one ulp
    of the dtype (they differ in the order of float32 sums only: at
    float32, one ulp per addition, ``_sum_tol``), on an
    up 2× and the head's chain, and its gradient through the transposed
    tables ≡ autograd through the dense product, the same way."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    x0 = torch.from_numpy(rng.standard_normal((2, 5, 12, 16)).astype(np.float32))
    for m in (tresize.interp_matrix(x0.shape[axis], 2 * x0.shape[axis]),
              tresize.resize_chain((x0.shape[axis], 2 * x0.shape[axis],
                                    x0.shape[axis]))):
        fwd = kres.bands_on(m, dtype, x0.device)
        bwd = kres.bands_on(m.T, dtype, x0.device)
        xa = _layout(x0.to(dtype), layout).requires_grad_()
        xb = x0.to(dtype).requires_grad_()
        got = kres.BandedResize.apply(xa, fwd, bwd, axis)
        want = tresize.apply_matrix(xb, m, axis)
        assert got.dtype == want.dtype == dtype
        assert torch.all((got.float() - want.float()).abs() <= _sum_tol(xb, m, axis))
        g = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32)).to(dtype)
        (ga,) = torch.autograd.grad(got, xa, g)
        (gb,) = torch.autograd.grad(want, xb, g)
        assert ga.dtype == dtype
        assert torch.all((ga.float() - gb.float()).abs() <= _sum_tol(g, m.T, axis))


def _emulate_band_entry(x, out, a):
    """The card kernel (csrc/resize.cu) over the arguments the wrapper
    passed: x's and out's memory read as [outer, L, inner] from their data
    pointers, out[n, o, j] = Σ_k w[o, k]·x[n, start[o] + k, j] in float32."""
    start, weight = a[2], a[3]
    outer, l_in, l_out, inner, nb = a[4:9]
    xm = torch.as_strided(x, (outer, l_in, inner), (l_in * inner, inner, 1))
    om = torch.as_strided(out, (outer, l_out, inner), (l_out * inner, inner, 1))
    acc = torch.zeros(outer, l_out, inner)
    for k in range(nb):
        acc = acc + weight[:, k][None, :, None] * xm[:, start.long() + k].float()
    om.copy_(acc.to(out.dtype))


@pytest.mark.parametrize("layout,axis,want_mode", [
    ("nchw", 2, "vector"),                 # inner = W
    ("nchw", 3, "rows"),                   # the resized axis is contiguous
    ("channels_last", 2, "vector"),        # inner = W·C
    ("channels_last", 3, "vector"),        # inner = C
    ("sliced", 2, "vector"),               # copied to contiguous first
    ("offset", 2, "scalar"),               # base 2 bytes off 16
])
def test_banded_resize_c_entry_arguments(rng, monkeypatch, layout, axis, want_mode):
    """What the wrapper hands the C entry, with a stub in its place: the
    [outer, L, inner] sizes of x's memory order, the band width, dtype and
    mode; the kernel emulated over those arguments gives the plain version
    exactly, in an output laid out as x is."""
    from pcss_unet_tpu_torch.ops.kernels import resize as kres

    x0 = torch.from_numpy(rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
                          ).to(torch.bfloat16)
    if layout == "offset":
        buf = torch.empty(x0.numel() + 1, dtype=torch.bfloat16)
        x = buf[1:].view(x0.shape)
        x.copy_(x0)
    else:
        x = _layout(x0, layout)
    m = tresize.interp_matrix(x.shape[axis], 2 * x.shape[axis])
    bands = kres.bands_on(m, torch.bfloat16, x.device)
    seen = []
    monkeypatch.setattr(kres._build, "call", lambda name, *a: seen.append((name, a)))
    out = kres._launch(x, bands, axis, 7)
    (name, a), = seen
    assert name == "pcss_band_resize" and a[-1] == 7
    assert a[8:11] == (2, kres.DTYPES[torch.bfloat16],
                       {"vector": kres.VECTOR, "rows": kres.ROWS,
                        "scalar": kres.SCALAR}[want_mode])
    assert a[4] * a[5] * a[7] == x.numel() and a[5] == x.shape[axis]
    assert a[6] == 2 * x.shape[axis] and a[0] != 0 and a[1] == out.data_ptr()
    src = x if layout != "sliced" else x.contiguous()
    if layout != "sliced":
        assert a[0] == x.data_ptr()
    _emulate_band_entry(src, out, (None, None, bands.start, bands.weight, *a[4:]))
    assert torch.equal(out, kres.banded_resize_plain(x, bands, axis))
    dense_like = layout in ("nchw", "channels_last")
    if dense_like:
        assert out.is_contiguous(memory_format=torch.channels_last
                                 if layout == "channels_last" else
                                 torch.contiguous_format)
