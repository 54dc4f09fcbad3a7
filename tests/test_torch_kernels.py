"""Port kernels' plain versions ≡ the JAX package's Pallas kernels run in
interpret mode on the CPU (the port's wrappers take their plain version for
a CPU tensor).  Inputs are made from a seed with numpy; each tolerance is
stated where it is used."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.ops.pallas import block_int8 as jb8
from pcss_unet_tpu.ops.pallas import conv3x3_int8 as jc7
from pcss_unet_tpu.ops.pallas import convblock as jcb
from pcss_unet_tpu.ops.pallas import convblock128 as jc128
from pcss_unet_tpu.ops.pallas import fused as jfused
from pcss_unet_tpu.ops.pallas.taps import conv3x3_band_taps as j_taps
from pcss_unet_tpu_torch.ops.kernels import _build
from pcss_unet_tpu_torch.ops.kernels import block_int8 as tb8
from pcss_unet_tpu_torch.ops.kernels import conv3x3_int8 as tc7
from pcss_unet_tpu_torch.ops.kernels import convblock as tcb
from pcss_unet_tpu_torch.ops.kernels import convblock128 as tc128
from pcss_unet_tpu_torch.ops.kernels import fused as tfused
from pcss_unet_tpu_torch.ops.kernels import taps as taps_mod
from pcss_unet_tpu_torch.ops.kernels.taps import conv3x3_band_taps as t_taps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K1 / K4


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_scrub_standardize_matches(rng, out_dtype):
    x = rng.standard_normal((2, 16, 64, 4)).astype(np.float32)
    x[0, 0, 0, 0] = np.nan
    x[0, 0, 1, 1] = np.inf
    x[1, 2, 3, 2] = -np.inf
    means = np.array([0.5, -0.5, 1.0, 0.0], np.float32)
    stds = np.array([2.0, 1.0, 0.5, 3.0], np.float32)
    want = np.asarray(jfused.fused_scrub_standardize(
        jnp.asarray(x), jnp.asarray(means), jnp.asarray(stds),
        out_dtype=getattr(jnp, out_dtype), interpret=True), np.float32)
    got = tfused.fused_scrub_standardize(
        _t(x), _t(means), _t(stds), out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    # float32: both multiply by the same float32 reciprocal → 1e-6;
    # bfloat16 output: equal after the same rounding
    tol = 1e-6 if out_dtype == "float32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _frame_with_specials(rng, n, h, w, c=4):
    x = (rng.standard_normal((n, h, w, c)) * 3).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 12, replace=False)
    flat[idx[:4]] = np.nan
    flat[idx[4:8]] = np.inf
    flat[idx[8:]] = -np.inf
    means = rng.standard_normal(c).astype(np.float32)
    stds = (rng.random(c) + 0.1).astype(np.float32)
    return x, means, stds


@pytest.mark.parametrize("entry", ["nhwc", "chw"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_scrub_standardize_entry_matches_jax_chain(rng, entry, out_dtype):
    """K1 writing the forward's first input ≡ the reference's chain: its
    Pallas kernel (interpret mode) into float32, then the posture's entry
    (``pixel_unshuffle_nhwc`` of the working dtype, or the chw engine's
    ``_entry_chw``), bit for bit.  W/2 = 20 leaves 108 pad columns."""
    from pcss_unet_tpu.infer.chw_engine import _entry_chw
    from pcss_unet_tpu.ops.pixelshuffle import pixel_unshuffle_nhwc

    x, means, stds = _frame_with_specials(rng, 2, 6, 40)
    jd = getattr(jnp, out_dtype)
    y = jfused.fused_scrub_standardize(jnp.asarray(x), jnp.asarray(means),
                                       jnp.asarray(stds), out_dtype=jnp.float32,
                                       interpret=True)
    want = (pixel_unshuffle_nhwc(y.astype(jd), 2) if entry == "nhwc"
            else _entry_chw(y, jd))
    got = tfused.fused_scrub_standardize(_t(x), _t(means), _t(stds),
                                         out_dtype=getattr(torch, out_dtype),
                                         entry=entry)
    assert got.dtype == getattr(torch, out_dtype)
    assert tuple(got.shape) == want.shape == tfused.entry_shape(x.shape, entry)
    assert torch.equal(got.float(), _t(np.asarray(want.astype(jnp.float32))))
    if entry == "chw":
        assert not got[..., 20:].any()


def _emulate_c_entry(x, mean, std, out_shape, a):
    """The card kernel's addressing (csrc/fused.cu) over the arguments the
    wrapper passed: value (n, h', dy, w', dx, c) of the scrubbed,
    standardized frame at offset n·sn + h'·sh + dy·sdy + w'·sw + dx·sdx +
    c·sc; columns w' ≥ W/R zero."""
    n, h, w, c, r, wout = a[4:10]
    sn, sh, sdy, sw, sdx, sc = a[10:16]
    y = tfused.scrub_standardize_plain(x, mean, std, torch.float32)
    flat = torch.full((int(np.prod(out_shape)),), float("nan"))
    idx = torch.meshgrid(*(torch.arange(k) for k in (n, h // r, r, wout, r, c)),
                         indexing="ij")
    i_n, i_h, i_dy, i_w, i_dx, i_c = idx
    off = i_n * sn + i_h * sh + i_dy * sdy + i_w * sw + i_dx * sdx + i_c * sc
    pad = i_w >= w // r
    src = y[i_n, i_h * r + i_dy, (i_w * r + i_dx).clamp(max=w - 1), i_c]
    flat[off.reshape(-1)] = torch.where(pad, 0.0, src).reshape(-1)
    return flat.reshape(out_shape)


@pytest.mark.parametrize("entry", [None, "nhwc", "chw"])
@pytest.mark.parametrize("case,c,mode", [
    ("aligned", 4, "vec"),
    ("offset", 4, tfused.GENERAL),     # base 4 bytes off 16: element by element
    ("c3", 3, tfused.GENERAL),         # C ≠ 4: the general path
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_scrub_standardize_c_entry_arguments(rng, monkeypatch, entry, case, c,
                                             mode, out_dtype):
    """What the wrapper hands the C entry, with a stub in its place: the
    sizes, the output's columns, the mode, and six strides that put every
    value where the plain version has it (the kernel's addressing emulated
    over those arguments gives the plain output exactly, pad columns
    included)."""
    seen = []
    monkeypatch.setattr(tfused._build, "call", lambda name, *a: seen.append((name, a)))
    n, h, w = 2, 6, 18                                  # W/2 = 9, H/2 odd
    x, means, stds = _frame_with_specials(rng, n, h, w, c)
    xt = _t(x)
    if case == "offset":
        buf = torch.empty(xt.numel() + 1)
        xt = buf[1:].view(xt.shape)
        xt.copy_(_t(x))
    out = torch.empty(tfused.entry_shape(xt.shape, entry), dtype=out_dtype)
    tfused._launch(xt, _t(means), _t(stds), out, entry, 7)
    (name, a), = seen
    assert name == "pcss_scrub_standardize"
    r = 1 if entry is None else 2
    want_mode = ({None: tfused.UNIT, "nhwc": tfused.UNIT, "chw": tfused.PLANES}[entry]
                 if mode == "vec" else mode)
    assert a[0] == xt.data_ptr() and a[3] == out.data_ptr()
    assert a[4:10] == (n, h, w, c, r, out.shape[3 if entry == "chw" else 2])
    assert a[16:] == (int(out_dtype == torch.bfloat16), want_mode, 7)
    got = _emulate_c_entry(xt, _t(means), _t(stds), out.shape, a).to(out_dtype)
    want = tfused.scrub_standardize_plain(xt, _t(means), _t(stds), out_dtype,
                                          entry=entry)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["chw", "nhwc"])
def test_engine_entry_equals_two_step_path(layout):
    """The engine's one-pass entry (K1 into the posture's first input, then
    ``chw_forward_entered`` / ``UNet.forward_entered``) gives the masks of
    the two-step path it replaced (K1 into float32 NHWC, then the whole
    forward), bit for bit in bf16; ``render_u8`` gives K4 of that mask."""
    from pcss_unet_tpu_torch.infer import InferenceEngine
    from pcss_unet_tpu_torch.infer.chw_engine import chw_forward
    from pcss_unet_tpu_torch.models.init import seeded_variables

    rng = np.random.default_rng(3)
    means = rng.standard_normal(4).astype(np.float32)
    stds = (rng.random(4) + 0.5).astype(np.float32)
    eng = InferenceEngine(None, seeded_variables((16, 32), seed=1), means=means,
                          stds=stds, fold_bn=True, quantize="int8", layout=layout,
                          dtype=torch.bfloat16, device="cpu")
    frames = _t(_frame_with_specials(rng, 1, 32, 64)[0])
    x = tfused.fused_scrub_standardize(frames, _t(means), _t(stds),
                                       out_dtype=torch.float32)
    with torch.inference_mode():
        raw = (chw_forward(eng.variables, x, dtype=torch.bfloat16, int8=True)
               if layout == "chw" else eng.model(x))
    assert raw.dtype == torch.float32
    want = InferenceEngine._postprocess(raw)
    assert torch.equal(eng.run_padded(frames), want)
    assert torch.equal(eng.render_u8(frames), tfused.mask_to_u8_plain(want))


def test_scrub_standardize_entry_validates():
    x, m = torch.zeros(1, 6, 10, 4), torch.zeros(4)
    with pytest.raises(ValueError, match="entry must be"):
        tfused.fused_scrub_standardize(x, m, m, entry="nchw")
    with pytest.raises(ValueError, match="H, W even"):
        tfused.fused_scrub_standardize(torch.zeros(1, 5, 10, 4), m, m, entry="nhwc")
    with pytest.raises(ValueError, match="means/stds"):
        tfused.fused_scrub_standardize(x, torch.zeros(3), m)


def test_mask_to_u8_needs_no_postprocess(rng):
    """K4 scrubs and clips by itself, so the serving path feeds it the
    forward's mask as it is: equal, bit for bit, to K4 after the engine's
    ``_postprocess``, over NaN, ±Inf, −0.0, out-of-range values and every
    exact ×255 tie."""
    from pcss_unet_tpu_torch.infer import InferenceEngine

    planted = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1e-30, 1 + 1e-7,
                        -3.5, 7.25, np.finfo(np.float32).max,
                        -np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                       np.float32)
    x = np.concatenate([planted, _u8_ties(),
                        (rng.random(4000) * 3 - 1).astype(np.float32)])
    xt = _t(x).reshape(1, 1, -1, 1)
    want = tfused.mask_to_u8_plain(InferenceEngine._postprocess(xt))
    assert torch.equal(tfused.mask_to_u8_plain(xt), want)
    assert torch.equal(tfused.fused_mask_to_u8(xt), want)


@pytest.mark.parametrize("offset,vec", [(0, 1), (1, 0), (4, 1)])
def test_mask_to_u8_c_entry_arguments(monkeypatch, offset, vec):
    """K4's C entry gets the count and takes its 16-pixel vector path only
    on a 16-byte aligned mask; an offset view is read in place."""
    seen = []
    monkeypatch.setattr(tfused._build, "call", lambda name, *a: seen.append((name, a)))
    buf = torch.zeros(offset + 5 * 37)
    x = buf[offset:].view(1, 5, 37, 1)
    out = torch.empty(x.shape, dtype=torch.uint8)
    tfused._launch_u8(x, out, 7)
    (name, a), = seen
    assert name == "pcss_mask_to_u8"
    assert a == (x.data_ptr(), out.data_ptr(), 185, vec, 7)


def _u8_ties():
    """float32 x in [0,1] with x·255 exactly k + 0.5 in float32."""
    ks = np.arange(255)
    x = ((ks + 0.5) / 255).astype(np.float32)
    exact = (x * np.float32(255)) == (ks + 0.5).astype(np.float32)
    return x[exact]


def test_mask_to_u8_matches_exactly(rng):
    x = rng.random((2, 8, 64, 1)).astype(np.float32) * 1.4 - 0.2
    flat = x.reshape(-1)
    planted = np.array([np.nan, np.inf, -np.inf, -0.0,
                        np.float32(0.5) / np.float32(255),
                        np.float32(254.5) / np.float32(255)], np.float32)
    ties = _u8_ties()
    assert len(ties) > 10
    flat[:len(planted)] = planted
    flat[len(planted):len(planted) + len(ties)] = ties
    want = np.asarray(jfused.fused_mask_to_u8(jnp.asarray(x), interpret=True))
    got = tfused.fused_mask_to_u8(_t(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().reshape(-1)[0] == 0          # NaN → 0, not 255
    # half to even on the exact ties: 0.5 → 0, 1.5 → 2, 2.5 → 2
    t = got.numpy().reshape(-1)[len(planted):len(planted) + len(ties)]
    k = np.round(ties * np.float32(255)).astype(np.int64)
    np.testing.assert_array_equal(t, k)


# --------------------------------------------------------------------- K2


def _convblock_params(rng, cin, cmid, cout):
    return {
        "conv_a": {"kernel": rng.standard_normal((3, 3, cin, cmid)).astype(np.float32) * 0.2,
                   "bias": rng.standard_normal(cmid).astype(np.float32) * 0.1},
        "conv_b": {"kernel": rng.standard_normal((1, 1, cmid, cout)).astype(np.float32) * 0.2,
                   "bias": rng.standard_normal(cout).astype(np.float32) * 0.1},
    }


_JAX_TAPS = {
    "loop": dict(),
    "stack": dict(stack_taps=True),
    "chunk128": dict(stack_taps="chunk128"),
    "acc_shift": dict(acc_shift=True),
    "rowpack": dict(rowpack=True),
}


@pytest.mark.parametrize("taps", list(_JAX_TAPS))
@pytest.mark.parametrize("cin,cmid,cout,h,w,k", [
    (16, 16, 64, 32, 48, 8),      # enc_0 shape class
    (64, 64, 16, 24, 130, 8),     # dec_final class; W just over a lane tile
    (16, 16, 32, 30, 96, 6),      # H a multiple of 6, not of 8
    # the card kernel's padding edges (channels not multiples of 16, one
    # row, W = 127 with Wp 128, W = 128 with Wp 256)
    (20, 12, 4, 10, 60, 5),
    (16, 16, 16, 1, 127, 1),
    (64, 64, 16, 4, 128, 4),
])
def test_convblock_plain_matches(rng, taps, cin, cmid, cout, h, w, k):
    """Every reference tap strategy ≡ the port's one function (rtol/atol
    2e-4, float32: the reference's kernel tolerance).  Without ``true_w``
    the reference's pad-column outputs depend on its band edges, so the
    comparison is over the W true columns."""
    params = _convblock_params(rng, cin, cmid, cout)
    wp = (w // 128 + 1) * 128
    x = np.zeros((1, cin, h, wp), np.float32)
    x[..., :w] = rng.standard_normal((1, cin, h, w))
    jw = jcb.pack_convblock_params(params, dtype=jnp.float32)
    want = np.asarray(jcb.fused_conv_block_chw(
        jnp.asarray(x), *jw, k_rows=k, interpret=True, **_JAX_TAPS[taps]))
    tw = tcb.pack_convblock_params(params, dtype=torch.float32)
    got = tcb.fused_conv_block_chw(_t(x), *tw, taps=taps).numpy()
    np.testing.assert_allclose(got[..., :w], want[..., :w], rtol=2e-4,
                               atol=2e-4)


_EPILOGUE_BASE = (16, 16, 32, 16, 100, 8)
_EPILOGUE_CASES = [("stack", _EPILOGUE_BASE), ("acc_shift", _EPILOGUE_BASE),
                   ("rowpack", _EPILOGUE_BASE),
                   # the card kernel's padding edges, as above
                   ("stack", (20, 12, 4, 10, 60, 5)),
                   ("stack", (16, 16, 16, 1, 127, 1)),
                   ("acc_shift", (64, 64, 16, 4, 128, 4))]


@pytest.mark.parametrize(
    "taps,shape", _EPILOGUE_CASES,
    ids=["stack", "acc_shift", "rowpack", "stack-c20-12-4", "stack-h1-w127",
         "acc_shift-w128"])
def test_convblock_epilogue_matches(rng, taps, shape):
    """true_w pad re-zeroing and the fused residual add ≡ the reference
    (rtol/atol 2e-4 over every column, float32)."""
    cin, cmid, cout, h, w, k = shape
    wp = (w // 128 + 1) * 128
    params = _convblock_params(rng, cin, cmid, cout)
    x = np.zeros((1, cin, h, wp), np.float32)
    x[..., :w] = rng.standard_normal((1, cin, h, w))
    res = np.zeros((1, cout, h, wp), np.float32)
    res[..., :w] = rng.standard_normal((1, cout, h, w))
    want = np.asarray(jcb.fused_conv_block_chw(
        jnp.asarray(x), *jcb.pack_convblock_params(params, dtype=jnp.float32),
        k_rows=k, interpret=True, true_w=w, residual=jnp.asarray(res),
        **_JAX_TAPS[taps]))
    got = tcb.fused_conv_block_chw(
        _t(x), *tcb.pack_convblock_params(params, dtype=torch.float32),
        taps=taps, true_w=w, residual=_t(res)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.all(got[..., w:] == 0.0)


def test_convblock_bf16_cpu_takes_plain_version(rng):
    """A bf16 CPU call takes the plain version on the bf16 weights as given:
    equal to it bit for bit, and no kernel launch counted."""
    params = _convblock_params(rng, 20, 12, 4)
    w1, b1, w2, b2 = tcb.pack_convblock_params(params, dtype=torch.bfloat16)
    assert w1.dtype == w2.dtype == torch.bfloat16
    x = torch.zeros(1, 20, 5, 128, dtype=torch.bfloat16)
    x[..., :60] = _t(rng.standard_normal((1, 20, 5, 60)).astype(np.float32))
    res = _t(rng.standard_normal((1, 4, 5, 128)).astype(np.float32)).bfloat16()
    before = tcb.fused_conv_block_chw.launches
    got = tcb.fused_conv_block_chw(x, w1, b1, w2, b2, true_w=60, residual=res)
    want = tcb.conv_block_chw_plain(x, w1, b1, w2, b2, true_w=60, residual=res)
    assert tcb.fused_conv_block_chw.launches == before
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.all(got[..., 60:] == 0)


def test_convblock_wrapper_validates(rng):
    params = _convblock_params(rng, 16, 16, 16)
    w = tcb.pack_convblock_params(params, dtype=torch.float32)
    x = torch.zeros(1, 16, 8, 128)
    with pytest.raises(ValueError, match="tap strategy"):
        tcb.fused_conv_block_chw(x, *w, taps="diagonal")
    with pytest.raises(ValueError, match="Wp % 128"):
        tcb.fused_conv_block_chw(torch.zeros(1, 16, 8, 100), *w)
    with pytest.raises(ValueError, match="residual"):
        tcb.fused_conv_block_chw(x, *w, residual=torch.zeros(1, 16, 8, 64))


# --------------------------------------------------------------- taps / K3


def test_band_taps_match(rng):
    """Shared tap contraction ≡ the reference helper (float32, 1e-5)."""
    ext = rng.standard_normal((6, 12, 8)).astype(np.float32)
    wt = rng.standard_normal((9, 8, 5)).astype(np.float32)
    want = np.asarray(j_taps(jnp.asarray(ext), jnp.asarray(wt), 4,
                             jnp.float32))
    got = t_taps(_t(ext)[None], _t(wt), 4)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _int8_params(rng, c, co):
    return {
        "conv_a": {"kernel": (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32),
                   "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)},
        "conv_b": {"kernel": (rng.standard_normal((1, 1, c, co)) * 0.05).astype(np.float32),
                   "bias": (rng.standard_normal(co) * 0.1).astype(np.float32)},
    }


@pytest.mark.parametrize("c,co,h,w", [
    (128, 64, 16, 16),    # two bands of 8: a halo row crosses a band edge
    (128, 64, 12, 16),    # k_rows 4: three bands
    (256, 128, 8, 8),     # the w16 dec_0 channel counts
])
def test_block_int8_plain_matches(rng, c, co, h, w):
    """int8 whole block ≡ the reference kernel at float32.  Both quantize
    the same float32 values with the same scales and sum integers exactly,
    so they differ only where float32 rounding of a scale product flips an
    int8 tie; the bound is max |d| ≤ 1e-3 (measured ≤ 4.8e-7 here)."""
    params = _int8_params(rng, c, co)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    k = tb8.pick_k_rows_int8(h, w, c, co)
    assert k == jb8.pick_k_rows_int8(h, w, c, co) and k is not None
    want = np.asarray(jb8.fused_block_int8_nhwc(
        jnp.asarray(x), *jb8.pack_block_int8_params(params), k_rows=k,
        interpret=True))
    got = tb8.fused_block_int8_nhwc(
        _t(x), *tb8.pack_block_int8_params(params), k_rows=k).numpy()
    d = float(np.abs(got - want).max())
    print(f"int8 block {c}->{co} {h}x{w} k_rows={k}: max |d| = {d:.3g}")
    assert d <= 1e-3, d


def test_block_int8_pack_matches(rng):
    params = _int8_params(rng, 128, 64)
    for got, want in zip(tb8.pack_block_int8_params(params),
                         jb8.pack_block_int8_params(params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("taps,c,co", [(9, 128, 64), (9, 256, 200), (1, 512, 128),
                                       (1, 16, 8)])
def test_pack_taps_i8_round_trip(rng, taps, c, co):
    """The tensor-core kernels' weight layout [taps, C/16, Co, 16] holds
    input channel 16k + i of output channel o at [t, k, o, i], and unpacks
    to [taps, C, Co] bit for bit; the 1×1's is the one-tap case."""
    wq = _t(rng.integers(-127, 128, (taps, c, co)).astype(np.int8))
    packed = tb8.pack_taps_i8(wq)
    assert tuple(packed.shape) == (taps, c // 16, co, 16) and packed.is_contiguous()
    t, k, o, i = (int(v) for v in rng.integers(0, (taps, c // 16, co, 16)))
    assert packed[t, k, o, i] == wq[t, 16 * k + i, o]
    back = packed.permute(0, 1, 3, 2).reshape(taps, c, co)
    assert torch.equal(back, wq)
    if taps == 1:
        assert torch.equal(tb8.pack_pointwise_i8(wq[0]), packed[0])


@pytest.mark.parametrize("k_rows,w,c,co", [(2, 12, 32, 24), (4, 7, 64, 16), (1, 5, 16, 8)])
def test_packed_taps_einsum_equals_plain_sums(rng, k_rows, w, c, co):
    """The contraction as the tensor-core tile runs it, word by word over the
    packed layout (einsum over [words, Co, 16]), gives the plain version's
    integer 3×3 sums exactly: int8 sums do not depend on their order."""
    ext = _t(rng.integers(-127, 128, (3, k_rows + 2, w, c)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (9, c, co)).astype(np.int8))
    want = t_taps(ext.double(), wq.double(), k_rows)
    packed = tb8.pack_taps_i8(wq).long()
    xp = torch.nn.functional.pad(ext.long(), (0, 0, 1, 1))        # zero columns
    got = 0
    for t in range(9):
        dy, dx = divmod(t, 3)                                       # dx + 1
        tap = xp[:, dy:dy + k_rows, dx:dx + w].reshape(3, k_rows * w, c // 16, 16)
        got = got + torch.einsum("bpki,koi->bpo", tap, packed[t])
    assert torch.equal(got.double(), want)


def _taps_constants() -> dict:
    """The int8 tiles' integer constants from ``csrc/taps.cuh``, per
    namespace (``i8wg``: the 3×3 on wgmma; ``i8mma``: the 1×1), with the
    expressions evaluated in order."""
    import re
    from pathlib import Path

    src = (Path(tb8.__file__).resolve().parents[2] / "csrc" / "taps.cuh").read_text()
    out = {}
    for ns in ("i8wg", "i8mma"):
        body = src[src.index(f"namespace {ns} {{"):src.index(f"}}  // namespace {ns}")]
        env = {}
        for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", body):
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
        out[ns] = env
    return out


def test_int8_tile_fits_shared_memory():
    """The int8 tiles' shared-memory plans, from the constants in
    ``csrc/taps.cuh`` and the layout of ``csrc/int8_conv.cuh``, fit one H100
    block (232,448 bytes, less the static mbarriers and per-warp maxima) at
    the largest chunk count the launcher admits (64): the 3×3's ring of 6
    stages, and of 3 beside the chunked kernel's float32 chunk sums (128 a
    consumer thread); the 1×1's two activation and two weight slices."""
    k = _taps_constants()
    wg, mma = k["i8wg"], k["i8mma"]
    assert wg["STAGE_BYTES"] % 128 == 0 and wg["WS_BYTES"] % 128 == 0
    for stages, chunked in ((6, False), (3, True)):
        ring = stages * wg["STAGE_BYTES"]
        total = ring + 4 * ((128 * wg["NC"] if chunked else 0) + 2 * wg["TN"] + 64)
        static = 2 * stages * 8 + 4 * wg["NC"] // 32
        assert total + static <= 232_448, (stages, chunked, total)
    xs = mma["KW"] * (mma["TM"] + 2) * 16
    total = 2 * xs + 2 * mma["KW"] * mma["TN"] * 16 + 4 * 2 * mma["TN"]
    assert total + 2 * 8 + 4 + 4 * mma["NT"] // 32 <= 232_448
    # the 3×3: two consumer warpgroups of 64 rows × TN channels (wgmma
    # m64nTNk32, 128 int32 accumulators a thread) cover TM pixels, whose three
    # taps read XW columns; one producer warp copies XS_COLS = TM + 2 of them
    # a word from the band copy (one bulk copy);
    # 288 threads leave each 224 registers, above the 168 that held the
    # accumulators without spills when 384 threads shared the file
    assert wg["TM"] + 2 <= 64 * wg["NC"] // 128 and wg["TN"] * 64 // 128 == 128
    assert wg["XW"] == 64 * wg["NC"] // 128 + 2 and wg["XS_COLS"] == wg["TM"] + 2
    assert wg["XS_COLS"] <= wg["XW"]
    assert wg["NP"] == 32 and wg["KW"] * 16 == 32
    threads = wg["NC"] + wg["NP"]
    assert 65536 // threads // 8 * 8 >= 168
    # the 1×1: 8 consumer warps of 32 × 64 cover 128 × 128; producers are
    # whole warpgroups; every thread keeps 128 registers (65536 / 512)
    assert (mma["TM"] // 32) * (mma["TN"] // 64) * 32 == mma["NT"] and mma["NP"] % 128 == 0
    assert 65536 // (mma["NT"] + mma["NP"]) >= 128 and mma["KW"] % 2 == 0


def _gmma_operand(smem: np.ndarray, start: int, lbo: int, sbo: int, rows: int) -> np.ndarray:
    """The rows × 32 int8 operand a wgmma reads through a descriptor without
    swizzle (K-major): element (r, k) at start + (r // 8)·sbo + (r % 8)·16 +
    (k // 16)·lbo + k % 16."""
    r, k = np.arange(rows)[:, None], np.arange(32)[None, :]
    return smem[start + (r // 8) * sbo + (r % 8) * 16 + (k // 16) * lbo + k % 16].astype(np.int64)


def _wgmma_conv3x3(xq: np.ndarray, packed: np.ndarray, *, h: int, w: int, k_rows: int,
                   cc: int, split: int, rng) -> list[np.ndarray]:
    """The 3×3 stage of ``int8_taps_kernel_wgmma`` modelled byte for byte on
    its shared memory: every block's ring stages (each word's bulk copy of
    XS_COLS columns of the band copy, the bulk copies of the packed weights,
    zeroed rows past the tile, stale weight words past a chunk's end and
    stale columns past XS_COLS), read through the consumers' descriptors as
    wgmma reads them.  xq: one image's band copy [H/k_rows, k_rows+2, words,
    Wp, 16] int8, packed [9, C/16, Co, 16].  Returns each chunk's int32 sums
    [H, W, Co]."""
    k = _taps_constants()["i8wg"]
    tm, tn, xw, kw, ws_bytes = k["TM"], k["TN"], k["XW"], k["KW"], k["WS_BYTES"]
    cols = k["XS_COLS"]
    c, co = packed.shape[1] * 16, packed.shape[2]
    ccw = cc // 16
    spc = (ccw + kw - 1) // kw
    cpw = xq.shape[2] // (c // cc)
    sums = [np.zeros((h, w, co), np.int64) for _ in range(c // cc)]
    tiles = [(g * split + t * tn, min(g * split + (t + 1) * tn, (g + 1) * split))
             for g in range(co // split) for t in range((split + tn - 1) // tn)]
    for row in range(h):
        for col0 in range(0, w, tm):
            for n0, n1 in tiles:
                nlim = n1 - n0
                stage = rng.integers(-128, 128, k["STAGE_BYTES"]).astype(np.int8)  # stale
                stage[:ws_bytes].reshape(3, kw, tn, 16)[:, :, nlim:] = 0
                d = np.zeros((2, 64, tn), np.int64)
                for g in range(c // cc * 3 * spc):
                    sl, dy = divmod(g, 3)
                    j = sl // spc
                    kw0 = (sl % spc) * kw
                    wlo, nw = j * ccw + kw0, min(kw, ccw - kw0)
                    ws = stage[:ws_bytes].reshape(3, kw, tn, 16)
                    for dx in range(3):
                        ws[dx, :nw, :nlim] = packed[3 * dy + dx, wlo:wlo + nw, n0:n1]
                    xs = stage[ws_bytes:ws_bytes + kw * xw * 16].reshape(kw, xw, 16)
                    for word in range(kw):
                        xs[word, :cols] = xq[row // k_rows, row % k_rows + dy,
                                             j * cpw + kw0 + word, col0:col0 + cols]
                    if g % (3 * spc) == 0:
                        d[:] = 0
                    for wg in range(2):
                        for dx in range(3):
                            a = _gmma_operand(stage, ws_bytes + (64 * wg + dx) * 16, xw * 16,
                                              128, 64)
                            b = _gmma_operand(stage, dx * kw * tn * 16, tn * 16, 128, tn)
                            d[wg] += a @ b.T
                    if g % (3 * spc) == 3 * spc - 1:
                        px = min(tm, w - col0)
                        sums[j][row, col0:col0 + px, n0:n1] = d.reshape(128, tn)[:px, :nlim]
    return sums


@pytest.mark.parametrize("h,w,c,co,cc,split,k_rows", [
    (3, 20, 64, 24, 64, 24, 3),       # one chunk, a ragged channel tile, one band
    (2, 130, 48, 16, 48, 16, 1),      # two pixel tiles; a slice with one word
    (2, 12, 96, 272, 32, 272, 2),     # three chunks; a full and a 16-channel tile
    (4, 9, 32, 384, 32, 192, 2),      # K7's split: two groups of 192 channels; two bands
])
def test_wgmma_stage_schedule_equals_plain_sums(rng, h, w, c, co, cc, split, k_rows):
    """The 3×3 as ``int8_taps_kernel_wgmma`` schedules it (stages of one dy
    row and 32 channels copied from the band copy, three dx descriptors a
    stage, each consumer warpgroup on its 64 pixels, chunk by chunk) gives
    each chunk's integer 3×3 sums of the plain version exactly.  Column 0
    holds 127 on every channel, so every band's scale is 1 and the band
    copy holds the integers themselves."""
    q = rng.integers(-127, 128, (h, w, c)).astype(np.int8)
    q[:, 0] = 127
    wq = rng.integers(-127, 128, (9, c, co)).astype(np.int8)
    packed = tb8.pack_taps_i8(torch.from_numpy(wq)).numpy()
    xq = tb8.quantize_bands(_t(q.astype(np.float32))[None], k_rows=k_rows, c_chunk=cc)[0]
    got = _wgmma_conv3x3(xq.numpy(), packed, h=h, w=w, k_rows=k_rows, cc=cc, split=split,
                         rng=rng)
    ext = torch.from_numpy(np.pad(q, ((1, 1), (0, 0), (0, 0)))[None]).double()
    for j, sums in enumerate(got):
        want = t_taps(ext[..., j * cc:(j + 1) * cc],
                      torch.from_numpy(wq[:, j * cc:(j + 1) * cc]).double(), h)
        np.testing.assert_array_equal(sums.reshape(h * w, co), want[0].numpy())


@pytest.mark.parametrize("n,h,w,c,k_rows,c_chunk", [
    (1, 4, 130, 256, 2, 128),   # two bands, halo rows in and outside the frame; W = 130
    (2, 6, 20, 512, 3, 256),    # N = 2, chunks of 256
    (1, 2, 12, 128, 2, 128),    # one band: both halo rows outside the frame
    (1, 2, 20, 96, 1, 48),      # 48-channel chunks: three words rounded up to four
])
def test_band_copy_plain_matches_reference_quantization(rng, n, h, w, c, k_rows, c_chunk):
    """The band copy's plain version (K3, K5, K7's first two launches) holds
    exactly what the reference kernels quantize: per band, its rows and one
    halo row above and below (zero outside the frame), each contraction
    chunk by its own max / 127 + 1e-12 (``block_int8.py::_quant``); laid
    out word-major with zero columns 0 and past W, and zero words past a
    chunk."""
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    got = tb8.quantize_bands(_t(x), k_rows=k_rows, c_chunk=c_chunk).numpy()
    tm, kw = _taps_constants()["i8wg"]["TM"], _taps_constants()["i8wg"]["KW"]
    assert (tm, kw) == (taps_mod.TM, taps_mod.KW)
    cpw = -(-c_chunk // 16 // kw) * kw
    assert got.shape == (n, h // k_rows, k_rows + 2, c // c_chunk * cpw,
                         -(-w // tm) * tm + 2, 16) and got.dtype == np.int8
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    want = np.zeros_like(got)
    for i in range(n):
        for b in range(h // k_rows):
            ext = jnp.asarray(xp[i, b * k_rows:b * k_rows + k_rows + 2])
            for j in range(c // c_chunk):
                e = ext[..., j * c_chunk:(j + 1) * c_chunk]
                q = np.asarray(jb8._quant(e, jnp.max(jnp.abs(e)) / 127.0 + 1e-12))
                want[i, b, :, j * cpw:j * cpw + c_chunk // 16, 1:w + 1] = (
                    q.reshape(k_rows + 2, w, c_chunk // 16, 16).transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(got, want)


_PICKER_SHAPES = [
    (128, 256, 256, 128),     # w16 2048x1024 dec_0
    (64, 128, 128, 256),      # w16 2048x1024 enc_3
    (272, 480, 512, 128),     # w64 1920x1088 dec_1
    (136, 240, 1024, 512),    # w64 1920x1088 dec_0
    (136, 240, 512, 1024),    # w64 1920x1088 enc_3
    (256, 512, 512, 128),     # w64 2048x1024 dec_1
    (128, 256, 1024, 512),    # w64 2048x1024 dec_0
]


@pytest.mark.parametrize("h,w,c,co", _PICKER_SHAPES)
def test_pickers_equal_at_model_stages(h, w, c, co):
    assert tb8.pick_k_rows_int8(h, w, c, co) == jb8.pick_k_rows_int8(h, w, c, co)
    assert tb8.pick_kchunked(h, w, c, co) == jb8.pick_kchunked(h, w, c, co)


def test_pickers_equal_over_grid():
    for h in (6, 8, 12, 30, 64):
        for w in (8, 20, 48, 240):
            for c in (64, 128, 256, 512, 1024):
                for co in (32, 64, 128, 512):
                    args = (h, w, c, co)
                    assert (tb8.pick_k_rows_int8(*args)
                            == jb8.pick_k_rows_int8(*args)), args
                    assert tb8.pick_kchunked(*args) == jb8.pick_kchunked(*args), args


def test_block_int8_wrapper_validates():
    x = torch.zeros(1, 8, 8, 128)
    w1q = torch.zeros(9, 128, 128, dtype=torch.int8)
    w2q = torch.zeros(128, 64, dtype=torch.int8)
    s, b = torch.ones(128), torch.zeros(128)
    s2, b2 = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="k_rows"):
        tb8.fused_block_int8_nhwc(x, w1q, s, b, w2q, s2, b2, k_rows=3)
    with pytest.raises(ValueError, match="int8"):
        tb8.fused_block_int8_nhwc(x, w1q.float(), s, b, w2q, s2, b2, k_rows=4)


# --------------------------------------------------------------------- K5


@pytest.mark.parametrize("c,co,h,w,k_rows,c_chunk", [
    (256, 64, 4, 32, 4, 128),     # tests/test_int8.py's shape, two chunks
    (256, 64, 8, 32, 2, 128),     # four bands: two at the frame edges
    (512, 128, 4, 16, 2, 128),    # four chunks
])
def test_block_int8_kchunked_plain_matches(rng, c, co, h, w, k_rows, c_chunk):
    """k-chunked int8 block ≡ the reference kernel at float32: the same
    per-chunk scales and integers, float32 chunk sums in the same order;
    the bound is 1e-3, as K3's (measured ≤ 4.8e-7)."""
    params = _int8_params(rng, c, co)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    want = np.asarray(jb8.fused_block_int8_kchunked(
        jnp.asarray(x), *jb8.pack_block_int8_params(params), k_rows=k_rows,
        c_chunk=c_chunk, interpret=True))
    got = tb8.fused_block_int8_kchunked(
        _t(x), *tb8.pack_block_int8_params(params), k_rows=k_rows,
        c_chunk=c_chunk).numpy()
    d = float(np.abs(got - want).max())
    print(f"kchunked {c}->{co} {h}x{w} k={k_rows} cc={c_chunk}: max |d| = {d:.3g}")
    assert d <= 1e-3, d


def test_block_int8_kchunked_one_chunk_is_k3_before_rounding(rng):
    """With one chunk K5 differs from K3 only in keeping h in float32:
    the two agree to one bf16 rounding of h's scale (5e-2 of the output
    range), and are not equal (h is not rounded)."""
    params = _int8_params(rng, 256, 64)
    x = _t(rng.standard_normal((1, 8, 16, 256)).astype(np.float32))
    ops = tb8.pack_block_int8_params(params)
    k3 = tb8.fused_block_int8_nhwc(x, *ops, k_rows=4)
    k5 = tb8.fused_block_int8_kchunked(x, *ops, k_rows=4, c_chunk=256)
    d = float((k3 - k5).abs().max())
    assert 0 < d <= 5e-2 * float(k3.abs().max()), d


def test_block_int8_kchunked_validates():
    x = torch.zeros(1, 8, 8, 256)
    w1q = torch.zeros(9, 256, 256, dtype=torch.int8)
    w2q = torch.zeros(256, 64, dtype=torch.int8)
    s, b = torch.ones(256), torch.zeros(256)
    s2, b2 = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="c_chunk"):
        tb8.fused_block_int8_kchunked(x, w1q, s, b, w2q, s2, b2, k_rows=4,
                                      c_chunk=96)


# --------------------------------------------------------------------- K6


@pytest.mark.parametrize("c,cout,h,w", [
    (128, 64, 16, 24),     # tests/test_convblock_kernel.py's shape
    (128, 128, 8, 40),     # Cout = Cmid
    (256, 64, 4, 20),      # two 128-channel blocks of hidden channels
])
def test_block128_plain_matches(rng, c, cout, h, w):
    """K6 ≡ the reference at float32, where its interpret mode and the TPU
    semantics agree (rtol/atol 2e-4, the reference's tolerance)."""
    params = _convblock_params(rng, c, c, cout)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    k = jc128.pick_k_rows_128(h, w, c, cout)
    assert k is not None
    want = np.asarray(jc128.fused_block128_nhwc(
        jnp.asarray(x), *jc128.pack_block128_params(params, dtype=jnp.float32),
        k_rows=k, interpret=True))
    got = tc128.fused_block128_nhwc(
        _t(x), *tc128.pack_block128_params(params, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_block128_rounds_hidden_to_bf16(rng):
    """The plain twin keeps the TPU semantics: bf16 input rounds h to bf16
    (the reference's interpret mode would compute in float32)."""
    params = _convblock_params(rng, 128, 128, 64)
    x = _t(rng.standard_normal((1, 4, 8, 128)).astype(np.float32))
    ops = tc128.pack_block128_params(params, dtype=torch.bfloat16)
    got = tc128.fused_block128_nhwc(x.bfloat16(), *ops)
    assert got.dtype == torch.bfloat16
    w1, b1, w2, b2 = ops
    hid = torch.nn.functional.conv2d(
        x.bfloat16().float().permute(0, 3, 1, 2),
        w1.float().reshape(3, 3, 128, 128).permute(3, 2, 0, 1), padding=1)
    hid = torch.nn.functional.leaky_relu(hid + b1[:, None, None], 0.2)
    out = torch.einsum("nmhw,mo->nhwo", hid.bfloat16().float(), w2.float())
    want = torch.nn.functional.leaky_relu(out + b2, 0.2).bfloat16()
    assert torch.equal(got, want)


def test_block128_pack_matches(rng):
    params = _convblock_params(rng, 128, 128, 64)
    for got, want in zip(tc128.pack_block128_params(params, dtype=torch.float32),
                         jc128.pack_block128_params(params, dtype=jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block128_wrapper_validates():
    w1 = torch.zeros(9, 128, 128)
    with pytest.raises(ValueError, match="C % 128"):
        tc128.fused_block128_nhwc(torch.zeros(1, 4, 4, 64), w1, torch.zeros(128),
                                  torch.zeros(128, 64), torch.zeros(64))
    with pytest.raises(ValueError, match="Cout"):
        tc128.fused_block128_nhwc(torch.zeros(1, 4, 4, 128), w1, torch.zeros(128),
                                  torch.zeros(128, 256), torch.zeros(256))



def test_block128_cpu_takes_any_c(rng):
    """The CPU's plain version keeps the reference's contract (any
    ``C % 128 == 0``); only the card kernels stop at ``MAX_C``."""
    c = tc128.MAX_C + 128
    x = _t(rng.standard_normal((1, 2, 4, c)).astype(np.float32))
    out = tc128.fused_block128_nhwc(x, torch.zeros(9, c, c), torch.zeros(c),
                                    torch.zeros(c, 64), torch.zeros(64))
    assert tuple(out.shape) == (1, 2, 4, 64)


def _in_storage(x: torch.Tensor, storage: str) -> torch.Tensor:
    if storage == "nhwc":
        return x.contiguous()
    if storage == "strided":                  # neither layout: a W slice
        wide = torch.cat([x, x], dim=2).contiguous()
        return wide[:, :, :x.shape[2]]
    nchw = x.permute(0, 3, 1, 2)
    if storage == "cmajor":                   # the main path's NHWC view
        return nchw.contiguous().permute(0, 2, 3, 1)
    buf = torch.empty(nchw.numel() + 8, dtype=x.dtype)   # 2 bytes off 16
    view = buf[1:1 + nchw.numel()].view(nchw.shape)
    view.copy_(nchw)
    return view.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype,storage,w,cout,mode,in_place,kernel", [
    (torch.bfloat16, "cmajor", 24, 64, tc128.CMAJOR_VEC, True, tc128.TC_KERNEL),
    (torch.bfloat16, "cmajor", 20, 64, tc128.CMAJOR_SCALAR, True,   # W % 8 != 0
     tc128.TC_KERNEL),
    (torch.bfloat16, "cmajor_unaligned", 24, 64, tc128.CMAJOR_SCALAR, True,
     tc128.TC_KERNEL),
    (torch.bfloat16, "nhwc", 20, 64, tc128.NHWC, True, tc128.WGMMA_KERNEL),
    (torch.bfloat16, "nhwc", 20, 68, tc128.NHWC, True,              # Cout % 8 != 0
     tc128.TC_KERNEL),
    (torch.bfloat16, "strided", 24, 64, tc128.NHWC, False,          # one copy
     tc128.WGMMA_KERNEL),
    (torch.float32, "cmajor", 24, 64, tc128.NHWC, False, None),     # CUDA cores
    (torch.float32, "nhwc", 24, 64, tc128.NHWC, True, None),
])
def test_block128_storage_decision(rng, monkeypatch, dtype, storage, w, cout, mode,
                                   in_place, kernel):
    """Which storage reaches which card kernel and in which order its output
    comes back, with a stub in place of the C entries: bf16 channels-last
    storage (in place, or the copy of storage no stage reads) goes to the
    wgmma kernel where Cout % 8 == 0 and answers channels-last; the
    mma.sync kernel reads an NHWC view of channels-major storage in place
    and answers channels-major; float32 goes channels-last.  Only the wgmma
    kernel's calls count in ``wgmma_launches``."""
    seen = []
    monkeypatch.setattr(tc128._build, "call", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(tc128.fused_block128_nhwc, "wgmma_launches", 0)
    n, h, c = 2, 3, 128
    x = _in_storage(_t(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(dtype),
                    storage)
    out = tc128._launch(x, torch.zeros(9, c, c, dtype=dtype), torch.zeros(c),
                        torch.zeros(c, cout, dtype=dtype), torch.zeros(cout), 0.2,
                        None)
    (name, a), = seen
    assert (a[0] == x.data_ptr()) == in_place and a[5] == out.data_ptr()
    if kernel == tc128.WGMMA_KERNEL:
        assert name == "pcss_block128_wgmma"
        assert a[6:10] == (n, cout, h, w) and a[10] == pytest.approx(0.2)
    else:
        assert name == "pcss_block128_nhwc"
        assert a[12] == int(dtype == torch.bfloat16) and a[13] == mode
        assert a[6:11] == (n, c, cout, h, w)
    assert tc128.fused_block128_nhwc.wgmma_launches == int(kernel == tc128.WGMMA_KERNEL)
    assert tuple(out.shape) == (n, h, w, cout) and out.dtype == dtype
    assert out.permute(0, 3, 1, 2).is_contiguous() == (mode != tc128.NHWC)
    assert out.is_contiguous() == (mode == tc128.NHWC)


def _strides(storage: str, shape) -> tuple[tuple, int]:
    """Strides (elements) and start modulo 16 bytes of x [N, H, W, C] bf16 in
    a storage: dense channels-last, aligned or 2 bytes off; the NHWC view of
    dense NCHW, aligned or off; a W slice of a twice-wider channels-last
    tensor (neither layout)."""
    n, h, w, c = shape
    nhwc, cmajor = (h * w * c, w * c, c, 1), (c * h * w, w, 1, h * w)
    return {"nhwc": (nhwc, 0), "nhwc_unaligned": (nhwc, 2),
            "cmajor": (cmajor, 0), "cmajor_unaligned": (cmajor, 2),
            "strided": ((h * 2 * w * c, 2 * w * c, c, 1), 0)}[storage]


@pytest.mark.parametrize("c", [128, 256, 384])
@pytest.mark.parametrize("storage,w,cout,mode,on_wgmma", [
    ("nhwc", 24, 64, tc128.NHWC, True),
    ("nhwc", 20, 128, tc128.NHWC, True),
    ("nhwc", 24, 68, tc128.NHWC, False),          # Cout % 8 != 0
    ("nhwc_unaligned", 24, 64, None, True),       # the copy is channels-last
    ("strided", 24, 64, None, True),
    ("cmajor", 24, 64, tc128.CMAJOR_VEC, False),
    ("cmajor", 20, 64, tc128.CMAJOR_SCALAR, False),
    ("cmajor_unaligned", 24, 64, tc128.CMAJOR_SCALAR, False),
])
def test_block128_bf16_kernel_pick(c, storage, w, cout, mode, on_wgmma):
    """The bf16 kernel K6 takes, a pure function of x's shape, strides and
    alignment: the wgmma kernel for channels-last storage (in place, or as
    the copy of storage no stage reads) at C = 128 with Cout % 8 == 0, the
    mma.sync kernel for channels-major storage, C of 256 or 384 and any other
    Cout."""
    shape = (2, 3, w, c)
    strides, offset = _strides(storage, shape)
    assert _build.stage_mode(shape, strides, offset) == mode
    want = tc128.WGMMA_KERNEL if on_wgmma and c == 128 else tc128.TC_KERNEL
    assert tc128.bf16_kernel(shape, strides, offset, cout) == want


@pytest.mark.parametrize("c,cout,match", [
    (512, 64, "C ≤ 384"),       # the hidden tile would not fit
    (640, 640, "C ≤ 384"),
    (128, 66, "Cout % 4"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block128_card_limits(monkeypatch, c, cout, match, dtype):
    monkeypatch.setattr(tc128._build, "call", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match=match):
        tc128._launch(torch.zeros(1, 2, 8, c, dtype=dtype),
                      torch.zeros(9, c, c, dtype=dtype), torch.zeros(c),
                      torch.zeros(c, cout, dtype=dtype), torch.zeros(cout), 0.2, None)


@pytest.mark.parametrize("c,kc", [(128, 128), (256, 64), (384, 64)])
@pytest.mark.parametrize("cout", [64, 128, "c"])
def test_block128_smem_plan_fits(c, kc, cout):
    """The bf16 kernel's shared-memory plan fits one H100 block (232,448
    bytes) at every C the card takes, with the input chunk the source
    documents; one more 128 channels would not fit at Cout = C."""
    cout = c if cout == "c" else cout
    assert tc128.smem_plan(c, cout)[0] == kc
    assert tc128.smem_plan(c, cout)[1] <= 232_448
    wider = tc128.MAX_C + 128
    assert tc128.smem_plan(wider, wider)[1] > 232_448


def test_block128_smem_plan_mirrors_source():
    """``smem_plan`` mirrors ``csrc/convblock128.cu``: the same limits and
    tile constants, and the w64 dec_2 plan the source header states; the
    storage modes mirror ``csrc/bf16_mma.cuh``'s enum Stage."""
    import re
    from pathlib import Path

    csrc = Path(tc128.__file__).resolve().parents[2] / "csrc"
    src = (csrc / "convblock128.cu").read_text()
    stages = (csrc / "bf16_mma.cuh").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["MAX_SMEM"] == tc128._MAX_SMEM and const["MAX_C"] == tc128.MAX_C
    assert (const["TW"], const["MB"]) == (128, 128)
    assert "OS = TW + 4" in src and "p.hs = c + 8" in src and "p.cs = p.kc + 8" in src
    assert ("enum Stage { kNhwc = %d, kCmajorVec = %d, kCmajorScalar = %d };"
            % (tc128.NHWC, tc128.CMAJOR_VEC, tc128.CMAJOR_SCALAR)) in stages
    assert tc128.smem_plan(128, 64) == (128, 210_528)
    assert "210,528 bytes at C = 128" in src


@pytest.mark.parametrize("c,cout", [(128, 64), (256, 200), (384, 384)])
def test_block128_packed_slices(rng, c, cout):
    """The bf16 kernel's weight slices, taken in its order (w1: hidden
    block, input chunk, tap; then w2: output block, hidden chunk) as
    row-major [rows][kc] B operands, rebuild the block: the GEMM sequence of
    the kernel on the packed operands ≡ the plain version (float32 sums of
    bf16 values; 1e-5 relative, sum order)."""
    kc = tc128.smem_plan(c, cout)[0]
    n, h, w = 1, 3, 10
    x = _t(rng.standard_normal((n, h, w, c)).astype(np.float32)).bfloat16()
    w1 = _t(rng.standard_normal((9, c, c)).astype(np.float32) * 0.05).bfloat16()
    w2 = _t(rng.standard_normal((c, cout)).astype(np.float32) * 0.1).bfloat16()
    b1 = _t(rng.standard_normal(c).astype(np.float32) * 0.1)
    b2 = _t(rng.standard_normal(cout).astype(np.float32) * 0.1)
    w1p, w2p = tc128.pack_tc_weights(w1, w2, kc)
    op = -(-cout // 16) * 16
    assert tuple(w1p.shape) == (c // 128, c // kc, 9, 128, kc)
    assert tuple(w2p.shape) == (c // kc, op, kc) and not w2p[:, cout:].any()
    flat1, flat2 = w1p.float().reshape(-1), w2p.float().reshape(-1)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))   # SAME
    hid = torch.zeros(n, h, w, c)
    for s in range((c // 128) * (c // kc) * 9):
        mb, kb, t = s // ((c // kc) * 9), (s // 9) % (c // kc), s % 9
        sl = flat1[s * 128 * kc:(s + 1) * 128 * kc].reshape(128, kc)
        a = xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w, kb * kc:(kb + 1) * kc]
        hid[..., mb * 128:(mb + 1) * 128] += a @ sl.T
    hid = hid + b1
    hid = torch.where(hid >= 0, hid, hid * 0.2).bfloat16().float()
    out = torch.zeros(n, h, w, op)
    for ob in range(-(-cout // 128)):
        rows = min(128, op - ob * 128)
        for kb in range(c // kc):
            base = (kb * op + ob * 128) * kc
            sl = flat2[base:base + rows * kc].reshape(rows, kc)
            out[..., ob * 128:ob * 128 + rows] += hid[..., kb * kc:(kb + 1) * kc] @ sl.T
    out = out[..., :cout] + b2
    got = torch.where(out >= 0, out, out * 0.2)
    want = tc128.block128_nhwc_plain(x, w1, b1, w2, b2).float()
    # the plain version rounds the output to bf16; hold the unrounded sum to
    # it within one bf16 rounding plus sum-order flips of the hidden rounding
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2e-2 * scale


def _operand(buf: torch.Tensor, start: int, lbo: int, sbo: int, rows: int) -> torch.Tensor:
    """The [rows][16] bf16 operand a wgmma shared-memory descriptor without
    swizzle reads from ``buf`` (a flat bf16 buffer; offsets in bytes): 8-row x
    16-byte core matrices, rows 16 bytes apart inside one, ``sbo`` bytes
    between 8-row blocks, ``lbo`` bytes between the two 8-element K halves."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    byte = start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return buf[byte // 2].float()


@pytest.mark.parametrize("cout", [64, 128])
def test_block128_wgmma_packing(rng, cout):
    """The wgmma kernel's packed weights, read through the descriptors it
    builds, stage by stage in its order (12 stages of one dy row of a
    32-channel slice, three dx taps each, then W2) from shared memory laid
    out as its TMA and bulk copies fill it, rebuild the block: the emulated
    GEMMs ≡ the plain version on random weights (float32 sums of bf16
    values; within one bf16 rounding of the output)."""
    src = (tc128._build.CSRC / "convblock128_wgmma.cu").read_text()
    tp, kc, xps, c = tc128.WG_TP, tc128.WG_KC, tc128.WG_XPS, 128
    kg, ng, ostr = kc // 8, c // 8, 128 + 8
    n, h, w = 1, 2, 250                                  # two tiles, the second ragged
    x = _t(rng.standard_normal((n, h, w, c)).astype(np.float32)).bfloat16()
    w1 = _t(rng.standard_normal((9, c, c)).astype(np.float32) * 0.05).bfloat16()
    w2 = _t(rng.standard_normal((c, cout)).astype(np.float32) * 0.1).bfloat16()
    b1 = _t(rng.standard_normal(c).astype(np.float32) * 0.1)
    b2 = _t(rng.standard_normal(cout).astype(np.float32) * 0.1)
    w1p, w2p = tc128.pack_wgmma_weights(w1, w2)
    op = w2p.shape[1]
    assert tuple(w1p.shape) == (c // kc, 3, 3, kg, c, 8) and op == -(-cout // 64) * 64
    assert tuple(w2p.shape) == (ng, op, 8) and not w2p[:, cout:].any()
    stages1 = w1p.reshape(-1, 3 * kg * c * 8)           # stage g's bytes at g * WS_BYTES
    assert "bulk_copy_multicast(st + rank * half, w1b + (size_t)g * WS_BYTES" in src
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 2 * tp - w + 1, 1, 1)).bfloat16()
    got = torch.zeros(n, h, w, cout)
    for row in range(h):
        for col0 in range(0, w, tp):
            hid = torch.zeros(c, tp)                     # [hidden][pixel], as the accumulators
            for g in range(stages1.shape[0]):
                dy, c0 = g % 3, g // 3 * kc
                ws = stages1[g]
                # the TMA box of each channel group: columns col0 - 1 .. col0 + 240
                xs = torch.zeros(kg, xps, 8, dtype=torch.bfloat16)
                for k in range(kg):
                    xs[k, :tp + 2] = xp[0, row + dy, col0:col0 + tp + 2, c0 + 8 * k:c0 + 8 * k + 8]
                xs = xs.reshape(-1)
                for wg in range(2):
                    for dx in range(3):
                        for kk in range(kg // 2):
                            a = _operand(ws, ((dx * kg + 2 * kk) * c + 64 * wg) * 16, c * 16,
                                         128, 64)
                            b = _operand(xs, (2 * kk * xps + dx) * 16, xps * 16, 128, tp)
                            hid[64 * wg:64 * wg + 64] += a @ b.T
            hid = hid + b1[:, None]
            hid = torch.where(hid >= 0, hid, hid * 0.2).bfloat16()
            hs = hid.reshape(ng, 8, tp).permute(0, 2, 1).reshape(-1)   # [NG][TP][8]
            w2s = w2p.reshape(-1)
            acc = torch.zeros(op, tp)
            for wg in range(op // 64):
                for kk in range(ng // 2):
                    a = _operand(w2s, (2 * kk * op + 64 * wg) * 16, op * 16, 128, 64)
                    b = _operand(hs, 2 * kk * tp * 16, tp * 16, 128, tp)
                    acc[64 * wg:64 * wg + 64] += a @ b.T
            acc = acc[:cout] + b2[:, None]
            acc = torch.where(acc >= 0, acc, acc * 0.2)
            cols = min(tp, w - col0)
            got[0, row, col0:col0 + cols] = acc[:, :cols].T
    assert ostr * 2 % 16 == 0
    want = tc128.block128_nhwc_plain(x, w1, b1, w2, b2).float()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2e-2 * scale


def test_block128_wgmma_smem_plan_mirrors_source():
    """``wgmma_smem_plan`` and the tile constants mirror
    ``csrc/convblock128_wgmma.cu``, and the plan fits one H100 block (232,448
    bytes of shared memory)."""
    import re

    src = (tc128._build.CSRC / "convblock128_wgmma.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["C"], const["TP"], const["KC"], const["STAGES"], const["XPS"]) == (
        tc128.WG_C, tc128.WG_TP, tc128.WG_KC, tc128.WG_STAGES, tc128.WG_XPS)
    assert const["MAX_OP"] == 128 and const["NC"] == 256 and const["NP"] == 32
    for line in ("constexpr int XP = TP + 2;", "constexpr int KG = KC / 8;",
                 "constexpr int WS_BYTES = 3 * KG * C * 16;",
                 "constexpr int XS_BYTES = KG * XPS * 16;",
                 "constexpr int OSTR = MAX_OP + 8;",
                 "constexpr int HID_BYTES = TP * OSTR * 2;",
                 "constexpr int SMEM = STAGES * STAGE_BYTES + HID_BYTES + 2 * STAGES * 8 + 128;"):
        assert line in src, line
    assert tc128.wgmma_smem_plan() == 227_264 <= 232_448
    # every TMA destination 128-byte aligned: the stage, its weights, each group
    assert (tc128.WG_XPS * 16) % 128 == 0 and (3 * 4 * 128 * 16) % 128 == 0
    assert tc128.WG_XPS >= tc128.WG_TP + 2


# --------------------------------------------------------------------- K2′


@pytest.mark.parametrize("n,cin,cmid,cout,h,w,k", [
    (1, 16, 16, 64, 32, 48, 8),      # enc_0 shape class
    (1, 64, 64, 16, 24, 130, 8),     # dec_final class; W just over a lane tile
    (1, 16, 16, 32, 30, 96, 6),      # H not divisible by k → row padding
    (3, 16, 16, 32, 16, 32, 8),      # batched
    (1, 16, 16, 32, 30, 96, None),   # the reference's k_rows pick
])
def test_convblock_nhwc_plain_matches(rng, n, cin, cmid, cout, h, w, k):
    """The NHWC wrapper ≡ the reference's (rtol/atol 2e-4, float32)."""
    params = _convblock_params(rng, cin, cmid, cout)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    want = np.asarray(jcb.fused_conv_block_nhwc(
        jnp.asarray(x), *jcb.pack_convblock_params(params, dtype=jnp.float32),
        k_rows=k, interpret=True, stack_taps=True))
    got = tcb.fused_conv_block_nhwc(
        _t(x), *tcb.pack_convblock_params(params, dtype=torch.float32), k_rows=k)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    plain = tcb.conv_block_nhwc_plain(
        _t(x), *tcb.pack_convblock_params(params, dtype=torch.float32), k_rows=k)
    assert torch.equal(plain, got)


def _nhwc_of(nchw: torch.Tensor) -> torch.Tensor:
    return nchw.permute(0, 2, 3, 1)


# x [N, H, W, Cin] as each storage lays it out (smallest shapes, bf16 on the
# card), the stage _build.stage_mode picks (None: storage no stage reads) and
# whether K2′ reads it in place
def _zeros(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


_STORAGES = {
    "channels_last": (lambda: _zeros(2, 3, 8, 16), _build.NHWC, True),  # enc_0, dec_final
    "channels_major": (lambda: _nhwc_of(_zeros(2, 16, 3, 8)), _build.CMAJOR_VEC, True),  # enc_1
    "one_image": (lambda: _nhwc_of(_zeros(1, 16, 3, 8)), _build.CMAJOR_VEC, True),
    "channels_last_w_not_8": (lambda: _zeros(1, 3, 12, 16), _build.NHWC, True),
    "cmajor_w_not_8": (lambda: _nhwc_of(_zeros(1, 16, 3, 12)), _build.CMAJOR_SCALAR, False),
    "cmajor_unaligned": (lambda: _nhwc_of(_zeros(1 + 16 * 3 * 8)[1:].view(1, 16, 3, 8)),
                         _build.CMAJOR_SCALAR, False),
    "cin_not_8": (lambda: _zeros(1, 3, 8, 12), None, False),
    "unaligned_start": (lambda: _zeros(1 + 3 * 8 * 16)[1:].view(1, 3, 8, 16), None, False),
    "channels_last_c_slice": (lambda: _zeros(1, 3, 8, 24)[..., 8:], None, False),
    "cmajor_w_slice": (lambda: _nhwc_of(_zeros(1, 16, 3, 24)[..., 8:]), None, False),
    "w_every_other": (lambda: _zeros(1, 3, 16, 16)[:, :, ::2], None, False),
}


@pytest.mark.parametrize("storage", list(_STORAGES))
def test_convblock_nhwc_stage_pick(rng, storage):
    """The stage is a pure function of x's shape, strides and start (in
    elements here: the CPU's own start is not the card's); K2′ reads only
    ``NHWC`` and ``CMAJOR_VEC`` in place and copies the rest; and the CPU's
    plain route is the padded route it always was: no launch, no copy
    counted, ≡ the plain version."""
    make, want, in_place = _STORAGES[storage]
    x = make()
    offset = x.storage_offset() * x.element_size()
    assert _build.stage_mode(tuple(x.shape), x.stride(), offset) == want
    assert (tcb.stage_of(x) != "copy") == in_place
    if in_place:
        assert tcb.stage_of(x) == _build.STAGES[want]
    assert tcb.stage_of(x.float()) == "copy"
    x = x.float()
    x.copy_(torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)))
    cin = x.shape[3]
    w = tcb.pack_convblock_params(_convblock_params(rng, cin, 8, 4), dtype=torch.float32)
    counts = (tcb.fused_conv_block_nhwc.launches, tcb.fused_conv_block_nhwc.copies,
              tcb.fused_conv_block_chw.launches)
    got = tcb.fused_conv_block_nhwc(x, *w)
    assert (tcb.fused_conv_block_nhwc.launches, tcb.fused_conv_block_nhwc.copies,
            tcb.fused_conv_block_chw.launches) == counts
    assert torch.equal(got, tcb.conv_block_nhwc_plain(x.contiguous(), *w))
    assert torch.equal(got, tcb.copy_route(x, *w))


def test_pick_k_rows_equal_over_grid():
    for cin, cmid, cout in ((16, 16, 64), (64, 64, 128), (16, 16, 16),
                            (128, 128, 64), (64, 64, 16)):
        for wp in (128, 256, 512, 1024, 2048):
            for itemsize in (2, 4):
                for acc_shift in (False, True):
                    for res in (False, True):
                        args = (cin, cmid, cout, wp, itemsize, acc_shift, res)
                        assert tcb._pick_k_rows(*args) == jcb._pick_k_rows(*args), args


# --------------------------------------------------------------------- K7


def _k7_operands(rng, n, h, w, c, co):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    k = rng.integers(-127, 127, (3, 3, c, co)).astype(np.int8)
    ws = rng.random(co).astype(np.float32) * 1e-2
    bias = rng.standard_normal(co).astype(np.float32) * 0.1
    return x, k.reshape(9, c, co), ws, bias


@pytest.mark.parametrize("n,h,w,c,co,slope", [
    (1, 8, 16, 128, 256, 0.2),     # tests/test_int8.py's shape
    (1, 8, 16, 128, 256, None),    # no activation
    (2, 12, 8, 256, 128, 0.2),     # batched, three bands of 4
])
def test_conv3x3_int8_plain_matches(rng, n, h, w, c, co, slope):
    """The single int8 conv ≡ the reference kernel (rtol 1e-5 / atol 1e-4,
    the reference's own tolerance), float32 out."""
    x, k, ws, bias = _k7_operands(rng, n, h, w, c, co)
    k_rows, co_tile = tc7.pick_tiles(h, w, c, co)
    want = np.asarray(jc7.conv3x3_int8_nhwc(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(ws), jnp.asarray(bias),
        k_rows=k_rows, co_tile=co_tile, negative_slope=slope,
        out_dtype=jnp.float32, interpret=True))
    got = tc7.conv3x3_int8_nhwc(_t(x), _t(k), _t(ws), _t(bias), k_rows=k_rows,
                                co_tile=co_tile, negative_slope=slope,
                                out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_conv3x3_int8_bf16_out(rng):
    """bf16 output is the float32 result rounded once."""
    x, k, ws, bias = _k7_operands(rng, 1, 8, 16, 128, 128)
    kw = dict(k_rows=4, co_tile=128, negative_slope=0.2)
    f32 = tc7.conv3x3_int8_nhwc(_t(x), _t(k), _t(ws), _t(bias),
                                out_dtype=torch.float32, **kw)
    bf = tc7.conv3x3_int8_nhwc(_t(x), _t(k), _t(ws), _t(bias), **kw)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, f32.bfloat16())


def test_conv3x3_int8_validates():
    x = torch.zeros(1, 8, 8, 128)
    k = torch.zeros(9, 128, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match="co_tile"):
        tc7.conv3x3_int8_nhwc(x, k, torch.ones(256), torch.zeros(256),
                              k_rows=4, co_tile=96)


# ---------------------------------------------------------------- pickers


def test_slice2_pickers_equal_over_grid():
    """pick_k_rows_128 and pick_tiles ≡ the reference's over a grid."""
    for h in (6, 8, 12, 30, 64, 136, 272):
        for w in (8, 20, 24, 48, 240, 480):
            for c in (64, 128, 256, 512, 1024):
                for co in (32, 64, 128, 256, 512):
                    args = (h, w, c, co)
                    assert (tc128.pick_k_rows_128(*args)
                            == jc128.pick_k_rows_128(*args)), args
                    assert tc7.pick_tiles(*args) == jc7.pick_tiles(*args), args


@pytest.mark.parametrize("h,w,c,co", _PICKER_SHAPES + [(272, 480, 128, 64)])
def test_slice2_pickers_at_model_stages(h, w, c, co):
    assert tc128.pick_k_rows_128(h, w, c, co) == jc128.pick_k_rows_128(h, w, c, co)
    assert tc7.pick_tiles(h, w, c, co) == jc7.pick_tiles(h, w, c, co)
