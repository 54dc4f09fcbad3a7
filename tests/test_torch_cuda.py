"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 with TF32 off, sum-order noise (1e-4 relative); bf16
outputs, one bf16 rounding plus flips of the hidden tile's bf16 rounding
(2e-2 relative).  The int8 kernels (K3, K5, K7) and the uint8 mask are held
exactly: int8 sums are exact in any order and the kernels take every float32
step as their plain versions do.
"""

import math
import os

import numpy as np
import pytest
import torch

from pcss_unet_tpu_torch.ops.kernels import _build
from pcss_unet_tpu_torch.ops.kernels import block_int8 as kb8
from pcss_unet_tpu_torch.ops.kernels import conv3x3_int8 as kc7
from pcss_unet_tpu_torch.ops.kernels import convblock as kcb
from pcss_unet_tpu_torch.ops.kernels import convblock128 as kc128
from pcss_unet_tpu_torch.ops.kernels import fused as kfu
from pcss_unet_tpu_torch.ops.kernels import resize as kres

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _close(got, want, rel):
    scale = max(1.0, want.float().abs().max().item())
    d = (got.float() - want.float()).abs().max().item()
    assert d <= rel * scale, (d, rel * scale)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_scrub_standardize_kernel(dev, gen, out_dtype):
    x = gen.standard_normal((2, 6, 37, 4)).astype(np.float32)  # ragged tail
    x.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    x = torch.from_numpy(x).to(dev)
    m = torch.tensor([0.5, -0.5, 1.0, 0.0], device=dev)
    s = torch.tensor([2.0, 1.0, 0.5, 3.0], device=dev)
    before = kfu.fused_scrub_standardize.launches
    got = kfu.fused_scrub_standardize(x, m, s, out_dtype=out_dtype)
    assert kfu.fused_scrub_standardize.launches == before + 1
    want = kfu.scrub_standardize_plain(x, m, s, out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", [None, "nhwc", "chw"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,shape", [
    ("aligned", (2, 6, 36, 4)),        # H/2 = 3 odd, W = 36 not a multiple of 8
    ("offset", (1, 10, 20, 4)),        # base 4 bytes off 16: element by element
    ("c3", (2, 6, 36, 3)),             # C != 4: the general path
    ("w64_row", (1, 4, 1920, 4)),      # the w64 frame's width: W/2 = 960, Wp 1024
])
def test_scrub_standardize_entry_kernel(dev, gen, entry, out_dtype, case, shape):
    """K1 in every layout ≡ its plain version exactly, pad columns included,
    one launch each."""
    x = (gen.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[[0, 5, 9, 14]] = [np.nan, np.inf, -np.inf, -0.0]
    xt = torch.from_numpy(x).to(dev)
    if case == "offset":
        buf = torch.empty(xt.numel() + 1, device=dev)
        xt = buf[1:].view(xt.shape)
        xt.copy_(torch.from_numpy(x).to(dev))
        assert xt.data_ptr() % 16 == 4
    c = shape[3]
    m = torch.from_numpy(gen.standard_normal(c).astype(np.float32)).to(dev)
    s = torch.from_numpy((gen.random(c) + 0.1).astype(np.float32)).to(dev)
    before = kfu.fused_scrub_standardize.launches
    got = kfu.fused_scrub_standardize(xt, m, s, out_dtype=out_dtype, entry=entry)
    assert kfu.fused_scrub_standardize.launches == before + 1
    want = kfu.scrub_standardize_plain(xt, m, s, out_dtype, entry=entry)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset,n", [(0, 16 * 40 + 5), (1, 16 * 40 + 5), (4, 16 * 40 + 5),
                                      (0, 7), (0, 1088 * 1920)])
def test_mask_to_u8_kernel_tail_and_offset(dev, gen, offset, n):
    """K4 ≡ its plain version exactly at counts not divisible by 16, on a
    view 4 bytes off 16 (element by element) and 16 bytes off (vector
    path), and at the w64 frame's size; one launch each."""
    x = (gen.random(n) * 1.4 - 0.2).astype(np.float32)
    x[:4] = [np.nan, np.inf, -np.inf, -0.0][:min(4, n)]
    buf = torch.zeros(offset + n, device=dev)
    xt = buf[offset:].view(1, 1, n, 1)
    xt.copy_(torch.from_numpy(x).to(dev).view(1, 1, n, 1))
    before = kfu.fused_mask_to_u8.launches
    got = kfu.fused_mask_to_u8(xt)
    assert kfu.fused_mask_to_u8.launches == before + 1
    assert torch.equal(got, kfu.mask_to_u8_plain(xt))


def test_mask_to_u8_kernel(dev, gen):
    x = (gen.random((1, 6, 51, 1)) * 1.4 - 0.2).astype(np.float32)  # 306 ≥ 4 + 255
    ks = np.arange(255)
    ties = ((ks + 0.5) / 255).astype(np.float32)
    flat = x.reshape(-1)
    flat[:4] = [np.nan, np.inf, -np.inf, -0.0]
    flat[4:4 + len(ties)] = ties
    xt = torch.from_numpy(x).to(dev)
    got = kfu.fused_mask_to_u8(xt)
    assert torch.equal(got, kfu.mask_to_u8_plain(xt))
    assert got.reshape(-1)[0].item() == 0


def _conv_operands(gen, dev, cin, cmid, cout, n, h, w, dtype):
    wp = (w // 128 + 1) * 128
    x = np.zeros((n, cin, h, wp), np.float32)
    x[..., :w] = gen.standard_normal((n, cin, h, w))
    res = np.zeros((n, cout, h, wp), np.float32)
    res[..., :w] = gen.standard_normal((n, cout, h, w))
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, cin, cmid)) * 0.2,
                   "bias": gen.standard_normal(cmid) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, cmid, cout)) * 0.2,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    ws = kcb.pack_convblock_params(params, dtype=dtype, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return t(x), ws, t(res), w


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("cin,cmid,cout,n,h,w", [
    (16, 16, 64, 1, 32, 48),
    (64, 64, 16, 2, 24, 130),
    (128, 128, 32, 1, 30, 200),
    (32, 32, 128, 1, 9, 127),
    # the rest of the main path's Cin→Cmid→Cout triples
    (64, 64, 128, 1, 8, 40),
    (128, 128, 64, 1, 6, 130),
    (16, 16, 16, 1, 12, 64),
    (16, 16, 32, 1, 8, 100),
    (32, 32, 16, 1, 7, 90),
    # padding edges: channels not multiples of 16 (or of 8), one row,
    # W = 127 (Wp 128) and W = 128 (Wp 256), a batch of two
    (20, 12, 4, 1, 5, 60),
    (24, 20, 8, 2, 4, 33),
    (16, 16, 16, 1, 1, 127),
    (64, 64, 16, 1, 1, 128),
    (20, 12, 4, 2, 3, 128),
])
def test_convblock_kernel(dev, gen, dtype, rel, cin, cmid, cout, n, h, w):
    x, ws, res, w = _conv_operands(gen, dev, cin, cmid, cout, n, h, w, dtype)
    for kw in (dict(), dict(true_w=w), dict(true_w=w, residual=res)):
        before = kcb.fused_conv_block_chw.launches
        got = kcb.fused_conv_block_chw(x, *ws, taps="acc_shift", **kw)
        assert kcb.fused_conv_block_chw.launches == before + 1
        want = kcb.conv_block_chw_plain(x, *ws, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
        _close(got, want, rel)
        if "true_w" in kw:
            assert torch.all(got[..., w:] == 0)


def test_convblock_kernel_refuses_wide_channels(dev):
    x = torch.zeros(1, 256, 8, 128, device=dev)
    w1 = torch.zeros(9, 16, 256, device=dev)
    w2 = torch.zeros(16, 16, device=dev)
    b = torch.zeros(16, 1, device=dev)
    with pytest.raises(ValueError, match="<= 128"):
        kcb.fused_conv_block_chw(x, w1, b, w2, b)
    with pytest.raises(ValueError, match="operand on cpu"):
        kcb.fused_conv_block_chw(x[:, :16], w1[..., :16].cpu(), b, w2, b)


def test_launch_error_raises(dev):
    """A C entry point's CUDA error surfaces as a RuntimeError."""
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.call("pcss_convblock_chw", None, None, None, None, None, None,
                    None, 1, 256, 16, 16, 8, 128, 128, 0.2, 1,
                    kcb.CMAJOR_VEC, 8, 128, torch.cuda.current_stream().cuda_stream)


def test_band_resize_launch_error_raises(dev):
    """The banded resize's C entry refuses a band wider than 4 with a CUDA
    error, which surfaces as a RuntimeError."""
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.call("pcss_band_resize", None, None, None, None, 1, 8, 16, 8,
                    9, 1, kres.VECTOR, torch.cuda.current_stream().cuda_stream)


# ------------------------------------------------------------ banded resize
# the w64 1088x1920 frame's eight resize calls: (input shape, axis, matrix)
W64_RESIZES = {
    "dec0_h": ((1, 1024, 68, 120), 2, ("up", 68)),
    "dec0_w": ((1, 1024, 136, 120), 3, ("up", 120)),
    "dec1_h": ((1, 512, 136, 240), 2, ("up", 136)),
    "dec1_w": ((1, 512, 272, 240), 3, ("up", 240)),
    "dec2_h": ((1, 128, 272, 480), 2, ("up", 272)),
    "dec2_w": ((1, 128, 544, 480), 3, ("up", 480)),
    "head_h": ((1, 64, 544, 960), 2, ("chain", 544)),
    "head_w": ((1, 64, 544, 960), 3, ("chain", 960)),
}


def _w64_matrix(kind, n):
    """(build, args) of the call's matrix, as the forward asks ``matrix_on``."""
    from pcss_unet_tpu_torch.ops.resize import interp_matrix, resize_chain

    return (interp_matrix, (n, 2 * n)) if kind == "up" else (resize_chain,
                                                             ((n, 2 * n, n),))


def _ulp_at(mag, dtype):
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    e = torch.floor(torch.log2(mag.float().abs().clamp(min=torch.finfo(dtype).tiny)))
    return torch.exp2(e - mant)


def _within_ulp(got, want, x, m, axis, ulps=1):
    """|got − want| within ``ulps`` ulp of the dtype at the sum's magnitude
    Σ|m||x| (at float32, that many per addition: band width − 1), as two
    orders of one float32 sum may differ → the share of elements that
    differ."""
    from pcss_unet_tpu_torch.ops.resize import apply_matrix_dense

    mr = np.abs(torch.as_tensor(m).to(x.dtype).float().numpy())
    mag = apply_matrix_dense(x.detach().abs().float(), mr, axis)
    adds = kres.band_tables(m, x.dtype)[1].shape[1] - 1
    tol = ulps * _ulp_at(mag, x.dtype) * (max(adds, 1) if x.dtype == torch.float32 else 1)
    d = (got.float() - want.float()).abs()
    assert torch.all(d <= tol), (d / tol).max().item()
    return (d > 0).float().mean().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("call", sorted(W64_RESIZES))
def test_banded_resize_kernel_w64_shapes(dev, gen, call, dtype, layout):
    """apply_matrix on the card (the banded kernel) against the dense
    product, at each of the w64 frame's eight resize shapes: the forward,
    and the Function's gradient against autograd through the dense product,
    each within one ulp of the dtype; the kernel's output and gradient keep
    the input's layout, and equal the plain banded version bit for bit."""
    from pcss_unet_tpu_torch.ops import resize as tres

    shape, axis, (kind, n) = W64_RESIZES[call]
    build, args = _w64_matrix(kind, n)
    m = build(*args)
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    x = torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(
        dev, dtype).contiguous(memory_format=fmt)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = kres.banded_resize.launches
    got = tres.apply_matrix(xa, tres.matrix_on(dev, build, *args), axis)
    assert kres.banded_resize.launches - before == 1
    want = tres.apply_matrix_dense(xb, m, axis)
    assert got.is_contiguous(memory_format=fmt)
    share = _within_ulp(got, want, x, m, axis)
    fwd = kres.bands_on(m, dtype, dev)
    assert torch.equal(got, kres.banded_resize_plain(x, fwd, axis))
    g = torch.from_numpy(gen.standard_normal(want.shape).astype(np.float32)).to(
        dev, dtype).contiguous(memory_format=fmt)
    (ga,) = torch.autograd.grad(got, xa, g)
    (gb,) = torch.autograd.grad(want, xb, g)
    assert kres.banded_resize.launches - before == 2
    assert ga.is_contiguous(memory_format=fmt)
    share_g = _within_ulp(ga, gb, g, m.T, axis)
    print(f"{call} {dtype} {layout}: differ {share:.4f} forward, {share_g:.4f} gradient")


# beyond the w64 frame: (matrix, input shape, axis) with rows-mode tiles
# that end inside a lane's 8 outputs (l_out > 256, l_out % 8 != 0), rows
# that are not whole 16-byte packs, the head's chain on such a row, and the
# windows' and row shards' cut matrices (halo columns past the frame)
BAND_CASES = {
    "rows_up_250": (("interp_matrix", (250, 500)), (2, 8, 5, 250), 3),
    "rows_up_242": (("interp_matrix", (242, 484)), (2, 8, 5, 242), 3),
    "rows_up_121": (("interp_matrix", (121, 242)), (2, 8, 5, 121), 3),
    "rows_chain_250": (("resize_chain", ((250, 500, 250),)), (2, 8, 5, 250), 3),
    "rows_down_500": (("interp_matrix", (500, 250)), (1, 4, 3, 500), 3),
    "cols_window_up": (("_window_of", ("interp_matrix", (68, 136), (40, 96), (19, 49))),
                       (1, 16, 30, 40), 2),
    "cols_window_chain": (("_window_of", ("resize_chain", ((68, 136, 68),), (10, 40),
                                          (8, 42))), (1, 16, 34, 40), 2),
}


def _band_case_matrix(spec):
    from pcss_unet_tpu_torch.ops import resize as tres

    name, args = spec
    if name == "_window_of":
        inner, *rest = args
        args = (getattr(tres, inner), *rest)
    return getattr(tres, name), tuple(args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_banded_resize_kernel_partial_tiles_and_cut_matrices(dev, gen, case, dtype):
    """apply_matrix on the card at the shapes the w64 frame does not reach:
    the forward and the Function's gradient equal the plain banded version
    bit for bit (float64 too: float64 sums rounded to float32), and lie
    within one ulp of the dense product."""
    from pcss_unet_tpu_torch.ops import resize as tres

    spec, shape, axis = BAND_CASES[case]
    build, args = _band_case_matrix(spec)
    m = build(*args)
    x = torch.from_numpy(gen.standard_normal(shape)).to(dev, dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    mat = tres.matrix_on(dev, build, *args)
    got = tres.apply_matrix(xa, mat, axis)
    assert torch.equal(got, kres.banded_resize_plain(x, mat.bands(dtype), axis))
    want = tres.apply_matrix_dense(xb, m, axis)
    # float64 results are float32 values: held at float32's ulp
    t = torch.float32 if dtype == torch.float64 else dtype
    _within_ulp(got.to(t), want.to(t), x.to(t), m, axis)
    g = torch.from_numpy(gen.standard_normal(want.shape)).to(dev, dtype)
    (ga,) = torch.autograd.grad(got, xa, g)
    assert torch.equal(ga, kres.banded_resize_plain(g, mat.bands(dtype, True), axis))
    (gb,) = torch.autograd.grad(want, xb, g)
    # at float64 the dense backward rounds g to float32 on the way in, the
    # kernel its result on the way out: one ulp more (test_torch_ops.py's
    # _sum_tol)
    _within_ulp(ga.to(t), gb.to(t), g.to(t), m.T, axis,
                ulps=2 if dtype == torch.float64 else 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_banded_resize_kernel_unaligned_base(dev, gen, dtype):
    """x one element past a 16-byte boundary takes the one-value-a-thread
    mode along inner, and the rows mode its unaligned staging; both equal
    the plain version bit for bit."""
    from pcss_unet_tpu_torch.ops import resize as tres

    shape = (1, 6, 20, 40)
    buf = torch.empty(math.prod(shape) + 1, device=dev, dtype=dtype)
    x = buf[1:].view(shape)
    x.copy_(torch.from_numpy(gen.standard_normal(shape)).to(dev, dtype))
    assert kres.plan(x, 2, 40)[3] == kres.SCALAR
    for axis, n in ((2, 20), (3, 40)):
        mat = tres.matrix_on(dev, tres.interp_matrix, n, 2 * n)
        got = kres.banded_resize(x, mat.bands(dtype), axis)
        assert torch.equal(got, kres.banded_resize_plain(x, mat.bands(dtype), axis))


def test_banded_resize_kernel_nonfinite_stays_in_its_band(dev):
    """An Inf input reaches only the outputs whose band reads it (the dense
    product spreads NaN along the whole axis, 0·Inf)."""
    from pcss_unet_tpu_torch.ops import resize as tres

    x = torch.zeros(1, 2, 8, 16, device=dev, dtype=torch.bfloat16)
    x[0, 0, 3, 5] = float("inf")
    out = tres.apply_matrix(x, tres.matrix_on(dev, tres.interp_matrix, 8, 16), 2)
    bad = ~torch.isfinite(out.float())
    assert bad[0, 0, 5:9, 5].all() and bad.sum() == 4


def test_banded_resize_counts_for_one_w64_forward(dev, gen):
    """One w64 NHWC fused+int8 bf16 forward from its entered input (the
    render cells' posture) makes 8 banded-resize launches (a card has no
    other route for a resize)."""
    from pcss_unet_tpu_torch.infer import InferenceEngine
    from pcss_unet_tpu_torch.models.init import seeded_variables
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    engine = InferenceEngine(None, seeded_variables(), fold_bn=True,
                             quantize="int8", layout="nhwc",
                             dtype=torch.bfloat16, device="cuda")
    x = torch.from_numpy(gen.standard_normal((1, 544, 960, 16)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    with torch.inference_mode():
        engine.model.forward_entered(x)
        reset_launch_counts()
        out = engine.model.forward_entered(x)
    torch.cuda.synchronize()
    assert out.shape == (1, 1088, 1920, 1) and torch.isfinite(out).all()
    assert kres.banded_resize.launches == 8


def test_banded_resize_train_forward_and_backward_match_dense(dev, monkeypatch):
    """A float32 train forward and backward of a small UNet on the card
    through the banded kernel against the same with the kernel swapped for
    the dense product of the matrix its tables describe: the loss and every
    gradient agree to float32 sum-order noise, and the kernel ran on both
    passes."""
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.ops import resize as tres
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((2, 64, 96, 4)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.random((2, 64, 96, 1)).astype(np.float32)).to(dev)
        torch.manual_seed(0)
        model = UNet(encoder_widths=(16, 32, 64), dropout_rate=0.0).to(dev).train()
        dense_calls = []

        def dense(x, fwd, axis):
            dense_calls.append(axis)
            m = kres.dense_of(fwd.start.cpu().numpy(), fwd.weight.cpu().numpy(),
                              fwd.in_size)
            return tres.apply_matrix_dense(x, m, axis)

        class DenseResize:
            @staticmethod
            def apply(x, fwd, bwd, axis):
                return dense(x, fwd, axis)

        runs = {}
        for route in ("banded", "dense"):
            if route == "dense":
                monkeypatch.setattr(tres, "banded_resize", dense)
                monkeypatch.setattr(tres.kresize, "BandedResize", DenseResize)
            reset_launch_counts()
            out, _ = model.forward_train(x, {})
            loss = (out - y).abs().mean()
            grads = torch.autograd.grad(loss, list(model.parameters()))
            runs[route] = (loss.item(), grads, kres.banded_resize.launches)
        (lb, gb, nb), (ld, gd, nd) = runs["banded"], runs["dense"]
        dd = len(dense_calls)
        assert nd == 0 and dd > 0
        assert nb == 2 * dd      # each forward resize once more in backward
        assert abs(lb - ld) <= 1e-6 * abs(ld)
        # each leaf against max(its own size, the median leaf's): the conv
        # biases in front of a BatchNorm have a zero true gradient (noise)
        sizes = [b.abs().max().item() for b in gd]
        floor = float(np.median(sizes))
        for a, b, size in zip(gb, gd, sizes):
            assert (a - b).abs().max().item() <= 1e-4 * max(size, floor)
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,n,h,w", [
    (128, 64, 1, 16, 16),
    (256, 128, 2, 8, 32),
    (128, 64, 1, 12, 20),      # W not a multiple of the pixel tile
    (512, 128, 1, 4, 40),
    # tile edges of the tensor-core kernel (128 pixels x 128 channels):
    (128, 64, 1, 2, 240),      # W = 240: two pixel tiles, the second ragged
    (256, 64, 2, 3, 130),      # N = 2, W two columns over one tile, k_rows = H
    (128, 192, 1, 4, 96),      # Cout 192: a full and a half channel tile
    (384, 64, 1, 5, 12),       # six 64-channel slices, one band of 5 rows
    # the 3x3's wgmma tile (128 pixels x 256 channels, 32-channel stages):
    (384, 64, 1, 4, 136),      # Cmid 384: a full and a half channel tile, W past one tile
    (256, 128, 1, 8, 16),      # the picker's largest band (8 rows) and k_rows = 1
    # the w64 frame's dec_1 (K3: 512 -> 512 -> 128 at 480 x 272), N = 1 and 4
    (512, 128, 1, 272, 480),
    (512, 128, 4, 272, 480),
    # W = 300: three pixel tiles, the last ragged, and a fourth past the
    # frame that rounds the clusters up
    (512, 128, 2, 16, 300),
])
def test_block_int8_kernel(dev, gen, dtype, c, co, n, h, w):
    """K3 ≡ its plain version exactly at k_rows 1, 2, 4, H and the
    picker's choice (those that divide H)."""
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, co)) * 0.05,
                   "bias": gen.standard_normal(co) * 0.1},
    }
    ops = kb8.pack_block_int8_params(params, device=dev)
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    # k_rows = H: one band touches both frame edges
    for k in sorted({1, 2, 4, h, kb8.pick_k_rows_int8(h, w, c, co) or h}):
        if h % k:
            continue
        before = kb8.fused_block_int8_nhwc.launches
        got = kb8.fused_block_int8_nhwc(x, *ops, k_rows=k)
        assert kb8.fused_block_int8_nhwc.launches == before + 1
        want = kb8.block_int8_nhwc_plain(x, *ops, k_rows=k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, (got.float() - want.float()).abs().max().item())


def _int8_block_operands(gen, dev, dtype, n, h, w, c, co):
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, co)) * 0.05,
                   "bias": gen.standard_normal(co) * 0.1},
    }
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32))
    return x.to(dev, dtype), kb8.pack_block_int8_params(params, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,n,h,w,k,cc", [
    (256, 64, 1, 4, 32, 4, 128),     # two chunks, one band
    (256, 64, 1, 8, 32, 2, 128),     # four bands: two at the frame edges
    (1024, 512, 1, 8, 40, 4, 256),   # w64 dec_0 channels, W not a multiple of 32
    (512, 128, 2, 4, 16, 2, 256),    # batched
    (768, 64, 1, 4, 240, 4, 256),    # three chunks, W = 240, k_rows = H
    (1024, 64, 2, 2, 20, 2, 256),    # four chunks, N = 2, k_rows = H
    (384, 64, 1, 3, 20, 1, 128),     # k_rows = 1; Cmid 384 past one 256-channel tile
    (512, 128, 1, 4, 130, 2, 16),    # 16-channel chunks: stages of one word
    # the w64 frame's dec_0 (K5: 1024 -> 1024 -> 512 at 240 x 136, the
    # (k_rows, c_chunk) deploy.py picks), N = 1 and 4
    (1024, 512, 1, 136, 240, 2, 256),
    (1024, 512, 4, 136, 240, 2, 256),
    (1024, 512, 2, 8, 300, 2, 256),  # three ragged pixel tiles and one past the frame
])
def test_block_int8_kchunked_kernel(dev, gen, dtype, c, co, n, h, w, k, cc):
    x, ops = _int8_block_operands(gen, dev, dtype, n, h, w, c, co)
    before = kb8.fused_block_int8_kchunked.launches
    got = kb8.fused_block_int8_kchunked(x, *ops, k_rows=k, c_chunk=cc)
    assert kb8.fused_block_int8_kchunked.launches == before + 1
    want = kb8.block_int8_kchunked_plain(x, *ops, k_rows=k, c_chunk=cc)
    torch.cuda.synchronize()
    # same integers, same float32 steps in the same order
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def _in_storage(x: torch.Tensor, storage: str) -> torch.Tensor:
    """x [N,H,W,C] with the same values in the given storage: contiguous
    NHWC (the main path's), the same starting 2 bytes past a 16-byte
    boundary, an NHWC view of contiguous NCHW, or that view 2 bytes off."""
    if storage == "nhwc":
        return x.contiguous()
    if storage == "nhwc_unaligned":
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
        view = buf[1:1 + x.numel()].view(x.shape)
        view.copy_(x)
        return view
    nchw = x.permute(0, 3, 1, 2)
    if storage == "cmajor":
        return nchw.contiguous().permute(0, 2, 3, 1)
    buf = torch.empty(nchw.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + nchw.numel()].view(nchw.shape)
    view.copy_(nchw)
    return view.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("storage", ["cmajor", "nhwc"])
@pytest.mark.parametrize("c,cout,n,h,w", [
    (128, 64, 1, 16, 24),
    (128, 128, 2, 8, 200),    # W over one 128-column tile
    (256, 64, 1, 4, 20),      # two hidden-channel blocks; W % 8 != 0
    (128, 64, 1, 4, 960),     # the w64 dec_2 width at a reduced H: 7.5 tiles
    (128, 64, 1, 3, 130),     # two columns past one tile
    (128, 64, 1, 1, 20),      # H = 1: both halo rows outside the frame
    (128, 128, 2, 2, 36),     # H = 2, N = 2
    (256, 128, 1, 3, 40),
    (256, 256, 1, 3, 24),     # Cout = C: two output blocks
    (384, 64, 1, 2, 136),     # three 64-channel chunks per hidden block
    (384, 128, 1, 2, 20),
    (384, 384, 1, 2, 24),     # Cout = C = 384: three output blocks
])
def test_block128_kernel(dev, gen, dtype, rel, storage, c, cout, n, h, w):
    ops = _block128_ops(gen, dev, dtype, c, cout)
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    x = _in_storage(x, storage)
    got = _block128_call(x, ops)
    want = kc128.block128_nhwc_plain(x, *ops)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (n, h, w, cout) and got.dtype == dtype
    _close(got, want, rel)


def _block128_ops(gen, dev, dtype, c, cout):
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, cout)) * 0.1,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    return kc128.pack_block128_params(params, dtype=dtype, device=dev)


def _block128_call(x, ops):
    """K6 on x: one more ``launches``, and one more ``wgmma_launches``
    exactly where the pick (``bf16_kernel``) names the wgmma kernel."""
    k6 = kc128.fused_block128_nhwc
    on_wgmma = x.dtype == torch.bfloat16 and kc128.bf16_kernel(
        x.shape, x.stride(), x.data_ptr() % 16, ops[2].shape[1]) == kc128.WGMMA_KERNEL
    before = (k6.launches, k6.wgmma_launches)
    got = k6(x, *ops)
    assert (k6.launches, k6.wgmma_launches) == (before[0] + 1, before[1] + on_wgmma)
    return got


@pytest.mark.parametrize("storage", ["nhwc", "nhwc_unaligned"])
@pytest.mark.parametrize("cout,n,h,w", [
    (64, 1, 544, 960),   # the w64 dec_2 block
    (64, 4, 6, 960),     # a batch of four frames
    (64, 1, 1, 20),      # H = 1: both halo rows outside the frame; one tile
    (64, 2, 2, 136),     # H = 2, N = 2
    (64, 1, 3, 250),     # a second tile of 10 columns
    (128, 1, 2, 250),    # Cout = 128: both warpgroups on the 1x1
    (128, 2, 3, 960),
    (72, 1, 2, 480),     # Cout between the two m64 blocks
])
def test_block128_wgmma_kernel(dev, gen, storage, cout, n, h, w):
    """K6's wgmma kernel (channels-last storage, in place or by the copy of
    storage no stage reads; C = 128, Cout % 8 == 0) ≡ its plain version
    within one bf16 rounding plus flips of the hidden rounding (2e-2)."""
    ops = _block128_ops(gen, dev, torch.bfloat16, 128, cout)
    x = torch.from_numpy(gen.standard_normal((n, h, w, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    x = _in_storage(x, storage)
    assert kc128.bf16_kernel(x.shape, x.stride(), x.data_ptr() % 16,
                             cout) == kc128.WGMMA_KERNEL
    got = _block128_call(x, ops)
    want = kc128.block128_nhwc_plain(x, *ops)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (n, h, w, cout) and got.is_contiguous()
    _close(got, want, 2e-2)


@pytest.mark.parametrize("storage,channels_major", [
    ("cmajor", True), ("cmajor_unaligned", True), ("nhwc", False),
    ("nhwc_unaligned", False)])
@pytest.mark.parametrize("w", [24, 20])
@pytest.mark.parametrize("cout", [64, 68])
def test_block128_keeps_storage_order(dev, gen, storage, channels_major, w, cout):
    """bf16: the output comes back in x's storage order, the 16-byte,
    element-by-element and channels-last staging paths of the mma.sync
    kernel and the wgmma kernel (channels-last, Cout % 8 == 0) agree with
    plain."""
    ops = _block128_ops(gen, dev, torch.bfloat16, 128, cout)
    x = torch.from_numpy(gen.standard_normal((2, 5, w, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    x = _in_storage(x, storage)
    got = _block128_call(x, ops)
    want = kc128.block128_nhwc_plain(x, *ops)
    torch.cuda.synchronize()
    assert got.permute(0, 3, 1, 2).is_contiguous() == channels_major
    assert got.is_contiguous() == (not channels_major)
    _close(got, want, 2e-2)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_convblock_nhwc_kernel(dev, gen, dtype, rel):
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, 64, 64)) * 0.2,
                   "bias": gen.standard_normal(64) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, 64, 16)) * 0.2,
                   "bias": gen.standard_normal(16) * 0.1},
    }
    ws = kcb.pack_convblock_params(params, dtype=dtype, device=dev)
    x = torch.from_numpy(gen.standard_normal((2, 30, 130, 64)).astype(np.float32)).to(dev, dtype)
    before = (kcb.fused_conv_block_nhwc.launches, kcb.fused_conv_block_chw.launches)
    got = kcb.fused_conv_block_nhwc(x, *ws)
    assert (kcb.fused_conv_block_nhwc.launches,
            kcb.fused_conv_block_chw.launches) == (before[0] + 1, before[1] + 1)
    want = kcb.conv_block_nhwc_plain(x, *ws)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, 30, 130, 16)
    _close(got, want, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co,k,cot,slope", [
    (1, 8, 16, 128, 256, 8, 256, 0.2),
    (2, 12, 40, 256, 256, 4, 128, None),   # two Co tiles, no activation
    (1, 6, 240, 128, 64, 6, 64, 0.2),      # Co 64 below the channel tile, k_rows = H
    (2, 4, 130, 256, 384, 2, 192, None),   # two co_tiles of 192: 128 + 64 channels each
    (1, 3, 20, 384, 320, 1, 320, 0.2),     # k_rows = 1; a full and a 64-channel tile
    (1, 272, 480, 512, 512, 2, 256, 0.2),  # the w64 dec_1a shape, pick_tiles' choice
    (4, 272, 480, 512, 512, 2, 256, 0.2),  # ... at the serving batch
    (2, 8, 300, 256, 256, 4, 256, None),   # three ragged pixel tiles and one past the frame
])
def test_conv3x3_int8_kernel(dev, gen, dtype, out_dtype, n, h, w, c, co, k,
                             cot, slope):
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    wq = torch.from_numpy(gen.integers(-127, 127, (9, c, co)).astype(np.int8)).to(dev)
    ws = torch.from_numpy(gen.random(co).astype(np.float32) * 1e-2).to(dev)
    bias = torch.from_numpy(gen.standard_normal(co).astype(np.float32) * 0.1).to(dev)
    kw = dict(k_rows=k, negative_slope=slope, out_dtype=out_dtype)
    before = kc7.conv3x3_int8_nhwc.launches
    got = kc7.conv3x3_int8_nhwc(x, wq, ws, bias, co_tile=cot, **kw)
    assert kc7.conv3x3_int8_nhwc.launches == before + 1
    want = kc7.conv3x3_int8_plain(x, wq, ws, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,cc", [
    (1, 4, 130, 256, 2, 128),     # halo rows in and outside the frame, ragged W
    (2, 6, 20, 512, 3, 256),      # N = 2, chunks of 256, W under one tile
    (1, 4, 130, 512, 2, 16),      # 16-channel chunks: a zero word after each
    (1, 272, 480, 512, 2, 512),   # w64 dec_1 (K3), deploy's bands
    (4, 136, 240, 1024, 2, 256),  # w64 dec_0 (K5) at the serving batch
    (2, 8, 300, 256, 4, 256),     # W = 300: three pixel tiles
])
def test_band_copy_kernel(dev, gen, dtype, n, h, w, c, k, cc):
    """The int8 kernels' band copy (``rowmax_kernel`` then
    ``rowmax_kernel_quant_bands``) ≡ its plain version byte for byte:
    zeros included."""
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    got = kb8.quantize_bands(x, k_rows=k, c_chunk=cc)
    want = kb8.quantize_bands_plain(x, k_rows=k, c_chunk=cc)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.int8
    assert torch.equal(got, want), (got != want).sum().item()


@pytest.mark.parametrize("c_chunk", [128, 256])
def test_int8_quantization_at_rounding_ties(dev, gen, c_chunk):
    """Every activation within three float32 ulp of (k + 1/2) · a, the tie
    of the int8 rounding at the band's scale a (each row holds the band's
    max |x| = 3, so a is known): the kernels' division-free quantization
    must round each as the plain version's IEEE division does."""
    n, h, w, c = 1, 4, 40, 256
    a = (torch.tensor(3.0) / 127.0 + 1e-12).float()
    k = torch.from_numpy(gen.integers(-126, 126, (n, h, w, c)).astype(np.float32))
    v = ((k + 0.5) * a).float()
    for step in range(1, 4):   # a few values on either side of the tie
        sel = torch.from_numpy(gen.integers(-step, step + 1, v.shape)).sign()
        v = torch.where(sel > 0, torch.nextafter(v, torch.tensor(np.inf)), v)
        v = torch.where(sel < 0, torch.nextafter(v, torch.tensor(-np.inf)), v)
    v[:, :, 0, :] = 3.0
    x = v.to(dev)
    wq = torch.from_numpy(gen.integers(-127, 127, (9, c, 128)).astype(np.int8)).to(dev)
    ones, zeros = torch.full((128,), 1e-3, device=dev), torch.zeros(128, device=dev)
    got = kc7.conv3x3_int8_nhwc(x, wq, ones, zeros, k_rows=2, co_tile=128,
                                out_dtype=torch.float32)
    want = kc7.conv3x3_int8_plain(x, wq, ones, zeros, k_rows=2, out_dtype=torch.float32)
    ops = (wq, ones, zeros, wq[4, :128, :64].contiguous(), ones[:64], zeros[:64])
    got5 = kb8.fused_block_int8_kchunked(x, *ops, k_rows=2, c_chunk=c_chunk)
    want5 = kb8.block_int8_kchunked_plain(x, *ops, k_rows=2, c_chunk=c_chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got5, want5)


# ------------------------------------------- the tiled CLI's batches, the CLI


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("cin,cmid,cout,h,w", [
    (16, 16, 16, 128, 128),     # a 256-pixel tile's enc_0 / dec_final (Wp 256)
    (128, 128, 32, 32, 32),     # its dec_1, with the skip
])
def test_convblock_kernel_batch_of_tiles(dev, gen, dtype, rel, cin, cmid, cout, h, w):
    """K2 on a batch of two tiles ≡ its plain version, and each image of the
    batch ≡ the kernel on that image alone (the grid indexes N)."""
    x, ws, res, w = _conv_operands(gen, dev, cin, cmid, cout, 2, h, w, dtype)
    kw = dict(true_w=w, residual=res)
    got = kcb.fused_conv_block_chw(x, *ws, **kw)
    _close(got, kcb.conv_block_chw_plain(x, *ws, **kw), rel)
    for i in range(2):
        one = kcb.fused_conv_block_chw(x[i:i + 1], *ws, true_w=w,
                                       residual=res[i:i + 1])
        assert torch.equal(got[i:i + 1], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co", [
    (2, 16, 16, 256, 128),      # a 256-pixel tile's dec_0 (256 -> 128 at 16x16)
    (4, 272, 480, 512, 128),    # the serving batch's w64 dec_1
])
def test_block_int8_kernel_batch_of_tiles(dev, gen, dtype, n, h, w, c, co):
    """K3 on a batch of tiles or frames ≡ its plain version exactly, and
    each image ≡ the kernel on that image alone: band scales are per
    image."""
    x, ops = _int8_block_operands(gen, dev, dtype, n, h, w, c, co)
    k = kb8.pick_k_rows_int8(h, w, c, co)
    got = kb8.fused_block_int8_nhwc(x, *ops, k_rows=k)
    assert torch.equal(got, kb8.block_int8_nhwc_plain(x, *ops, k_rows=k))
    for i in range(n):
        assert torch.equal(got[i:i + 1],
                           kb8.fused_block_int8_nhwc(x[i:i + 1], *ops, k_rows=k))


@pytest.mark.parametrize("with_norm", [False, True])
def test_blend_tiles_device_on_card(dev, gen, with_norm):
    """The tiled path's blend on the card ≡ the host's numpy accumulation
    within 1e-6."""
    from pcss_unet_tpu_torch.infer.tiled import _feather_weights, plan_tiles
    from pcss_unet_tpu_torch.ops.blend import blend_tiles_device

    fh, fw, tile, halo = 200, 300, 64, 8
    offsets = np.array([(y, x) for y in plan_tiles(fh, tile, 2 * halo)
                        for x in plan_tiles(fw, tile, 2 * halo)], np.int32)
    tiles = gen.random((len(offsets), tile, tile, 1)).astype(np.float32)
    w2d = np.outer(_feather_weights(tile, halo),
                   _feather_weights(tile, halo)).astype(np.float32)[..., None]
    acc = np.zeros((fh, fw, 1), np.float32)
    norm = np.zeros((fh, fw, 1), np.float32)
    for t, (y, x) in enumerate(offsets):
        acc[y:y + tile, x:x + tile] += tiles[t] * w2d
        norm[y:y + tile, x:x + tile] += w2d
    got = blend_tiles_device(torch.from_numpy(tiles).to(dev),
                             torch.from_numpy(w2d), offsets, (fh, fw),
                             norm=torch.from_numpy(norm) if with_norm else None)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), acc / np.maximum(norm, 1e-8),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--tile", "128", "--halo", "16"]],
                         ids=["untiled", "tiled"])
def test_infer_cli_on_card_writes_the_engines_codes(dev, gen, tmp_path, extra):
    """``infer`` on the card (its default device) writes exactly the codes
    trunc(255 · mask) of the engine built the same way, untiled and tiled,
    and launches K1, K2 ×6 and K3 once each and K4 never."""
    import json
    import os

    from pcss_unet_tpu_torch.cli import infer as cli_infer
    from pcss_unet_tpu_torch.infer import (InferenceEngine, infer_tiled,
                                           load_variables)
    from pcss_unet_tpu_torch.io.exr import write_exr
    from pcss_unet_tpu_torch.io.png import decode_png_l
    from pcss_unet_tpu_torch.ops.kernels import KERNELS, reset_launch_counts

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    with open(os.path.join(golden, "deploy_w16.json")) as f:
        meta = json.load(f)
    np.save(tmp_path / "train_stats.npy",
            {"means": meta["means"], "stds": meta["stds"]}, allow_pickle=True)
    frame = gen.random((256, 384, 4)).astype(np.float32)
    write_exr(str(tmp_path / "f.exr"), {c: frame[..., i] for i, c in enumerate("RGBA")})
    weights = os.path.join(golden, "deploy_w16.npz")
    reset_launch_counts()
    cli_infer.main(["--input", str(tmp_path / "f.exr"), "--output",
                    str(tmp_path / "m.png"), "--weights", weights,
                    "--stats_dir", str(tmp_path), "--fold_bn", "--quantize",
                    "int8", "--layout", "chw", *extra])
    launches = {k.__name__: k.launches for k in KERNELS}
    assert launches == {**{k.__name__: 0 for k in KERNELS},
                        "fused_scrub_standardize": 1, "fused_conv_block_chw": 6,
                        "fused_block_int8_nhwc": 1}
    engine = InferenceEngine(None, load_variables(weights), fold_bn=True,
                             quantize="int8", layout="chw", dtype=torch.bfloat16,
                             means=np.asarray(meta["means"], np.float32),
                             stds=np.asarray(meta["stds"], np.float32))
    mask = (infer_tiled(engine, frame, tile=128, halo=16) if extra
            else engine(frame))
    want = (np.clip(mask[..., 0], 0.0, 1.0) * 255.0).astype(np.uint8)
    with open(tmp_path / "m.png", "rb") as f:
        got = decode_png_l(f.read())
    assert np.array_equal(got, want)


# ------------------------------- serving: batches of frames, the server


@pytest.mark.parametrize("cin,cmid,cout,h,w", [
    (16, 16, 64, 34, 60),      # w64 enc_0 (544×960 reduced)
    (64, 64, 128, 17, 30),     # w64 enc_1
    (64, 64, 16, 34, 60),      # w64 dec_final
])
def test_convblock_nhwc_kernel_batch_of_frames(dev, gen, cin, cmid, cout, h, w):
    """K2′ on a batch of two frames at the w64 stages' channels, on the
    NHWC view of channels-major storage the model hands it: ≡ its plain
    version, and each image ≡ the kernel on that image alone."""
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, cin, cmid)) * 0.2,
                   "bias": gen.standard_normal(cmid) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, cmid, cout)) * 0.2,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    ws = kcb.pack_convblock_params(params, dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(gen.standard_normal((2, h, w, cin)).astype(np.float32))
    x = _in_storage(x.to(dev, torch.bfloat16), "cmajor")
    got = kcb.fused_conv_block_nhwc(x, *ws)
    _close(got, kcb.conv_block_nhwc_plain(x, *ws), 2e-2)
    for i in range(2):
        assert torch.equal(got[i:i + 1], kcb.fused_conv_block_nhwc(x[i:i + 1], *ws))


def _k2_weights(gen, dev, cin, cmid, cout):
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, cin, cmid)) * 0.2,
                   "bias": gen.standard_normal(cmid) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, cmid, cout)) * 0.2,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    return kcb.pack_convblock_params(params, dtype=torch.bfloat16, device=dev)


def _whole_storage(t: torch.Tensor) -> torch.Tensor:
    """The flat storage under the view t (pad rows and columns too)."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(t.untyped_storage())


def _in_place_vs_copy_route(x, ws, stage):
    """K2′ on x, read in place in stage ``stage`` (no copy counted) or, for
    ``"copy"``, through the copy route (one copy counted), ≡ its copy route
    bit for bit, the whole output allocation included, with the same
    strides."""
    counts = (kcb.fused_conv_block_nhwc.launches, kcb.fused_conv_block_chw.launches,
              kcb.fused_conv_block_nhwc.copies)
    assert kcb.stage_of(x) == stage
    got = kcb.fused_conv_block_nhwc(x, *ws)
    assert (kcb.fused_conv_block_nhwc.launches, kcb.fused_conv_block_chw.launches,
            kcb.fused_conv_block_nhwc.copies) == (counts[0] + 1, counts[1] + 1,
                                                  counts[2] + (stage == "copy"))
    want = kcb.copy_route(x, *ws)
    torch.cuda.synchronize()
    assert got.stride() == want.stride() and tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got, want)
    assert torch.equal(_whole_storage(got), _whole_storage(want))


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("cin,cmid,cout,h,w,storage,stage", [
    (16, 16, 64, 544, 960, "nhwc", "nhwc"),          # w64 enc_0: K1's NHWC output
    (64, 64, 128, 272, 480, "cmajor", "cmajor_vec"),  # w64 enc_1: the pool's output
    (64, 64, 16, 544, 960, "nhwc", "nhwc"),          # w64 dec_final: the head resize's
])
def test_convblock_nhwc_in_place_w64_calls(dev, gen, n, cin, cmid, cout, h, w,
                                            storage, stage):
    """K2′ at the three w64 calls, in the storage each gets on the main
    path, for the batch of one and of four: read in place, ≡ the padded
    copy route bit for bit."""
    ws = _k2_weights(gen, dev, cin, cmid, cout)
    x = torch.randn((n, h, w, cin), device=dev).to(torch.bfloat16)
    _in_place_vs_copy_route(_in_storage(x, storage), ws, stage)


@pytest.mark.parametrize("case", ["w_not_8", "w_not_8_cmajor", "w_not_128", "odd_h",
                                  "odd_h_cmajor", "unaligned", "c_slice", "w_slice",
                                  "every_other_column", "cin_not_8"])
def test_convblock_nhwc_in_place_ragged(dev, gen, case):
    """K2′ on storage off the main path: W not a multiple of 8 or of 128,
    an odd H, a view starting 2 bytes past a 16-byte boundary, non-dense
    views (a slice of the channels, of the columns, every other column),
    Cin not a multiple of 8.  Dense channels-last storage and dense
    channels-major storage with W % 8 == 0 and an aligned start are read in
    place, any other storage through the copy route, counted; each ≡ the
    copy route bit for bit.  A float32 x takes the copy route, counted."""
    cin = 20 if case == "cin_not_8" else 16
    ws = _k2_weights(gen, dev, cin, 16, 32)
    x = torch.randn((2, 9, 130, 48), device=dev).to(torch.bfloat16)
    x, stage = {
        "w_not_8": (x[..., :cin].contiguous(), "nhwc"),
        "w_not_8_cmajor": (_in_storage(x[..., :cin], "cmajor"), "copy"),
        "w_not_128": (x[:, :, :100, :cin].contiguous(), "nhwc"),
        "odd_h": (x[:, :7, :, :cin].contiguous(), "nhwc"),
        "odd_h_cmajor": (_in_storage(x[:, :7, :64, :cin], "cmajor"), "cmajor_vec"),
        "unaligned": (_in_storage(x[:, :, :64, :cin], "offset"), "copy"),
        "c_slice": (x[..., 8:8 + cin], "copy"),
        "w_slice": (_in_storage(x[:, :, :128, :cin], "cmajor")[:, :, 8:120], "copy"),
        "every_other_column": (x[:, :, ::2, :cin], "copy"),
        "cin_not_8": (x[..., :cin].contiguous(), "copy"),
    }[case]
    _in_place_vs_copy_route(x, ws, stage)
    xf = x.float()
    ws32 = tuple(t.float() for t in ws)
    before = kcb.fused_conv_block_nhwc.copies
    got = kcb.fused_conv_block_nhwc(xf, *ws32)
    assert kcb.fused_conv_block_nhwc.copies == before + 1
    assert torch.equal(got, kcb.copy_route(xf, *ws32))


def _device_ops(fn) -> int:
    """Device events (kernels, copies, memsets) of one ``fn()`` under
    torch.profiler; the trace starts one step ahead, as a trace started
    with the call can miss its first kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep"))


def test_convblock_nhwc_w64_forward_copies_nothing(dev, gen, monkeypatch):
    """One w64 NHWC fused+int8 bf16 forward (the render cells' posture):
    K2′ launches 3 times, on channels-last (enc_0, dec_final) and
    channels-major (enc_1) storage, and copies its input none; the padded
    copy route for the same calls costs 8 more device operations (each pad
    a fill and a copy, each channels-last pad then a transposing copy) and
    gives the same mask, bit for bit."""
    from pcss_unet_tpu_torch.infer import InferenceEngine
    from pcss_unet_tpu_torch.models import unet as unet_mod
    from pcss_unet_tpu_torch.models.init import seeded_variables
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    engine = InferenceEngine(None, seeded_variables(), fold_bn=True,
                             quantize="int8", layout="nhwc",
                             dtype=torch.bfloat16, device="cuda")
    x = torch.from_numpy(gen.standard_normal((1, 544, 960, 16)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    stages, real = [], unet_mod.fused_conv_block_nhwc

    def watched(xh, *a, **k):
        stages.append(kcb.stage_of(xh))
        return real(xh, *a, **k)

    with torch.inference_mode():
        engine.model.forward_entered(x)
        reset_launch_counts()
        monkeypatch.setattr(unet_mod, "fused_conv_block_nhwc", watched)
        got = engine.model.forward_entered(x)
        torch.cuda.synchronize()
        assert (kcb.fused_conv_block_nhwc.launches, kcb.fused_conv_block_nhwc.copies,
                stages) == (3, 0, ["nhwc", "cmajor_vec", "nhwc"])
        monkeypatch.setattr(unet_mod, "fused_conv_block_nhwc", real)
        in_place = _device_ops(lambda: engine.model.forward_entered(x))
        monkeypatch.setattr(unet_mod, "fused_conv_block_nhwc", kcb.copy_route)
        want = engine.model.forward_entered(x)
        copied = _device_ops(lambda: engine.model.forward_entered(x))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert copied - in_place == 8, (in_place, copied)


def test_block_int8_kchunked_kernel_batch_of_frames(dev, gen):
    """K5 at w64 dec_0's channels (1024 → 512) on a batch of two frames ≡
    its plain version exactly, and each image ≡ the kernel on it alone."""
    x, ops = _int8_block_operands(gen, dev, torch.bfloat16, 2, 8, 40, 1024, 512)
    kw = dict(k_rows=4, c_chunk=256)
    got = kb8.fused_block_int8_kchunked(x, *ops, **kw)
    assert torch.equal(got, kb8.block_int8_kchunked_plain(x, *ops, **kw))
    for i in range(2):
        assert torch.equal(got[i:i + 1],
                           kb8.fused_block_int8_kchunked(x[i:i + 1], *ops, **kw))


@pytest.mark.parametrize("storage", ["nhwc", "cmajor"])
def test_block128_kernel_batch_of_frames(dev, gen, storage):
    """K6 at w64 dec_2's channels (128 → 64) on a batch of two frames, in
    the main path's channels-last storage (the wgmma kernel) and in
    channels-major storage (the mma.sync kernel), ≡ its plain version within
    2e-2, and each image ≡ the kernel on it alone."""
    ops = _block128_ops(gen, dev, torch.bfloat16, 128, 64)
    x = torch.from_numpy(gen.standard_normal((2, 6, 960, 128)).astype(np.float32))
    x = _in_storage(x.to(dev, torch.bfloat16), storage)
    got = _block128_call(x, ops)
    _close(got, kc128.block128_nhwc_plain(x, *ops), 2e-2)
    for i in range(2):
        assert torch.equal(got[i:i + 1], _block128_call(x[i:i + 1], ops))


def test_mask_to_u8_kernel_batch_of_frames(dev, gen):
    """K4 on a batch of two masks ≡ its plain version, each image ≡ K4 on
    it alone."""
    x = torch.from_numpy((gen.random((2, 34, 60, 1)) * 1.4 - 0.2)
                         .astype(np.float32)).to(dev)
    got = kfu.fused_mask_to_u8(x)
    assert torch.equal(got, kfu.mask_to_u8_plain(x))
    for i in range(2):
        assert torch.equal(got[i:i + 1], kfu.fused_mask_to_u8(x[i:i + 1]))


def _serving_engine(layout="nhwc"):
    import json
    import os

    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    with open(os.path.join(golden, "deploy_w16.json")) as f:
        meta = json.load(f)
    return InferenceEngine(None, load_variables(os.path.join(golden, "deploy_w16.npz")),
                           fold_bn=True, quantize="int8", layout=layout,
                           dtype=torch.bfloat16,
                           means=np.asarray(meta["means"], np.float32),
                           stds=np.asarray(meta["stds"], np.float32))


@pytest.mark.parametrize("batch", [1, 2])
def test_server_on_card_serves_each_batchs_codes(dev, gen, tmp_path, batch):
    """The server on the card (NHWC fused+int8, bf16) over 7 distinct
    frames: every mask ≡ ``render_u8`` of the same padded batch, cropped,
    code for code.  A pinned buffer reused before its copy finished would
    hand one frame's codes to another; at batch 1 the upload buffers are
    reused."""
    from pcss_unet_tpu_torch.infer import ShadowServer, pad_to_multiple
    from pcss_unet_tpu_torch.io.exr import read_exr_stack, write_exr

    paths = []
    for i in range(7):
        x = gen.random((100, 200, 4)).astype(np.float32)
        x[..., 0] += i                                  # distinct frames
        p = str(tmp_path / f"f{i}.exr")
        write_exr(p, {c: x[..., k] for k, c in enumerate("RGBA")})
        paths.append(p)
    engine = _serving_engine()
    got, order = {}, []

    def sink(p, m):
        got[p] = m
        order.append(p)
    stats = ShadowServer(engine, batch_size=batch, decode_workers=1).run(paths, sink)
    assert stats.frames == 7 and order == paths
    frames = [read_exr_stack(p) for p in paths]
    for b in range(0, 7, batch):
        padded, (h, w) = pad_to_multiple(np.stack(frames[b:b + batch]),
                                         engine.pad_multiple)
        want = engine.render_u8(padded).cpu().numpy()[:, :h, :w]
        for k, p in enumerate(paths[b:b + batch]):
            assert got[p].shape == (100, 200, 1)
            assert np.array_equal(got[p], want[k]), p
    assert len({got[p].tobytes() for p in paths}) == 7


@pytest.mark.parametrize("layout", ["nhwc", "chw"])
def test_dispatch_does_not_wait_for_the_device(dev, gen, layout):
    """With ~200 ms of work queued ahead on the stream (``torch.cuda._sleep``),
    one batch's upload and ``render_u8`` return on the host in under half
    of it: no copy from pageable memory, no host read of a device tensor,
    nothing in the forward waits.  The result is still right."""
    import time

    engine = _serving_engine(layout)
    frames = gen.random((2, 256, 384, 4)).astype(np.float32)
    want = engine.render_u8(frames).cpu()       # warm: caches, pinned buffers
    engine.render_u8(frames)
    torch.cuda.synchronize()
    # cycles per ms of this card's clock
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(stop)
    sleep_ms = 200.0
    torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
    t0 = time.perf_counter()
    out = engine.render_u8(frames)
    host_ms = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "the stream finished before the host returned"
    assert host_ms < sleep_ms / 2, host_ms
    assert torch.equal(out.cpu(), want)


# ------------------------------------------------------------------ training
def _train_run(device, steps=3, widths=(16, 32, 64, 128), hw=64):
    """``steps`` port train steps in float32 (adamw, dropout 0) from the
    same seeded weights on ``device`` → (losses, {name: change}, stats)."""
    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.train import build_train_step, create_train_state

    cfg = Config(batch_size=2, num_epochs=4, warmup_epochs=1, dropout_rate=0.0)
    model = init_train_weights(UNet(encoder_widths=widths, dropout_rate=0.0),
                               torch.Generator().manual_seed(0)).to(device).train()
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, cfg, 4)
    bundle = LossBundle(perceptual=PerceptualLoss(None, device=device))
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), 4)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        x = torch.from_numpy(rng.standard_normal((2, hw, hw, 4)).astype(np.float32))
        y = torch.from_numpy(rng.random((2, hw, hw, 1)).astype(np.float32))
        m = step(state, x.to(device), y.to(device))
        assert int(m["skipped"]) == 0
        losses.append(float(m["total_loss"]))
    deltas = {n: (p.detach().cpu() - before[n]).double().numpy().ravel()
              for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers() if "running" in n}
    return losses, deltas, stats


def test_train_step_on_the_card_matches_the_cpu(dev):
    """Three train steps on the card against the same steps on the CPU,
    float32, TF32 off: losses within 1e-4 relative, each parameter's change
    along the same direction (cosine > 0.995, norm within 2 %: the criteria
    of tests/test_train_parity.py for Adam, whose first steps are
    sign-like), BatchNorm statistics within 1e-4.  The conv biases in front
    of a BatchNorm have a zero true gradient, so only their size is held."""
    import re

    cl, cd, cs = _train_run(dev)
    hl, hd, hs = _train_run("cpu")
    np.testing.assert_allclose(cl, hl, rtol=1e-4)
    for name in hd:
        a, b = cd[name], hd[name]
        if re.search(r"\.conv_[ab]\.bias$", name):
            assert np.abs(a).max() < 1e-3 and np.abs(b).max() < 1e-3, name
            continue
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.995 and abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) < 2e-2, \
            (name, cos)
    for name in hs:
        torch.testing.assert_close(cs[name], hs[name], rtol=1e-4, atol=1e-5)


def test_remat_on_the_card(dev):
    """The bottleneck under torch.utils.checkpoint with dropout on, on the
    card: the same gradients as without remat (the mask is drawn outside
    the checkpointed region), with deterministic cuDNN."""
    from pcss_unet_tpu_torch.models.unet import UNet

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((2, 64, 64, 4)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.random((2, 64, 64, 1)).astype(np.float32)).to(dev)
        grads = {}
        for remat in (False, True):
            torch.manual_seed(3)
            model = UNet(encoder_widths=(16, 32, 64), dropout_rate=0.5,
                         dtype=torch.bfloat16, remat_bottleneck=remat).to(dev).train()
            masks = model.dropout_masks(2, torch.Generator(dev).manual_seed(11), dev)
            out, _ = model.forward_train(x, masks)
            grads[remat] = torch.autograd.grad((out - y).abs().mean(),
                                               list(model.parameters()))
        for a, b in zip(grads[False], grads[True]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        torch.backends.cudnn.deterministic = saved


def test_prefetch_to_device_delivers_the_host_batches(dev):
    """Batches come out on the card equal to the host loader's, in order,
    through pinned buffers on a copy stream."""
    from pcss_unet_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [(rng.random((2, 64, 96, 4), dtype=np.float32),
             rng.random((2, 64, 96, 1), dtype=np.float32)) for _ in range(5)]
    got = list(prefetch_to_device(iter(host), dev))
    assert len(got) == 5
    for (x, y), (a, b) in zip(host, got):
        assert a.device.type == "cuda"
        assert np.array_equal(a.cpu().numpy(), x) and np.array_equal(b.cpu().numpy(), y)


def test_batchnorm_stats_after_one_w64_step_match_the_cpu(dev):
    """The w64 net (64, 128, 512, 1024): BatchNorm running statistics after
    ONE train step on the card against the CPU, float32, TF32 off, within
    the 1e-4 of ``test_train_step_on_the_card_matches_the_cpu``.  Step 1's
    statistics come from the initial parameters, before any update."""
    _, _, cs = _train_run(dev, steps=1, widths=(64, 128, 512, 1024))
    _, _, hs = _train_run("cpu", steps=1, widths=(64, 128, 512, 1024))
    for name in hs:
        torch.testing.assert_close(cs[name], hs[name], rtol=1e-4, atol=1e-5)


# ------------------------------------ the train-mode BatchNorm tail kernel
def _bn_tail_case(dev, shape, layout, rate, seed=0):
    """A bf16 conv output of ``shape`` in ``layout``, a float32 BatchNorm
    away from the identity, running statistics and a keep-mask of ``rate``
    (None for 0)."""
    from torch import nn

    g = torch.Generator(device=dev).manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    norm = nn.BatchNorm2d(c).to(dev)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
        norm.bias.uniform_(-0.5, 0.5, generator=g)
    running = (torch.rand(c, generator=g, device=dev),
               torch.rand(c, generator=g, device=dev) + 0.5)
    mask = (torch.rand((n, c, 1, 1), generator=g, device=dev) >= rate) if rate else None
    return x, norm, running, mask


def _bn_tail_chain(x, norm, running, mask, keep):
    """The plain chain ``ConvBlock.forward_train`` runs without the kernel,
    and its float32 y (where LeakyReLU's branch is decided)."""
    from pcss_unet_tpu_torch.models.unet import _act, batch_norm_train

    y, new = batch_norm_train(x, norm, running, torch.float32)
    a = _act("leaky_relu", y).to(x.dtype)
    if mask is not None:
        a = torch.where(mask, a / keep, torch.zeros_like(a))
    return a, new, y.detach()


def _bf16_close(got, want, where=None, roundings=1):
    """Within ``roundings`` bf16 roundings of each value (the dropout's
    output is rounded twice: a flip of the first, from the statistics'
    float32 sums in another order, carries through the second), plus a
    floor of 1e-5 of the largest for values that cancel (float32 noise
    before the rounding); ``where``: the elements held.  → the share of
    codes that differ."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    ok = d <= roundings * 2 ** -7 * want.abs() + 1e-5 * want.abs().max()
    if where is not None:
        ok |= ~where
    assert bool(ok.all()), (d.max().item(), int((~ok).sum()))
    return (d > 0).float().mean().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("case,shape,rate", [
    ("L0_conv_b_64", (8, 64, 512, 1024), 0.0),      # enc_0 / dec_2 conv_b at L0
    ("dec_1_conv_a_512", (8, 512, 256, 512), 0.2),  # dec_1 conv_a at L1, dropout
])
def test_bn_tail_kernel_against_the_plain_chain(dev, case, shape, rate, layout):
    """The kernel pair at w64 batch-8 training shapes against the plain
    chain in bf16, both storages: output codes within one bf16 rounding
    (the statistics' float32 sums in another order; two with the dropout's
    second rounding), the running statistics within 1e-5, dx within one bf16 rounding (elements whose
    float32 y is within 1e-6 of the largest |y| of 0, where LeakyReLU's
    branch may fall either way, are left out and counted), dγ and dβ within
    1e-4 of the largest (float32 sums of N·H·W products in another order);
    output and dx in x's storage; three launches a pass."""
    from pcss_unet_tpu_torch.models.unet import BN_MOMENTUM
    from pcss_unet_tpu_torch.ops.kernels import bn_train as kbn

    x, norm, running, mask = _bn_tail_case(dev, shape, layout, rate)
    keep = 1.0 - rate
    xa = x.detach().clone().requires_grad_()
    want, want_new, y = _bn_tail_chain(xa, norm, running, mask, keep)
    g = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    want_grads = torch.autograd.grad(want, [xa, norm.weight, norm.bias], g)
    before = kbn.bn_act_dropout_train.launches
    xb = x.detach().clone().requires_grad_()
    got, *got_new = kbn.bn_act_dropout_train(xb, norm.weight, norm.bias, *running,
                                             mask, keep, 0.2, norm.eps, BN_MOMENTUM)
    assert kbn.bn_act_dropout_train.launches == before + 3
    assert got.stride() == x.stride() and got.dtype == torch.bfloat16
    _bf16_close(got, want, roundings=1 if mask is None else 2)
    for a, b in zip(got_new, want_new):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    got_grads = torch.autograd.grad(got, [xb, norm.weight, norm.bias], g)
    assert kbn.bn_act_dropout_train.launches == before + 6
    assert got_grads[0].stride() == x.stride()
    decided = y.abs() > 1e-6 * y.abs().max()
    assert (~decided).float().mean().item() < 1e-5
    _bf16_close(got_grads[0], want_grads[0], decided)
    for a, b in zip(got_grads[1:], want_grads[1:]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_bn_tail_kernel_in_the_checkpointed_bottleneck(dev, layout):
    """The w64 bottleneck block (512 → 1024 at L3, batch 8, dropout) under
    torch.utils.checkpoint, as the train forward runs it: the kernel route,
    the same output and gradients as without the checkpoint exactly (the
    recompute runs the same kernels), and within bf16 noise of the block's
    plain chain (the output within 2 % of its largest, each leaf's gradient
    within 1 % in norm, running statistics within 1e-4); the recompute
    launches the forward's kernels again."""
    from torch.utils.checkpoint import checkpoint

    from pcss_unet_tpu_torch.models.unet import ConvBlock
    from pcss_unet_tpu_torch.ops.kernels import bn_train as kbn

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.manual_seed(0)
        blk = ConvBlock(512, 1024, 0.2, dtype=torch.bfloat16).to(dev).train()
        x, _, _, mask = _bn_tail_case(dev, (8, 512, 64, 128), layout, 0.2)
        running = tuple(b.detach() for b in blk.buffers() if b.is_floating_point())
        g = torch.randn((8, 1024, 64, 128), device=dev).to(torch.bfloat16)
        runs = {}
        for mode in ("checkpoint", "direct", "plain"):
            xi = x.detach().clone().requires_grad_()
            if mode == "plain":
                blk._tail_fusable = lambda *a: False
            before = kbn.bn_act_dropout_train.launches
            if mode == "checkpoint":
                out, st = checkpoint(blk.forward_train, xi, mask, running, None, None,
                                     use_reentrant=False, preserve_rng_state=False)
            else:
                out, st = blk.forward_train(xi, mask, running)
            fwd = kbn.bn_act_dropout_train.launches - before
            grads = torch.autograd.grad(out, [xi] + list(blk.parameters()), g)
            runs[mode] = (blk.route, out, st, grads, fwd,
                          kbn.bn_act_dropout_train.launches - before - fwd)
        ck, di, pl = runs["checkpoint"], runs["direct"], runs["plain"]
        assert ck[0] == di[0] == "bn_act_dropout_train" and pl[0] == "plain"
        assert (di[4:], ck[4:], pl[4:]) == ((6, 6), (6, 12), (0, 0))
        assert torch.equal(ck[1], di[1])
        assert all(torch.equal(a, b) for a, b in zip(ck[2] + ck[3], di[2] + di[3]))
        # conv_b reads conv_a's tail, which the two chains round apart in
        # some values (twice with the dropout): the block's output and its
        # running statistics agree to that noise, not to one rounding
        d = (di[1].float() - pl[1].float()).abs().max().item()
        assert d <= 2e-2 * pl[1].float().abs().max().item()
        for a, b in zip(di[2], pl[2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        # every leaf's gradient within 1 % in norm of max(its norm, the
        # median leaf's): the two bf16 chains round some activations apart,
        # and the convolutions' bf16 weight gradients sum 65,536 such
        # products each; the conv biases in front of a BatchNorm have a zero
        # true gradient (noise)
        sizes = [b.float().norm().item() for b in pl[3]]
        floor = float(np.median(sizes))
        for a, b, size in zip(di[3], pl[3], sizes):
            assert (a.float() - b.float()).norm().item() <= 1e-2 * max(size, floor)
    finally:
        torch.backends.cudnn.deterministic = saved


def test_bf16_train_forward_routes_every_block_to_the_tail_kernel(dev):
    """A bf16 ``forward_train`` on the card routes every block to
    ``bn_act_dropout_train`` (three launches a conv output; the backward
    three more, and three a conv output of the checkpointed bottleneck's
    recompute); a float64 one, and a float32 one, still route ``plain``."""
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.ops.kernels import bn_train as kbn
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    x = torch.rand((2, 64, 96, 4), device=dev)
    model = UNet(encoder_widths=(16, 32, 64), dtype=torch.bfloat16).to(dev).train()
    masks = model.dropout_masks(2, torch.Generator(dev).manual_seed(0), dev)
    convs = 2 * len(model.blocks())
    reset_launch_counts()
    with torch.no_grad():
        model.forward_train(x, masks)
    assert set(model.routes().values()) == {"bn_act_dropout_train"}
    assert kbn.bn_act_dropout_train.launches == 3 * convs
    reset_launch_counts()
    out, _ = model.forward_train(x, masks)
    torch.autograd.grad(out.sum(), list(model.parameters()))
    assert kbn.bn_act_dropout_train.launches == 3 * convs + 3 * convs + 3 * 2
    for dtype in (torch.float64, torch.float32):
        m = UNet(encoder_widths=(16, 32, 64), dtype=dtype).to(dev, dtype).train()
        m.forward_train(x.to(dtype), {})
        assert set(m.routes().values()) == {"plain"}


# ------------------------------------------------------ governor and cache
def _probe_net(dev, **kw):
    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.models.unet import UNet

    cfg = Config(num_epochs=4, warmup_epochs=1, dropout_rate=0.0, alpha=0.9,
                 **kw)
    torch.manual_seed(0)
    return cfg, UNet(encoder_widths=(16, 32, 64, 128), dropout_rate=0.0).to(dev).train()


def test_probe_on_the_card_grows_with_the_microbatch_and_reports_oom(dev):
    """The measured probe: its peak grows with the microbatch, an oversized
    one (batch 64 of 2048², several hundred GB) reports "does not fit"
    (inf), what it allocated is freed, and the run's model is untouched."""
    from pcss_unet_tpu_torch.train.governor import probe_step_memory

    cfg, model = _probe_net(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    base = torch.cuda.memory_allocated(dev)
    zeros = np.zeros(4, np.float32), np.ones(4, np.float32)
    small = probe_step_memory(cfg.replace(grad_accum_steps=4), model, *zeros,
                              8, 256, 256)
    big = probe_step_memory(cfg.replace(grad_accum_steps=1), model, *zeros,
                            8, 256, 256)
    assert not small["oom"] and not big["oom"]
    assert 0 < small["args"] <= small["total"] < big["total"]
    assert big["temp"] > 2 * small["temp"]
    huge = probe_step_memory(cfg.replace(grad_accum_steps=1), model, *zeros,
                             64, 2048, 2048)
    assert huge["oom"] and huge["total"] == float("inf")
    # all freed but the resize matrices the forward caches per shape
    assert torch.cuda.memory_allocated(dev) - base < 256 << 20
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_governor_walk_on_the_card_skips_a_microbatch_that_does_not_fit(dev):
    """The walk with the real probe: a budget between the two measured
    peaks picks the split that fits."""
    from pcss_unet_tpu_torch.train.governor import (find_accum_steps_compiled,
                                                    probe_step_memory)

    cfg, model = _probe_net(dev, grad_accum_steps=0)
    zeros = np.zeros(4, np.float32), np.ones(4, np.float32)
    p1 = probe_step_memory(cfg.replace(grad_accum_steps=1), model, *zeros,
                           8, 256, 256)["total"]
    p2 = probe_step_memory(cfg.replace(grad_accum_steps=2), model, *zeros,
                           8, 256, 256)["total"]
    budget = int((p1 + p2) / 2 * 1.15)
    assert find_accum_steps_compiled(cfg, model, *zeros, 8, 256, 256,
                                     hbm_bytes=budget) == 2


def test_device_cache_batches_equal_the_streamed_ones(dev, tmp_path):
    """DeviceCache on the card against the host loader through
    prefetch_to_device: every batch equal, with and without crops."""
    from pcss_unet_tpu_torch.data.device_cache import DeviceCache
    from pcss_unet_tpu_torch.data.pipeline import (Loader, PackedDataset,
                                                   prefetch_to_device)

    rng = np.random.default_rng(0)
    np.save(tmp_path / "train_inputs.npy",
            rng.standard_normal((10, 4, 64, 96)).astype(np.float32))   # NCHW
    np.save(tmp_path / "train_labels.npy",
            rng.random((10, 1, 64, 96)).astype(np.float32))
    ds = PackedDataset(str(tmp_path), "train")
    assert ds.layout == "nchw"
    for crop in (None, (32, 48)):
        loader = Loader(ds, 4, shuffle=True, seed=5, crop_hw=crop)
        cache = DeviceCache(ds, crop_hw=crop, upload_chunk=3, device=dev)
        for epoch in (0, 1):
            got = list(cache.batches(loader, epoch))
            want = list(prefetch_to_device(loader.epoch(epoch), dev))
            assert len(got) == len(want) == 2
            for (x, y), (a, b) in zip(got, want):
                assert x.device.type == "cuda"
                assert torch.equal(x, a) and torch.equal(y, b)


@pytest.mark.parametrize("posture", [[], ["--fold_bn"],
                                     ["--fold_bn", "--quantize", "int8"]],
                         ids=["plain", "fold_bn", "fold_bn_int8"])
def test_temporal_score_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch,
                                                    posture):
    """``temporal`` on deploy_w16's golden sequence with its motion
    vectors, float32 engines: the card's score within 1e-5 of the CPU's."""
    import functools
    import json
    import os
    import sys

    import pcss_unet_tpu_torch.infer as pinfer
    from pcss_unet_tpu_torch.cli import temporal
    from pcss_unet_tpu_torch.io.exr import write_exr

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(os.path.dirname(here), "scripts"))
    import make_deployment_golden as g

    with open(os.path.join(here, "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    seq, motion = g.make_sequence(meta["seed_seq"], meta["n_seq"])
    (tmp_path / "f").mkdir()
    for t, frame in enumerate(seq):
        write_exr(str(tmp_path / "f" / f"t{t:03d}.exr"),
                  {n: frame[..., i] for i, n in enumerate("RGBA")})
    np.save(tmp_path / "mv.npy", motion)
    np.save(tmp_path / "train_stats.npy", {"means": meta["means"],
                                           "stds": meta["stds"]})
    monkeypatch.setattr(pinfer, "InferenceEngine", functools.partial(
        pinfer.InferenceEngine, dtype=torch.float32))
    argv = ["--frames_dir", str(tmp_path / "f"), "--weights",
            os.path.join(here, "golden", "deploy_w16.npz"), "--stats_dir",
            str(tmp_path), "--motion_vectors", str(tmp_path / "mv.npy"),
            "--alpha", "5", *posture]
    card = temporal.main(argv + ["--device", "cuda"])["score"]
    host = temporal.main(argv + ["--device", "cpu"])["score"]
    assert abs(card - host) <= 1e-5, (card, host)
    assert card <= meta["temporal_instability"] * 1.25 + 1e-4


# ------------------------------------------- devices and data parallelism
def test_kernels_launch_on_their_tensors_device(dev, gen):
    """With cuda:0 current, K1–K6 and the banded resize on cuda:1 tensors
    launch on cuda:1 (each wrapper runs under its tensors' device, so the
    stream, the shared-memory opt-in and the SM count are cuda:1's) and
    equal their plain versions there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(d1, dt)  # noqa: E731
    x = t(gen.standard_normal((2, 8, 40, 4)))
    m, s = t([0.5, -0.5, 1.0, 0.0]), t([2.0, 1.0, 0.5, 3.0])
    got = kfu.fused_scrub_standardize(x, m, s, out_dtype=torch.float32, entry="nhwc")
    want = kfu.scrub_standardize_plain(x, m, s, torch.float32, entry="nhwc")
    assert got.device == d1 and torch.equal(got, want)
    mask = t(gen.random((2, 8, 40, 1)))
    assert torch.equal(kfu.fused_mask_to_u8(mask), kfu.mask_to_u8_plain(mask))
    xc, ws, _, w = _conv_operands(gen, d1, 16, 16, 32, 1, 8, 40, torch.bfloat16)
    _close(kcb.fused_conv_block_chw(xc, *ws, true_w=w),
           kcb.conv_block_chw_plain(xc, *ws, true_w=w), 2e-2)
    xi, ops = _int8_block_operands(gen, d1, torch.bfloat16, 1, 8, 32, 256, 64)
    assert torch.equal(kb8.fused_block_int8_nhwc(xi, *ops, k_rows=4),
                       kb8.block_int8_nhwc_plain(xi, *ops, k_rows=4))
    assert torch.equal(kb8.fused_block_int8_kchunked(xi, *ops, k_rows=4, c_chunk=128),
                       kb8.block_int8_kchunked_plain(xi, *ops, k_rows=4, c_chunk=128))
    params = {"conv_a": {"kernel": gen.standard_normal((3, 3, 128, 128)) * 0.05,
                         "bias": gen.standard_normal(128) * 0.1},
              "conv_b": {"kernel": gen.standard_normal((1, 1, 128, 64)) * 0.1,
                         "bias": gen.standard_normal(64) * 0.1}}
    ops128 = kc128.pack_block128_params(params, dtype=torch.bfloat16, device=d1)
    x128 = t(gen.standard_normal((1, 16, 24, 128)), torch.bfloat16)
    got = kc128.fused_block128_nhwc(x128, *ops128)
    _close(got, kc128.block128_nhwc_plain(x128, *ops128), 2e-2)
    from pcss_unet_tpu_torch.ops.resize import interp_matrix

    xr = t(gen.standard_normal((1, 8, 6, 40)), torch.bfloat16)
    bands = kres.bands_on(interp_matrix(6, 12), torch.bfloat16, d1)
    assert torch.equal(kres.banded_resize(xr, bands, 2),
                       kres.banded_resize_plain(xr, bands, 2))
    torch.cuda.synchronize(d1)
    assert got.device == d1 and torch.cuda.current_device() == 0


_DP_RANK = r"""
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from pcss_unet_tpu_torch.train.step import rank_rows
from pcss_unet_tpu_torch.utils.distributed import initialize_multihost
sys.path.insert(0, os.path.dirname(sys.argv[1]))
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
initialize_multihost()
from test_torch_cuda import _dp_case
rows = rank_rows(4, dist.get_rank(), 2)
out = _dp_case(dist.group.WORLD, rows)
with open(sys.argv[2] + f".{dist.get_rank()}", "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _dp_case(group, rows):
    """Two standard steps (dropout 0.2) of a (8, 16) net at 32×32 on
    cuda:0 from seed 0, on the given rows of a batch of 4 → (losses,
    parameters)."""
    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.train import build_train_step, create_train_state

    torch.manual_seed(0)
    model = UNet(encoder_widths=(8, 16), dropout_rate=0.2).cuda().train()
    cfg = Config(batch_size=4, num_epochs=2, warmup_epochs=1)
    state = create_train_state(model, cfg, 4)
    step = build_train_step(cfg, LossBundle(perceptual=PerceptualLoss(
        None, taps=(2,), tap_weights=(1.0,), device="cuda")),
        np.zeros(4, np.float32), np.ones(4, np.float32), 4, group=group)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 4)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.random((4, 32, 32, 1), dtype=np.float32)).cuda()
    losses = []
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(i)
        losses.append(float(step(state, x[rows], y[rows], gen)["total_loss"]))
    return losses, {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}


def test_two_ranks_on_one_card_match_one_process(dev, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card) take
    the group step, each on its half of the batch: the one-process step's
    losses (1e-5) and parameters (rtol 1e-4, atol 1e-5; the conv biases in
    front of a BatchNorm, whose true gradient is zero, by size).  cuDNN is
    deterministic in all three processes, so that what differs is the
    split of the batch alone."""
    import pickle
    import re
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2")
    out = str(tmp_path / "rank")
    procs = [subprocess.Popen([sys.executable, "-c", _DP_RANK, os.path.abspath(__file__),
                               out], env=dict(env, RANK=str(r)), cwd=repo,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False):
        want_losses, want = _dp_case(None, np.arange(4))
    for r in range(2):
        with open(f"{out}.{r}", "rb") as f:
            losses, got = pickle.load(f)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k in want:
            if re.search(r"\.conv_[ab]\.bias$", k):
                assert np.abs(got[k] - want[k]).max() < 1e-3, k
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                           err_msg=k)

