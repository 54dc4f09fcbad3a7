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
                    torch.cuda.current_stream().cuda_stream)


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
])
def test_block_int8_kernel(dev, gen, dtype, c, co, n, h, w):
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, co)) * 0.05,
                   "bias": gen.standard_normal(co) * 0.1},
    }
    ops = kb8.pack_block_int8_params(params, device=dev)
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    for k in sorted({2, 4, h}):  # k_rows = H: one band touches both frame edges
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
    NHWC, an NHWC view of contiguous NCHW (the main path's), or that view
    starting 2 bytes past a 16-byte boundary."""
    if storage == "nhwc":
        return x.contiguous()
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
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, cout)) * 0.1,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    ops = kc128.pack_block128_params(params, dtype=dtype, device=dev)
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dtype)
    x = _in_storage(x, storage)
    before = kc128.fused_block128_nhwc.launches
    got = kc128.fused_block128_nhwc(x, *ops)
    assert kc128.fused_block128_nhwc.launches == before + 1
    want = kc128.block128_nhwc_plain(x, *ops)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (n, h, w, cout) and got.dtype == dtype
    _close(got, want, rel)


@pytest.mark.parametrize("storage,channels_major", [
    ("cmajor", True), ("cmajor_unaligned", True), ("nhwc", False)])
@pytest.mark.parametrize("w", [24, 20])
def test_block128_keeps_storage_order(dev, gen, storage, channels_major, w):
    """bf16: the output comes back in x's storage order, the 16-byte,
    element-by-element and channels-last staging paths agree with plain."""
    c, cout = 128, 64
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                   "bias": gen.standard_normal(c) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, c, cout)) * 0.1,
                   "bias": gen.standard_normal(cout) * 0.1},
    }
    ops = kc128.pack_block128_params(params, dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(gen.standard_normal((2, 5, w, c)).astype(np.float32)).to(
        dev, torch.bfloat16)
    x = _in_storage(x, storage)
    before = kc128.fused_block128_nhwc.launches
    got = kc128.fused_block128_nhwc(x, *ops)
    assert kc128.fused_block128_nhwc.launches == before + 1
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
def test_block_int8_kernel_batch_of_tiles(dev, gen, dtype):
    """K3 on a batch of two tiles at a 256-pixel tile's dec_0 shape (256 →
    128 at 16×16) ≡ its plain version exactly, and each image ≡ the kernel
    on that image alone: band scales are per image."""
    x, ops = _int8_block_operands(gen, dev, dtype, 2, 16, 16, 256, 128)
    k = kb8.pick_k_rows_int8(16, 16, 256, 128)
    got = kb8.fused_block_int8_nhwc(x, *ops, k_rows=k)
    assert torch.equal(got, kb8.block_int8_nhwc_plain(x, *ops, k_rows=k))
    for i in range(2):
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


def test_block128_kernel_batch_of_frames(dev, gen):
    """K6 at w64 dec_2's channels (128 → 64) on a batch of two frames in
    the main path's channels-major storage ≡ its plain version within 2e-2,
    and each image ≡ the kernel on it alone."""
    params = {
        "conv_a": {"kernel": gen.standard_normal((3, 3, 128, 128)) * 0.05,
                   "bias": gen.standard_normal(128) * 0.1},
        "conv_b": {"kernel": gen.standard_normal((1, 1, 128, 64)) * 0.1,
                   "bias": gen.standard_normal(64) * 0.1},
    }
    ops = kc128.pack_block128_params(params, dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(gen.standard_normal((2, 6, 960, 128)).astype(np.float32))
    x = _in_storage(x.to(dev, torch.bfloat16), "cmajor")
    got = kc128.fused_block128_nhwc(x, *ops)
    _close(got, kc128.block128_nhwc_plain(x, *ops), 2e-2)
    for i in range(2):
        assert torch.equal(got[i:i + 1], kc128.fused_block128_nhwc(x[i:i + 1], *ops))


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
    """With cuda:0 current, K1–K6 on cuda:1 tensors launch on cuda:1 (each
    wrapper runs under its tensors' device, so the stream, the
    shared-memory opt-in and the SM count are cuda:1's) and equal their
    plain versions there."""
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

