"""The train-mode BatchNorm → activation → cast → Dropout2d op
(``ops/kernels/bn_train.py``) on the CPU: its plain forward and backward
against autograd through the plain chain that ``ConvBlock.forward_train``
runs without it (``batch_norm_train`` → ``_act`` → cast → ``torch.where``),
and what its wrapper hands the kernels.  The kernels themselves run in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch import nn

from pcss_unet_tpu_torch.models.unet import (BN_MOMENTUM, SLOPES, UNet, _act,
                                             batch_norm_train)
from pcss_unet_tpu_torch.ops.kernels import bn_train as kbn
from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

SHAPE = (3, 6, 5, 8)            # N, C, H, W
ZERO_VAR, CLAMPED = 1, 2        # channels held constant


def _clamped_value(dtype) -> float:
    """A constant whose E[x²] − E[x]² is below 0 at SHAPE in ``dtype``, so
    that the clamp holds the variance at 0 and passes it no gradient."""
    for v in np.linspace(0.1, 3.0, 300):
        x = torch.full(SHAPE, float(v), dtype=dtype)
        m = x.mean(dim=(0, 2, 3))
        if ((x * x).mean(dim=(0, 2, 3)) - m * m)[0] < 0:
            return float(v)
    raise AssertionError("no constant clamps the variance")


def _case(dtype, rate, seed=0):
    """x [N, C, H, W] with a constant channel of exact zero variance and
    one whose variance the clamp holds at 0, BatchNorm parameters away from
    the identity, running statistics and a keep-mask of ``rate`` (None for
    0), all in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(SHAPE) * 1.5 + 0.3).to(dtype)
    x[:, ZERO_VAR] = 1.0
    x[:, CLAMPED] = _clamped_value(dtype)
    norm = nn.BatchNorm2d(SHAPE[1], eps=1e-5).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, SHAPE[1])))
        norm.bias.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, SHAPE[1])))
    running = tuple(torch.from_numpy(rng.uniform(0.1, 1.0, SHAPE[1])).to(dtype)
                    for _ in range(2))
    mask = None
    if rate:
        mask = torch.from_numpy(rng.random((SHAPE[0], SHAPE[1], 1, 1)) >= rate)
        assert mask.any() and not mask.all()
    return x, norm, running, mask


def _chain(x, norm, running, mask, keep, activation):
    """The plain chain as ``ConvBlock.forward_train`` runs it."""
    y, new = batch_norm_train(x, norm, running,
                              torch.promote_types(torch.float32, x.dtype))
    a = _act(activation, y).to(x.dtype)
    if mask is not None:
        a = torch.where(mask, a / keep, torch.zeros_like(a))
    return a, new


def _grad_tol(want, dtype):
    # float64: the rearranged formula's roundings; float32: sums of N·H·W
    # products in another order, against the largest gradient of the leaf
    rel = 1e-10 if dtype == torch.float64 else 2e-5
    return rel * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.1],
                         ids=["no_mask", "rate_0.2", "dec_final_half_rate"])
@pytest.mark.parametrize("activation", ["leaky_relu", "relu"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_op_matches_autograd_through_the_plain_chain(dtype, activation, rate):
    """The op on CPU tensors (its plain versions): output and updated
    running statistics equal to the chain's bit for bit; dx, dγ and dβ from
    its backward formula within rounding of autograd's, the constant
    channels included (exact zero variance, and a variance the clamp holds
    at 0, whose variance term drops out)."""
    x, norm, running, mask = _case(dtype, rate)
    keep = 1.0 - rate
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(SHAPE)).to(dtype)
    xa = x.clone().requires_grad_()
    want, want_new = _chain(xa, norm, running, mask, keep, activation)
    want_grads = torch.autograd.grad(want, [xa, norm.weight, norm.bias], g)

    xb = x.clone().requires_grad_()
    before = kbn.bn_act_dropout_train.launches
    got, *got_new = kbn.bn_act_dropout_train(
        xb, norm.weight, norm.bias, *running, mask, keep, SLOPES[activation],
        norm.eps, BN_MOMENTUM)
    assert got.dtype == dtype and torch.equal(got, want)
    for a, b in zip(got_new, want_new):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got_grads = torch.autograd.grad(got, [xb, norm.weight, norm.bias], g)
    for a, b in zip(got_grads, want_grads):
        assert a.dtype == b.dtype
        assert (a - b).abs().max().item() <= _grad_tol(b, dtype)
    assert kbn.bn_act_dropout_train.launches == before    # no kernel on the CPU

    _, stats = kbn.bn_act_dropout_plain(x, norm.weight, norm.bias, *running, mask,
                                        keep, SLOPES[activation], norm.eps,
                                        BN_MOMENTUM)
    live = stats[kbn.STATS_ROWS.index("live")]
    assert live[ZERO_VAR] == 1 and live[CLAMPED] == 0     # both cases reached
    if mask is not None:
        dropped = ~mask[:, :, 0, 0]
        assert not got[dropped].any()


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_op_in_bf16_matches_the_chain(rate):
    """x in bf16 (the card's working dtype, statistics in float32): the
    same output codes and running statistics as the chain, dx within one
    bf16 rounding of autograd's, dγ and dβ within float32 rounding."""
    x, norm, running, mask = _case(torch.float32, rate, seed=2)
    x = x.to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE)).to(torch.bfloat16)
    keep = 1.0 - rate
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    want, want_new = _chain(xa, norm, running, mask, keep, "leaky_relu")
    got, *got_new = kbn.bn_act_dropout_train(xb, norm.weight, norm.bias, *running,
                                             mask, keep, 0.2, norm.eps, BN_MOMENTUM)
    assert torch.equal(got, want)
    for a, b in zip(got_new, want_new):
        assert torch.equal(a, b)
    gw = torch.autograd.grad(want, [xa, norm.weight, norm.bias], g)
    gg = torch.autograd.grad(got, [xb, norm.weight, norm.bias], g)
    assert gg[0].dtype == torch.bfloat16
    d = (gg[0].float() - gw[0].float()).abs()
    assert torch.all(d <= 2 ** -7 * gw[0].float().abs() + 1e-5 * gw[0].float().abs().max())
    for a, b in zip(gg[1:], gw[1:]):
        assert (a - b).abs().max().item() <= 2e-5 * max(1.0, b.abs().max().item())


def test_unet_forward_train_on_the_cpu_routes_plain():
    """The gate takes card tensors only: a CPU bf16 train forward runs the
    plain chain in every block and launches nothing."""
    model = UNet(encoder_widths=(16, 32), dtype=torch.bfloat16).train()
    reset_launch_counts()
    model.forward_train(torch.rand(1, 16, 16, 4), {})
    assert set(model.routes().values()) == {"plain"}
    assert kbn.bn_act_dropout_train.launches == 0


def _storage(x, layout):
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    if layout == "offset":          # a view 2 bytes past an aligned start
        buf = torch.empty(x.numel() + 1, dtype=x.dtype)
        v = buf[1:].view(x.shape)
        v.copy_(x)
        return v
    return x.contiguous()


@pytest.mark.parametrize("layout,shape,want", [
    ("nchw", (8, 64, 64, 128), (kbn.PLANAR, 8)),
    ("nchw", (2, 16, 5, 7), (kbn.PLANAR, 1)),              # H·W not a multiple of 8
    ("channels_last", (8, 64, 64, 128), (kbn.ROWS, 8)),
    ("channels_last", (8, 1024, 16, 32), (kbn.ROWS, 8)),
    ("channels_last", (2, 12, 6, 10), (kbn.ROWS, 1)),       # C not a multiple of 8
    ("offset", (2, 16, 8, 8), (kbn.PLANAR, 1)),             # unaligned start
])
def test_plan_covers_the_walk_once(layout, shape, want):
    """The walk the wrapper asks for: NCHW contiguous → planar, channels-last
    → rows, 16 bytes a thread where the walked extent is a multiple of 8
    and the start aligned; its blocks cover the N·H·W values of a channel
    (or rows) once, every block some, in spans of whole vectors (planar)."""
    x = _storage(torch.zeros(shape, dtype=torch.bfloat16), layout)
    layout_id, vec, span, parts = kbn.plan(x)
    assert (layout_id, vec) == want
    extent = shape[0] * shape[2] * shape[3]
    assert parts * span >= extent > (parts - 1) * span
    if layout_id == kbn.PLANAR:
        assert span % vec == 0
    blocks = parts * (shape[1] if layout_id == kbn.PLANAR else 1)
    assert blocks <= max(kbn.TARGET_BLOCKS * 2, x.numel() // kbn.MIN_SPAN + shape[1])


def test_plan_refuses_other_strides():
    x = torch.zeros((2, 8, 4, 6), dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="NCHW contiguous or channels-last"):
        kbn.plan(x)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_c_entry_arguments(monkeypatch, layout, with_mask):
    """What the wrappers hand the C entries, with a stub in their place:
    pointers of x, the output in x's storage, the mask as uint8 [N, C] and
    the per-channel vectors, the sizes and walk of ``plan``, the float32
    momentum pair and the dropout's reciprocal; the backward gets the
    gradient in x's storage."""
    seen = []
    monkeypatch.setattr(kbn._build, "call", lambda name, *a: seen.append((name, a)))
    x, norm, running, mask = _case(torch.float32, 0.2 if with_mask else 0.0)
    x = _storage(x.to(torch.bfloat16), layout)
    out, stats = kbn._launch_forward(x, norm.weight.detach(), norm.bias.detach(),
                                     *running, mask, 0.8, 0.2, 1e-5, BN_MOMENTUM, 7)
    (name, a), = seen
    n, c, h, w = x.shape
    assert name == "pcss_bn_train_forward" and a[-1] == 7
    assert a[0] == x.data_ptr() and a[1] == out.data_ptr() and (a[2] != 0) == with_mask
    assert a[7] == stats.data_ptr() and stats.shape == (6, c)
    assert a[9:16] == (n, c, h * w, *kbn.plan(x))
    assert out.stride() == x.stride()
    assert a[17] == np.float32(0.9) and a[18] == np.float32(0.1)
    assert a[19] == np.float32(1.25) and a[20] == 0.2

    g = torch.ones(x.shape, dtype=torch.bfloat16)          # NCHW contiguous
    dx, _, _ = kbn._launch_backward(g, x, norm.bias.detach(), stats, mask, 0.8,
                                    0.2, 7)
    (name, b) = seen[1]
    assert name == "pcss_bn_train_backward" and b[-1] == 7
    assert b[0] == x.data_ptr() and b[2] == dx.data_ptr() and dx.stride() == x.stride()
    assert b[8:15] == (n, c, h * w, *kbn.plan(x))
    assert (b[1] == g.data_ptr()) == (layout == "nchw")    # relaid only when it differs


def test_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch):
    monkeypatch.setattr(kbn._build, "call", lambda *a: None)
    x, norm, running, _ = _case(torch.float32, 0.0)
    args = (norm.weight.detach(), norm.bias.detach(), *running)
    with pytest.raises(ValueError, match="bf16"):
        kbn._launch_forward(x, *args, None, 1.0, 0.2, 1e-5, BN_MOMENTUM, 0)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        kbn._launch_forward(xb, args[0].double(), *args[1:], None, 1.0, 0.2, 1e-5,
                            BN_MOMENTUM, 0)
    with pytest.raises(ValueError, match="mask"):
        kbn._launch_forward(xb, *args, torch.ones(SHAPE[0], SHAPE[1]), 1.0, 0.2,
                            1e-5, BN_MOMENTUM, 0)
