"""The port's copy of the reference's torch ground truth
(``pcss_unet_tpu_torch.parity.unet_torch`` / ``vgg_torch``) against the
JAX package's, on the CPU: the same U-Net state dict under one torch seed,
and the port's plain ``UNet`` through ``models.torch_import`` against it
at PSNR > 50 dB (``tests/test_model_parity.py``'s bar); the same VGG-19
tower, conversion, loss and tap activations."""

import numpy as np
import pytest
import torch

from pcss_unet_tpu.parity import unet_torch as junet_torch
from pcss_unet_tpu.parity import vgg_torch as jvgg_torch
from pcss_unet_tpu_torch.models.torch_import import convert_torch_state_dict
from pcss_unet_tpu_torch.models.unet import unet_for_variables
from pcss_unet_tpu_torch.models.vgg import DEFAULT_TAPS, VGG19_CONVS
from pcss_unet_tpu_torch.parity import (build_vgg19_features_torch,
                                        convert_features_module,
                                        load_features_npz_into_torch,
                                        make_torch_reference,
                                        reference_vgg_loss_torch,
                                        torch_tap_activations)
from pcss_unet_tpu_torch.parity.vgg_torch import N_FEATURE_LAYERS


def _seeded(make):
    """``make()`` under torch seed 0 with non-trivial BatchNorm statistics
    (``tests/test_model_parity.py``'s fixture)."""
    torch.manual_seed(0)
    m = make()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.05)
                mod.running_var.uniform_(0.8, 1.2)
    return m.eval()


@pytest.fixture(scope="module")
def reference():
    return _seeded(make_torch_reference)


def test_state_dict_equals_the_reference_copy(reference):
    want = _seeded(junet_torch.make_torch_reference).state_dict()
    got = reference.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_unet_through_torch_import_matches(reference, rng, hw):
    state = {k: v.numpy() for k, v in reference.state_dict().items()}
    model = unet_for_variables(convert_torch_state_dict(state), device="cpu")
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    with torch.inference_mode():
        ref = reference(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ours = model(torch.from_numpy(x))
    mse = float(((ours - ref) ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 50, f"PSNR {psnr:.1f} dB below parity threshold (mse={mse:.2e})"


def test_vgg_tower_matches_the_reference():
    seq = build_vgg19_features_torch()
    jseq = jvgg_torch.build_vgg19_features_torch()
    assert len(seq) == len(jseq) == N_FEATURE_LAYERS == jvgg_torch.N_FEATURE_LAYERS
    assert [type(a) for a in seq] == [type(b) for b in jseq]
    convs = dict(VGG19_CONVS)
    for idx, layer in enumerate(seq):
        if idx in convs:
            assert layer.out_channels == convs[idx] == jseq[idx].out_channels


def test_vgg_conversion_loss_and_taps_match_the_reference():
    torch.manual_seed(0)
    seq = build_vgg19_features_torch().eval()
    got, want = convert_features_module(seq), jvgg_torch.convert_features_module(seq)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = build_vgg19_features_torch().eval()
    load_features_npz_into_torch(back, got)
    for a, b in zip(seq.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(1)
    out = rng.random((1, 32, 32, 1)).astype(np.float32)
    out[0, 0, 0, 0] = np.nan
    target = rng.random((1, 32, 32, 1)).astype(np.float32)
    assert reference_vgg_loss_torch(seq, out, target) == \
        jvgg_torch.reference_vgg_loss_torch(seq, out, target)
    x = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    for a, b in zip(torch_tap_activations(seq, x, DEFAULT_TAPS),
                    jvgg_torch.torch_tap_activations(seq, x, DEFAULT_TAPS)):
        np.testing.assert_array_equal(a, b)
