"""The program's spans (``utils/profiling.py::span``), on the CPU: off by
default and then one shared no-op, switched on by ``spans()`` (which
restores the previous state) and by ``trace``; the names and nesting the
engine, the NHWC and channels-major forwards and the train step give them;
and outputs that are bit for bit the same with the spans on and off."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.infer import InferenceEngine
from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
from pcss_unet_tpu_torch.models.init import seeded_variables
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.train import build_train_step, create_train_state
from pcss_unet_tpu_torch.utils import profiling

BLOCKS = ("enc_0", "enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2",
          "dec_final")
STATS = dict(means=np.array([0.1, -0.2, 0.3, 0.0], np.float32),
             stds=np.array([1.5, 0.8, 1.0, 2.0], np.float32))


def _spans(fn):
    """Run ``fn`` under the profiler; → (span, innermost enclosing span)
    pairs of every ``pcss.`` range, without the prefix."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    pairs = []
    for e in prof.events():
        if not e.name.startswith("pcss."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("pcss."):
            p = p.cpu_parent
        pairs.append((e.name[5:], None if p is None else p.name[5:]))
    return pairs


def _engine(layout, widths):
    return InferenceEngine(None, seeded_variables(widths, seed=5),
                           dtype=torch.float32, fold_bn=True, quantize="int8",
                           layout=layout, device="cpu", **STATS)


def _frames(h=64, w=128, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, h, w, 4)).astype(np.float32)


def test_span_is_one_shared_no_op_while_off():
    assert not profiling._SPANS_ON
    a, b = profiling.span("unet.enc_0"), profiling.span("step")
    assert a is b
    with a:
        pass
    with profiling.spans():
        assert profiling.span("step") is not a


def test_spans_restore_the_previous_state():
    with profiling.spans():
        with profiling.spans():
            assert profiling._SPANS_ON
        assert profiling._SPANS_ON
    assert not profiling._SPANS_ON
    with pytest.raises(RuntimeError):
        with profiling.spans():
            raise RuntimeError("inside")
    assert not profiling._SPANS_ON


def test_a_profiled_forward_has_no_program_span_by_default():
    eng = _engine("nhwc", (16, 64, 128, 1024))
    pairs = _spans(lambda: eng.render_u8(_frames()))
    assert pairs == []


@pytest.mark.parametrize("layout,widths,prep", [
    # K2' on the <=64-channel stages (5), K5 on dec_0, K6 on dec_1
    ("nhwc", (16, 64, 128, 1024), 7),
    # K2 on the <=64-channel stages and dec_1 (6), K3 on dec_0
    ("chw", (16, 32, 128, 256), 7),
])
def test_render_spans_name_each_block_and_resize(layout, widths, prep):
    eng = _engine(layout, widths)
    with profiling.spans():
        pairs = _spans(lambda: eng.render_u8(_frames()))
    count = Counter(pairs)
    want = {("engine.render_u8", None): 1, ("engine.upload", "engine.render_u8"): 1,
            ("engine.entry", "engine.render_u8"): 1,
            ("engine.exit", "engine.render_u8"): 1,
            # three decoder levels' up-2x and re-match, and the head's pair
            ("unet.resize", "engine.render_u8"): 4,
            ("unet.head", "engine.render_u8"): 1}
    want.update({(f"unet.{b}", "engine.render_u8"): 1 for b in BLOCKS})
    prep_in = Counter(p for n, p in pairs if n == "ops.weight_prep")
    assert sum(prep_in.values()) == prep
    assert set(prep_in) <= {f"unet.{b}" for b in BLOCKS}
    assert {k: v for k, v in count.items() if k[0] != "ops.weight_prep"} == want


def test_run_padded_spans_its_exit():
    eng = _engine("nhwc", (16, 64, 128, 1024))
    with profiling.spans():
        pairs = _spans(lambda: eng.run_padded(torch.from_numpy(_frames())))
    tops = [n for n, p in pairs if p is None and not n.startswith("unet.")]
    assert tops == ["engine.upload", "engine.entry", "engine.exit"]


@pytest.mark.parametrize("layout,widths", [("nhwc", (16, 64, 128, 1024)),
                                           ("chw", (16, 32, 128, 256))])
def test_render_u8_is_bit_identical_with_spans_on(layout, widths):
    eng = _engine(layout, widths)
    frames = _frames(seed=11)
    off = eng.render_u8(frames)
    with profiling.spans():
        on = eng.render_u8(frames)
    assert torch.equal(off, on)


def _train(seed=0):
    torch.manual_seed(seed)
    cfg = Config(num_epochs=4, warmup_epochs=1, loss_type="perturb",
                 perturbation_count=3, ema_decay=0.5)
    model = UNet(encoder_widths=(8, 16), dropout_rate=0.2).train()
    state = create_train_state(model, cfg, 4)
    bundle = LossBundle(perceptual=PerceptualLoss(taps=(2, 7), tap_weights=(0.5, 0.5)),
                        alpha=cfg.alpha, perturb_weight=cfg.perturb_weight,
                        perturbation_count=cfg.perturbation_count)
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), 4)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 4)).astype(np.float32))
    y = torch.from_numpy(rng.random((4, 16, 16, 1)).astype(np.float32))
    return state, step, x, y


def test_train_step_spans_name_its_phases():
    state, step, x, y = _train()
    with profiling.spans():
        pairs = _spans(lambda: step(state, x, y, torch.Generator().manual_seed(0)))
    count = Counter(pairs)
    tops = {("step", None): 1, ("step.forward", "step"): 1,
            ("loss.base", "step"): 1, ("loss.vgg", "loss.base"): 1,
            ("loss.perturb", "step"): 1, ("step.backward", "step"): 1,
            ("step.update", "step"): 1}
    tops.update({(f"step.{c}", "step.update"): 1
                 for c in ("clip", "optimizer", "commit", "metrics")})
    assert {k: v for k, v in count.items() if not k[0].startswith("unet.")} == tops
    # the main forward in step.forward, the 3 perturbed ones in loss.perturb
    for b in ("enc_0", "enc_1", "dec_0", "dec_final"):
        assert count[(f"unet.{b}", "step.forward")] == 1
        assert count[(f"unet.{b}", "loss.perturb")] == 3
    assert count[("unet.resize", "step.forward")] == 2
    assert count[("unet.resize", "loss.perturb")] == 6


def test_train_step_is_bit_identical_with_spans_on():
    runs = []
    for on in (False, True):
        state, step, x, y = _train()
        gen = torch.Generator().manual_seed(0)
        masks, draw = [], state.model.dropout_masks
        state.model.dropout_masks = lambda *a, **k: masks.append(draw(*a, **k)) or masks[-1]
        if on:
            with profiling.spans():
                m = step(state, x, y, gen)
        else:
            m = step(state, x, y, gen)
        opt = [t for v in state.opt_state.values()
               for t in (v if isinstance(v, list) else [v])]
        runs.append((masks, m["total_loss"], [p.detach().clone() for p in state.params],
                     opt, state.ema_params))
    (m0, l0, p0, o0, e0), (m1, l1, p1, o1, e1) = runs
    assert len(m0) == len(m1) == 2        # the forward's and the perturbed copies'
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert all(torch.equal(a, b) for a, b in zip(e0, e1))


def test_device_cache_batch_span_closes_before_the_yield():
    from pcss_unet_tpu_torch.data.device_cache import DeviceCache
    from pcss_unet_tpu_torch.data.pipeline import Loader

    class Frames:
        sample_hw = (8, 8)
        inputs = np.zeros((4, 8, 8, 4), np.float32)
        labels = np.zeros((4, 8, 8, 1), np.float32)

        def __len__(self):
            return 4

        def gather(self, idx):
            return self.inputs[idx], self.labels[idx]

    loader = Loader(Frames(), 2, shuffle=True, seed=0)
    cache = DeviceCache(Frames(), device="cpu")

    def consume():
        for x, _ in cache.batches(loader, 0):
            with profiling.span("consumer"):
                x.sum()

    with profiling.spans():
        pairs = _spans(consume)
    assert Counter(pairs) == {("data.batch", None): 2, ("consumer", None): 2}
