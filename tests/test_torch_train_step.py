"""The port's train step (``pcss_unet_tpu_torch.train``) against the JAX
package's, mirroring ``tests/test_train_parity.py``, ``test_grad_accum.py``,
``test_ema.py`` and the loss cases of ``test_distill.py``.

The step parity runs both sides in float64 from the same variables (the
JAX package's init, carried across) on the same batches, dropout off, as
``test_train_parity.py`` does, so the comparison tests semantics, not
float32 noise: per-step losses within 2e-6 relative (the loss is a float32
mean on both sides), every parameter's change within 1e-6 absolute and
1e-4 of its largest element (Adam's first steps are sign-like, so
near-zero gradient coordinates carry the float32 loss's rounding), and the
BatchNorm running statistics (flax's biased variance, momentum 0.9) within
1e-7.  The conv biases in front of a BatchNorm have an exactly zero true
gradient; their changes are rounding noise of ~1e-21 on both sides and
pass the absolute bound."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.losses import LossBundle as JBundle
from pcss_unet_tpu.losses import PerceptualLoss as JPerceptual
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.train.schedule import clip_norm_for_step as j_clip
from pcss_unet_tpu.train.schedule import warmup_cosine_schedule as j_sched
from pcss_unet_tpu.train.state import TrainState as JState
from pcss_unet_tpu.train.state import make_optimizer as j_make_optimizer
from pcss_unet_tpu.train.step import build_train_step as j_build

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
from pcss_unet_tpu_torch.models.torch_import import (from_flax_variables,
                                                     to_flax_variables)
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.train import build_train_step, create_train_state
from pcss_unet_tpu_torch.train.schedule import (clip_norm_for_step,
                                                warmup_cosine_schedule)
from pcss_unet_tpu_torch.train.state import make_optimizer

WIDTHS = (8, 16, 16, 16)
SPE = 4
HW = 32


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("args", [(7e-4, 5, 200, 2), (3e-3, 1, 4, 4),
                                  (1e-3, 2, 7, 3)])
def test_schedules_match_jax(args):
    """The clip schedule and the warmup are exact; the cosine decay within
    base_lr · 2⁻²³: XLA's float32 cos and torch's differ by one ulp (of a
    value near ±1) at a few percent of arguments, and 0.5·(1 + cos) keeps
    that absolute error where the cosine nears −1."""
    steps = np.arange(0, 600)
    want = np.asarray(j_sched(*args)(steps))
    got = warmup_cosine_schedule(*args)(torch.from_numpy(steps)).numpy()
    warm = steps < max(1, args[1] * args[3])
    np.testing.assert_array_equal(got[warm], want[warm])
    assert np.all(np.abs(got - want) <= args[0] * 2.0 ** -23)
    assert float(got[0]) == 0.0                 # the first step's lr is 0
    for s in range(0, 600, 7):
        assert float(clip_norm_for_step(s, args[3], args[2])) == \
            float(j_clip(s, args[3], args[2]))
    ep = j_sched(*args, granularity="epoch")(steps)
    np.testing.assert_allclose(
        warmup_cosine_schedule(*args, granularity="epoch")(torch.from_numpy(steps)).numpy(),
        np.asarray(ep), rtol=0, atol=args[0] * 2.0 ** -23)


# ------------------------------------------------------------------ optimizer
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Four updates of each optimizer on the same gradients (a NaN among
    them: ``zero_nans``) against optax's chain, from count 0 (lr 0 under
    warmup: a zero first update) on."""
    cfg = Config(optimizer_type=kind, warmup_epochs=1, num_epochs=4)
    jcfg = JConfig(optimizer_type=kind, warmup_epochs=1, num_epochs=4)
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    tx, jtx = make_optimizer(cfg, 2), j_make_optimizer(jcfg, 2)
    tp = [torch.from_numpy(p.copy()) for p in params]
    jp = [jnp.asarray(p) for p in params]
    state, jstate = tx.init(tp), jtx.init(jp)
    for i in range(4):
        g = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        g[0][1, 2] = np.nan
        upd, state = tx.update([torch.from_numpy(a) for a in g], state, tp)
        jupd, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp)
        if i == 0:
            assert all(float(u.abs().max()) == 0.0 for u in upd)
        for u, ju in zip(upd, jupd):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5,
                                       atol=1e-9)
        tp = [p + u for p, u in zip(tp, upd)]
        jp = [p + u for p, u in zip(jp, jupd)]
    assert int(state["count"]) == 4


# ------------------------------------------------------------ step parity
def _batches(n=3, batch=2):
    rng = np.random.default_rng(42)
    xs = [rng.standard_normal((batch, HW, HW, 4)).astype(np.float32)
          for _ in range(n)]
    ys = [rng.random((batch, HW, HW, 1), dtype=np.float32) for _ in range(n)]
    return xs, ys


@pytest.fixture(scope="module")
def jax_vgg():
    j = JPerceptual(None, taps=(2,), tap_weights=(1.0,))
    return j, jax.tree.map(np.asarray, jax.device_get(j.params))


def _jax_run(jcfg, variables, xs, ys, base_step, vgg, ema=False):
    """``build_train_step`` in float64 → (losses, variables after, ema)."""
    with enable_x64():
        v = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                         variables)
        fm = JUNet(encoder_widths=WIDTHS, dropout_rate=jcfg.dropout_rate,
                   dtype=jnp.float64, param_dtype=jnp.float64,
                   remat_bottleneck=False)
        tx = j_make_optimizer(jcfg, SPE)
        state = JState(step=jnp.asarray(base_step, jnp.int32),
                       params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]),
                       skipped_steps=jnp.zeros((), jnp.int32),
                       apply_fn=fm.apply, tx=tx,
                       ema_params=(jax.tree.map(jnp.copy, v["params"])
                                   if ema else None))
        bundle = JBundle(perceptual=vgg, alpha=jcfg.alpha)
        step = jax.jit(j_build(jcfg, bundle, np.zeros(4, np.float32),
                               np.ones(4, np.float32) - 1e-8, SPE,
                               per_block_norms=False))
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(0))
            assert int(m["skipped"]) == 0
            losses.append(float(m["total_loss"]))
        out = {"params": jax.tree.map(np.asarray, state.params),
               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
        emap = None if not ema else jax.tree.map(np.asarray, state.ema_params)
    return losses, out, emap


def _port_run(cfg, variables, xs, ys, base_step, vgg_params, remat=False):
    model = UNet(encoder_widths=WIDTHS, dropout_rate=cfg.dropout_rate,
                 dtype=torch.float64, remat_bottleneck=remat).double()
    model.load_state_dict(from_flax_variables(variables, torch.float64))
    model.train()
    state = create_train_state(model, cfg, SPE)
    state.step.fill_(base_step)
    bundle = LossBundle(perceptual=PerceptualLoss(taps=(2,), tap_weights=(1.0,),
                                                  params=vgg_params),
                        alpha=cfg.alpha)
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32) - 1e-8, SPE,
                            per_block_norms=False)
    losses = []
    for x, y in zip(xs, ys):
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert int(m["skipped"]) == 0
        losses.append(float(m["total_loss"]))
    return losses, to_flax_variables(model), state


def _init_variables():
    fm = JUNet(encoder_widths=WIDTHS, dropout_rate=0.0, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    v = fm.init({"params": key, "dropout": key}, jnp.zeros((1, HW, HW, 4)), True)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), dict(v))
    # running statistics away from (0, 1), as test_train_parity.py sets them
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree.map(
        lambda a: (rng.normal(0, 0.05, a.shape) if a.mean() == 0
                   else rng.uniform(0.8, 1.2, a.shape)), v["batch_stats"])
    return v


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_same_update(v0, jv, pv):
    before = dict(_leaves(v0["params"]))
    j, p = dict(_leaves(jv["params"])), dict(_leaves(pv["params"]))
    assert set(j) == set(p)
    for name in j:
        dj, dp = j[name] - before[name], p[name] - before[name]
        err = np.abs(dp - dj).max()
        assert err <= 1e-6 and err <= 1e-4 * np.abs(dj).max() + 1e-12, \
            (name, err, np.abs(dj).max())
    js, ps = dict(_leaves(jv["batch_stats"])), dict(_leaves(pv["batch_stats"]))
    assert set(js) == set(ps)
    for name in js:
        np.testing.assert_allclose(ps[name], js[name], rtol=0, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kind,base_step,alpha", [
    ("adam", 0, 1.0), ("adam", 3 * SPE, 1.0), ("adamw", 0, 1.0),
    ("adamw", 3 * SPE, 1.0), ("sgd", 0, 1.0), ("sgd", 3 * SPE, 1.0),
    ("adamw", 3 * SPE, 0.9)])
def test_three_steps_match_jax(kind, base_step, alpha, jax_vgg):
    """3 float64 steps of the port's step against ``build_train_step``:
    losses, every parameter's change (the lr-0 first step at base_step 0,
    the decayed clip at 3·SPE) and the BatchNorm running statistics."""
    vgg, vgg_params = jax_vgg
    kw = dict(batch_size=2, num_epochs=4, warmup_epochs=1, optimizer_type=kind,
              alpha=alpha, loss_type="standard", dropout_rate=0.0)
    v0 = _init_variables()
    xs, ys = _batches()
    jl, jv, _ = _jax_run(JConfig(**kw), v0, xs, ys, base_step, vgg)
    pl, pv, _ = _port_run(Config(**kw), v0, xs, ys, base_step, vgg_params)
    np.testing.assert_allclose(pl, jl, rtol=2e-6)
    _assert_same_update(v0, jv, pv)


def test_grad_accumulation_matches_jax(jax_vgg):
    """grad_accum_steps=2 over a batch of 4: per-microbatch BatchNorm
    statistics chained through the microbatches, one update on the mean
    gradient — as the JAX package's scan."""
    vgg, vgg_params = jax_vgg
    kw = dict(batch_size=4, num_epochs=4, warmup_epochs=1, optimizer_type="adamw",
              alpha=1.0, loss_type="standard", dropout_rate=0.0,
              grad_accum_steps=2)
    v0 = _init_variables()
    xs, ys = _batches(n=2, batch=4)
    jl, jv, _ = _jax_run(JConfig(**kw), v0, xs, ys, 3 * SPE, vgg)
    pl, pv, _ = _port_run(Config(**kw), v0, xs, ys, 3 * SPE, vgg_params)
    np.testing.assert_allclose(pl, jl, rtol=2e-6)
    _assert_same_update(v0, jv, pv)


def test_ema_matches_jax(jax_vgg):
    vgg, vgg_params = jax_vgg
    kw = dict(batch_size=2, num_epochs=4, warmup_epochs=1, alpha=1.0,
              loss_type="standard", dropout_rate=0.0, ema_decay=0.9)
    v0 = _init_variables()
    xs, ys = _batches()
    _, jv, jema = _jax_run(JConfig(**kw), v0, xs, ys, 3 * SPE, vgg, ema=True)
    _, pv, state = _port_run(Config(**kw), v0, xs, ys, 3 * SPE, vgg_params)
    names = [n for n, _ in state.model.named_parameters()]
    ema = {n: e for n, e in zip(names, state.ema_params)}
    for (bn, jblock) in jema.items():
        for leaf_path, want in _leaves(jblock):
            layer, leaf = (leaf_path.split("/") + [None])[:2]
            if leaf is None:                  # the head: kernel / bias
                key = f"{bn}.{'weight' if layer == 'kernel' else 'bias'}"
            else:
                key = f"{bn}.{layer}." + {"kernel": "weight", "scale": "weight",
                                          "bias": "bias"}[leaf]
            got = ema[key].detach().numpy()
            if got.ndim == 4:
                got = got.transpose(2, 3, 1, 0)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)


# -------------------------------------------------- the port's own semantics
def _small(cfg, normalization="batch_norm", dropout=0.0, remat=False, seed=0):
    torch.manual_seed(seed)
    model = UNet(encoder_widths=(8, 16), dropout_rate=dropout,
                 normalization=normalization, remat_bottleneck=remat).train()
    state = create_train_state(model, cfg, SPE)
    bundle = LossBundle(perceptual=PerceptualLoss(taps=(2, 7), tap_weights=(0.5, 0.5)),
                        alpha=cfg.alpha, perturb_weight=cfg.perturb_weight,
                        perturbation_count=cfg.perturbation_count)
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), SPE)
    return state, step


def _batch(batch=4, hw=16, seed=7):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((batch, hw, hw, 4)).astype(np.float32)),
            torch.from_numpy(rng.random((batch, hw, hw, 1)).astype(np.float32)))


def _snapshot(state):
    return ({n: t.detach().clone() for n, t in state.model.state_dict().items()},
            {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
             for k, v in state.opt_state.items()},
            None if state.ema_params is None else [e.clone() for e in state.ema_params])


@pytest.mark.parametrize("accum,where", [(1, 0), (2, 3)])
def test_nan_batch_leaves_state_unchanged(accum, where):
    """A non-finite input (in any microbatch) → skipped = 1, and the
    parameters, BatchNorm statistics, optimizer state and EMA are the ones
    before the step; only the step and skip counters advance."""
    cfg = Config(num_epochs=4, warmup_epochs=1, grad_accum_steps=accum,
                 ema_decay=0.9, loss_type="perturb", perturbation_count=2)
    state, step = _small(cfg, dropout=0.2)
    before = _snapshot(state)
    x, y = _batch()
    x[where, 0, 0, 0] = float("nan")
    m = step(state, x, y, torch.Generator().manual_seed(0))
    assert int(m["skipped"]) == 1 and int(state.skipped_steps) == 1
    assert int(state.step) == 1
    after = _snapshot(state)
    for a, b in zip(before[0].values(), after[0].values()):
        assert torch.equal(a, b)
    for k in before[1]:
        va, vb = before[1][k], after[1][k]
        assert all(torch.equal(a, b) for a, b in zip(va, vb)) \
            if isinstance(va, list) else torch.equal(va, vb)
    assert all(torch.equal(a, b) for a, b in zip(before[2], after[2]))


def test_step_moves_state_and_reports_metrics():
    cfg = Config(num_epochs=4, warmup_epochs=1, loss_type="perturb",
                 perturbation_count=2, ema_decay=0.5)
    state, step = _small(cfg, dropout=0.2)
    stats0 = {n: b.clone() for n, b in state.model.named_buffers()
              if "running" in n}
    x, y = _batch()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):                # the first update is zero (lr 0)
        m = step(state, x, y, gen)
    assert int(m["skipped"]) == 0 and int(state.step) == 2
    assert {"l1_loss", "vgg_loss", "perturbation_loss", "total_loss",
            "grad_norm", "clip_max_norm", "skipped"} <= set(m)
    assert {k for k in m if k.startswith("grad_norm/")} == {
        f"grad_norm/{b}" for b in ("enc_0", "enc_1", "dec_0", "dec_final",
                                   "head")}
    assert float(m["perturbation_loss"]) > 0
    moved = [float((b - stats0[n]).abs().max())
             for n, b in state.model.named_buffers() if "running" in n]
    assert max(moved) > 0


def test_accum_matches_whole_batch():
    """accum 2 and 4 reproduce accum 1's update when nothing couples the
    samples (no BatchNorm, no dropout): a batch-mean loss on equal
    microbatches."""
    x, y = _batch()
    outs = {}
    for accum in (1, 2, 4):
        cfg = Config(num_epochs=4, warmup_epochs=1, normalization="none",
                     dropout_rate=0.0, grad_accum_steps=accum)
        state, step = _small(cfg, normalization="none")
        state.step.fill_(SPE)                      # past the zero first update
        state.opt_state["count"].fill_(SPE)
        m = step(state, x, y)
        outs[accum] = ([p.detach().clone() for p in state.params],
                       float(m["total_loss"]), float(m["grad_norm"]))
    p1, loss1, gn1 = outs[1]
    for accum in (2, 4):
        p, loss, gn = outs[accum]
        assert loss == pytest.approx(loss1, rel=1e-5)
        assert gn == pytest.approx(gn1, rel=1e-4)
        for a, b in zip(p, p1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-7)


def test_accum_rejects_indivisible_batch():
    cfg = Config(num_epochs=4, warmup_epochs=1, grad_accum_steps=3)
    state, step = _small(cfg)
    x, y = _batch()
    with pytest.raises(ValueError, match="grad_accum_steps"):
        step(state, x, y)


def test_remat_gradients_equal_no_remat_with_dropout():
    """The bottleneck under torch.utils.checkpoint with dropout on: the mask
    is drawn outside the checkpointed region, so the recompute applies the
    same one, and the gradients equal those without remat."""
    x, y = _batch()
    grads = {}
    for remat in (False, True):
        torch.manual_seed(3)
        model = UNet(encoder_widths=(8, 16, 16), dropout_rate=0.5,
                     remat_bottleneck=remat).train()
        masks = model.dropout_masks(4, torch.Generator().manual_seed(11), "cpu")
        assert "enc_2" in masks and not masks["enc_2"].all()
        out, _ = model.forward_train(x, masks)
        loss = (out - y).abs().mean()
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_masks_follow_the_generator():
    model = UNet(encoder_widths=(8, 16), dropout_rate=0.2)
    a = model.dropout_masks(3, torch.Generator().manual_seed(1), "cpu")
    b = model.dropout_masks(3, torch.Generator().manual_seed(1), "cpu")
    assert set(a) == {"enc_0", "enc_1", "dec_0", "dec_final"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["enc_0"].shape == (3, 16, 1, 1) and a["dec_final"].shape == (3, 8, 1, 1)


def test_perturbation_forwards_share_masks_and_discard_stats():
    """The p perturbed forwards see one set of dropout masks (identical
    outputs for identical inputs) and leave no BatchNorm update behind."""
    from pcss_unet_tpu_torch.losses.perturbation import perturbation_loss

    model = UNet(encoder_widths=(8, 16), dropout_rate=0.5).train()
    x, _ = _batch()
    masks = model.dropout_masks(4, torch.Generator().manual_seed(0), "cpu")
    seen = []

    def apply(xp):
        out = model.forward_train(xp, masks)[0]
        seen.append(out)
        return out

    zero = torch.zeros((3, *x.shape))
    base = model.forward_train(x, masks)[0]
    assert float(perturbation_loss(apply, x, base, 3, noise=zero)) == 0.0
    assert all(torch.equal(s, base) for s in seen)
    assert all(float(b.abs().sum()) in (0.0, float(b.numel()))
               for n, b in model.named_buffers() if "running" in n)


# ------------------------------------------------------------- distillation
def _distill(weight):
    torch.manual_seed(7)
    teacher = UNet(encoder_widths=(16, 32)).eval().requires_grad_(False)
    cfg = Config(batch_size=2, num_epochs=4, warmup_epochs=1, learning_rate=1e-3,
                 loss_type="standard", distill_weight=weight)
    state, _ = _small(cfg)
    bundle = LossBundle(perceptual=PerceptualLoss(taps=(2,), tap_weights=(1.0,)))
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), 4, teacher=teacher)
    return state, step, teacher


def test_distill_term_in_loss_and_metrics():
    """total = base + w·mean((out − teacher)²); the same batch with w=0
    yields exactly the base total."""
    x, y = _batch(batch=2, seed=0)
    state_w, step_w, _ = _distill(0.7)
    m_w = step_w(state_w, x, y, torch.Generator().manual_seed(0))
    state_0, step_0, _ = _distill(0.0)
    m_0 = step_0(state_0, x, y, torch.Generator().manual_seed(0))
    d = float(m_w["distill_loss"])
    assert d > 0
    np.testing.assert_allclose(float(m_w["total_loss"]),
                               float(m_0["total_loss"]) + 0.7 * d, rtol=1e-5)


def test_distill_pulls_student_toward_teacher():
    state, step, teacher = _distill(50.0)
    x, y = _batch(batch=2, seed=1)
    first = None
    for i in range(12):
        m = step(state, x, y, torch.Generator().manual_seed(i))
        first = float(m["distill_loss"]) if first is None else first
    assert float(m["distill_loss"]) < first
    assert not any(p.requires_grad for p in teacher.parameters())
