"""Data parallelism in the port (``train/step.py``'s group step,
``parallel/dp.py``, ``utils/distributed.py``, ``train --data_parallel``)
against the one-process step and the JAX package, on the CPU over gloo.

One spawn of 8 ranks (``_WORKER``, joined by ``initialize_multihost`` from
a launcher's environment, as ``--multihost`` joins) runs every group case:
world 8, then world 4 (ranks 0-3).
Each rank writes what it computed; rank 0 of each group also computes the
one-process step on the whole batch.  Meanwhile this process computes the
JAX package's sharded steps on the 8 virtual CPU devices.

Bars: against the one-process step, float64 (so that the comparison tests
semantics, not float32 noise) within 1e-9 relative on losses and 1e-8 on
parameters and statistics; against JAX, float32 at
``tests/test_sharding.py``'s and ``tests/test_dp_explicit.py``'s bars
(loss 1e-5 relative, parameters rtol 1e-4 / atol 1e-5, BatchNorm
statistics rtol 1e-4 / atol 1e-6); ZeRO-1 against the replicated explicit
step at the same bars.  The port's dropout streams are torch's, so the JAX
comparisons run with dropout 0, as the JAX tests do; the float64 group
cases keep dropout on (the masks are drawn for the whole batch and
sliced)."""

import json
import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.losses import LossBundle as JBundle
from pcss_unet_tpu.losses import PerceptualLoss as JPerceptual
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.parallel import (batch_sharding as j_batch_sharding,
                                    make_mesh as j_make_mesh,
                                    replicate_sharding as j_replicate)
from pcss_unet_tpu.parallel.dp import build_explicit_dp_train_step as j_explicit
from pcss_unet_tpu.train import build_train_step as j_build
from pcss_unet_tpu.train import create_train_state as j_create

from pcss_unet_tpu_torch.cli.train import main
from pcss_unet_tpu_torch.parallel import (batch_sharding, make_mesh,
                                          replicate_sharding,
                                          shard_train_inputs)
from pcss_unet_tpu_torch.train.step import rank_rows
from pcss_unet_tpu_torch.utils.distributed import backend_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (8, 16)
SPE = 4

_WORKER = r"""
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
from pcss_unet_tpu_torch.models.torch_import import (from_flax_variables,
                                                     to_flax_variables)
from pcss_unet_tpu_torch.models.unet import UNet, batch_norm_train
from pcss_unet_tpu_torch.parallel.dp import (build_explicit_dp_train_step,
                                             build_zero1_dp_train_step,
                                             create_zero1_state)
from pcss_unet_tpu_torch.train import build_train_step, create_train_state
from pcss_unet_tpu_torch.train.step import rank_rows
from pcss_unet_tpu_torch.utils.distributed import (host_shard_args,
                                                   initialize_multihost)

SPE = 4
root = sys.argv[1]
inp = pickle.load(open(os.path.join(root, "inputs.pkl"), "rb"))
initialize_multihost()
rank, world = dist.get_rank(), dist.get_world_size()
out = {"world": world, "shard": host_shard_args()}
loader = Loader(PackedDataset(root, "train"), 2, shuffle=True, seed=5,
                **host_shard_args())
out["idx"] = sorted(int(i) for b in loader.epoch_indices(0) for i in b)

# sync BatchNorm, forward and backward: one row per rank
x = torch.from_numpy(inp["bn_x"])
norm = torch.nn.BatchNorm2d(x.shape[1]).double()
with torch.no_grad():
    norm.weight.copy_(torch.from_numpy(inp["bn_scale"]))
    norm.bias.copy_(torch.from_numpy(inp["bn_bias"]))
running = (torch.zeros(x.shape[1], dtype=torch.float64),
           torch.ones(x.shape[1], dtype=torch.float64))
xr = x[rank:rank + 1].clone().requires_grad_()
y, new = batch_norm_train(xr, norm, running, torch.float64, dist.group.WORLD)
(y * torch.from_numpy(inp["bn_cot"][rank:rank + 1])).sum().backward()
out["bn"] = [t.detach().numpy() for t in (y, xr.grad, norm.weight.grad,
                                            norm.bias.grad, *new)]

X, Y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])


def model_for(dtype, dropout, normalization="batch_norm", widths=(8, 16)):
    torch.manual_seed(0)
    m = UNet(encoder_widths=widths, dropout_rate=dropout, dtype=dtype,
             normalization=normalization)
    if normalization == "batch_norm":
        m.load_state_dict(from_flax_variables(inp["v"], dtype))
    return m.to(dtype).train()


def bundle(alpha=0.9):
    return LossBundle(perceptual=PerceptualLoss(taps=(2,), tap_weights=(1.0,),
                                                params=inp["vgg"]), alpha=alpha)


def result(model, state, losses):
    return {"losses": losses,
            "vars": to_flax_variables(model),
            "ema": None if getattr(state, "ema_params", None) is None
            else {n: p.numpy().copy() for (n, _), p in
                  zip(model.named_parameters(), state.ema_params)},
            "step": int(state.step), "skipped": int(state.skipped_steps)}


def run(kw, group, dtype, steps, base_step=0, dropout=0.0, builder="group"):
    cfg = Config(batch_size=8, num_epochs=2, warmup_epochs=1, **kw)
    model = model_for(dtype, dropout)
    state = create_train_state(model, cfg, SPE)
    state.step.fill_(base_step)
    means, stds = np.zeros(4, np.float32), np.ones(4, np.float32)
    if builder == "explicit":
        step = build_explicit_dp_train_step(cfg, bundle(), means, stds, SPE,
                                            group)
    elif builder == "zero1":
        state = create_zero1_state(model, cfg, SPE, group)
        state.step.fill_(base_step)
        step = build_zero1_dp_train_step(cfg, bundle(), means, stds, SPE,
                                         group)
    else:
        step = build_train_step(cfg, bundle(), means, stds, SPE, group=group)
    if group is None:
        rows = np.arange(8)
    else:
        rows = rank_rows(8, dist.get_rank(group), dist.get_world_size(group),
                         max(1, cfg.grad_accum_steps))
    losses = []
    for i in range(steps):
        gen = torch.Generator().manual_seed(100 + i)
        m = step(state, X[rows].to(dtype), Y[rows].to(dtype), gen)
        losses.append(float(m["total_loss"]))
    r = result(model, state, losses)
    if builder == "zero1":
        r["chunk"] = [tuple(t.shape) for t in state.opt_state["mu"]]
        r["n_flat"] = state.n_flat
    return r


W = dist.group.WORLD
f64 = dict(optimizer_type="adamw", loss_type="standard")
out["step8"] = run(dict(loss_type="standard", dropout_rate=0.0), W,
                   torch.float32, 1)
out["step8_f64"] = run(f64, W, torch.float64, 2, base_step=SPE, dropout=0.2)
if rank == 0:
    out["single_step8_f64"] = run(f64, None, torch.float64, 2,
                                  base_step=SPE, dropout=0.2)

# fit over the 8 ranks: a stop that one rank's step_hook asks for after
# step 1 stops every rank there (the flag is all-reduced after each step)
from pcss_unet_tpu_torch.train import fit
res = fit(Config(batch_size=8, num_epochs=2, warmup_epochs=1, dropout_rate=0.0,
                 save_dir="", log_dir=os.path.join(root, "logs"),
                 device_data_cache="off"),
          model_for(torch.float32, 0.0),
          Loader(PackedDataset(root, "fit"), 8, shuffle=True, seed=5),
          install_preemption_handler=False, group=dist.group.WORLD,
          step_hook=lambda step, epoch, batch: rank == 3 and step == 1)
out["fit_stop"] = {"step": int(res.state.step),
                   "epochs": [h["epoch"] for h in res.history]}

g = dist.new_group([0, 1, 2, 3])       # every rank takes part in new_group
if rank >= 4:
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    sys.exit(0)
pert = dict(optimizer_type="adamw", loss_type="perturb", grad_accum_steps=2,
            ema_decay=0.9)
out["step4"] = run(dict(loss_type="standard", dropout_rate=0.0), g,
                   torch.float32, 1)
out["accum4"] = run(dict(loss_type="standard", dropout_rate=0.0,
                         grad_accum_steps=2), g, torch.float32, 1)
out["pert_accum4_f64"] = run(pert, g, torch.float64, 2, base_step=SPE,
                             dropout=0.2)
if rank % 4 == 0:
    out["single_pert_accum_f64"] = run(pert, None, torch.float64, 2,
                                       base_step=SPE, dropout=0.2)
out["explicit4"] = run(dict(dropout_rate=0.0), g, torch.float32, 1,
                       builder="explicit")
out["explicit4_3"] = run(dict(dropout_rate=0.0), g, torch.float32, 3,
                         builder="explicit")
out["zero1_4"] = run(dict(dropout_rate=0.0), g, torch.float32, 3,
                     builder="zero1")
out["ema4"] = run(dict(dropout_rate=0.0, ema_decay=0.9), g, torch.float32, 2,
                  builder="explicit")

# the reference's refusals; a BatchNorm net is not one (the group step
# synchronises its statistics itself)
refusals = {}
args = (bundle(), np.zeros(4, np.float32), np.ones(4, np.float32), SPE, g)
for name, build, cfg in (
        ("perturb", build_explicit_dp_train_step, Config(loss_type="perturb")),
        ("accum", build_explicit_dp_train_step, Config(grad_accum_steps=2)),
        ("batch_norm", build_explicit_dp_train_step, Config()),
        ("zero1_ema", build_zero1_dp_train_step, Config(ema_decay=0.9))):
    try:
        build(cfg, *args)
        refusals[name] = None
    except ValueError as e:
        refusals[name] = str(e)
out["refusals"] = refusals

# a group_norm net: no BatchNorm to synchronise, the step still runs
cfg = Config(batch_size=4, num_epochs=2, warmup_epochs=1, dropout_rate=0.0,
             normalization="group_norm")
m = model_for(torch.float32, 0.0, "group_norm", (16, 32))
state = create_train_state(m, cfg, SPE)
step = build_explicit_dp_train_step(cfg, bundle(), np.zeros(4, np.float32),
                                    np.ones(4, np.float32), SPE, g)
sub = dist.get_rank(g)
met = step(state, X[sub:sub + 1], Y[sub:sub + 1],
           torch.Generator().manual_seed(0))
out["group_norm4"] = {"loss": float(met["total_loss"]), "step": int(state.step)}

with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plain(tree):
    """A JAX tree as nested dicts of numpy arrays (no flax to unpickle)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def dp(tmp_path_factory, cpus):
    """Start the 8 ranks, compute the JAX references meanwhile, and return
    (per-rank results, JAX results, inputs)."""
    root = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(0)
    np.save(os.path.join(root, "train_inputs.npy"),
            rng.standard_normal((16, 8, 8, 4)).astype(np.float32))
    np.save(os.path.join(root, "train_labels.npy"),
            rng.random((16, 8, 8, 1)).astype(np.float32))
    fit_rng = np.random.default_rng(1)      # frames the full VGG can take
    np.save(os.path.join(root, "fit_inputs.npy"),
            fit_rng.standard_normal((16, 32, 32, 4)).astype(np.float32))
    np.save(os.path.join(root, "fit_labels.npy"),
            fit_rng.random((16, 32, 32, 1)).astype(np.float32))
    x = rng.standard_normal((8, 32, 32, 4)).astype(np.float32)
    y = rng.random((8, 32, 32, 1)).astype(np.float32)
    jcfg = JConfig(batch_size=8, num_epochs=2, warmup_epochs=1,
                   loss_type="standard", dropout_rate=0.0)
    model = JUNet(encoder_widths=WIDTHS, dtype=jnp.float32, dropout_rate=0.0)
    state = j_create(model, jcfg, SPE, (8, 32, 32, 4))
    variables = _plain({"params": state.params,
                        "batch_stats": state.batch_stats})
    jvgg = JPerceptual(None, taps=(2,), tap_weights=(1.0,))
    inputs = {"v": variables, "x": x, "y": y,
              "vgg": _plain(jax.device_get(jvgg.params)),
              "bn_x": rng.standard_normal((8, 6, 5, 5)),
              "bn_cot": rng.standard_normal((8, 6, 5, 5)),
              "bn_scale": rng.uniform(0.5, 1.5, 6),
              "bn_bias": rng.standard_normal(6)}
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="8",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, root], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(8)]
    try:
        ref = _jax_references(jcfg, model, state, jvgg, x, y, cpus)
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            p.kill()
    ranks = []
    for r in range(8):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref, inputs


def _jax_references(jcfg, model, state, jvgg, x, y, cpus):
    """The JAX package's sharded steps: (8, 1) and (4, 2) meshes, grad
    accumulation on (8, 1), and the explicit step on a 4-device mesh."""
    bundle = JBundle(perceptual=jvgg)
    means, stds = np.zeros(4, np.float32), np.ones(4, np.float32)
    key = jax.random.PRNGKey(0)
    out = {}

    def sharded(cfg, mesh_shape):
        step = j_build(cfg, bundle, means, stds, SPE)
        mesh = j_make_mesh(*mesh_shape, devices=cpus)
        s, m = jax.jit(step)(jax.device_put(state, j_replicate(mesh)),
                             jax.device_put(x, j_batch_sharding(mesh)),
                             jax.device_put(y, j_batch_sharding(mesh)),
                             jax.device_put(key, j_replicate(mesh)))
        return {"loss": float(m["total_loss"]),
                "params": jax.device_get(s.params),
                "batch_stats": jax.device_get(s.batch_stats)}

    out["step8"] = sharded(jcfg, (8, 1))
    out["step4"] = sharded(jcfg, (4, 2))
    out["accum8"] = sharded(jcfg.replace(grad_accum_steps=2), (8, 1))
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(cpus[:4]).reshape(4), ("data",))
    model_exp = JUNet(encoder_widths=WIDTHS, dtype=jnp.float32, dropout_rate=0.0,
                      bn_axis_name="data")
    cfg = JConfig(batch_size=8, num_epochs=2, warmup_epochs=1, dropout_rate=0.0)
    exp = j_explicit(cfg, bundle, means, stds, SPE, mesh, model_exp)
    state_exp = j_create(model_exp, cfg, SPE, (8, 32, 32, 4)).replace(
        params=state.params, batch_stats=state.batch_stats,
        opt_state=state.opt_state)
    shard = NamedSharding(mesh, P("data"))
    s, m = exp(jax.device_put(state_exp, j_replicate(mesh)),
               jax.device_put(x, shard), jax.device_put(y, shard),
               jax.device_put(key, j_replicate(mesh)))
    out["explicit4"] = {"loss": float(m["total_loss"]),
                        "params": jax.device_get(s.params),
                        "batch_stats": jax.device_get(s.batch_stats)}
    return out


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict) and not hasattr(tree, "items"):
        return {prefix: np.asarray(tree)}
    return {k: v for name, sub in tree.items()
            for k, v in _leaves(sub, f"{prefix}/{name}").items()}


def _close_trees(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys() and g
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def _pre_bn(name: str) -> bool:
    """A conv bias in front of a BatchNorm (JAX or torch name)."""
    return re.search(r"[./]conv_[ab][./]bias$", name) is not None


def _same_on_ranks(ranks, key):
    for r in ranks[1:]:
        _close_trees(r[key]["vars"], ranks[0][key]["vars"], 0, 0)
        assert r[key]["losses"] == ranks[0][key]["losses"]


# --------------------------------------------------------------- CPU cases
def test_rank_rows_interleave_microbatches():
    assert list(rank_rows(8, 1, 4)) == [2, 3]
    assert list(rank_rows(8, 1, 4, accum=2)) == [1, 5]
    got = np.concatenate([rank_rows(12, r, 3, accum=2) for r in range(3)])
    assert sorted(got) == list(range(12))
    with pytest.raises(ValueError, match="divide"):
        rank_rows(6, 0, 4)


def test_make_mesh_shapes_and_splits():
    """``tests/test_sharding.py::test_make_mesh_shapes``' arithmetic and
    errors, on devices that may repeat; the batch split and the copy."""
    cpus = ["cpu"] * 8
    assert make_mesh(-1, 2, devices=cpus).shape == {"data": 4, "spatial": 2}
    assert make_mesh(8, 1, devices=cpus).shape == {"data": 8, "spatial": 1}
    with pytest.raises(ValueError, match="needs 16"):
        make_mesh(16, 1, devices=cpus)
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(-1, 3, devices=cpus)
    mesh = make_mesh(4, 1, devices=cpus)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    xs, ys = shard_train_inputs(mesh, x, x + 1)
    assert [tuple(t.shape) for t in xs] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), x + 1)
    with pytest.raises(ValueError, match="divide"):
        batch_sharding(mesh)(x[:6])
    copies = replicate_sharding(mesh)(x)
    assert list(copies) == [torch.device("cpu")]


def test_backend_follows_the_devices():
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"   # one card, 2 ranks
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_host_shards_are_disjoint(dp):
    """``tests/test_multihost.py``'s check: every rank's shard args are its
    own, and the Loader shards are disjoint and cover the batched set."""
    ranks, _, _ = dp
    seen = set()
    for r, out in enumerate(ranks):
        assert out["world"] == 8
        assert out["shard"] == {"shard_index": r, "shard_count": 8}
        assert len(out["idx"]) == 2 and not seen & set(out["idx"])
        seen |= set(out["idx"])
    assert seen == set(range(16))


def test_sync_batch_norm_forward_and_backward(dp):
    """BatchNorm over 8 ranks of one row each ≡ BatchNorm over the whole
    batch in one process: outputs, input gradients, the scale and bias
    gradients (summed over ranks) and the running statistics."""
    from pcss_unet_tpu_torch.models.unet import batch_norm_train

    ranks, _, inp = dp
    x = torch.from_numpy(inp["bn_x"]).requires_grad_()
    norm = torch.nn.BatchNorm2d(6).double()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(inp["bn_scale"]))
        norm.bias.copy_(torch.from_numpy(inp["bn_bias"]))
    running = (torch.zeros(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64))
    y, new = batch_norm_train(x, norm, running, torch.float64)
    (y * torch.from_numpy(inp["bn_cot"])).sum().backward()
    got = [np.concatenate([r["bn"][0] for r in ranks]),
           np.concatenate([r["bn"][1] for r in ranks]),
           sum(r["bn"][2] for r in ranks), sum(r["bn"][3] for r in ranks)]
    want = [y.detach().numpy(), x.grad.numpy(), norm.weight.grad.numpy(),
            norm.bias.grad.numpy()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
    for r in ranks:
        for g, w in zip(r["bn"][4:], new):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("key,ref", [("step8", "step8"), ("step4", "step4"),
                                     ("accum4", "accum8"),
                                     ("explicit4", "explicit4")])
def test_group_step_matches_jax_sharded(dp, key, ref):
    """The group step (world 8, world 4, world 4 with accumulation) and the
    explicit builder against the JAX package's step on a mesh: the loss,
    the parameters and the global BatchNorm statistics, at the JAX tests'
    bars; every rank holds the same state."""
    ranks, jref, _ = dp
    _same_on_ranks(ranks if key == "step8" else ranks[:4], key)
    got, want = ranks[0][key], jref[ref]
    assert got["losses"][0] == pytest.approx(want["loss"], rel=1e-5)
    _close_trees(got["vars"]["params"], want["params"], 1e-4, 1e-5)
    _close_trees(got["vars"]["batch_stats"], want["batch_stats"], 1e-4, 1e-6)


@pytest.mark.parametrize("key,single", [
    ("step8_f64", "single_step8_f64"),
    ("pert_accum4_f64", "single_pert_accum_f64")])
def test_group_step_matches_one_process(dp, key, single):
    """Two float64 steps with lr > 0 and dropout 0.2 (masks drawn for the
    whole batch, each rank's rows kept): world 8 with the standard loss,
    and world 4 with the perturbation loss (noise drawn whole, the channel
    σ of the whole batch, the perturbed forwards' BatchNorm synchronised),
    2 microbatches and EMA, against one process on the whole batch, at
    ``tests/test_torch_train_step.py``'s float64 bars (the loss terms are
    float32 means on both sides: 2e-6 relative; each parameter's change
    within 1e-6 and 1e-4 of its largest element; statistics 1e-7).  The
    conv biases in front of a BatchNorm are held by the size of their
    change (< 1e-5, against changes of ~1e-4 elsewhere)."""
    ranks, _, inp = dp
    group = ranks if key == "step8_f64" else ranks[:4]
    _same_on_ranks(group, key)
    got, want = ranks[0][key], ranks[0][single]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-6)
    before = _leaves(inp["v"]["params"])
    g, w = _leaves(got["vars"]["params"]), _leaves(want["vars"]["params"])
    assert g.keys() == w.keys() == before.keys()
    assert any(np.abs(w[k] - before[k]).max() > 1e-4 for k in w)   # lr > 0
    for k in w:
        dg, dw = g[k] - before[k], w[k] - before[k]
        err = np.abs(dg - dw).max()
        if _pre_bn(k):
            # in front of a BatchNorm: a zero true gradient, so Adam moves
            # these by lr·|g|/eps on rounding noise g; held by size
            assert max(np.abs(dg).max(), np.abs(dw).max()) < 1e-5, (key, k)
            continue
        assert err <= 1e-6 and err <= 1e-4 * np.abs(dw).max() + 1e-12, \
            (key, k, err, np.abs(dw).max())
    _close_trees(got["vars"]["batch_stats"], want["vars"]["batch_stats"], 0, 1e-7)
    if want["ema"] is not None:
        assert got["ema"].keys() == want["ema"].keys()
        for k in want["ema"]:
            tol = 1e-5 if _pre_bn(k) else 1e-7
            np.testing.assert_allclose(got["ema"][k], want["ema"][k],
                                       rtol=0, atol=tol, err_msg=k)
    assert got["step"] == SPE + 2 and got["skipped"] == 0


def test_zero1_matches_replicated_explicit(dp):
    """ZeRO-1 ≡ the replicated explicit step over 3 steps; each rank keeps
    Adam's moments for one chunk of ceil(n / 4) elements."""
    ranks, _, _ = dp
    z, rep = ranks[0]["zero1_4"], ranks[0]["explicit4_3"]
    chunk = -(-z["n_flat"] // 4)
    assert z["chunk"] == [(chunk,)]
    assert z["losses"][-1] == pytest.approx(rep["losses"][-1], rel=1e-5)
    _close_trees(z["vars"]["params"], rep["vars"]["params"], 1e-4, 1e-5)
    for r in ranks[1:4]:
        _close_trees(r["zero1_4"]["vars"], z["vars"], 0, 0)


def test_a_stop_on_one_rank_stops_every_rank(dp):
    """``fit`` over 8 ranks, where rank 3's step_hook asks to stop after
    step 1 of 4: every rank stops there, in epoch 0 (a rank that went on
    would wait in the next step's collectives for ever)."""
    ranks, _, _ = dp
    assert [r["fit_stop"] for r in ranks] == [{"step": 1, "epochs": [0]}] * 8


def test_explicit_builders_refuse_what_the_reference_refuses(dp):
    refusals = dp[0][0]["refusals"]
    assert "standard loss" in refusals["perturb"]
    assert "accumulation" in refusals["accum"]
    assert refusals["batch_norm"] is None    # no sync-BN option to forget
    assert "EMA" in refusals["zero1_ema"]


def test_explicit_step_group_norm_and_ema(dp):
    """A group_norm net (no BatchNorm) runs through the explicit step, and
    ``ema_decay > 0`` keeps the EMA: after two steps, the first at lr 0
    (warmup), ema = d·θ₀ + (1 − d)·θ₂."""
    ranks, _, inp = dp
    assert np.isfinite(ranks[0]["group_norm4"]["loss"])
    assert ranks[0]["group_norm4"]["step"] == 1
    from pcss_unet_tpu_torch.models.torch_import import from_flax_variables

    out = ranks[0]["ema4"]
    p0 = from_flax_variables(inp["v"], torch.float32)
    p1 = from_flax_variables(out["vars"], torch.float32)
    assert out["ema"] and any(not np.array_equal(p0[k], p1[k]) for k in out["ema"])
    for name, e in out["ema"].items():
        np.testing.assert_allclose(e, 0.9 * p0[name].numpy() + 0.1 * p1[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


# --------------------------------------------------------------- the CLI
@pytest.fixture
def work(tmp_path, monkeypatch):
    """A tiny pack and a w4 config, as tests/test_torch_train_cli.py's."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
    y = (x.mean(axis=-1, keepdims=True) > 0).astype(np.float32)
    d = tmp_path / "d"
    d.mkdir()
    np.save(d / "train_inputs.npy", x)
    np.save(d / "train_labels.npy", y)
    np.save(d / "val_inputs.npy", x[:4])
    np.save(d / "val_labels.npy", y[:4])
    (tmp_path / "cfg.ini").write_text(
        "[base]\nbase_width=4\nbatch_size=4\nnum_epochs=2\nwarmup_epochs=1\n"
        "save_frequency=1\nlog_dir=logs\nsave_dir=ck\nprocessed_data_dir=d\n"
        "compute_dtype=float32\n")
    return tmp_path


def _ckpt_params(path):
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy() for k, v in payload["params"].items()}


def test_train_data_parallel_2_matches_1(work):
    """``train --data_parallel 2 --device cpu`` (two gloo ranks started by
    the CLI, each taking its rows of every batch) trains what
    ``--data_parallel 1`` trains: the same checkpoints, one set of them,
    the same saved metrics and parameters."""
    common = ["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
              "--loss_type", "perturb", "--num_epochs", "1"]
    one = main(common + ["--data_parallel", "1", "--save_dir", "one"])
    assert main(common + ["--data_parallel", "2", "--save_dir", "two"]) is None
    files = sorted(f for f in os.listdir(work / "two") if not f.startswith("."))
    assert files == sorted(os.listdir(work / "one"))
    assert "ckpt_0.pt" in files
    m1 = json.loads((work / "one" / "checkpoints.json").read_text())
    m2 = json.loads((work / "two" / "checkpoints.json").read_text())
    assert m1.keys() == m2.keys()
    for k in m1:
        for name, v in m1[k].items():
            assert m2[k][name] == pytest.approx(v, rel=1e-5), (k, name)
    p1, p2 = (_ckpt_params(work / d / "ckpt_0.pt") for d in ("one", "two"))
    assert p1.keys() == p2.keys()
    for k in p1:
        if _pre_bn(k):
            # in front of a BatchNorm: a zero true gradient, so Adam moves
            # these by ±lr on float32 noise, which differs with the sum
            # order; held by size, as chip_smoke's train_parity holds them
            assert np.abs(p2[k] - p1[k]).max() < 1e-3, k
            continue
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-4, atol=1e-5, err_msg=k)
    cfg2 = json.loads((work / "two" / "resolved_config.json").read_text())
    assert cfg2["data_parallel"] == 2 and len(one.history) == 1


def test_data_parallel_needs_the_devices(work):
    """More ranks than cards raises, as ``make_mesh`` does; ``cuda:K``
    shares card K."""
    from pcss_unet_tpu_torch.cli.train import _rank_devices

    assert _rank_devices("cuda:0", 2) == [torch.device("cuda:0")] * 2
    with pytest.raises(ValueError, match="needs"):
        _rank_devices("cuda", torch.cuda.device_count() + 1)


def test_multihost_needs_the_launcher(work, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        main(["--config", "cfg.ini", "--allow_random_vgg", "--device", "cpu",
              "--multihost"])
