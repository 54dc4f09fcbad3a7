"""Row-sharded training in the port (``parallel/spatial.py``, the halo
exchange of ``utils/distributed.py``, the row context of the UNet, the VGG
tower, the losses, the steps and ``fit``) against the unsharded port and
the JAX package's (data × spatial) steps, on the CPU over gloo.

One spawn of 8 ranks (``_WORKER``, joined from a launcher's environment as
``--multihost`` joins) runs every grid:

- 1×8 (all ranks, 4 rows of a 32-row frame each): the halo exchange under
  3×3 convs of dilation 1, 2 and 4;
- 1×2 (four independent pairs) and 1×4 (two quads): the UNet's train
  forward, BatchNorm statistics and gradients (group and instance norm
  nets on the pairs too); on the pairs, every loss term on 16-row shards
  of 32-row frames (the VGG tower's 4 pools);
- 4×2 (all ranks, rank r at cell (r // 2, r % 2)): the same forwards, the
  train step against the JAX package's step, the float64 step with the
  perturbation loss, accumulation, EMA and dropout, and with distillation
  and every extra loss term, against one process; the eval step; ``fit``
  (its logged validation frame too).

Meanwhile this process computes the JAX package's sharded steps on the 8
virtual CPU devices (the (4, 2) mesh of ``tests/test_sharding.py``).  Bars:
against JAX, ``tests/test_sharding.py``'s (loss 1e-5 relative, parameters
rtol 1e-4 / atol 1e-5, statistics rtol 1e-4 / atol 1e-6; the eval step's
output 1e-5 / 1e-6); against one process in float64,
``tests/test_torch_dp.py``'s; the forward in float64 within 1e-10; the loss
terms, float32 by construction, within 1e-5 of their scale."""

import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.losses import LossBundle as JBundle
from pcss_unet_tpu.losses import PerceptualLoss as JPerceptual
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.parallel import (batch_sharding as j_batch_sharding,
                                    make_mesh as j_make_mesh,
                                    replicate_sharding as j_replicate)
from pcss_unet_tpu.train import build_eval_step as j_build_eval
from pcss_unet_tpu.train import build_train_step as j_build
from pcss_unet_tpu.train import create_train_state as j_create

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.losses import (LossBundle, PerceptualLoss,
                                        high_freq_loss, penumbra_weighted_l1,
                                        sobel_gradient_loss, ssim_loss)
from pcss_unet_tpu_torch.models.torch_import import from_flax_variables
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.models.vgg import init_vgg_params
from pcss_unet_tpu_torch.parallel import make_mesh, shard_train_inputs
from pcss_unet_tpu_torch.parallel.dp import (build_explicit_dp_train_step,
                                             build_zero1_dp_train_step)
from pcss_unet_tpu_torch.parallel.spatial import (check_config_rows,
                                                  check_row_split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE = 4

_WORKER = r"""
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
from pcss_unet_tpu_torch.losses import (LossBundle, PerceptualLoss,
                                        high_freq_loss, penumbra_weighted_l1,
                                        sobel_gradient_loss, ssim_loss)
from pcss_unet_tpu_torch.models.torch_import import (from_flax_variables,
                                                     to_flax_variables)
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.parallel.spatial import conv2d_rows, row_shard
from pcss_unet_tpu_torch.train import (build_eval_step, build_train_step,
                                       create_train_state, fit)
from pcss_unet_tpu_torch.train.step import rank_rows
from pcss_unet_tpu_torch.utils.distributed import (grid_coords,
                                                   initialize_multihost)

SPE = 4
root = sys.argv[1]
inp = pickle.load(open(os.path.join(root, "inputs.pkl"), "rb"))
initialize_multihost()
rank = dist.get_rank()
W = dist.group.WORLD
# every rank creates every group, in one order
pair = [dist.new_group([2 * k, 2 * k + 1]) for k in range(4)][rank // 2]
quad = [dist.new_group(list(range(4 * k, 4 * k + 4))) for k in range(2)][rank // 4]
grid = row_shard(W, 2)                 # (4, 2): a spatial group per data index
d, s = grid_coords(W, 2)
out = {"cell": (d, s), "grid_index": grid.index}


def part(t, samples, n, i, dim=1):
    # samples, then rows [i·h, (i+1)·h) of n shards on dim
    t = t[samples]
    h = t.shape[dim] // n
    return t.narrow(dim, i * h, h)


# the halo exchange: 3x3 convs of a 32-row frame on 1x8 (4 rows a rank)
rows8 = row_shard(W, 8)
hx = torch.from_numpy(inp["halo_x"])
out["halo"] = {}
for dil in (1, 2, 4):
    w = torch.from_numpy(inp["halo_w"]).requires_grad_()
    xs = part(hx, slice(None), 8, rank, dim=2).clone().requires_grad_()
    yv = conv2d_rows(xs, w, None, rows8, (dil, dil), dil)
    cot = part(torch.from_numpy(inp["halo_cot"]), slice(None), 8, rank, dim=2)
    (yv * cot).sum().backward()
    out["halo"][dil] = (yv.detach().numpy(), xs.grad.numpy(), w.grad.numpy())

X, Y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])


def model_for(dtype, dropout=0.0):
    m = UNet(encoder_widths=(8, 16), dropout_rate=dropout, dtype=dtype)
    m.load_state_dict(from_flax_variables(inp["v"], dtype))
    return m.to(dtype).train()


# the UNet's train forward, BatchNorm statistics and gradients
out["unet"] = {}
for name, group, n, samples in (
        ("1x2", pair, 2, slice(None)), ("1x4", quad, 4, slice(None)),
        ("4x2", W, 2, slice(2 * d, 2 * d + 2))):
    rows = grid if name == "4x2" else row_shard(group, n)
    m = model_for(torch.float64)
    i = rows.index
    o, st = m.forward_train(part(X, samples, n, i).double(), None, None,
                            group=group, rows=rows)
    cot = part(torch.from_numpy(inp["cot"]), samples, n, i)
    g = torch.autograd.grad((o * cot).sum(), list(m.parameters()))
    out["unet"][name] = (o.detach().numpy(), {k: v.numpy() for k, v in st.items()},
                         [t.numpy() for t in g])

# group and instance norms: each sample's statistics over the frame
out["norms"] = {}
for norm in ("group_norm", "instance_norm"):
    for name, group, n, samples in (("1x2", pair, 2, slice(None)),
                                    ("4x2", W, 2, slice(2 * d, 2 * d + 2))):
        rows = grid if name == "4x2" else row_shard(group, n)
        torch.manual_seed(3)
        m = UNet(encoder_widths=(16, 32), normalization=norm,
                 dtype=torch.float64).double().train()
        xs = part(X, samples, n, rows.index).double()
        o, _ = m.forward_train(xs, None, None, group=group, rows=rows)
        cot = part(torch.from_numpy(inp["cot"]), samples, n, rows.index)
        g = torch.autograd.grad((o * cot).sum(), list(m.parameters()))
        with torch.no_grad():
            ev = m.eval()(xs, rows=rows)
        out["norms"][norm, name] = (o.detach().numpy(), [t.numpy() for t in g],
                                    ev.numpy())

# every loss term on 16-row shards of 32-row frames, on the pairs
i = rank % 2
O = torch.from_numpy(inp["o"])
o = part(O, slice(None), 2, i).clone().requires_grad_()
t = part(Y, slice(None), 2, i)
rows2 = row_shard(pair, 2)
vgg = PerceptualLoss(params=inp["vgg_all"], grad=True)
terms = {"vgg": lambda: vgg(o, t, rows2),
         "high_freq": lambda: high_freq_loss(o, t, rows=rows2),
         "sobel": lambda: sobel_gradient_loss(o, t, rows2),
         "ssim": lambda: ssim_loss(o, t, rows=rows2, group=pair),
         "penumbra": lambda: penumbra_weighted_l1(o, t, group=pair)}
out["terms"] = {}
for k, fn in terms.items():
    v = fn()
    out["terms"][k] = (float(v.detach()), torch.autograd.grad(v, o)[0].numpy())


def run(kw, group, rows, dtype, steps, base_step=0, dropout=0.0, bundle=None,
        teacher=None):
    cfg = Config(batch_size=8, num_epochs=2, warmup_epochs=1, **kw)
    model = model_for(dtype, dropout)
    state = create_train_state(model, cfg, SPE)
    state.step.fill_(base_step)
    bundle = bundle or LossBundle(perceptual=PerceptualLoss(
        taps=(2,), tap_weights=(1.0,), params=inp["vgg"]))
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), SPE, teacher=teacher,
                            group=group, rows=rows)
    accum = max(1, cfg.grad_accum_steps)
    samples = np.arange(8) if group is None else rank_rows(8, d, 4, accum)
    n, i = (1, 0) if rows is None else (rows.count, rows.index)
    losses = []
    for k in range(steps):
        gen = torch.Generator().manual_seed(100 + k)
        m = step(state, part(X, samples, n, i).to(dtype),
                 part(Y, samples, n, i).to(dtype), gen)
        losses.append(float(m["total_loss"]))
    return {"losses": losses, "vars": to_flax_variables(model),
            "ema": None if state.ema_params is None
            else {nm: p.numpy().copy() for (nm, _), p in
                  zip(model.named_parameters(), state.ema_params)},
            "step": int(state.step), "skipped": int(state.skipped_steps)}


out["step"] = run(dict(loss_type="standard", dropout_rate=0.0), W, grid,
                  torch.float32, 1)
pert = dict(optimizer_type="adamw", loss_type="perturb", grad_accum_steps=2,
            ema_decay=0.9)
torch.manual_seed(1)
teacher = UNet(encoder_widths=(8, 16), dtype=torch.float64).double().eval()
teacher.requires_grad_(False)
extras = dict(perceptual=PerceptualLoss(params=inp["vgg_all"], grad=True),
              high_freq_weight=0.5, sobel_weight=0.1, ssim_weight=0.5,
              penumbra_weight=0.5)
distill = dict(optimizer_type="adamw", loss_type="standard", distill_weight=2.0)
for key, kw, extra in (("pert", pert, {}),
                       ("distill", distill,
                        dict(bundle=LossBundle(**extras), teacher=teacher))):
    out[key] = run(kw, W, grid, torch.float64, 2, SPE, 0.2, **extra)
    if rank == 0:
        out["single_" + key] = run(kw, None, None, torch.float64, 2, SPE, 0.2,
                                   **extra)

# the eval step on the grid: every rank its rows of its samples
m = model_for(torch.float32)
ev = build_eval_step(Config(batch_size=8, dropout_rate=0.0),
                     LossBundle(perceptual=PerceptualLoss(
                         taps=(2,), tap_weights=(1.0,), params=inp["vgg"])),
                     np.zeros(4, np.float32), np.ones(4, np.float32),
                     group=W, rows=grid)
samples = slice(2 * d, 2 * d + 2)
ev_terms, ev_out = ev(m, part(X, samples, 2, s), part(Y, samples, 2, s))
out["eval"] = ({k: float(v) for k, v in ev_terms.items()}, ev_out.numpy())

class NoWriter:
    # metrics go nowhere (the TensorBoard writer's import costs seconds);
    # the images are kept
    def __init__(self):
        self.images = {}

    def image(self, tag, img, step):
        self.images[tag, step] = img

    def __getattr__(self, name):
        return lambda *a, **k: None


# fit on the (4, 2) grid, tests/test_fit.py::test_fit_multidevice's run,
# with a validation set (validated on the grid)
def fit_run(group):
    cfg = Config(batch_size=8, num_epochs=2, warmup_epochs=1,
                 learning_rate=3e-3, validation_frequency=1, dropout_rate=0.0,
                 data_parallel=4 if group else 1,
                 spatial_parallel=2 if group else 1, resume=False,
                 save_dir="", log_dir=os.path.join(root, f"logs{rank}"),
                 device_data_cache="off")
    model = UNet(encoder_widths=(8, 16), dropout_rate=0.0,
                 dtype=torch.float64)
    model.load_state_dict(from_flax_variables(inp["v"], torch.float64))
    writer = NoWriter()
    res = fit(cfg, model.double(),
              Loader(PackedDataset(root, "fit"), 8, shuffle=True, seed=0),
              Loader(PackedDataset(root, "val"), 4, shuffle=False),
              install_preemption_handler=False, log_every=1, group=group,
              writer=writer)
    return ([(h["train"]["total_loss"], h["val"]["total_loss"])
             for h in res.history], writer.images)


out["fit"], out["fit_images"] = fit_run(W)
if rank == 0:
    out["single_fit"], out["single_fit_images"] = fit_run(None)

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


def _leaves(tree, prefix=""):
    if not hasattr(tree, "items"):
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


@pytest.fixture(scope="module")
def grid(tmp_path_factory, cpus):
    """Start the 8 ranks, compute the JAX references meanwhile, and return
    (per-rank results, JAX results, inputs)."""
    root = str(tmp_path_factory.mktemp("spatial"))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 4)).astype(np.float32)
    y = rng.random((8, 32, 32, 1)).astype(np.float32)
    fit_rng = np.random.default_rng(1)
    for split, n in (("fit", 8), ("val", 4)):
        np.save(os.path.join(root, f"{split}_inputs.npy"),
                fit_rng.standard_normal((n, 32, 32, 4)).astype(np.float32))
        np.save(os.path.join(root, f"{split}_labels.npy"),
                fit_rng.random((n, 32, 32, 1)).astype(np.float32))
    jcfg = JConfig(batch_size=8, num_epochs=2, warmup_epochs=1,
                   loss_type="standard", dropout_rate=0.0)
    model = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    state = j_create(model, jcfg, SPE, (8, 32, 32, 4))
    jvgg = JPerceptual(None, taps=(2,), tap_weights=(1.0,))
    inputs = {"v": _plain({"params": state.params,
                           "batch_stats": state.batch_stats}),
              "x": x, "y": y, "o": rng.random((8, 32, 32, 1)).astype(np.float32),
              "cot": rng.standard_normal((8, 32, 32, 1)),
              "vgg": _plain(jax.device_get(jvgg.params)),
              "vgg_all": init_vgg_params(),
              "halo_x": rng.standard_normal((2, 3, 32, 5)),
              "halo_w": rng.standard_normal((4, 3, 3, 3)),
              "halo_cot": rng.standard_normal((2, 4, 32, 5))}
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
        ref = _jax_references(jcfg, state, jvgg, x, y, cpus)
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


def _jax_references(jcfg, state, jvgg, x, y, cpus):
    """The JAX package's train and eval steps on the (4, 2) mesh of
    ``tests/test_sharding.py``."""
    bundle = JBundle(perceptual=jvgg)
    means, stds = np.zeros(4, np.float32), np.ones(4, np.float32)
    mesh = j_make_mesh(4, 2, devices=cpus)
    repl, shard = j_replicate(mesh), j_batch_sharding(mesh)
    state_sh = jax.device_put(state, repl)
    xs, ys = jax.device_put(x, shard), jax.device_put(y, shard)
    s, m = jax.jit(j_build(jcfg, bundle, means, stds, SPE))(
        state_sh, xs, ys, jax.device_put(jax.random.PRNGKey(0), repl))
    terms, out = jax.jit(j_build_eval(JConfig(batch_size=8, dropout_rate=0.0),
                                      bundle, means, stds))(state_sh, xs, ys)
    return {"step": {"loss": float(m["total_loss"]),
                     "params": jax.device_get(s.params),
                     "batch_stats": jax.device_get(s.batch_stats)},
            "eval": {"total_loss": float(terms["total_loss"]),
                     "out": np.asarray(out)}}


def _model64(inp):
    m = UNet(encoder_widths=(8, 16), dropout_rate=0.0, dtype=torch.float64)
    m.load_state_dict(from_flax_variables(inp["v"], torch.float64))
    return m.double().train()


# --------------------------------------------------------------- no ranks
def test_misaligned_heights_are_refused():
    """A shard height that is not a multiple of max(2^depth, 2^VGG pools),
    or a halo taller than a shard, is refused at start, naming it."""
    assert check_row_split(1024, 8, 4, vgg_pools=4) == 128
    assert check_row_split(32, 4, 2) == 8
    with pytest.raises(ValueError, match=r"row alignment 16 .*max\(16, 16\)"):
        check_row_split(1000, 2, 4, vgg_pools=4)
    with pytest.raises(ValueError, match=r"row alignment 16 .*max\(4, 16\)"):
        check_row_split(32, 4, 2, vgg_pools=4)
    with pytest.raises(ValueError, match="SSIM"):
        check_row_split(32, 4, 2, ssim=True)
    with pytest.raises(ValueError, match="dilation"):
        check_row_split(64, 4, 4, apply_dilation=True)


def test_a_deeper_teacher_is_refused():
    """The distillation teacher runs on the shards too: a teacher deeper
    than the model raises the row alignment, from the config (the CLI's
    check before any rank starts) or from the built nets (``fit``'s)."""
    cfg = Config(spatial_parallel=2, model_depth=4, distill_teacher="t.pt",
                 distill_teacher_depth=5)
    assert check_config_rows(cfg.replace(distill_teacher=""), 32) == 16
    with pytest.raises(ValueError, match=r"row alignment 32 .*teacher: depth 5"):
        check_config_rows(cfg, 32)
    assert check_config_rows(cfg, 64) == 32
    student = UNet(encoder_widths=(8, 16, 32, 64))
    teacher = UNet(encoder_widths=(8, 8, 16, 32, 64))
    assert check_config_rows(cfg, 32, (student, None)) == 16
    with pytest.raises(ValueError, match=r"row alignment 32 .*teacher: depth 5"):
        check_config_rows(cfg, 32, (student, teacher))


def test_explicit_builders_refuse_a_grid():
    """The explicit and ZeRO-1 builders are pure data parallel, as the
    reference's: a grid with spatial_parallel > 1 is refused."""
    bundle = LossBundle(perceptual=PerceptualLoss(
        taps=(2,), tap_weights=(1.0,), params=init_vgg_params(taps=(2,))))
    args = (bundle, np.zeros(4, np.float32), np.ones(4, np.float32), SPE, None)
    for build in (build_explicit_dp_train_step, build_zero1_dp_train_step):
        with pytest.raises(ValueError, match="pure data parallel"):
            build(Config(spatial_parallel=2), *args)


def test_batch_sharding_splits_rows():
    """``shard_train_inputs`` on a (4, 2) mesh: one block per cell in rank
    order, samples by data index and rows by spatial index; with spatial 1
    one block of samples per data index."""
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    xs, ys = shard_train_inputs(make_mesh(4, 2, devices=["cpu"] * 8), x, x + 1)
    assert len(xs) == 8 and all(tuple(t.shape) == (2, 2, 3) for t in xs)
    for r, t in enumerate(xs):
        d, s = divmod(r, 2)
        np.testing.assert_array_equal(t.numpy(), x[2 * d:2 * d + 2, 2 * s:2 * s + 2])
    np.testing.assert_array_equal(ys[5].numpy(), xs[5].numpy() + 1)
    flat, _ = shard_train_inputs(make_mesh(4, 1, devices=["cpu"] * 4), x, x)
    assert [tuple(t.shape) for t in flat] == [(2, 4, 3)] * 4
    with pytest.raises(ValueError, match="height 4 does not divide"):
        shard_train_inputs(make_mesh(1, 3, devices=["cpu"] * 3), x, x)


# --------------------------------------------------------------- the ranks
def test_grid_cells_follow_make_mesh(grid):
    ranks, _, _ = grid
    assert [r["cell"] for r in ranks] == [divmod(r, 2) for r in range(8)]
    assert [r["grid_index"] for r in ranks] == [r % 2 for r in range(8)]


@pytest.mark.parametrize("dil", [1, 2, 4])
def test_halo_exchange_matches_the_unsharded_conv(grid, dil):
    """A 3×3 conv of dilation ``dil`` on 8 shards of 4 rows, its halos
    exchanged: the frame's output, input gradient (the halo rows'
    gradients added back into the neighbours' edge rows) and weight
    gradient (summed over shards), float64."""
    ranks, _, inp = grid
    x = torch.from_numpy(inp["halo_x"]).requires_grad_()
    w = torch.from_numpy(inp["halo_w"]).requires_grad_()
    y = F.conv2d(x, w, padding=dil, dilation=dil)
    (y * torch.from_numpy(inp["halo_cot"])).sum().backward()
    got = [r["halo"][dil] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got], 2),
                               y.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([g[1] for g in got], 2),
                               x.grad.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sum(g[2] for g in got), w.grad.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,groups,n", [("1x2", 4, 2), ("1x4", 2, 4),
                                           ("4x2", 1, 2)])
def test_unet_train_forward_on_row_shards(grid, name, groups, n):
    """The UNet's train forward on row shards, float64: each grid's output
    rows are the one-process forward's, its BatchNorm statistics the whole
    batch's, and its parameter gradients (summed over the grid's ranks) the
    whole batch's, within 1e-10; every independent grid agrees."""
    ranks, _, inp = grid
    m = _model64(inp)
    x = torch.from_numpy(inp["x"]).double()
    o, st = m.forward_train(x)
    g = torch.autograd.grad((o * torch.from_numpy(inp["cot"])).sum(),
                            list(m.parameters()))
    size = len(ranks) // groups
    for k in range(groups):
        mine = [r["unet"][name] for r in ranks[k * size:(k + 1) * size]]
        if name == "4x2":
            rows = [np.concatenate([mine[2 * dd][0], mine[2 * dd + 1][0]], 1)
                    for dd in range(4)]
            got = np.concatenate(rows, 0)
        else:
            got = np.concatenate([r[0] for r in mine], 1)
        np.testing.assert_allclose(got, o.detach().numpy(), rtol=1e-10, atol=1e-12)
        for r in mine:
            for key, v in st.items():
                np.testing.assert_allclose(r[1][key], v.numpy(), rtol=1e-10,
                                           atol=1e-12, err_msg=key)
        for (pname, _), want, *gs in zip(m.named_parameters(), g,
                                         *[r[2] for r in mine]):
            np.testing.assert_allclose(sum(gs), want.numpy(), rtol=1e-9,
                                       atol=1e-12 if _pre_bn(pname) else 1e-11,
                                       err_msg=pname)


@pytest.mark.parametrize("norm", ["group_norm", "instance_norm"])
@pytest.mark.parametrize("name,groups", [("1x2", 4), ("4x2", 1)])
def test_group_norms_on_row_shards(grid, norm, name, groups):
    """A group or instance norm net on row shards, float64: each sample's
    statistics are the whole frame's, so every grid's train forward, its
    parameter gradients (summed over the grid's ranks) and its eval forward
    are one process's, within 1e-10."""
    ranks, _, inp = grid
    torch.manual_seed(3)
    m = UNet(encoder_widths=(16, 32), normalization=norm,
             dtype=torch.float64).double().train()
    x = torch.from_numpy(inp["x"]).double()
    o, _ = m.forward_train(x)
    g = torch.autograd.grad((o * torch.from_numpy(inp["cot"])).sum(),
                            list(m.parameters()))
    with torch.no_grad():
        ev = m.eval()(x)
    size = len(ranks) // groups
    for k in range(groups):
        mine = [r["norms"][norm, name] for r in ranks[k * size:(k + 1) * size]]
        for j, want in ((0, o.detach()), (2, ev)):
            if name == "4x2":
                got = np.concatenate([np.concatenate([mine[2 * dd][j],
                                                      mine[2 * dd + 1][j]], 1)
                                      for dd in range(4)], 0)
            else:
                got = np.concatenate([r[j] for r in mine], 1)
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-12)
        for (pname, _), want, *gs in zip(m.named_parameters(), g,
                                         *[r[1] for r in mine]):
            np.testing.assert_allclose(sum(gs), want.numpy(), rtol=1e-9,
                                       atol=1e-11, err_msg=pname)


@pytest.mark.parametrize("term", ["vgg", "high_freq", "sobel", "ssim",
                                  "penumbra"])
def test_loss_terms_on_row_shards(grid, term):
    """Each loss term on 16-row shards of 32-row frames (pairs of ranks)
    against the whole frame: the value (the shards' mean; SSIM and the
    penumbra ratio the grid's sums) and the gradient (the shards' halves,
    over the 2 shards).  VGG with all 5 taps and its gradient on: the 32-row
    frame takes the tower's 4 pools, each shard's 16 rows come down to 1."""
    ranks, _, inp = grid
    o = torch.from_numpy(inp["o"]).requires_grad_()
    t = torch.from_numpy(inp["y"])
    fn = {"vgg": PerceptualLoss(params=inp["vgg_all"], grad=True),
          "high_freq": high_freq_loss, "sobel": sobel_gradient_loss,
          "ssim": ssim_loss, "penumbra": penumbra_weighted_l1}[term]
    want = fn(o, t)
    gw = torch.autograd.grad(want, o)[0].numpy()
    want = float(want.detach())
    for k in range(4):
        pair = [r["terms"][term] for r in ranks[2 * k:2 * k + 2]]
        assert np.mean([v for v, _ in pair]) == pytest.approx(want, rel=1e-5)
        got = np.concatenate([g for _, g in pair], 1) / 2
        np.testing.assert_allclose(got, gw, rtol=0,
                                   atol=1e-5 * np.abs(gw).max() + 1e-12)


def test_grid_step_matches_jax_sharded(grid):
    """The port's step on the (4, 2) grid against the JAX package's step
    on the (4, 2) mesh (``tests/test_sharding.py``'s case and bars); every
    rank holds the same state."""
    ranks, jref, _ = grid
    for r in ranks[1:]:
        _close_trees(r["step"]["vars"], ranks[0]["step"]["vars"], 0, 0)
    got, want = ranks[0]["step"], jref["step"]
    assert got["losses"][0] == pytest.approx(want["loss"], rel=1e-5)
    _close_trees(got["vars"]["params"], want["params"], 1e-4, 1e-5)
    _close_trees(got["vars"]["batch_stats"], want["batch_stats"], 1e-4, 1e-6)


@pytest.mark.parametrize("key", ["pert", "distill"])
def test_grid_step_matches_one_process(grid, key):
    """Two float64 steps with lr > 0 and dropout 0.2 on the (4, 2) grid
    against one process on the whole batch: ``pert`` with the perturbation
    loss, 2 microbatches and EMA; ``distill`` with a teacher, every extra
    term (high-frequency, Sobel, SSIM, penumbra) and the VGG tower's 5 taps
    with gradients.  ``tests/test_torch_dp.py``'s float64 bars: losses 2e-6
    relative, each parameter's change within 1e-6 and 1e-4 of its largest,
    statistics 1e-7, the pre-BN conv biases by size."""
    ranks, _, inp = grid
    for r in ranks[1:]:
        _close_trees(r[key]["vars"], ranks[0][key]["vars"], 0, 0)
        assert r[key]["losses"] == ranks[0][key]["losses"]
    got, want = ranks[0][key], ranks[0]["single_" + key]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-6)
    before = _leaves(inp["v"]["params"])
    g, w = _leaves(got["vars"]["params"]), _leaves(want["vars"]["params"])
    assert g.keys() == w.keys() == before.keys()
    assert any(np.abs(w[k] - before[k]).max() > 1e-4 for k in w)   # lr > 0
    for k in w:
        dg, dw = g[k] - before[k], w[k] - before[k]
        if _pre_bn(k):
            assert max(np.abs(dg).max(), np.abs(dw).max()) < 1e-5, k
            continue
        err = np.abs(dg - dw).max()
        assert err <= 1e-6 and err <= 1e-4 * np.abs(dw).max() + 1e-12, \
            (k, err, np.abs(dw).max())
    _close_trees(got["vars"]["batch_stats"], want["vars"]["batch_stats"], 0, 1e-7)
    if want["ema"] is not None:
        for k in want["ema"]:
            np.testing.assert_allclose(got["ema"][k], want["ema"][k], rtol=0,
                                       atol=1e-5 if _pre_bn(k) else 1e-7,
                                       err_msg=k)
    assert got["step"] == SPE + 2 and got["skipped"] == 0


def test_grid_eval_step_matches_jax(grid):
    """The eval step on the (4, 2) grid (every rank its rows of its
    samples, the terms averaged over the grid) against the JAX package's
    on the (4, 2) mesh (``tests/test_sharding.py::test_sharded_eval_step``'s
    bars): the gathered output and the total loss, the same on every rank."""
    ranks, jref, _ = grid
    totals = {r["eval"][0]["total_loss"] for r in ranks}
    assert len(totals) == 1
    assert totals.pop() == pytest.approx(jref["eval"]["total_loss"], rel=1e-5)
    rows = [np.concatenate([ranks[2 * d]["eval"][1], ranks[2 * d + 1]["eval"][1]], 1)
            for d in range(4)]
    np.testing.assert_allclose(np.concatenate(rows, 0), jref["eval"]["out"],
                               rtol=1e-5, atol=1e-6)


def test_fit_on_a_grid(grid):
    """``fit`` on the (4, 2) grid (``tests/test_fit.py::
    test_fit_multidevice``'s run, float64, with a validation set validated
    on the grid): two finite epochs, the same on every rank, and the train
    and validation losses of one process on the whole batches."""
    ranks, _, _ = grid
    hist = ranks[0]["fit"]
    assert len(hist) == 2 and np.all(np.isfinite(hist))
    assert all(r["fit"] == hist for r in ranks)
    np.testing.assert_allclose(hist, ranks[0]["single_fit"], rtol=1e-5)
    # rank 0 logs the whole validation frame, as one process does
    got, want = ranks[0]["fit_images"], ranks[0]["single_fit_images"]
    assert got.keys() == want.keys() and len(got) == 10
    for key, img in want.items():
        assert got[key].shape == img.shape == (32, 32, img.shape[-1]), key
        np.testing.assert_allclose(got[key], img, rtol=0, atol=1e-5,
                                   err_msg=str(key))
