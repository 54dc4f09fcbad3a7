"""Configuration system (the port's copy of ``pcss_unet_tpu/config.py``).

One dataclass mirrors every key of the reference's ``config.ini`` ``[base]``
section (reference: config.ini:1-38, read via configparser at main.py:875-885)
plus the framework's own knobs.  An INI file with the reference's exact
schema loads unchanged; CLI flags override INI values, matching the
reference's argparse-over-configparser precedence (main.py:870-881).
"""

from __future__ import annotations

import configparser
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Config:
    # --- training parameters (reference config.ini:4-13) ---
    batch_size: int = 8
    num_epochs: int = 200
    learning_rate: float = 7e-4
    activation: str = "leaky_relu"          # leaky_relu | relu | gelu
    normalization: str = "batch_norm"       # batch_norm | group_norm | instance_norm | none
    dropout_rate: float = 0.2
    optimizer_type: str = "adamw"           # adam | adamw | sgd  (main.py:952-957)
    warmup_epochs: int = 5
    perturbation_count: int = 3             # p in the paper; pert_loss.py:12-24
    perturb_weight: float = 0.1

    # --- model / checkpoint paths (reference config.ini:16-18) ---
    save_dir: str = "./checkpoints"
    ckptpath: str = "./checkpoints/pcss_model.pth"
    best_model_path: str = "./checkpoints/pcss_best_model.pth"

    # --- data paths (reference config.ini:21-23) ---
    train_dir: str = "./data/train"
    val_dir: str = "./data/val"
    processed_data_dir: str = "./data/processed"

    # --- image parameters (reference config.ini:26-29) ---
    image_width: int = 2048
    image_height: int = 1024
    input_channels: int = 4
    output_channels: int = 1

    # --- loss parameters (reference config.ini:32-34) ---
    alpha: float = 0.9                      # L1-vs-VGG blend (customLoss.py:160)
    loss_type: str = "standard"             # standard | perturb (main.py:870-873)
    validation_frequency: int = 1

    # --- logging (reference config.ini:37-38) ---
    log_dir: str = "./logs"
    save_frequency: int = 10

    # ===== framework extensions (no reference equivalent) =====
    # The training, memory and parallelism keys below are the JAX package's
    # and are read by its training stack; the port reads none of them yet
    # (ROADMAP Queue 1 items 9-14) and keeps them so that one INI serves both.
    seed: int = 42                          # reference hardcodes 42 (main.py:73-92)
    compute_dtype: str = "bfloat16"         # AMP analogue: main.py:257-259 uses fp16-cuda
    param_dtype: str = "float32"
    shuffle: bool = True                    # reference trains with shuffle=False
                                            # (main.py:850); set False for parity runs
    weight_decay_adam: float = 1e-4         # main.py:953
    weight_decay_adamw: float = 1e-3        # main.py:955
    sgd_momentum: float = 0.9               # main.py:957
    lr_floor_fraction: float = 0.01         # cosine floor = 1% of base (main.py:966-967)
    grad_clip_norm: float = 1.0             # initial max_norm (main.py:356-358)
    grad_clip_decay: bool = True            # decay max_norm→max(0.1, 1−epoch_ratio)
                                            # after half the epochs (main.py:356-358)

    # VGG perceptual loss
    vgg_weights_path: str = ""              # converted VGG-19 weights (.npz); empty
                                            # → deterministic seeded init (no
                                            # download is possible offline)
    vgg_grad: bool = False                  # reference's VGG branch is gradient-dead
                                            # (customLoss.py:69-71, 90); True enables
                                            # true perceptual gradients
    # Extra loss terms the reference computes then discards (customLoss.py:140-193);
    # exposed here as real config-gated terms, default off for parity.
    high_freq_weight: float = 0.0
    penumbra_weight: float = 0.0
    sobel_weight: float = 0.0
    ssim_weight: float = 0.0      # 1−SSIM term; the reference carries this
                                  # commented out (customLoss.py:187-191)

    # Model variants (paper Table 1: 3/5/7-layer depth study; paper.md:179-203)
    model_depth: int = 4                    # number of encoder levels incl. bottleneck
    base_width: int = 64                    # conv2 output channels (Unetmodel.py:39)
    apply_dilation: bool = False            # reference accepts but never applies
                                            # dilation (Unetmodel.py:18-26); True
                                            # actually dilates encoder 3x3 convs

    # Training crops (BASELINE config 1: random 256x256 crops of full
    # frames); 0 disables (full frames, the reference behavior)
    crop_height: int = 0
    crop_width: int = 0

    # Distillation — the paper's deployment pipeline trims the 25 MB net to
    # a 2.5 MB variant (paper.md:143); here the trimmed student trains
    # against a trained full-size teacher's soft masks in addition to the
    # labels: total += distill_weight · mean((student − teacher)²).
    distill_teacher: str = ""               # teacher checkpoint (Orbax dir or
                                            # .pth); empty = distillation off
    distill_teacher_depth: int = 4          # teacher architecture (defaults:
    distill_teacher_width: int = 64         #   the reference network)
    distill_weight: float = 0.5

    # Gradient accumulation: split each incoming batch into N equal
    # microbatches inside the jitted step (lax.scan), accumulate gradients
    # in fp32, apply ONE optimizer update: the answer to the reference's
    # OOM-retry loop (main.py:478-499) for reference-scale batches (batch 8
    # @ 2048x1024): the per-microbatch activation footprint is what must
    # fit device memory, not the full batch's.  batch_size must be
    # divisible by this.  0 = auto: the memory governor picks the smallest
    # split whose microbatch fits the memory estimate.
    grad_accum_steps: int = 1

    # Exponential moving average of the parameters: ema ← d·ema + (1−d)·θ
    # after every applied update (skipped steps leave it untouched).  The
    # EMA weights checkpoint alongside the raw ones and deploy via
    # ``cli.infer --ema`` — a smoother serving net for free on a model
    # whose headline metric is temporal stability (paper.md:133).  0 = off
    # (reference behavior).
    ema_decay: float = 0.0

    # Memory-governor oracle for the auto modes (batch_size=0 /
    # grad_accum_steps=0).  'xla' (the name config.ini shares with the JAX
    # package, which reads XLA's static plan there): in the port, one real
    # train step per candidate on the card, its peak allocated memory
    # measured (train/governor.py); the CPU has no allocator statistics and
    # keeps the analytic answer.  'analytic': the calibrated closed-form
    # estimate only (utils/memory.py) — instant, conservative.
    governor: str = "xla"                   # xla | analytic

    # Device-resident dataset cache: upload the packed dataset to the device once
    # and gather/crop batches on device, eliminating per-step host→device
    # transfers (the dominant step cost when the host link is slow).  The
    # reference streams every batch from host mmap (setdata.py:243-245).
    device_data_cache: str = "auto"         # on | off | auto (auto = cache
                                            # when the dataset fits the budget)
    device_cache_budget_mb: int = 6144      # device-memory budget for the cache
                                            # (the JAX package's default)

    # Parallelism / inference
    data_parallel: int = -1                 # -1 → all devices on the 'data' axis
    spatial_parallel: int = 1               # mesh 'spatial' axis for sharded frames
    pad_multiple: int = 16                  # pad full frames to ×16 (inference.py:154-163)
    tile_size: int = 512                    # tiled-inference tile edge
    tile_halo: int = 32                     # tiled-inference overlap halo

    # Checkpointing (superset of reference: adds resume, which main.py lacks —
    # SURVEY.md §5 "No resume path exists")
    max_checkpoints_to_keep: int = 3
    resume: bool = True

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(name: str, raw: str) -> Any:
    """Coerce an INI string to the dataclass field's type."""
    f = _FIELDS[name]
    t = f.type if isinstance(f.type, type) else {"int": int, "float": float,
                                                 "bool": bool, "str": str}[str(f.type)]
    if t is bool:
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    return t(str(raw).strip())


def load_config(ini_path: str | None = None, overrides: dict | None = None) -> Config:
    """Build a Config from an INI file (reference schema, ``[base]`` section)
    plus override dict (CLI flags).  Unknown INI keys are ignored with a
    warning so reference config.ini files load as-is."""
    cfg = Config()
    values: dict[str, Any] = {}
    if ini_path:
        if not os.path.exists(ini_path):
            raise FileNotFoundError(f"config file not found: {ini_path}")
        parser = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        parser.read(ini_path)
        section = parser["base"] if parser.has_section("base") else parser["DEFAULT"]
        for key, raw in section.items():
            if key in _FIELDS:
                values[key] = _coerce(key, raw)
    if overrides:
        for key, val in overrides.items():
            if val is None:
                continue
            if key in _FIELDS:
                values[key] = val if not isinstance(val, str) else _coerce(key, val)
    return cfg.replace(**values)


def save_config(cfg: Config, path: str, extra: dict | None = None) -> None:
    """Persist the resolved config next to checkpoints (JSON for fidelity).

    ``extra``: runtime-resolved facts that aren't config inputs, e.g. the
    ``vgg_weights`` provenance (pretrained artifact vs random fallback)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = cfg.to_dict()
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)

