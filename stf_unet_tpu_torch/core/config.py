"""Typed configuration (counterpart of stf_unet_tpu/core/config.py).

The fields of the JAX package's DataConfig, ModelConfig, OptimConfig and
TrainConfig that the port implements, with the same defaults (the
reference's presets), and `parse_config` for the training CLI: dotted
dataclass flags (`--data-crop-size`) and the reference's flat flags
(`--data-path`, `--lr`, `--model`, ...). A flag of a feature the port has
not implemented yet is refused with the ROADMAP item that will bring it,
never silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch


@dataclass
class DataConfig:
    """Dataset and transform settings (ref:train.py:51-74, 146-148)."""

    data_path: str = "./BreaDM"
    use_subtraction: bool = False
    sequence_types: Optional[Sequence[str]] = None
    use_pk_maps: bool = False
    # Transform presets (ref:train.py:51-74).
    base_size: int = 256
    crop_size: int = 224
    hflip_prob: float = 0.5
    vflip_prob: float = 0.5
    rotate_degrees: float = 30.0
    rotate_prob: float = 0.5
    # Dataset statistics (ref:train.py:146-148).
    mean: float = 0.709
    std: float = 0.127
    # "binary": masks store the tumour as 255 and load as //255 (the
    # reference); "index": mask pixels hold class indices.
    mask_format: str = "binary"
    # Host batches decoded ahead by the loader's thread.
    prefetch: int = 2
    # Augmentations beyond the reference, all off by default (the
    # reference's distribution exactly). Elastic deformation: a [grid,
    # grid, 2] normal control field times alpha (source pixels), upsampled
    # bilinearly to the crop and added to the warp coordinates of frames
    # and mask alike; shared-frame mode only.
    elastic_alpha: float = 0.0
    elastic_grid: int = 4
    elastic_prob: float = 0.5
    # Photometric jitter of the [0, 1] frames (PK maps and mask untouched),
    # one draw per sample shared by its T frames.
    brightness: float = 0.0    # v * f, f ~ U(1-b, 1+b)
    contrast: float = 0.0      # (v - mean) * f + mean, f ~ U(1-c, 1+c)
    gamma_jitter: float = 0.0  # v ** f, f ~ U(1-g, 1+g)
    noise_std: float = 0.0     # + N(0, std), drawn on the device
    # Keep the decoded uint8 samples in host RAM after the first epoch.
    cache_ram: bool = False
    # Dataset pack root (data/pack.py, built by cli/pack): decode-free
    # train / val / test batches read from memory maps. "" = decode.
    pack_dir: str = ""
    # Host batches pinned and copied to the device this many steps ahead
    # on a side stream (train/loop.py); 0 copies inline.
    device_prefetch: int = 2
    # One augmentation draw shared by a sample's T frames (the JAX
    # package's documented fix of the reference's per-frame re-roll);
    # False re-rolls every plane, the mask following frame 0.
    shared_frame_augmentation: bool = True
    # The JAX package's TPU routing of unrotated samples into a separable
    # program; K2 warps every sample in one launch, so here it is accepted
    # and changes nothing.
    rotation_split: bool = False

    @property
    def resolved_sequence_types(self) -> Sequence[str]:
        if self.sequence_types is not None:
            return tuple(self.sequence_types)
        if self.use_subtraction:
            return tuple(f"SUB{i}" for i in range(1, 9))
        return tuple(f"VIBRANT+C{i}" for i in range(1, 9))


@dataclass
class ModelConfig:
    """Model selection. `num_classes` counts foreground classes; the
    network predicts `total_classes` = num_classes + 1 (background)."""

    model: str = "stflstm"
    num_classes: int = 1
    time_steps: int = 8
    use_pk_maps: bool = False
    # PK parameter maps (Ktrans, ve, vp) carried as extra input planes.
    pk_channels: int = 3
    # {"auto", "scan", "fused", "last"}: see ops/lstm.pixel_lstm.
    lstm_backend: str = "auto"
    base_c: int = 64  # vanilla UNet width (ref:src/unet.py:7)

    @property
    def total_classes(self) -> int:
        return self.num_classes + 1


@dataclass
class OptimConfig:
    """AdamW + warmup-poly schedule (ref:train.py:227-247,
    train_and_eval.py:414-438)."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup: bool = True
    warmup_epochs: int = 1
    warmup_factor: float = 1e-3
    poly_power: float = 0.9
    # EMA of the parameters (0 = off), updated after each AdamW apply;
    # validation, the test pass and inference restores use it. The BN
    # running statistics stay the live model's.
    ema_decay: float = 0.0
    # d_eff = min(ema_decay, (1 + n) / (10 + n)) over the apply count n.
    ema_warmup: bool = True


@dataclass
class TrainConfig:
    """Top-level training config (ref:train.py:96-121)."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    # 0 (CLI spelling: --batch-size auto) picks the batch from a measured
    # train step's memory (train/autobatch.py).
    batch_size: int = 16
    # The device memory budget of --batch-size auto in GiB; 0 = what the
    # card reports free.
    auto_batch_budget_gb: float = 0.0
    # Mean of k micro-batch gradients, one AdamW apply per k.
    grad_accum: int = 1
    # The reference evaluates with batch 1; larger values group same-shape
    # samples, which gives the same metrics.
    eval_batch_size: int = 1
    epochs: int = 100
    start_epoch: int = 0
    print_freq: int = 10
    resume: str = ""
    save_best: bool = True
    # bfloat16 compute with float32 parameters (the JAX package's --amp);
    # no loss scaling is needed in bf16.
    amp: bool = False
    # Per-class CE weights, comma-separated, one per TOTAL class.
    loss_class_weights: str = ""
    silent: bool = False
    # Skip the epochs (after any --resume) and run only the best model's
    # test-set pass.
    test_only: bool = False
    # Fit the PK maps of every split (pk/maps.py) before training.
    generate_pk_maps: bool = False
    early_stop_patience: int = 20  # ref:train.py:171
    # Stop after N train steps with a step-exact resumable checkpoint
    # (0 = off); SIGTERM and a first SIGINT take the same path.
    stop_after_steps: int = 0
    save_dir: str = "./save_weights"
    output_dir: str = "./output"
    seed: int = 0
    # Where the run computes: CUDA unless the CPU is asked for.
    device: str = "cuda"

    @property
    def tag_suffix(self) -> str:
        return "_pk" if self.data.use_pk_maps else ""


@dataclass(frozen=True)
class PKConfig:
    """Extended-Tofts fitter settings (the JAX package's PKConfig, same
    defaults; ref:pk_fitting.py:15-26,257,290-307)."""

    aif_method: str = "population"  # {"population", "modified", "auto"}
    aif_dose: float = 0.1
    time_points: Sequence[float] = tuple(float(i) for i in range(8))
    dt: float = 0.01
    # Fit hyperparameters (ref:pk_fitting.py:290-307,316).
    init_ktrans: float = 0.05
    init_ve: float = 0.1
    init_vp: float = 0.01
    lr: float = 0.005
    num_epochs: int = 100
    # Physiological clamp box (ref:pk_fitting.py:303-307).
    ktrans_bounds: Sequence[float] = (0.0, 1.0)
    ve_bounds: Sequence[float] = (0.001, 0.5)
    vp_bounds: Sequence[float] = (0.0, 0.2)
    # Tissue mask threshold factor (ref:pk_fitting.py:180).
    tissue_threshold_factor: float = 0.15
    # {"lm", "adam"}: Levenberg-Marquardt (the fast path) or Adam.
    solver: str = "lm"
    lm_iters: int = 50


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a CUDA request without a visible GPU raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


# Flags of the JAX package's trainer whose features the port has not
# implemented yet -> the ROADMAP.md item (§1) that brings them.
UNPORTED_FLAGS = {
    "--multihost": "data parallelism",
    "--data-parallel": "data parallelism",
    "--spatial-parallel": "data parallelism",
    "--profile-dir": "long tail",
    "--nan-check": "long tail",
    "--jsonl-metrics": "long tail",
    "--matmul-precision": "long tail",
    "--tf32": "long tail",
    "--aux": "long tail",
    "--compile-cache-dir": "long tail",
    "--model-remat": "long tail",
}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _parse_batch_size(s: str) -> int:
    """A positive batch, or 'auto' -> 0 (train/autobatch sizes it)."""
    if s.strip().lower() == "auto":
        return 0
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be positive, got {v}")
    return v


def _add_dataclass_args(parser: argparse.ArgumentParser, dc: Any,
                        prefix: str = "") -> None:
    for f in dataclasses.fields(dc):
        default = getattr(dc, f.name)
        if dataclasses.is_dataclass(default):
            _add_dataclass_args(parser, default, prefix=f"{prefix}{f.name}.")
            continue
        name = f"--{(prefix + f.name).replace('_', '-').replace('.', '-')}"
        if isinstance(default, bool):
            # A bare flag sets True (reference store_true style); an
            # explicit true/false value also works.
            parser.add_argument(name, type=_parse_bool, default=None,
                                nargs="?", const=True, metavar="BOOL")
        elif f.name == "batch_size" and prefix == "":
            parser.add_argument(name, type=_parse_batch_size, default=None)
        elif isinstance(default, (int, float, str)):
            parser.add_argument(name, type=type(default), default=None)
        else:
            parser.add_argument(name, type=str, default=None)


def _apply_overrides(dc: Any, ns: argparse.Namespace, prefix: str = ""):
    updates = {}
    for f in dataclasses.fields(dc):
        val = getattr(dc, f.name)
        if dataclasses.is_dataclass(val):
            updates[f.name] = _apply_overrides(val, ns,
                                               prefix=f"{prefix}{f.name}.")
            continue
        ov = getattr(ns, (prefix + f.name).replace(".", "_"), None)
        if ov is not None:
            if isinstance(ov, str) and f.name == "sequence_types":
                ov = tuple(x.strip() for x in ov.split(",") if x.strip())
            updates[f.name] = ov
    return dataclasses.replace(dc, **updates)


def parse_config(argv: Optional[Sequence[str]] = None,
                 defaults: Optional[TrainConfig] = None) -> TrainConfig:
    """A TrainConfig from command-line flags, as the JAX package's
    parse_config reads them. Raises SystemExit (argparse's error) for a
    flag of an unported feature, naming its ROADMAP item."""
    cfg = defaults or TrainConfig()
    parser = argparse.ArgumentParser(description="STF-UNet training "
                                     "(PyTorch port)")
    _add_dataclass_args(parser, cfg)
    alias = {  # the reference's flat flags (ref:train.py:96-121)
        "--model": ("model_model", str),
        "--data-path": ("data_data_path", str),
        "--num-classes": ("model_num_classes", int),
        "--lr": ("optim_lr", float),
        "--weight-decay": ("optim_weight_decay", float),
        "--use-pk-maps": ("data_use_pk_maps", _parse_bool),
        "--use-subtraction": ("data_use_subtraction", _parse_bool),
        "--data-pack": ("data_pack_dir", str),
    }
    for flag, (dest, typ) in alias.items():
        if typ is _parse_bool:
            parser.add_argument(flag, dest=dest, type=typ, default=None,
                                nargs="?", const=True, metavar="BOOL")
        else:
            parser.add_argument(flag, dest=dest, type=typ, default=None)
    for flag in UNPORTED_FLAGS:
        parser.add_argument(flag, dest=f"unported_{flag[2:]}", default=None,
                            nargs="?", const="", help=argparse.SUPPRESS)
    # Accepted and ignored, as by the JAX package: --workers (the threaded
    # loader replaces worker processes) and --momentum (unused by the
    # reference's AdamW too).
    for flag in ("--workers", "--momentum"):
        parser.add_argument(flag, dest=f"ignored_{flag[2:]}", default=None,
                            help=argparse.SUPPRESS)
    ns = parser.parse_args(argv)
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(ns, f"unported_{flag[2:]}") is not None:
            parser.error(f"{flag} is not ported to the PyTorch package yet "
                         f"(ROADMAP.md §1, '{item}')")
    cfg = _apply_overrides(cfg, ns)
    # --use-pk-maps feeds both the dataset and the model (ref:train.py:181,
    # 221).
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pk_maps=cfg.data.use_pk_maps))


def config_to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
