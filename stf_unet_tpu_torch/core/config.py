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
    # One augmentation draw shared by a sample's T frames (the JAX
    # package's documented fix of the reference's per-frame re-roll).
    shared_frame_augmentation: bool = True

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


@dataclass
class TrainConfig:
    """Top-level training config (ref:train.py:96-121)."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    batch_size: int = 16
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
    # Fit the PK maps of every split (pk/maps.py) before training.
    generate_pk_maps: bool = False
    early_stop_patience: int = 20  # ref:train.py:171
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
    "--grad-accum": "EMA and gradient accumulation",
    "--optim-ema-decay": "EMA and gradient accumulation",
    "--optim-ema-warmup": "EMA and gradient accumulation",
    "--data-brightness": "augmentation extras",
    "--data-contrast": "augmentation extras",
    "--data-gamma-jitter": "augmentation extras",
    "--data-noise-std": "augmentation extras",
    "--data-elastic-alpha": "augmentation extras",
    "--data-elastic-grid": "augmentation extras",
    "--data-elastic-prob": "augmentation extras",
    "--data-rotation-split": "augmentation extras",
    "--data-pack": "dataset packs",
    "--data-pack-dir": "dataset packs",
    "--data-cache-ram": "native loader and RAM cache",
    "--data-device-prefetch": "native loader and RAM cache",
    "--auto-batch-budget-gb": "autobatch",
    "--stop-after-steps": "preemption",
    "--multihost": "data parallelism",
    "--data-parallel": "data parallelism",
    "--spatial-parallel": "data parallelism",
    "--test-only": "cli/test.py",
    "--profile-dir": "long tail",
    "--nan-check": "long tail",
    "--jsonl-metrics": "long tail",
    "--matmul-precision": "long tail",
    "--tf32": "long tail",
    "--aux": "long tail",
    "--compile-cache-dir": "long tail",
    "--model-remat": "long tail",
    "--model-base-c": "vanilla UNet",
}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _parse_batch_size(s: str) -> int:
    if s.strip().lower() == "auto":
        raise argparse.ArgumentTypeError(
            "'auto' is not ported to the PyTorch package yet (ROADMAP.md "
            "§1, 'autobatch')")
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
