"""Config dataclasses of the PyTorch port.

The port's own copy of the JAX package's config tree (model topology, data,
training, mesh), kept field-for-field identical so that a config serialized
by either package loads in the other. The serving forward reads
``ModelConfig`` and the compute dtype of ``TrainConfig``; training reads
the rest, and the parallel modes read ``MeshConfig`` (``runtime/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Topology of the VSR model (flow + depth + fusion + SR head)."""

    scale: int = 4                      # SR upscale factor
    window: int = 3                     # temporal window (3 or 5)
    # --- feature pyramid / flow ---
    pyramid_levels: int = 5
    pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128)
    max_displacement: int = 4           # cost volume radius d -> (2d+1)^2 ch
    # finest pyramid level that runs a flow estimator (0 = 1/2 res,
    # 1 = 1/4 res, the PWC-Net convention)
    flow_finest_level: int = 1
    flow_estimator_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    context_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32)
    # --- depth branch ---
    depth_channels: int = 64            # hourglass width
    depth_levels: int = 4               # hourglass downsampling depth
    # --- fusion + SR head ---
    fusion_channels: int = 64
    sr_channels: int = 64
    sr_blocks: int = 5                  # residual blocks in the SR trunk
    sr_wide_blocks: bool = True         # C -> 2C -> C blocks
    lrelu_slope: float = 0.1
    # warp 64-ch neighbor features (+ depth) instead of frames + depth
    warp_features: bool = False
    # "espcn" or "two_stage" (the reference-era head)
    sr_head_style: str = "espcn"
    # espcn-only extra LR conv width before the subpixel conv (0 = off)
    sr_espcn_mid: int = 0
    # legacy switch for the depth branch resolution, read when
    # depth_res_divisor is 0: 2 if set, else 1
    depth_at_half_res: bool = True
    # resolution divisor of the depth branch input (0 = derive from
    # depth_at_half_res); serving_config() sets 4
    depth_res_divisor: int = 0
    # warp implementation name of the JAX package; the port always runs
    # the exact per-pixel gather warp
    warp_impl: str = "pallas"

    @property
    def num_neighbors(self) -> int:
        return self.window - 1

    @property
    def cost_volume_channels(self) -> int:
        d = self.max_displacement
        return (2 * d + 1) ** 2


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Sliding-temporal-window clip pipeline."""

    train_root: str = ""
    eval_root: str = ""
    window: int = 3
    scale: int = 4
    crop_size: int = 64                 # LR crop (HR crop = crop*scale)
    batch_size: int = 4
    augment: bool = True                # random flips + temporal reverse
    edge_mode: str = "replicate"        # clip-edge window padding policy
    y_channel_eval: bool = True         # Vid4 convention: PSNR/SSIM on Y
    border_crop: int = 4                # crop `scale` px border before metrics


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_schedule: str = "cosine"         # "cosine" | "step" | "const"
    lr_step_every: int = 100_000
    lr_step_gamma: float = 0.5
    steps: int = 300_000
    warmup_steps: int = 2_000
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    charbonnier_eps: float = 1e-6
    ckpt_dir: str = "/tmp/vsr_tpu_ckpt"
    ckpt_every: int = 1_000
    keep_ckpts: int = 5
    log_every: int = 100
    seed: int = 0
    compute_dtype: str = "bfloat16"     # activations
    param_dtype: str = "float32"        # master params & loss


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallel axes: data, time, space and model (1 disables an axis)."""

    data: int = 1
    time: int = 1
    space: int = 1
    model: int = 1

    @property
    def shape(self):
        return {"data": self.data, "time": self.time, "space": self.space,
                "model": self.model}

    @property
    def num_devices(self) -> int:
        return self.data * self.time * self.space * self.model


@dataclasses.dataclass(frozen=True)
class VSRConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    use_pallas: bool = False            # JAX-only switch, kept for the format

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "VSRConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "VSRConfig":
        def _mk(klass, sub: Optional[dict]):
            if sub is None:
                return klass()
            fields = {f.name for f in dataclasses.fields(klass)}
            kw: dict[str, Any] = {}
            for k, v in sub.items():
                if k not in fields:
                    raise ValueError(f"unknown {klass.__name__} field: {k}")
                if isinstance(v, list):
                    v = tuple(v)
                kw[k] = v
            return klass(**kw)

        return cls(
            model=_mk(ModelConfig, d.get("model")),
            data=_mk(DataConfig, d.get("data")),
            train=_mk(TrainConfig, d.get("train")),
            mesh=_mk(MeshConfig, d.get("mesh")),
            use_pallas=bool(d.get("use_pallas", False)),
        )

    def replace(self, **kw) -> "VSRConfig":
        return dataclasses.replace(self, **kw)


def serving_config(**model_overrides: Any) -> VSRConfig:
    """The serving configuration: dataclass defaults plus quarter-res depth
    (depth_res_divisor=4), which is not baked into the defaults so that
    configs stamped into checkpoints keep their trained-time numerics."""
    cfg = VSRConfig()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, depth_res_divisor=4, **model_overrides))
