"""Augmentation registry: declarative configs -> composed transforms
(reference: data/aug/registry.py:10-125, config.py:24-54)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type

from ultravox_torch.data.aug.base import Augmentation, AugmentationArgs, NoopAugmentation
from ultravox_torch.data.aug import transforms


@dataclasses.dataclass
class AugmentationConfig:
    name: str
    type: Optional[str] = None  # registry type; None => group of children
    p: float = 1.0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: Optional[List["AugmentationConfig"]] = None

    def __post_init__(self):
        if self.children:
            self.children = [
                c if isinstance(c, AugmentationConfig) else AugmentationConfig(**c)
                for c in self.children
            ]


class AugRegistry:
    _types: Dict[str, Type[Augmentation]] = {}
    _configs: Dict[str, AugmentationConfig] = {}

    @classmethod
    def register_type(cls, name: str, aug_cls: Type[Augmentation]) -> None:
        cls._types[name] = aug_cls

    @classmethod
    def register_config(cls, config: AugmentationConfig) -> None:
        cls._configs[config.name] = config

    @classmethod
    def get_config(cls, name: str) -> AugmentationConfig:
        if name not in cls._configs:
            raise KeyError(
                f"unknown augmentation {name!r}; known: {sorted(cls._configs)}"
            )
        return cls._configs[name]

    @classmethod
    def create(
        cls,
        config: AugmentationConfig,
        args: Optional[AugmentationArgs] = None,
    ) -> Augmentation:
        args = args or AugmentationArgs()
        children = [cls.create(c, args) for c in (config.children or [])]
        if config.type is None:
            return Augmentation(args, p=config.p, children=children, name=config.name)
        aug_cls = cls._types[config.type]
        return aug_cls(
            args, p=config.p, children=children, name=config.name, **config.args
        )


def create_augmentation(
    name_or_config, args: Optional[AugmentationArgs] = None
) -> Augmentation:
    if isinstance(name_or_config, str):
        name_or_config = AugRegistry.get_config(name_or_config)
    elif isinstance(name_or_config, dict):
        name_or_config = AugmentationConfig(**name_or_config)
    return AugRegistry.create(name_or_config, args)


AugRegistry.register_type("noop", NoopAugmentation)
AugRegistry.register_type("gain", transforms.GainAugmentation)
AugRegistry.register_type("noise", transforms.ColoredNoiseAugmentation)
AugRegistry.register_type("resampling", transforms.ResamplingAugmentation)
AugRegistry.register_type("filter", transforms.ButterworthFilterAugmentation)
AugRegistry.register_type("compression", transforms.CompressionAugmentation)
AugRegistry.register_type(
    "ffmpeg_compression", transforms.FfmpegCodecAugmentation
)

# Built-in configs (reference: aug/registry.py default configs)
AugRegistry.register_config(AugmentationConfig(name="null", type="noop"))
AugRegistry.register_config(
    AugmentationConfig(name="gain", type="gain", p=0.5)
)
AugRegistry.register_config(
    AugmentationConfig(
        name="white_noise", type="noise", p=0.5, args={"exponent": 0.0}
    )
)
AugRegistry.register_config(
    AugmentationConfig(
        name="pink_noise", type="noise", p=0.5, args={"exponent": 1.0}
    )
)
AugRegistry.register_config(
    AugmentationConfig(name="resample", type="resampling", p=0.3)
)
AugRegistry.register_config(
    AugmentationConfig(name="lowpass", type="filter", p=0.3)
)
AugRegistry.register_config(
    AugmentationConfig(
        name="bandpass", type="filter", p=0.3, args={"btype": "bandpass"}
    )
)
AugRegistry.register_config(
    AugmentationConfig(name="mulaw", type="compression", p=0.3)
)
# ffmpeg codec round-trips — config names match the reference registry
# (aug/compression.py:240-274) so its recipes port verbatim; each degrades
# to a warned no-op where ffmpeg isn't installed
AugRegistry.register_config(
    AugmentationConfig(
        name="amr_4_75kbps", type="ffmpeg_compression",
        args={"codec": "amr", "bitrate": 4750},
    )
)
AugRegistry.register_config(
    AugmentationConfig(
        name="amr_12kbps", type="ffmpeg_compression",
        args={"codec": "amr", "bitrate": 12200},
    )
)
AugRegistry.register_config(
    AugmentationConfig(
        name="amr_wb", type="ffmpeg_compression",
        args={"codec": "amrwb", "bitrate": 23850},
    )
)
AugRegistry.register_config(
    AugmentationConfig(
        name="random_amr_compression", type="ffmpeg_compression",
        args={"codec": "random_amr"},
    )
)
AugRegistry.register_config(
    AugmentationConfig(
        name="telephony",
        children=[
            AugmentationConfig(
                name="telephony_resample",
                type="resampling",
                args={"min_rate": 8000, "max_rate": 8000},
            ),
            AugmentationConfig(name="telephony_mulaw", type="compression"),
        ],
        p=0.5,
    )
)
