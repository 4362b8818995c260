"""Learning-rate schedules (pure functions of the step counter).

Counterpart of ``repro.train.schedule``: the same four schedules, computed
in f32 tensors as the reference computes them in f32 arrays.
``make_schedule`` is the registry entry point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class ScheduleConfig:
    name: str = "cosine"             # constant | linear | cosine | rsqrt
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1        # floor as a fraction of base_lr


def _warmup(step: torch.Tensor, cfg: ScheduleConfig) -> torch.Tensor:
    w = max(cfg.warmup_steps, 1)
    return torch.clamp((step + 1) / w, max=1.0)


def _progress(step: torch.Tensor, cfg: ScheduleConfig) -> torch.Tensor:
    return torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)


def constant(step, cfg: ScheduleConfig):
    return cfg.base_lr * _warmup(step, cfg)


def linear(step, cfg: ScheduleConfig):
    decay = 1.0 - (1.0 - cfg.min_lr_ratio) * _progress(step, cfg)
    return cfg.base_lr * _warmup(step, cfg) * decay


def cosine(step, cfg: ScheduleConfig):
    t = _progress(step, cfg)
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) \
        * 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.base_lr * _warmup(step, cfg) * decay


def rsqrt(step, cfg: ScheduleConfig):
    s = torch.clamp(step, min=1.0)
    w = max(cfg.warmup_steps, 1)
    return cfg.base_lr * _warmup(step, cfg) * torch.sqrt(
        w / torch.clamp(s, min=w))


_SCHEDULES: dict[str, Callable] = {
    "constant": constant,
    "linear": linear,
    "cosine": cosine,
    "rsqrt": rsqrt,
}


def make_schedule(cfg: ScheduleConfig) -> Callable[[int], torch.Tensor]:
    """``step -> lr`` as an f32 scalar tensor."""
    if cfg.name not in _SCHEDULES:
        raise ValueError(f"unknown schedule {cfg.name!r}; "
                         f"known: {sorted(_SCHEDULES)}")
    fn = _SCHEDULES[cfg.name]
    return lambda step: fn(torch.tensor(float(step), dtype=torch.float32),
                           cfg).to(torch.float32)
