"""Deterministic synthetic LM data with exact resume (the JAX package's
``data/pipeline.py``).

A batch is a pure function of ``(seed, step)``: it is drawn from a
``torch.Generator`` on the CPU seeded from
``numpy.random.SeedSequence([seed, step])``, so any step is computable on
its own, restart-from-checkpoint replays the exact stream with no reader
state beyond the step counter, and the CPU and the card see the same
tokens.  These are not the JAX package's bits (it draws with threefry):
the differential tests feed both packages the same numpy tokens.

The ``zipf`` task draws Zipf-ish tokens (squared uniforms); ``copy`` is a
noisy copy task (second half = first half with 5% of tokens corrupted).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "batch_for_step", "SyntheticLMStream"]

Device = Optional[Union[str, torch.device]]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    task: str = "copy"    # copy | zipf


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(
        2, dtype=np.uint32)
    gen = torch.Generator()
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def batch_for_step(cfg: DataConfig, step: int, *,
                   device: Device = None) -> Dict[str, torch.Tensor]:
    """Pure (seed, step) -> ``{"tokens": int32 [global_batch, seq_len]}``
    on ``device``."""

    device = resolve_device(device)
    gen = _generator(cfg.seed, int(step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    if cfg.task == "zipf":
        # Zipf-ish marginal via squared uniforms.
        u = torch.rand((B, S), generator=gen)
        toks = torch.clamp((u * u * V).to(torch.int32), 0, V - 1)
        return {"tokens": toks.to(device)}
    if cfg.task != "copy":
        raise ValueError(f"unknown task {cfg.task!r}")
    half = S // 2
    first = torch.randint(0, V, (B, half), generator=gen, dtype=torch.int32)
    noise = torch.rand((B, S - half), generator=gen) < 0.05
    corrupt = torch.randint(0, V, (B, S - half), generator=gen,
                            dtype=torch.int32)
    second = torch.where(noise, corrupt, first[:, : S - half])
    return {"tokens": torch.cat([first, second], dim=1).to(device)}


class SyntheticLMStream:
    """Iterator over :func:`batch_for_step` with an exactly resumable
    cursor."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *,
                 device: Device = None) -> None:
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = batch_for_step(self.cfg, self.step, device=self.device)
        self.step += 1
        return batch

    # -- checkpoint integration ---------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"stream seed mismatch: {state['seed']} != "
                             f"{self.cfg.seed}")
        self.step = int(state["step"])
