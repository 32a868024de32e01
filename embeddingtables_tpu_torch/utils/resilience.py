"""Training resilience: divergence detection and rollback, auto-resume
(counterpart of `embeddingtables_tpu/utils/resilience.py`).

  - `DivergenceGuard` watches the loss stream; on a non-finite loss (or a
    spike past `spike_factor` times the running mean) it restores the last
    good checkpoint into the live model, in place, and reports it.
  - `resume_or_init`: restore the latest checkpoint if there is one, else
    initialize fresh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from .checkpoint import CheckpointManager


@dataclasses.dataclass
class DivergenceGuard:
    """Loss-stream watchdog with checkpoint rollback.

    ckpt:          CheckpointManager holding known-good state.
    spike_factor:  a loss > spike_factor * running mean counts as divergence
                   (None disables; a non-finite loss always counts).
    patience:      consecutive bad losses tolerated before rolling back.
    """

    ckpt: Optional[CheckpointManager] = None
    spike_factor: Optional[float] = 10.0
    patience: int = 1
    ema: float = 0.98

    _mean: Optional[float] = dataclasses.field(default=None, init=False)
    _bad: int = dataclasses.field(default=0, init=False)
    rollbacks: int = dataclasses.field(default=0, init=False)

    def is_bad(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if self.spike_factor is not None and self._mean is not None:
            return loss > self.spike_factor * max(self._mean, 1e-12)
        return False

    def observe(self, loss: float, model):
        """Feed one loss. Returns `(model, rolled_back)`; on a rollback the
        latest checkpoint has been copied into `model` in place."""
        if self.is_bad(loss):
            self._bad += 1
            if self._bad >= self.patience:
                self._bad = 0
                if self.ckpt is not None and \
                        self.ckpt.latest_step() is not None:
                    restored = self.ckpt.restore_latest(model)
                    self.rollbacks += 1
                    return restored, True
                self.rollbacks += 1
                return model, True  # no checkpoint: the caller re-inits
            return model, False
        self._bad = 0
        self._mean = (loss if self._mean is None
                      else self.ema * self._mean + (1 - self.ema) * loss)
        return model, False


def resume_or_init(ckpt: CheckpointManager, init_fn: Callable[[], object],
                   template=None):
    """Restore the latest checkpoint into `template` (default: a fresh
    `init_fn()`), else initialize fresh. Returns `(model, start_step)`."""
    step = ckpt.latest_step()
    if step is None:
        return init_fn(), 0
    tmpl = template if template is not None else init_fn()
    return ckpt.restore(step, tmpl), step
