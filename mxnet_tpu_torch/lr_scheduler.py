"""Learning-rate schedules as pure functions of the update count
(counterpart of ``mxnet_tpu/lr_scheduler.py``, which it copies).

API parity with the reference's ``python/mxnet/lr_scheduler.py``
(``LRScheduler`` / ``FactorScheduler`` / ``MultiFactorScheduler``, same
constructor kwargs and call contract), but the design is deliberately
different: the reference walks mutable state forward on every call
(``while num_update > count + step: base_lr *= factor``), which only
yields the right lr if the scheduler object replayed every update since
step 0.  Here each schedule is a *closed-form* function of
``num_update`` — ``lr(t) = base_lr * factor^decays(t)`` — so a
scheduler restored mid-training (checkpoint resume, ``num_update``
jumping from a loaded optimizer state) returns the correct lr on the
first call, and the same expression could be traced into a jitted
update step as a function of the step counter.

``base_lr`` stays the *undecayed* base (the optimizer assigns it after
construction); decay never mutates it.
"""

from __future__ import annotations

import bisect
import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base contract: ``sched(num_update) -> lr``.

    ``base_lr`` is written by the optimizer (``optimizer.py``: the
    ``learning_rate`` kwarg) after construction; subclasses treat it as
    the t=0 value and derive everything else from ``num_update``.
    """

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def _decays(self, num_update):
        """Number of decay events that have fired by ``num_update``."""
        raise NotImplementedError()

    def __call__(self, num_update):
        raise NotImplementedError()


class _GeometricDecay(LRScheduler):
    """Shared closed-form core: ``lr = base_lr * factor ** decays(t)``,
    floored at ``stop_lr``, with a transition log when the decay count
    changes between calls (observability parity with the reference's
    per-decay log lines, without the state machine)."""

    def __init__(self, factor, stop_lr=0.0):
        super().__init__()
        self.factor = factor
        self.stop_lr = stop_lr
        self._logged_decays = 0

    def __call__(self, num_update):
        k = self._decays(num_update)
        lr = self.base_lr * (self.factor ** k)
        floored = lr < self.stop_lr
        if floored:
            lr = self.stop_lr
        if k != self._logged_decays:
            self._logged_decays = k
            if floored:
                logging.info("Update[%d]: lr at lower bound %0.5e",
                             num_update, lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, lr)
        return lr


class FactorScheduler(_GeometricDecay):
    """Multiply the lr by ``factor`` every ``step`` updates.

    Reference ``lr_scheduler.py:36`` contract: the k-th decay fires once
    ``num_update`` exceeds ``k * step``, and the lr never drops below
    ``stop_factor_lr``.  Closed form: ``decays(t) = (t - 1) // step``.
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1")
        super().__init__(factor, stop_lr=stop_factor_lr)
        self.step = step
        self.stop_factor_lr = stop_factor_lr

    def _decays(self, num_update):
        return max(0, num_update - 1) // self.step


class MultiFactorScheduler(_GeometricDecay):
    """Multiply the lr by ``factor`` at each boundary in ``step``.

    Reference ``lr_scheduler.py:77`` contract: boundary ``b`` has fired
    once ``num_update > b`` (strict).  Closed form: ``decays(t)`` is the
    number of boundaries strictly below ``num_update`` — a bisect over
    the sorted boundary list instead of a cursor walked by repeated
    calls.
    """

    def __init__(self, step, factor=1):
        if not isinstance(step, list) or len(step) < 1:
            raise ValueError("Schedule step must be a non-empty list")
        for prev, cur in zip(step, step[1:]):
            if cur <= prev:
                raise ValueError("Schedule step must be an increasing list")
        if step[0] < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        super().__init__(factor)
        self.step = step

    def _decays(self, num_update):
        # boundaries with b < num_update have fired (num_update > b)
        return bisect.bisect_left(self.step, num_update)
