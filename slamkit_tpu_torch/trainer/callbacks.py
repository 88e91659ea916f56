"""Training callbacks: the callback contract and the budget stops (time, tokens).

A copy of `slamkit_tpu/trainer/callbacks.py`, copied because the JAX
package's trainer package imports jax; `tests/test_torch_data.py` holds the
two equal. on_train_begin / on_step_end / on_train_end receive (args, state,
control); setting control.should_training_stop also requests a final evaluate
and save, so a budget-stopped run ends with a usable checkpoint.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Union

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerState:
    global_step: int = 0
    epoch: float = 0.0
    num_input_tokens_seen: int = 0
    max_steps: int = 0
    log_history: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TrainerControl:
    should_training_stop: bool = False
    should_evaluate: bool = False
    should_save: bool = False


class TrainerCallback:
    def on_train_begin(self, args, state: TrainerState, control: TrainerControl, **kw):
        pass

    def on_step_end(self, args, state: TrainerState, control: TrainerControl, **kw):
        pass

    def on_train_end(self, args, state: TrainerState, control: TrainerControl, **kw):
        pass


def parse_run_time(run_time: Union[str, int]) -> int:
    """'D-HH:MM:SS' (days optional) or raw seconds -> seconds."""
    if isinstance(run_time, int):
        return run_time
    days = 0
    if "-" in run_time:
        days, run_time = run_time.split("-")
        days = int(days)
    hours, minutes, seconds = run_time.split(":")
    return days * 86400 + int(hours) * 3600 + int(minutes) * 60 + int(seconds)


class RunTimeStopperCallback(TrainerCallback):
    """Stop after a wall-clock budget."""

    def __init__(self, run_time: Union[str, int]):
        self.run_time = parse_run_time(run_time)
        self.start_time = None

    def on_train_begin(self, args, state, control, **kw):
        logger.info("Training will run for %s seconds", self.run_time)
        self.start_time = time.time()

    def on_step_end(self, args, state, control, **kw):
        if time.time() - self.start_time > self.run_time:
            control.should_training_stop = True
            control.should_evaluate = True
            control.should_save = True
            logger.info("Stopping training as it has run for %s seconds", self.run_time)


class MaxTokensStopperCallback(TrainerCallback):
    """Stop after a token budget, counted in the configured id range."""

    def __init__(self, train_max_tokens: int):
        self.max_tokens = train_max_tokens

    def on_train_begin(self, args, state, control, **kw):
        logger.info("Training will run for %s tokens", self.max_tokens)

    def on_step_end(self, args, state, control, **kw):
        if state.num_input_tokens_seen >= self.max_tokens:
            control.should_training_stop = True
            control.should_evaluate = True
            control.should_save = True
            logger.info("Stopping training at %s tokens seen", state.num_input_tokens_seen)
