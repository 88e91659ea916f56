from .callbacks import (MaxTokensStopperCallback, RunTimeStopperCallback, TrainerCallback,
                        TrainerControl, TrainerState, parse_run_time)
from .optim import AdamW, make_optimizer, make_schedule, resolve_warmup_steps
from .slam_trainer import SLAMTrainer

__all__ = ["MaxTokensStopperCallback", "RunTimeStopperCallback", "TrainerCallback",
           "TrainerControl", "TrainerState", "parse_run_time", "AdamW", "make_optimizer",
           "make_schedule", "resolve_warmup_steps", "SLAMTrainer"]
