from .callbacks import (MaxTokensStopperCallback, RunTimeStopperCallback, TrainerCallback,
                        TrainerControl, TrainerState, parse_run_time)
from .optim import AdamW, make_optimizer, make_schedule, resolve_warmup_steps
from .slam_dpo_trainer import SLAMDPOTrainer, tokenize_row
from .slam_trainer import SLAMTrainer

__all__ = ["MaxTokensStopperCallback", "RunTimeStopperCallback", "TrainerCallback",
           "TrainerControl", "TrainerState", "parse_run_time", "AdamW", "make_optimizer",
           "make_schedule", "resolve_warmup_steps", "SLAMDPOTrainer", "SLAMTrainer",
           "tokenize_row"]
