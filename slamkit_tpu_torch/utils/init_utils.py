"""Experiment-tracker init: a copy of `slamkit_tpu/utils/init_utils.py::init_wandb`.

wandb is optional; where it is missing, init_wandb logs a warning and returns
None, so training falls back to the print logger."""
from __future__ import annotations

import json
import logging
import os

from ..config import to_container

logger = logging.getLogger(__name__)


def init_wandb(cfg, name: str):
    """Start a wandb run and upload the composed config as a run artifact."""
    try:
        import wandb
    except ImportError:
        logger.warning("wandb not installed; falling back to print logging")
        return None
    run = wandb.init(project=cfg.logger.project,
                     entity=cfg.logger.get("entity", None),
                     name=name,
                     group=cfg.logger.get("group", None),
                     resume=cfg.logger.get("resume", None),
                     config=to_container(cfg))
    config_path = os.path.join(run.dir, f"{run.entity}-{run.name}-config.json")
    with open(config_path, "w") as f:
        json.dump(to_container(cfg), f, indent=2)
    run.save(config_path, policy="now")
    return run
