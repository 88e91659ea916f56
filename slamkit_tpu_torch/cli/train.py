"""Stage 3 on the port: tokens jsonl -> trained checkpoint.

    python -m slamkit_tpu_torch.cli.train model=slam data.train_path=<tokens.jsonl> \
        data.val_path=<tokens.jsonl> [overrides ...]

The counterpart of `cli/train.py`, on the repo's `config/` tree (train.yaml)
and its override grammar, with its rules line for line:
  * an interleave tokeniser's text tokeniser follows the model's base (a
    local directory with tokenizer.json, read without transformers), so
    `--config-name train_inter_scale` trains the SIMS recipe on a list of
    corpora mixed by `data.train_ratios`;
  * num_train_epochs = train_max_tokens / ds_token_size x 1.01;
  * vocab_size = -1 takes the tokeniser's vocabulary size (the interleaved
    one: the text tokeniser's length with the units, <speech> and <text>);
  * training_args.remat or gradient_checkpointing turns on the decoder's
    activation checkpointing;
  * report_to=wandb logs through wandb where it is installed;
  * the run_time and train_max_tokens stoppers;
  * data.packing and data.packing_strategy;
  * resume through cont_training.
Everything runs on the CUDA card unless training_args.use_cpu=true.
training_args.multihost=true raises: multi-host training is not ported.
"""
import logging
import os

from ..config import main
from ..data.dataset import init_dataset
from ..models.unit_lm import tlm_factory
from ..tokeniser import tokeniser_factory
from ..trainer import MaxTokensStopperCallback, RunTimeStopperCallback, SLAMTrainer
from ..utils.device import DEFAULT_DEVICE
from ..utils.init_utils import init_wandb

logger = logging.getLogger(__name__)


@main(config_name="train", config_path="../../config")
def train(cfg):
    logging.basicConfig(level=logging.INFO)
    if cfg.training_args.get("multihost", False):
        raise NotImplementedError("training_args.multihost=true: multi-host training is not "
                                  "ported yet (ROADMAP queue 1 item 14)")
    device = "cpu" if cfg.training_args.get("use_cpu", False) else DEFAULT_DEVICE
    if cfg.tokeniser.tokeniser_type == "interleave":
        # interleaved data: text tokeniser must match the model base
        if cfg.tokeniser.params.text_tokeniser_path != cfg.model.config_args.base_model_name:
            logger.warning(
                "Text tokeniser %s doesn't match model, changing it to: %s",
                cfg.tokeniser.params.text_tokeniser_path,
                cfg.model.config_args.base_model_name)
            cfg.tokeniser.params.text_tokeniser_path = cfg.model.config_args.base_model_name

    if cfg.get("train_max_tokens", None) is not None and cfg.get("ds_token_size", 0) > 0:
        EPS = 0.01
        cfg.training_args.num_train_epochs = (
            cfg.train_max_tokens / cfg.ds_token_size) * (1 + EPS)
        logger.info("Updated num_train_epochs to %s from train_max_tokens",
                    cfg.training_args.num_train_epochs)

    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    logger.info("tokeniser inited")

    ds = init_dataset(cfg, tokeniser)
    logger.info("datasets loaded: train=%d rows", len(ds["train"]))

    if cfg.model.config_args.vocab_size == -1:
        logger.info("Model vocab_size is -1, setting to tokeniser vocab size")
        cfg.model.config_args.vocab_size = len(tokeniser.text_tokeniser)
    if bool(cfg.training_args.get("remat", False)) or \
            bool(cfg.training_args.get("gradient_checkpointing", False)):
        cfg.model.config_args.remat = True
    model = tlm_factory(cfg.model, device=device)
    logger.info("model inited on %s", model.device)

    log_fn = None
    if cfg.logger.report_to == "wandb":
        run = init_wandb(cfg, os.path.basename(os.path.normpath(cfg.training_args.output_dir)))
        if run is not None:
            log_fn = run.log
        logger.info("wandb inited")

    callbacks = []
    if cfg.get("run_time", None) is not None:
        callbacks.append(RunTimeStopperCallback(cfg.run_time))
    if cfg.get("train_max_tokens", None) is not None:
        callbacks.append(MaxTokensStopperCallback(cfg.train_max_tokens))

    trainer = SLAMTrainer(
        model=model,
        args=cfg.training_args,
        train_dataset=ds["train"],
        eval_dataset=ds.get("validation"),
        callbacks=callbacks,
        packing=bool(cfg.data.get("packing", False)),
        packing_strategy=cfg.data.get("packing_strategy", "bestfit"),
        context_len=cfg.model.context_len,
        log_fn=log_fn,
    )
    return trainer.train(resume_from_checkpoint=cfg.get("cont_training", False))


if __name__ == "__main__":
    train()
