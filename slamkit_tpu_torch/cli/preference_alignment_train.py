"""Preference stage 2 on the port: DPO from a preference features jsonl.

    python -m slamkit_tpu_torch.cli.preference_alignment_train \
        model.pretrained_model=<checkpoint> data.train_path=<pref.jsonl> \
        data.val_path=<pref.jsonl> [overrides ...]

The counterpart of `cli/preference_alignment_train.py`, on the repo's
`config/` tree (preference_alignment_train.yaml: model=twist,
dpo_training_args, the repetition-filtered preference data), with its rules
line for line:
  * an interleave tokeniser raises;
  * vocab_size = -1 takes the tokeniser's vocabulary size;
  * report_to=wandb logs through wandb where it is installed;
  * run_time sets the wall-clock stopper;
  * resume through cont_training (the reference stays the model built from
    model.pretrained_model).
Everything runs on the CUDA card unless training_args.use_cpu=true. Under
torchrun (WORLD_SIZE > 1) each process joins the process group on its own
card (gloo on the CPU) and trains its pairs of every global batch on the
'data' axis of training_args.mesh_shape (null: every rank on 'data'):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m slamkit_tpu_torch.cli.preference_alignment_train ... training_args.mesh_shape=[4]

training_args.fsdp=true shards the policy and the reference over 'data'
(ZeRO-3, `parallel/fsdp.py`); beside a 'model' axis over each 'model'
coordinate's 'data' line, the weights whole across 'model' as JAX's DPO
keeps them. A 'seq' axis raises. training_args.multihost=true
trains over several hosts, torchrun on each (`torch.distributed.run --nnodes
N --node_rank k ...`, as `cli.train` says): data.train_path / val_path must
exist on every node and training_args.output_dir must be shared by them
(both checked); without torchrun it raises, and so does a launch over
several nodes without it.
"""
import logging
import os

from ..config import main
from ..data.preference import init_preference_optimization_dataset
from ..models.unit_lm import tlm_factory
from ..parallel import make_mesh, multihost, process_group
from ..tokeniser import tokeniser_factory
from ..trainer import RunTimeStopperCallback, SLAMDPOTrainer
from ..utils.device import DEFAULT_DEVICE
from ..utils.init_utils import init_wandb

logger = logging.getLogger(__name__)


@main(config_name="preference_alignment_train", config_path="../../config")
def train(cfg):
    logging.basicConfig(level=logging.INFO)
    if cfg.tokeniser.tokeniser_type == "interleave":
        raise ValueError("Interleave tokeniser not supported for Preference Alignment yet")
    multihost.check_launch(bool(cfg.training_args.get("multihost", False)))
    device = "cpu" if cfg.training_args.get("use_cpu", False) else DEFAULT_DEVICE
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        with process_group(device) as device:
            return _train(cfg, device)
    return _train(cfg, device)


def _train(cfg, device):
    mesh = make_mesh(cfg.training_args.get("mesh_shape", None),
                     cfg.training_args.get("mesh_axes", None))
    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    logger.info("tokeniser inited")
    if mesh.nodes > 1:
        multihost.check_data_paths(cfg.data, mesh, device)
    ds = init_preference_optimization_dataset(cfg.data)
    logger.info("datasets loaded")

    if cfg.model.config_args.vocab_size == -1:
        cfg.model.config_args.vocab_size = len(tokeniser.text_tokeniser)
    model = tlm_factory(cfg.model, device=device)
    logger.info("model inited on %s", model.device)

    log_fn = None
    if cfg.logger.report_to == "wandb" and mesh.rank == 0:
        run = init_wandb(cfg, os.path.basename(os.path.normpath(cfg.training_args.output_dir)))
        if run is not None:
            log_fn = run.log

    callbacks = []
    if cfg.get("run_time", None) is not None:
        callbacks.append(RunTimeStopperCallback(cfg.run_time))

    trainer = SLAMDPOTrainer(
        model=model,
        tokenizer=tokeniser,
        args=cfg.training_args,
        train_dataset=ds["train"],
        eval_dataset=ds.get("validation"),
        callbacks=callbacks,
        log_fn=log_fn,
        mesh=mesh,
    )
    return trainer.train(resume_from_checkpoint=cfg.get("cont_training", None))


if __name__ == "__main__":
    train()
