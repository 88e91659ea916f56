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
Everything runs on the CUDA card unless training_args.use_cpu=true. Under
torchrun (WORLD_SIZE > 1) each process joins the process group on its own
card (gloo on the CPU) and trains its tile of the mesh that
training_args.mesh_shape / mesh_axes / cp_schedule describe:

    python -m torch.distributed.run --nproc_per_node 4 -m slamkit_tpu_torch.cli.train \
        model=slam ... training_args.mesh_shape=[1,4] training_args.mesh_axes=[data,seq]

training_args.fsdp=true shards the parameters, gradients and optimizer
state over 'data' (ZeRO-3, `parallel/fsdp.py`; the checkpoints keep the
one-rank format). training_args.mesh_shape=[d,m] mesh_axes=[data,model]
splits the decoder's weights over 'model' (tensor parallelism,
`parallel/tensor.py`), the batch over 'data':

    python -m torch.distributed.run --nproc_per_node 4 -m slamkit_tpu_torch.cli.train \
        model=slam ... training_args.mesh_shape=[2,2] training_args.mesh_axes=[data,model]

training_args.multihost=true trains over several hosts: start torchrun on
every node with the same rendezvous, each with its node's rank
(`parallel/multihost.py`):

    python -m torch.distributed.run --nnodes 2 --node_rank k --nproc_per_node 4 \
        --master_addr <node 0> --master_port <port> -m slamkit_tpu_torch.cli.train \
        model=slam ... training_args.multihost=true

Every node reads the same data.train_path / val_path (each must exist on
every node) and keeps its tiles; training_args.output_dir and a
data.saved_ds_path cache must be directories every node shares, which is
checked, every rank raising together where a node cannot see rank 0's.
multihost=true without torchrun raises, and so does a launch over several
nodes without it. training_args.fsdp=true beside a 'model' axis also shards
each rank's slices over 'data' (JAX `tp_shardings(fsdp=True)`):

    python -m torch.distributed.run --nproc_per_node 4 -m slamkit_tpu_torch.cli.train \
        model=slam ... training_args.mesh_shape=[2,2] training_args.mesh_axes=[data,model] \
        training_args.fsdp=true

A 'model' axis beside 'seq' (JAX's three-axis mesh, the names in any
order) splits each layer's heads over 'model' and runs the ring over 'seq'
on the rank's heads, with or without fsdp over 'data':

    python -m torch.distributed.run --nproc_per_node 4 -m slamkit_tpu_torch.cli.train \
        model=slam ... training_args.mesh_shape=[1,2,2] \
        training_args.mesh_axes=[data,model,seq] [training_args.cp_schedule=zigzag] \
        [training_args.fsdp=true]
"""
import logging
import os

import torch.distributed as dist

from ..config import main
from ..data.dataset import init_dataset
from ..models.unit_lm import tlm_factory
from ..parallel import make_mesh, multihost, process_group
from ..tokeniser import tokeniser_factory
from ..trainer import MaxTokensStopperCallback, RunTimeStopperCallback, SLAMTrainer
from ..utils.device import DEFAULT_DEVICE
from ..utils.init_utils import init_wandb

logger = logging.getLogger(__name__)


@main(config_name="train", config_path="../../config")
def train(cfg):
    logging.basicConfig(level=logging.INFO)
    multihost.check_launch(bool(cfg.training_args.get("multihost", False)))
    device = "cpu" if cfg.training_args.get("use_cpu", False) else DEFAULT_DEVICE
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        with process_group(device) as device:
            return _train(cfg, device)
    return _train(cfg, device)


def _train(cfg, device):
    mesh = make_mesh(cfg.training_args.get("mesh_shape", None),
                     cfg.training_args.get("mesh_axes", None))
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

    # rank 0 builds (and, under data.saved_ds_path, caches) the datasets
    # before the other ranks build or load theirs
    if mesh.nodes > 1:
        multihost.check_data_paths(cfg.data, mesh, device)
    if mesh.rank == 0:
        ds = init_dataset(cfg, tokeniser)
    if mesh.size > 1:
        dist.barrier()
        saved = cfg.data.get("saved_ds_path", None)
        if saved and mesh.nodes > 1:
            multihost.every_node(os.path.isdir(saved), f"data.saved_ds_path {saved}, which rank "
                                 f"0 built or loaded, must be a directory every node shares",
                                 mesh, device)
    if mesh.rank:
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
    if cfg.logger.report_to == "wandb" and mesh.rank == 0:
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
        mesh=mesh,
    )
    return trainer.train(resume_from_checkpoint=cfg.get("cont_training", False))


if __name__ == "__main__":
    train()
