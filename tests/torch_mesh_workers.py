"""Rank processes for the port's multi-process CPU tests (gloo, no card).

`launch(fn, world, tmp)` starts `world` copies of this file as torchrun
would (RANK / WORLD_SIZE / LOCAL_RANK in the environment); each joins the
process group through `parallel.init_distributed("cpu")` over a FileStore
under `tmp` (so parallel test files never share a port), runs `fn` on its
rank and saves what it computed to `tmp/<fn>-<rank>.npz`. The test reads
those files back. Nothing here imports JAX; with `block=True` the ranks
refuse to import it (and the other packages the card's host lacks).

Under torchrun itself (`python -m torch.distributed.run ... tests/
torch_mesh_workers.py <fn> <tmp> --torchrun`, as `tools/multinode.py`
starts its nodes) a rank joins torchrun's group (`parallel.process_group`)
and `fn` runs the port's command-line entry points in it, which keep it;
the result goes to `tmp/<fn>-<rank>.json`.
"""
from __future__ import annotations

import importlib.abc
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO_ROOT = HERE.parent
BLOCKED = ("jax", "slamkit_tpu", "yaml", "transformers", "tokenizers", "safetensors", "nltk",
           "openai")


class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port must run without it")
        return None


def launch(fn: str, world: int, tmp: pathlib.Path, timeout: float = 240.0,
           block: bool = False, per_node: int = 0, **kwargs):
    """Run `fn(**kwargs)` on `world` ranks (with `block`, none may import
    JAX and the rest of `BLOCKED`; with `per_node`, torchrun's environment
    of nodes of that many ranks); returns each rank's saved arrays."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / f"{fn}.json").write_text(json.dumps(kwargs))
    store = tmp / f"{fn}.store"
    if store.exists():
        store.unlink()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO_ROOT))
        if per_node:
            env.update(LOCAL_RANK=str(rank % per_node), LOCAL_WORLD_SIZE=str(per_node),
                       GROUP_RANK=str(rank // per_node))
        procs.append(subprocess.Popen([sys.executable, __file__, fn, str(tmp),
                                       *(["--block"] if block else [])], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{out[-4000:]}" for r, out in enumerate(outputs)))
    return [dict(np.load(tmp / f"{fn}-{r}.npz")) for r in range(world)]


# --------------------------------------------------------------------------- #
# ring attention
# --------------------------------------------------------------------------- #
def ring(tmp, inputs, schedule, dtype="float32"):
    """This rank's chunk of `inputs` (q, k, v, seg, do: global arrays, the
    sequence already zigzag-permuted for that schedule) through
    `ring_flash_attention` over the world as one 'seq' group: out, dq, dk, dv."""
    import torch
    import torch.distributed as dist

    from slamkit_tpu_torch.ops.ring_attention import ring_flash_attention

    g = dict(np.load(inputs))
    n, r = dist.get_world_size(), dist.get_rank()
    c = g["q"].shape[2] // n
    part = lambda x, dim: torch.from_numpy(np.ascontiguousarray(
        np.take(x, np.arange(r * c, (r + 1) * c), axis=dim)))
    dt = getattr(torch, dtype)
    q, k, v = (part(g[name], 2).to(dt).requires_grad_() for name in ("q", "k", "v"))
    out = ring_flash_attention(q, k, v, part(g["seg"], 1), group=dist.group.WORLD,
                               schedule=schedule, sm_scale=float(g["scale"]))
    out.backward(part(g["do"], 2).to(dt))
    return {"out": out.detach().float().numpy(), "dq": q.grad.float().numpy(),
            "dk": k.grad.float().numpy(), "dv": v.grad.float().numpy()}


def ring_tp(tmp, inputs, schedule, mesh_shape, mesh_axes):
    """`ring` on a mesh with a 'model' axis: this rank's heads of q, k, v
    (its 'model' coordinate's share of each) and its chunk of the sequence
    (its 'seq' coordinate's) through `ring_flash_attention` over its 'seq'
    group: out, dq, dk, dv, and the coordinate they belong to."""
    import torch

    from slamkit_tpu_torch.ops.ring_attention import ring_flash_attention
    from slamkit_tpu_torch.parallel import make_mesh

    g = dict(np.load(inputs))
    mesh = make_mesh(mesh_shape, mesh_axes)
    at, n, m = mesh.coordinate, mesh.shape["seq"], mesh.shape["model"]
    c = g["q"].shape[2] // n
    cols = np.arange(at["seq"] * c, (at["seq"] + 1) * c)

    def part(x, heads=True):
        if heads:
            h = x.shape[1] // m
            x = x[:, at["model"] * h:(at["model"] + 1) * h]
        return torch.from_numpy(np.ascontiguousarray(np.take(x, cols, axis=-2 if heads
                                                             else 1)))

    q, k, v = (part(g[name]).requires_grad_() for name in ("q", "k", "v"))
    out = ring_flash_attention(q, k, v, part(g["seg"], heads=False), group=mesh.group("seq"),
                               schedule=schedule, sm_scale=float(g["scale"]))
    out.backward(part(g["do"]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy(), "model": np.asarray(at["model"]),
            "seq": np.asarray(at["seq"])}


def mesh_groups(tmp, shape, orders):
    """For each axis order of `orders` on a mesh of `shape`: this rank's
    coordinate and the global ranks of its `batch_group()` (the world: all
    ranks) and of its 'model' and 'seq' lines."""
    import torch.distributed as dist

    from slamkit_tpu_torch.parallel import make_mesh

    out = {}
    for i, axes in enumerate(orders):
        mesh = make_mesh(shape, axes)
        group = mesh.batch_group()
        out[f"{i}/batch"] = np.asarray(list(range(dist.get_world_size())) if group is None
                                       else dist.get_process_group_ranks(group))
        for axis in ("model", "seq"):
            out[f"{i}/{axis}"] = np.asarray(dist.get_process_group_ranks(mesh.group(axis)))
        out[f"{i}/coordinate"] = np.asarray([mesh.coordinate[a] for a in axes])
    return out


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def record_grads(trainer) -> list:
    """Make `trainer` keep a copy of the gradients each optimizer step
    reads (on a mesh: the all-reduced global gradient, gathered whole
    where it is sharded over 'data' or split over 'model'); returns the list
    they are appended to, one {parameter name: array} a step."""
    from slamkit_tpu_torch.models.convert import whole
    from slamkit_tpu_torch.parallel.tensor import whole_of

    steps, step = [], trainer.optimizer.step

    def recording_step(*a, **kw):
        steps.append({n: whole_of(p, whole(p.grad.detach())).clone().numpy()
                      for n, p in trainer.model.decoder.named_parameters()
                      if p.grad is not None})
        return step(*a, **kw)

    trainer.optimizer.step = recording_step
    return steps


def _params(params_path):
    """The flat JAX-layout weights saved at `params_path`, or None."""
    if params_path is None:
        return None
    with np.load(params_path) as flat:
        return {k: flat[k] for k in flat.files}


def train(tmp, config, args, train_seqs, eval_seqs, context_len, params_path=None):
    """`SLAMTrainer` on the mesh of `args` (training_args as a dict), a fresh
    `UnitLM(config, seed=0)` (or the weights at `params_path`) and
    `train_seqs` packed at `context_len`, then a second trainer resuming
    from the first's checkpoint-1 (`train_runs`' runs "a" and "b")."""
    first = args["output_dir"]
    return train_runs(tmp, config, [["a", args, None],
                                    ["b", {**args, "output_dir": first + "_b"},
                                     first + "/checkpoint-1"]],
                      train_seqs, eval_seqs, context_len, params_path)


def train_runs(tmp, config, runs, train_seqs, eval_seqs, context_len, params_path=None):
    """`SLAMTrainer` runs one after another in this rank's process group,
    each `runs` entry [name, args (training_args as a dict, its mesh's),
    a checkpoint to resume from or None] from a fresh `UnitLM(config,
    seed=0)` (or the weights at `params_path`) over `train_seqs` packed at
    `context_len`: each run's logged losses and eval losses, the gradients
    of each step it took, its final parameters and every parameter as this
    rank holds it (`<name>/local/<parameter>`)."""
    from slamkit_tpu_torch.data import TokenDataset
    from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
    from slamkit_tpu_torch.parallel.fsdp import local
    from slamkit_tpu_torch.trainer import SLAMTrainer

    out = {}
    for name, args, resume in runs:
        model = UnitLM(UnitLMConfig(**config), params=_params(params_path), seed=0,
                       device="cpu")
        tr = SLAMTrainer(model, args, TokenDataset.from_lists(train_seqs),
                         eval_dataset=TokenDataset.from_lists(eval_seqs), packing=True,
                         context_len=context_len)
        grads = record_grads(tr)
        history = tr.train(resume_from_checkpoint=resume or False).log_history
        out[f"{name}/loss"] = np.asarray([r["loss"] for r in history if "loss" in r])
        out[f"{name}/eval_loss"] = np.asarray([r["eval_loss"] for r in history
                                               if "eval_loss" in r])
        out.update({f"{name}/param/{k}": v for k, v in to_flat(model.decoder).items()})
        out.update({f"{name}/grad{i}/{k}": v for i, g in enumerate(grads) for k, v in g.items()})
        out.update({f"{name}/local/{k}": local(p.detach()).numpy()
                    for k, p in model.decoder.named_parameters()})
    return out


#: what a DPO run logs: each step's loss and reward metrics, the evaluation
DPO_KEYS = ("loss", "rewards/chosen", "rewards/rejected", "rewards/accuracies",
            "rewards/margins", "eval_loss", "eval_rewards/accuracies")


def dpo(tmp, config, args, train_rows, eval_rows, params_path=None):
    """`SLAMDPOTrainer` on the mesh of `args` (training_args as a dict) from
    a fresh `UnitLM(config, seed=0)` (or the weights at `params_path`) over
    `train_rows` (preference rows of unit strings), then a second trainer
    resuming from the first's checkpoint-1: each run's logged `DPO_KEYS`,
    the first run's gradients of each step, and each run's final
    parameters."""
    from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
    from slamkit_tpu_torch.tokeniser import UnitTokeniser
    from slamkit_tpu_torch.trainer import SLAMDPOTrainer

    out = {}
    first = args["output_dir"]
    for run, resume in (("a", None), ("b", first + "/checkpoint-1")):
        model = UnitLM(UnitLMConfig(**config), params=_params(params_path), seed=0,
                       device="cpu")
        tr = SLAMDPOTrainer(model, UnitTokeniser(num_units=60),
                            {**args, "output_dir": first + ("" if run == "a" else "_b")},
                            train_rows, eval_dataset=eval_rows)
        grads = record_grads(tr)
        history = tr.train(resume_from_checkpoint=resume).log_history
        out.update({f"{run}/{key}": np.asarray([r[key] for r in history if key in r])
                    for key in DPO_KEYS})
        out.update({f"{run}/param/{k}": v for k, v in to_flat(model.decoder).items()})
        if run == "a":
            out.update({f"a/grad{i}/{k}": v for i, g in enumerate(grads) for k, v in g.items()})
    return out


def eval_calls(tlm, tokens, prompts, int8: bool = False) -> dict:
    """The scoring and sampling calls the eval-mesh test compares: mean and
    summed log-likelihoods, with ignored ids, and greedy, sampled and
    penalised generations of the left-padded `prompts` (with `int8`, also
    the int8 greedy one)."""
    mask = (prompts != tlm.config.pad_token_id).astype(np.int32)
    out = {"ll": tlm.log_likelihood(tokens), "ll_sum": tlm.log_likelihood(tokens, mean_nll=False),
           "ll_ignore": tlm.log_likelihood(tokens, ignore_tokens=[5, 6, 7]),
           "greedy": tlm.generate(prompts, mask, max_new_tokens=6, do_sample=False),
           "sampled": tlm.generate(prompts, mask, max_new_tokens=6, top_k=20, temperature=0.8,
                                   seed=3),
           "penalised": tlm.generate(prompts, mask, max_new_tokens=6, top_p=0.9,
                                     repetition_penalty=1.3, bad_words_ids=[[9]], seed=4)}
    if int8:
        out["int8"] = tlm.generate(prompts, mask, max_new_tokens=6, do_sample=False,
                                   weight_quant="int8")
    return {k: v.numpy() for k, v in out.items()}


def eval_mesh(tmp, ckpt, tokens, prompts, fsdp=False, overrides=None, tp_shape=None, tp=True):
    """`UnitLM.shard` over the world's 'data' mesh (with `fsdp`, the weights
    sharded too; with `tp_shape` [d, m], a ('data', 'model') mesh and
    `tp=True`, or `tp` False: 'model' replicas): `eval_calls` on the global
    `tokens` and `prompts` (lists), every rank's results (with `fsdp` or
    `tp_shape`, the int8 greedy call too). overrides: `from_pretrained`
    keyword overrides."""
    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.parallel import make_mesh

    tlm = UnitLM.from_pretrained(ckpt, device="cpu", **(overrides or {}))
    if tp_shape is None:
        tlm.shard(make_mesh(), fsdp=fsdp)
    else:
        tlm.shard(make_mesh(tp_shape, ["data", "model"]), fsdp=fsdp, tp=tp)
    return eval_calls(tlm, np.asarray(tokens, np.int32), np.asarray(prompts, np.int32),
                      int8=fsdp or tp_shape is not None)


# --------------------------------------------------------------------------- #
# tensor parallelism
# --------------------------------------------------------------------------- #
def tp_forward(tmp, config, params_path, ids, mesh_shape):
    """The decoder split over a ('data', 'model') mesh of `mesh_shape`
    (`shard_decoder_tp`): this rank's 'data' rows of `ids` forward, the
    vocab columns and then the rows gathered (`logits`), and the shape of
    every parameter this rank holds (`shape/<name>`)."""
    import torch

    from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
    from slamkit_tpu_torch.parallel import make_mesh
    from slamkit_tpu_torch.parallel.tensor import gather_vocab, shard_decoder_tp

    tlm = UnitLM(UnitLMConfig(**config), params=_params(params_path), device="cpu")
    mesh = make_mesh(mesh_shape, ["data", "model"])
    shard_decoder_tp(tlm.decoder, mesh)
    ids = torch.tensor(ids)
    tile = mesh.row_tile(len(ids))
    with torch.no_grad():
        logits, _ = tlm.decoder(tile.mine(ids, 0))
    out = {"logits": tile.gather(gather_vocab(logits, tlm.decoder.tp)).numpy()}
    out.update({f"shape/{k}": np.asarray(p.shape) for k, p in tlm.decoder.named_parameters()})
    return out


def tp_int8(tmp, ckpt, prompts, mesh_shape):
    """`UnitLM.shard(tp=True)`'s int8 decode copy on a ('data', 'model')
    mesh: every projection's q and s as this rank holds them, and the int8
    prefill's last-position logits of the global `prompts` (gathered)."""
    import torch

    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.models.generate import _QUANT_KEYS
    from slamkit_tpu_torch.parallel import make_mesh
    from slamkit_tpu_torch.parallel.tensor import gather_vocab

    tlm = UnitLM.from_pretrained(ckpt, device="cpu")
    mesh = make_mesh(mesh_shape, ["data", "model"])
    tlm.shard(mesh, tp=True)
    dec = tlm._int8_decode_params()
    out = {f"{part}/{i}/{key}": getattr(layer, key)[part].float().numpy()
           for i, layer in enumerate(dec.layers) for key in _QUANT_KEYS
           if isinstance(getattr(layer, key, None), dict) for part in ("q", "s")}
    ids = torch.tensor(prompts)
    tile = mesh.row_tile(len(ids))
    with torch.inference_mode():
        logits, _ = dec(tile.mine(ids, 0))
    out["logits"] = tile.gather(gather_vocab(logits[:, -1], dec.tp)).numpy()
    return out


def fsdp_on_one_line(tmp, config, args, train_seqs, context_len):
    """On a ('data', 'model') mesh of one 'data' coordinate: `SLAMTrainer`
    built with `training_args.fsdp=true` (what it split and sharded), then
    `UnitLM.shard(mesh, fsdp=True, tp=True)` (the same, and the warnings
    it logged)."""
    import logging

    from slamkit_tpu_torch.data import TokenDataset
    from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
    from slamkit_tpu_torch.parallel import make_mesh
    from slamkit_tpu_torch.parallel.fsdp import is_sharded
    from slamkit_tpu_torch.parallel.tensor import is_tp
    from slamkit_tpu_torch.trainer import SLAMTrainer

    mesh = make_mesh(args["mesh_shape"], args["mesh_axes"])
    tr = SLAMTrainer(UnitLM(UnitLMConfig(**config), seed=0, device="cpu"), args,
                     TokenDataset.from_lists(train_seqs), context_len=context_len, mesh=mesh)
    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    log = logging.getLogger("slamkit_tpu_torch.models.unit_lm")
    log.addHandler(Keep())
    tlm = UnitLM(UnitLMConfig(**config), seed=0, device="cpu").shard(mesh, fsdp=True, tp=True)
    return {"trainer": np.asarray([is_tp(tr.model.decoder), is_sharded(tr.model.decoder)]),
            "shard": np.asarray([is_tp(tlm.decoder), is_sharded(tlm.decoder)]),
            "warnings": np.asarray(json.dumps(warnings))}


def fsdp_placement(tmp, config, params_path):
    """`UnitLM.shard(fsdp=True)` of the weights at `params_path` over the
    world's 'data' mesh: this rank's local shard of every parameter, by
    `named_parameters()` name."""
    from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
    from slamkit_tpu_torch.parallel import make_mesh
    from slamkit_tpu_torch.parallel.fsdp import local

    tlm = UnitLM(UnitLMConfig(**config), params=_params(params_path), device="cpu")
    tlm.shard(make_mesh(), fsdp=True)
    return {name: local(p.detach()).numpy() for name, p in tlm.decoder.named_parameters()}


def parallel_smoke(tmp, context, rows, n_rows, lengths, legs=("meshes", "dpo", "eval"),
                   sims=None, eval_sizes=None, multihost=False):
    """`tools/parallel_smoke.run` of `legs` on the CPU at a 2-layer, 64-wide
    decoder in float32 (`sims`: the sims7b leg's `sims_*` keyword
    arguments; `eval_sizes`: `run_eval`'s; `multihost`: its own): its
    result as JSON, and the blocked modules loaded."""
    import torch

    from slamkit_tpu_torch.models import UnitLMConfig
    from slamkit_tpu_torch.tools import parallel_smoke as smoke

    cfg = UnitLMConfig(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
                       torch_dtype="float32", rope_theta=10000,
                       config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                             num_attention_heads=4, num_key_value_heads=2,
                                             head_dim=16, intermediate_size=128))
    work = tmp / "work"
    work.mkdir(exist_ok=True)
    result = smoke.run(torch.device("cpu"), work, cfg=cfg, context=context, rows=rows,
                       n_rows=n_rows, lengths=tuple(lengths), legs=tuple(legs),
                       eval_sizes=eval_sizes, multihost=multihost,
                       **{f"sims_{k}": v for k, v in (sims or {}).items()})
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    return {"result": np.asarray(json.dumps(result)), "loaded": np.asarray(json.dumps(loaded))}


# --------------------------------------------------------------------------- #
# several nodes: the command-line entry points under torchrun
# --------------------------------------------------------------------------- #
def spy_on_threads() -> dict:
    """Record every `torch.distributed` function (but isend / irecv, whose
    identity `P2POp` checks) called from a thread other than the main one
    (`dist`: [thread, function] pairs) and the threads
    `checkpoint.save_state` ran on (`save_state`)."""
    import threading

    import torch.distributed as dist

    from slamkit_tpu_torch.trainer import checkpoint

    seen = {"dist": [], "save_state": []}

    def wrap(name, fn):
        def spy(*a, **kw):
            if threading.current_thread() is not threading.main_thread():
                seen["dist"].append([threading.current_thread().name, name])
            return fn(*a, **kw)
        return spy

    for name, fn in list(vars(dist).items()):
        # `P2POp` checks its op by identity with isend / irecv: those two stay
        # (a point-to-point exchange goes through batch_isend_irecv, wrapped)
        if callable(fn) and not isinstance(fn, type) and name not in ("isend", "irecv") and \
                getattr(fn, "__module__", "").startswith("torch.distributed"):
            setattr(dist, name, wrap(name, fn))
    save = checkpoint.save_state

    def save_state(*a, **kw):
        seen["save_state"].append(threading.current_thread().name)
        return save(*a, **kw)

    checkpoint.save_state = save_state
    return seen


def cli_cases(tmp, cases, spy=False):
    """Each of `cases` ([name, cli, overrides]: cli `train`, `dpo` or
    `eval`) through the port's entry point on this rank of torchrun's
    launch: a training run's `log_history` or the evaluation's scores, by
    name; with `spy`, what `spy_on_threads` saw."""
    from slamkit_tpu_torch.cli import eval as port_eval
    from slamkit_tpu_torch.cli import preference_alignment_train as port_dpo
    from slamkit_tpu_torch.cli import train as port_train

    seen = spy_on_threads() if spy else None
    entry = {"train": port_train.train, "dpo": port_dpo.train, "eval": port_eval.eval_main}
    out = {}
    for name, cli, overrides in cases:
        got = entry[cli](list(overrides))
        out[name] = got if cli == "eval" else got.log_history
    if spy:
        out["threads"] = seen
    return out


def main():
    fn, tmp = sys.argv[1], pathlib.Path(sys.argv[2])
    if "--block" in sys.argv[3:]:
        sys.meta_path.insert(0, _Blocker())
    import torch

    torch.set_num_threads(1)
    from slamkit_tpu_torch.parallel import init_distributed, process_group

    if "--torchrun" in sys.argv[3:]:
        with process_group("cpu"):
            result = globals()[fn](tmp, **json.loads((tmp / f"{fn}.json").read_text()))
        (tmp / f"{fn}-{os.environ['RANK']}.json").write_text(json.dumps(result, default=float))
        return

    init_distributed("cpu", init_method=f"file://{tmp / (fn + '.store')}")
    import torch.distributed as dist

    try:
        result = globals()[fn](tmp, **json.loads((tmp / f"{fn}.json").read_text()))
        np.savez(tmp / f"{fn}-{dist.get_rank()}.npz", **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
