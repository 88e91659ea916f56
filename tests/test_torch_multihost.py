"""Training across several hosts (`training_args.multihost=true`,
`parallel/multihost.py`): two torchrun nodes of two gloo ranks on the CPU,
started by `tools/multinode.py::launch_nodes` (`--nnodes 2 --node_rank k
--nproc_per_node 2 --master_addr 127.0.0.1`), against one node of four and
the JAX package, as `tests/test_multihost.py` holds two JAX processes to
one (pythia-14m's widths at two layers, vocabulary 64, float32).

  * One launch of the two nodes runs every case through the port's
    command-line entry points, with an absolute (shared) output_dir: DP
    [4], TP [2, 2] ('model' inside each node), fsdp [4] and CP ('data',
    'seq') [2, 2] ('seq' inside each node) pretraining for 4 steps with a
    save at step 3, DPO on [4] and `cli.eval eval_mesh=4` (sBLIMP). One
    launch of one node of four runs the same cases and resumes the two
    nodes' DP checkpoint-3. The pretraining losses and the scores equal one
    node's bit for bit (the same gloo collectives over the same ranks), DPO
    within `tests/test_torch_parallel_dpo.py`'s 1e-5; the DP losses equal
    the JAX trainer's on a 4-device CPU mesh within
    `tests/test_torch_tp_jax.py`'s rtol 2e-4; the two nodes' checkpoints
    are one node's, file for file, in the one-rank format; the resume on
    one node repeats step 4 bit for bit, and in one process within 1e-5
    (one process sums a step's loss and gradients in another order).
  * Under one node the saves ran on the writer thread, which made no
    `torch.distributed` call; over two nodes every save ran on the main
    thread (synchronous), and no rank called `torch.distributed` from
    another thread.
  * Refusals, each launch ending non-zero by itself within 60 s with a
    message naming the fault (and the node): an output_dir each node
    resolves to a directory of its own (a relative path, each node in its
    own working directory), a checkpoint to resume from that one node
    cannot see, a launch over two nodes without the flag, and the flag
    without torchrun.
  * Unit tests: the topology read from torchrun's environment, which axes
    cross nodes, `async_allowed`, and no collective from the saver thread.
"""
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.config import compose as jax_compose
from slamkit_tpu.data.dataset import init_dataset as jax_init_dataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.tokeniser import tokeniser_factory as jax_tokeniser_factory
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu_torch.cli import train as port_train
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.parallel import Mesh, mesh as port_mesh, multihost
from slamkit_tpu_torch.tools.multinode import launch_nodes
from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus, write_preference_rows
from slamkit_tpu_torch.trainer import SLAMTrainer, checkpoint

import torch_mesh_workers
from test_torch_eval_mesh import _sblimp_files

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = str(pathlib.Path(torch_mesh_workers.__file__))
PYTHIA64 = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
                torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))
PYTHIA502 = dict(PYTHIA64, vocab_size=502)
STEPS, PER_RANK = 4, 2
#: what a training run logs that does not depend on the clock
LOGGED = ("loss", "eval_loss", "learning_rate", "num_input_tokens_seen", "epoch")
#: (name, mesh overrides, per-rank rows) of the pretraining cases
MESHES = {"dp": (["training_args.mesh_shape=[4]"], PER_RANK),
          "tp": (["training_args.mesh_shape=[2,2]", "training_args.mesh_axes=[data,model]"],
                 2 * PER_RANK),
          "fsdp": (["training_args.mesh_shape=[4]", "training_args.fsdp=true"], PER_RANK),
          # the ring's chunks: 128 positions
          "cp": (["training_args.mesh_shape=[2,2]", "training_args.mesh_axes=[data,seq]",
                  "model.context_len=256"], 2 * PER_RANK)}


def _env():
    return {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
            "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def _train_overrides(d, out, per_rank, *extra):
    return [f"model.pretrained_model={d / 'ckpt64'}", "model.context_len=64",
            "model.config_args.torch_dtype=float32", f"data.train_path={d / 'tokens.jsonl'}",
            f"data.val_path={d / 'val.jsonl'}", "data.packing=true",
            f"training_args.output_dir={out}", f"training_args.max_steps={STEPS}",
            f"training_args.per_device_train_batch_size={per_rank}",
            f"training_args.per_device_eval_batch_size={per_rank}",
            "training_args.logging_steps=1", "training_args.save_steps=3",
            f"training_args.eval_steps={STEPS}", "training_args.warmup_steps=1",
            "training_args.use_cpu=true", *extra]


def _dpo_overrides(d, out, *extra):
    return [f"model.pretrained_model={d / 'ckpt502'}", "model.config_args.torch_dtype=float32",
            f"data.train_path={d / 'pref.jsonl'}", f"data.val_path={d / 'pref.jsonl'}",
            f"training_args.output_dir={out}", "training_args.max_steps=3",
            "training_args.per_device_train_batch_size=1", "training_args.logging_steps=1",
            "training_args.save_steps=1", "training_args.use_cpu=true", *extra]


def _eval_overrides(d, *extra):
    return [f"model.pretrained_model={d / 'ckpt502'}", "model.config_args.torch_dtype=float32",
            "metric=sblimp", f"metric.data_path={d / 'sblimp'}", "metric.subfolder=false",
            f"tokeniser.feature_extractor.pretrained_model={d / 'hubert'}",
            f"tokeniser.feature_extractor.kmeans_path={d / 'km.npy'}",
            "tokeniser.feature_extractor.layer=2", "batch_size=3", "device=cpu", *extra]


def _cases(d, out, flag):
    """Every case of one launch under `out`, with `flag` (the multihost
    override or nothing) on each training run."""
    cases = [[name, "train", _train_overrides(d, out / name, per, *mesh, *flag)]
             for name, (mesh, per) in MESHES.items()]
    return cases + [["dpo", "dpo", _dpo_overrides(d, out / "dpo", *flag)],
                    ["eval", "eval", _eval_overrides(d, "eval_mesh=4")]]


def _launch(tmp, cases, nodes, per_node, spy=False, timeout=240):
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "cli_cases.json").write_text(json.dumps({"cases": cases, "spy": spy}))
    runs = launch_nodes([WORKER, "cli_cases", str(tmp), "--torchrun"], nodes=nodes,
                        per_node=per_node, env=_env(), timeout=timeout)
    for r in runs:
        assert r.returncode == 0 and not r.stopped, (r.node, r.stderr[-6000:])
    return [json.loads((tmp / f"cli_cases-{rank}.json").read_text())
            for rank in range(nodes * per_node)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two launches: two nodes of two ranks, then one node of four with
    the resume of the two nodes' DP checkpoint-3."""
    d = tmp_path_factory.mktemp("multihost")
    JaxUnitLM(JaxUnitLMConfig(**PYTHIA64), seed=0).save_pretrained(str(d / "ckpt64"))
    UnitLM(UnitLMConfig(**PYTHIA502), seed=0, device="cpu").save_pretrained(str(d / "ckpt502"))
    write_markov_corpus(d / "tokens.jsonl", 80, lengths=(20, 100), n_units=60)
    write_markov_corpus(d / "val.jsonl", 8, lengths=(20, 100), seed=1, n_units=60)
    write_preference_rows(d / "pref.jsonl", 12, prompt_len=20, completion_len=10)
    _sblimp_files(d)
    two = _launch(d / "two", _cases(d, d / "two", ["training_args.multihost=true"]), 2, 2,
                  spy=True)
    resume = ["resume", "train",
              _train_overrides(d, d / "one" / "resume", PER_RANK, *MESHES["dp"][0],
                               f"cont_training={d / 'two' / 'dp' / 'checkpoint-3'}")]
    one = _launch(d / "one", _cases(d, d / "one", []) + [resume], 1, 4, spy=True)
    return d, two, one


def _pick(history, key):
    return [r[key] for r in history if key in r]


@pytest.mark.parametrize("name", list(MESHES))
def test_two_nodes_train_as_one_node_bit_for_bit(runs, name):
    d, two, one = runs
    want = one[0][name]
    assert len(_pick(want, "loss")) == STEPS and len(_pick(want, "eval_loss")) == 1
    for rank in two + one:
        for key in LOGGED:
            assert _pick(rank[name], key) == _pick(want, key), (name, key)
    # the checkpoints: the one-rank format, file for file one node's
    for step in (3, STEPS):
        ckpt = pathlib.Path(f"checkpoint-{step}")
        with np.load(d / "two" / name / ckpt / "params.npz") as a, \
                np.load(d / "one" / name / ckpt / "params.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        a, b = (torch.load(d / run / name / ckpt / "state" / "train_state.pt",
                           weights_only=True) for run in ("two", "one"))
        assert sorted(a["params"]) == sorted(b["params"])
        for k, v in b["params"].items():
            assert torch.equal(a["params"][k], v), k
    ref = UnitLM.from_pretrained(str(d / "ckpt64"), device="cpu")
    with np.load(d / "two" / name / "checkpoint-3" / "params.npz") as a:
        from slamkit_tpu_torch.models import to_flat
        assert {k: v.shape for k, v in to_flat(ref.decoder).items()} == \
            {k: a[k].shape for k in a.files}
    # no marker is left in the shared directory
    assert not (d / "two" / name / multihost.MARKER_DIR).exists()


def test_two_nodes_dpo_and_eval_equal_one_node(runs):
    d, two, one = runs
    want = one[0]["dpo"]
    assert len(_pick(want, "loss")) == 3 and len(_pick(want, "eval_loss")) == 1
    assert abs(_pick(want, "loss")[-1] - np.log(2)) > 1e-4   # the policy moved
    for rank in two + one:
        for key in ("loss", "rewards/chosen", "rewards/rejected", "rewards/accuracies",
                    "rewards/margins", "eval_loss", "eval_rewards/accuracies"):
            np.testing.assert_allclose(_pick(rank["dpo"], key), _pick(want, key), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        assert rank["eval"] == one[0]["eval"]
    assert one[0]["eval"]


def test_two_nodes_dp_equals_the_jax_trainer(runs):
    """The JAX SLAMTrainer in this process on 4 CPU devices from the same
    checkpoint, on the dataset the JAX package builds from the same files."""
    d, two, _ = runs
    cfg = jax_compose(str(ROOT / "config"), "train", _train_overrides(d, d / "jax", PER_RANK))
    tokeniser = jax_tokeniser_factory(cfg.tokeniser)
    ds = jax_init_dataset(cfg, tokeniser)
    model = JaxUnitLM.from_pretrained(str(d / "ckpt64"))
    want = JaxSLAMTrainer(model, cfg.training_args, ds["train"], ds.get("validation"),
                          packing=True, context_len=64,
                          mesh=JaxMesh(np.array(jax.devices()[:4]), ("data",))
                          ).train().log_history
    assert len(_pick(want, "loss")) == STEPS
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(_pick(two[0]["dp"], key), _pick(want, key), rtol=2e-4,
                                   err_msg=key)


def test_two_node_checkpoint_resumes_on_one_node_and_in_one_process(runs):
    d, two, one = runs
    step4 = _pick(two[0]["dp"], "loss")[-1]
    for rank in one:   # the checkpoint's history, then step 4
        assert _pick(rank["resume"], "loss") == _pick(two[0]["dp"], "loss")
    state = port_train.train(_train_overrides(
        d, d / "one_process", 4 * PER_RANK, f"cont_training={d / 'two' / 'dp' / 'checkpoint-3'}"))
    assert state.global_step == STEPS
    np.testing.assert_allclose(_pick(state.log_history, "loss")[-1], step4, rtol=1e-5)


def test_saves_on_the_writer_thread_make_no_collective(runs):
    """One node's saves ran on the writer thread (async_save), rank 0's
    alone, and no rank made a `torch.distributed` call from another thread
    than its main one."""
    _, _, one = runs
    saves = one[0]["threads"]["save_state"]   # rank 0 writes
    # DP, TP, fsdp and CP at steps 3 and 4; DPO at 1, 2, 3 and its final
    # save; the resume at 4
    assert len(saves) == 2 * 4 + 4 + 1 and all(t.startswith("ckpt-save") for t in saves)
    for rank in one:
        assert rank["threads"]["dist"] == []
    assert all(rank["threads"]["save_state"] == [] for rank in one[1:])


def test_saves_over_two_nodes_are_synchronous(runs):
    """Under training_args.multihost=true over two nodes (`async_allowed`
    in both trainers) rank 0 wrote every checkpoint on its main thread, and
    no rank made a `torch.distributed` call from another thread."""
    _, two, _ = runs
    saves = two[0]["threads"]["save_state"]
    # DP, TP, fsdp and CP at steps 3 and 4; DPO at 1, 2, 3 and its final save
    assert saves == ["MainThread"] * (2 * 4 + 4)
    for rank in two:
        assert rank["threads"]["dist"] == []
    assert all(rank["threads"]["save_state"] == [] for rank in two[1:])


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["non_shared_output_dir", "checkpoint_one_node_cannot_see",
                                  "two_nodes_without_the_flag", "the_flag_without_torchrun"])
def test_refusals_end_every_node(runs, tmp_path, case):
    d = runs[0]
    cwds = [tmp_path / "node0", tmp_path / "node1"]
    for c in cwds:
        c.mkdir()
    flag = ["training_args.multihost=true"]
    out = tmp_path / "out"
    match = {"non_shared_output_dir": "training_args.output_dir out must be one directory that "
                                      "every node shares",
             "checkpoint_one_node_cannot_see": "the checkpoint ckpt/checkpoint-3 to resume from",
             "two_nodes_without_the_flag": "set training_args.multihost=true",
             "the_flag_without_torchrun": "torch.distributed.run --nnodes N"}[case]
    if case == "non_shared_output_dir":
        out = "out"   # each node resolves it in its own working directory
    elif case == "checkpoint_one_node_cannot_see":
        shutil.copytree(d / "two" / "dp" / "checkpoint-3", cwds[0] / "ckpt" / "checkpoint-3")
        flag.append("cont_training=ckpt/checkpoint-3")
    elif case == "two_nodes_without_the_flag":
        flag = []
    cli = ["-m", "slamkit_tpu_torch.cli.train",
           *_train_overrides(d, out, PER_RANK, *MESHES["dp"][0], *flag)]
    if case == "the_flag_without_torchrun":
        proc = subprocess.run([sys.executable, *cli], cwd=cwds[0], env=_env(),
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode != 0 and match in proc.stderr, proc.stderr[-3000:]
        return
    node_runs = launch_nodes(cli, cwds=cwds, env=_env(), timeout=60, stop_others=False)
    for r in node_runs:
        assert not r.stopped and r.returncode != 0 and r.seconds < 60, (r, r.stderr[-3000:])
        assert match in r.stderr, r.stderr[-3000:]
        if case != "two_nodes_without_the_flag":
            assert "failed on node 1 of 2" in r.stderr, r.stderr[-3000:]
    assert not list(tmp_path.glob("**/out/checkpoint-*"))


# --------------------------------------------------------------------------- #
# unit tests: no launch
# --------------------------------------------------------------------------- #
def _torchrun_env(rank, nodes=2, per_node=2, **drop):
    env = {"RANK": rank, "WORLD_SIZE": nodes * per_node, "LOCAL_RANK": rank % per_node,
           "LOCAL_WORLD_SIZE": per_node, "GROUP_RANK": rank // per_node}
    return {k: str(v) for k, v in env.items() if k not in drop}


@pytest.mark.parametrize("env,want", [
    (_torchrun_env(3), port_mesh.Topology(3, 4, 1, 2, 1)),
    (_torchrun_env(1), port_mesh.Topology(1, 4, 1, 2, 0)),
    # a launch that sets only RANK / WORLD_SIZE / LOCAL_RANK: one node
    ({"RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2"}, port_mesh.Topology(2, 4, 2, 4, 0)),
    ({"RANK": "1", "WORLD_SIZE": "2"}, port_mesh.Topology(1, 2, 1, 2, 0)),
    ({}, port_mesh.Topology()),
    (_torchrun_env(2, LOCAL_RANK=None), "names no card of this host"),
    ({**_torchrun_env(2), "LOCAL_WORLD_SIZE": "3"}, "not a whole number of nodes"),
    ({**_torchrun_env(2), "GROUP_RANK": "0"}, "numbers ranks node by node"),
], ids=["node1_local1", "node0_local1", "one_node_no_local_world", "no_local_rank_one_node",
        "no_torchrun", "no_local_rank_two_nodes", "uneven_nodes", "out_of_order"])
def test_topology_from_torchruns_environment(env, want):
    if isinstance(want, str):
        with pytest.raises((RuntimeError, ValueError), match=want):
            port_mesh.topology(env)
        return
    got = port_mesh.topology(env)
    assert got == want and got.nodes == want.world // want.local_world


@pytest.mark.parametrize("shape,axes,crossing", [
    ((4,), ("data",), ("data",)),
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 2), ("data", "seq"), ("data",)),
    ((1, 4), ("data", "model"), ("model",)),
    ((1, 4), ("data", "seq"), ("seq",)),
])
def test_which_axes_cross_nodes_at_two_ranks_a_node(shape, axes, crossing, caplog):
    meshes = [Mesh(axes, shape, rank=r, local_size=2) for r in range(4)]
    assert [m.node for m in meshes] == [0, 0, 1, 1] and meshes[0].nodes == 2
    assert all(m.cross_node_axes == crossing for m in meshes)
    assert Mesh(axes, shape, rank=3).cross_node_axes == () and Mesh(axes, shape).nodes == 1
    with caplog.at_level(logging.INFO, logger=port_mesh.__name__):
        port_mesh._log_layout(meshes[0])
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert f"{', '.join(crossing)} cross nodes" in caplog.records[0].getMessage()
    assert bool(warned) == (crossing[0] in ("model", "seq"))


def test_async_saves_only_on_one_node(caplog):
    with caplog.at_level(logging.WARNING, logger=checkpoint.__name__):
        assert checkpoint.async_allowed(True, 1) and not caplog.records
        assert not checkpoint.async_allowed(True, 2)
        assert "async_save disabled on multihost (2 nodes)" in caplog.text
        assert not checkpoint.async_allowed(False, 1) and not checkpoint.async_allowed(False, 2)


@pytest.mark.parametrize("env,flag,match", [
    ({}, True, "torch.distributed.run --nnodes N"),
    (_torchrun_env(0), False, "spans 2 nodes of 2 ranks"),
    (_torchrun_env(0), True, None),
    (_torchrun_env(0, nodes=1, per_node=4), True, None),
    (_torchrun_env(0, nodes=1, per_node=4), False, None),
    ({}, False, None),
])
def test_check_launch(monkeypatch, env, flag, match):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if match is None:
        multihost.check_launch(flag)
    else:
        with pytest.raises(RuntimeError, match=match):
            multihost.check_launch(flag)


def test_the_saver_thread_makes_no_collective(tmp_path, monkeypatch):
    """One process with async saves: every `checkpoint.save_state` runs on
    the writer thread, and nothing there calls `torch.distributed` (the
    gather of a sharded state runs on the main thread before the write;
    the sharded paths are held by the launches above)."""
    import torch.distributed as dist

    for name, fn in list(vars(dist).items()):   # monkeypatch puts back what the spy wraps
        if callable(fn):
            monkeypatch.setattr(dist, name, fn)
    monkeypatch.setattr(checkpoint, "save_state", checkpoint.save_state)
    seen = torch_mesh_workers.spy_on_threads()
    args = {"output_dir": str(tmp_path), "per_device_train_batch_size": 2, "max_steps": 3,
            "learning_rate": 1e-3, "save_steps": 1, "logging_steps": 1, "async_save": True,
            "save_total_limit": 2}
    rng = np.random.default_rng(0)
    from slamkit_tpu_torch.data import TokenDataset

    ds = TokenDataset.from_lists([rng.integers(2, 64, int(n)).tolist()
                                  for n in rng.integers(8, 30, 24)])
    state = SLAMTrainer(UnitLM(UnitLMConfig(**PYTHIA64), seed=0, device="cpu"), args, ds,
                        packing=True, context_len=32).train()
    assert state.global_step == 3
    assert len(seen["save_state"]) == 3 and all(t.startswith("ckpt-save")
                                                for t in seen["save_state"])
    assert seen["dist"] == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint-2", "checkpoint-3"]
