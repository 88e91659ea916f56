"""The port's mesh (`slamkit_tpu_torch/parallel/mesh.py`) against the JAX
package's (`slamkit_tpu/parallel/mesh.py`) on the suite's 8 CPU devices:
the shapes and axes `make_mesh` takes and refuses, with JAX's messages; each
rank's `local_tile` of a batch against the slice JAX's `shard_batch` places
on the device at the rank's mesh position (`devices_indices_map`); the fsdp
rule; and the refusals that have no JAX counterpart (a rank without its
card). No process group is started, a rank's mesh being built for its rank
directly, except where a ('data', 'model', 'seq') mesh is built on 4 gloo
ranks (`torch_mesh_workers.launch`).
"""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.parallel import mesh as jax_mesh
from slamkit_tpu_torch.parallel import mesh as port_mesh
from slamkit_tpu_torch.ops.ring_attention import zigzag_permutation

import torch_mesh_workers

torch.set_num_threads(1)

N_DEVICES = 8


def _jax_result(shape, axes):
    try:
        m = jax_mesh.make_mesh(shape, axes)
        return ("ok", tuple(m.devices.shape), tuple(m.axis_names))
    except ValueError as e:
        return ("error", str(e))


def _port_result(shape, axes):
    try:
        return ("ok",) + port_mesh.check_mesh(shape, axes, N_DEVICES)
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("shape,axes", [
    (None, None), ([8], None), ([4, 2], None), ([2, 4], ["data", "seq"]),
    ([1, 8], ["data", "seq"]), ([2, 2, 2], ["data", "model", "seq"]),
    ([4], None), ([4, 4], ["data", "seq"]), ([8], ["seq"]), ([4, 2], ["data", "pipe"]),
    ([4, 2], ["data"]), ([2, 2, 2], None), ([8, 1], ["data", "model"])])
def test_make_mesh_takes_and_refuses_what_jax_does(shape, axes):
    assert jax.device_count() == N_DEVICES
    assert _port_result(shape, axes) == _jax_result(shape, axes)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("t", [512, 6])
def test_local_tile_is_what_shard_batch_places(shape, t):
    """Every rank's tile of a [B, T] batch, a [B, T, D] array and a [B]
    vector equals the slice JAX's batch sharding puts on the device at the
    rank's row-major mesh position (a T that does not divide 'seq' stays
    whole in time, as in JAX)."""
    axes = ("data", "seq")
    jm = JaxMesh(np.asarray(jax.devices()[:4]).reshape(shape), axes)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 100, (4, t)).astype(np.int32),
             "features": rng.standard_normal((4, t, 3)).astype(np.float32),
             "weights": rng.standard_normal(4).astype(np.float32)}
    for rank in range(4):
        mesh = port_mesh.Mesh(axes, shape, rank)
        got = port_mesh.local_tile(batch, mesh)
        device = jm.devices.reshape(-1)[rank]
        for key, v in batch.items():
            ndim = np.ndim(v)
            sharding = (jax_mesh.batch_sharding(jm, v.shape[1] if ndim == 2 else None, ndim)
                        if ndim >= 2 else jax_mesh.replicated(jm))
            want = v[sharding.devices_indices_map(v.shape)[device]]
            np.testing.assert_array_equal(got[key], want, err_msg=f"{key} rank {rank}")


def test_local_tile_refuses_rows_that_do_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.local_tile({"x": np.zeros((3, 8))}, port_mesh.Mesh(("data",), (2,), 1))


@pytest.mark.parametrize("shape", [(8, 896), (896, 4864), (7,), (), (3, 5), (16, 6, 4)])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_spec_is_jax_rule(shape, n):
    jm = JaxMesh(np.asarray(jax.devices()[:n]), ("data",))
    assert port_mesh.fsdp_spec(shape, port_mesh.Mesh(("data",), (n,))) == \
        tuple(jax_mesh.fsdp_spec(shape, jm))


def test_seq_axis_size_and_shards():
    """The shard a rank's forward sees: its rows and its logical columns
    (contiguous chunk, or zigzag's two half-chunks)."""
    mesh = port_mesh.Mesh(("data", "seq"), (2, 2), rank=3)
    assert port_mesh.seq_axis_size(mesh) == 2
    assert port_mesh.seq_axis_size(port_mesh.Mesh(("data",), (4,))) == 1
    s = mesh.shard(8, 512)
    assert (s.rows, s.rank, s.size) == (slice(4, 8), 1, 2)
    np.testing.assert_array_equal(s.cols, np.arange(256, 512))
    z = mesh.shard(8, 512, "zigzag")
    np.testing.assert_array_equal(z.cols, zigzag_permutation(512, 2)[256:])
    np.testing.assert_array_equal(z.cols, np.r_[128:256, 256:384])
    full = torch.arange(8 * 512).reshape(8, 512)
    np.testing.assert_array_equal(z.tile(full).numpy(), full.numpy()[4:8][:, z.cols])


def test_one_rank_mesh_needs_no_process_group():
    mesh = port_mesh.make_mesh(None, None)
    assert (mesh.axis_names, mesh.sizes, mesh.rank, mesh.device_mesh) == \
        (("data",), (1,), 0, None)
    assert mesh.group("seq") is None
    with pytest.raises(ValueError, match="device count 1"):
        port_mesh.make_mesh([2], None)


def test_a_rank_outside_its_group_raises(monkeypatch):
    """A process torchrun started as one of several ranks raises until it
    has joined their group, instead of training alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="joined no process group"):
        port_mesh.make_mesh(None, None)


def test_model_axis_raises_naming_the_roadmap(tmp_path):
    """A 'model' axis is ported (tensor parallelism): beside 'data' it
    passes the JAX rules, and beside a 'seq' axis above 1 (ROADMAP item 29,
    ported) the mesh no longer raises: `make_mesh([1, 2, 2], ['data',
    'model', 'seq'])` builds on 4 gloo ranks, each at its row-major
    coordinate, its 'model' and 'seq' lines and its batch group (the 'seq'
    line: the one 'data' coordinate's plane) those of that coordinate."""
    assert port_mesh.check_mesh([2, 2], ["data", "model"], 4) == ((2, 2), ("data", "model"))
    assert port_mesh.check_mesh([2, 2], None, 4) == ((2, 2), ("data", "model"))
    got = torch_mesh_workers.launch("mesh_groups", 4, tmp_path, shape=[1, 2, 2],
                                    orders=[["data", "model", "seq"]])
    assert [r["0/coordinate"].tolist() for r in got] == [[0, m, s] for m in range(2)
                                                         for s in range(2)]
    assert [r["0/model"].tolist() for r in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["0/seq"].tolist() for r in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["0/batch"].tolist() for r in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    # the batch goes over 'data' alone: both ranks of a 'model' line hold
    # the same tile, rows and dropout shape
    meshes = [port_mesh.Mesh(("data", "model"), (2, 2), rank=r) for r in range(4)]
    assert [m.coordinate for m in meshes] == [{"data": d, "model": m}
                                              for d in range(2) for m in range(2)]
    shards = [m.shard(8, 64) for m in meshes]
    assert [s.rows for s in shards] == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    assert [m.row_tile(5).lo for m in meshes] == [0, 0, 3, 3]


def test_a_rank_without_its_card_raises(monkeypatch):
    """A local rank past the host's cards (every rank here: no card) raises
    before any process group exists."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    monkeypatch.setenv("RANK", str(local))
    monkeypatch.setenv("WORLD_SIZE", str(local + 1))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    with pytest.raises(RuntimeError, match="has no CUDA card"):
        port_mesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()
