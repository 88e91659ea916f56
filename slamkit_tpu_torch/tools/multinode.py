"""Two torchrun nodes on one host: the multi-host path, run and measured.

    python -m slamkit_tpu_torch.tools.multinode

`launch_nodes(target, ...)` starts one `torch.distributed.run --nnodes N
--node_rank k --nproc_per_node G --master_addr 127.0.0.1 --master_port
<free port>` a node, each in its own process group, working directory and
environment (on the card: `CUDA_VISIBLE_DEVICES` a node's cards), with
`target` (`-m module args ...` or a script and its arguments) on every rank.
When one node's launch fails the others are stopped at once, so no rank
waits in a collective for a peer that is gone; a launch past `timeout`
seconds is stopped too. Each node's output goes to files, returned with its
exit status and wall seconds.

`main()` needs four cards of one host, the first four that this process may
use (its own `CUDA_VISIBLE_DEVICES`, else cards 0-3). It runs
`tools/parallel_smoke.py`'s nodes leg (the Slam recipe on DP [4], TP [2, 2]
with 'model' inside a node, and fsdp [4]: step 1 against one card, the
exact resume, one card resuming the mesh's checkpoint-3, step time,
tokens/s, peaks and NCCL shares) in three launches:

  1. one node of 4, the reference;
  2. two nodes of 2 (the first two of those cards and the other two) with
     `training_args.multihost=true` and a 300 s bound on every collective
     (`init_process_group`'s timeout);
  3. DP alone (the nodes_dp leg) on the two nodes again with
     `NCCL_P2P_DISABLE=1 NCCL_SHM_DISABLE=1`, set here for that launch only,
     so that NCCL's traffic between the ranks goes through its socket
     transport, as between hosts without NVLink or InfiniBand.

Both nodes live on one host: NCCL sees one host name and, in (2), joins the
nodes' cards over NVLink as it would inside one node; (3) measures its socket
transport over loopback, not a real network. Each launch logs NCCL's
transports (`NCCL_DEBUG=INFO` into files under the work directory), which
are counted by kind. Every mesh's four losses and step 1's gradient norm of
(2) must equal (1)'s bit for bit (the same ranks, the same NCCL algorithm);
those of (3) must lie within SOCKET_BOUND of (1)'s (the socket transport
may sum in another order). The last line of the output is one JSON object;
the exit status is 1 if a launch or a check failed. The three launches
share TIME_LIMIT seconds.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pathlib
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: seconds every collective of a two-node launch may wait
COLLECTIVE_TIMEOUT = 300
#: seconds `main` may take in all (`chip_smoke.py` phase 17 gives it 900)
TIME_LIMIT = 870
#: what `NCCL_P2P_DISABLE` / `NCCL_SHM_DISABLE` leave NCCL between ranks
SOCKET_ENV = {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"}
#: nats (every step's loss) and relative error (step 1's gradient norm) that
#: the socket run may differ from one node by
SOCKET_BOUND = 1e-5


@dataclasses.dataclass
class NodeRun:
    """One node's launch: its exit status, output and wall seconds, and
    whether it was `stopped` (another node failed, or time ran out) rather
    than ending by itself."""
    node: int
    returncode: Optional[int]
    stdout: str
    stderr: str
    seconds: float
    stopped: bool = False


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(proc: subprocess.Popen, grace: float = 10.0):
    """SIGTERM to the launch's process group (torchrun and its ranks), then
    SIGKILL after `grace` seconds."""
    for sig, wait in ((signal.SIGTERM, grace), (signal.SIGKILL, None)):
        if proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(wait)
        except subprocess.TimeoutExpired:
            continue


def launch_nodes(target: Sequence[str], nodes: int = 2, per_node: int = 2,
                 cwds: Optional[Sequence] = None, env: Optional[dict] = None,
                 node_envs: Optional[Sequence[dict]] = None, timeout: float = 900.0,
                 logs: Optional[pathlib.Path] = None, stop_others: bool = True) -> list:
    """Start `nodes` torchrun launches of `per_node` ranks each running
    `target`, on one rendezvous at 127.0.0.1 (module docstring); returns
    each node's `NodeRun`. `cwds`: each node's working directory; `env`:
    every node's environment (default this process's); `node_envs`: what
    each node adds to it; `logs`: where the output files go (default a
    temporary directory, removed). With `stop_others` false a failed node
    leaves the others running until they end or time runs out (a test of
    how every node ends by itself)."""
    import tempfile

    port = free_port()
    keep = logs is not None
    logs = pathlib.Path(logs or tempfile.mkdtemp(prefix="multinode-"))
    logs.mkdir(parents=True, exist_ok=True)
    procs, files, t0 = [], [], time.perf_counter()
    try:
        for k in range(nodes):
            out, err = (open(logs / f"node{k}.{s}", "w+") for s in ("out", "err"))
            files.append((out, err))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nodes),
                   "--node_rank", str(k), "--nproc_per_node", str(per_node),
                   "--master_addr", "127.0.0.1", "--master_port", str(port), *target]
            procs.append(subprocess.Popen(
                cmd, cwd=None if cwds is None else cwds[k],
                env={**(os.environ if env is None else env), **(node_envs[k] if node_envs
                                                                 else {})},
                stdout=out, stderr=err, start_new_session=True))
        ended = [None] * nodes
        while any(e is None for e in ended):
            time.sleep(0.2)
            for k, p in enumerate(procs):
                if ended[k] is None and p.poll() is not None:
                    ended[k] = time.perf_counter() - t0
            if (stop_others and any(p.returncode not in (None, 0) for p in procs)) or \
                    time.perf_counter() - t0 > timeout:
                break   # a node failed (or time is up): stop the others
    finally:
        for p in procs:
            _stop(p)
    runs = []
    for k, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        runs.append(NodeRun(k, p.returncode, out.read(), err.read(),
                            ended[k] or time.perf_counter() - t0, stopped=ended[k] is None))
        out.close()
        err.close()
    if not keep:
        shutil.rmtree(logs, ignore_errors=True)
    return runs


def _last_json(stdout: str) -> Optional[dict]:
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def nccl_transports(logs: pathlib.Path) -> dict:
    """Connections by NCCL transport (P2P/IPC, P2P/CUMEM, SHM, NET/Socket,
    ...) in the `NCCL_DEBUG=INFO` files of one launch."""
    counts = collections.Counter()
    for path in logs.glob("nccl.*"):
        for line in path.read_text(errors="replace").splitlines():
            m = re.search(r"\bvia (\S+)", line)
            if m and "Channel" in line:
                counts[m.group(1)] += 1
    return dict(counts)


def _smoke(legs: str, multihost: bool) -> list:
    return ["-m", "slamkit_tpu_torch.tools.parallel_smoke", "--legs", legs,
            *(["--multihost", "--timeout", str(COLLECTIVE_TIMEOUT)] if multihost else [])]


def compare(name: str, got: dict, want: dict, bound: float = 0.0) -> dict:
    """Every step's loss and step 1's gradient norm of a mesh over nodes
    (`got`, a `parallel_smoke` row) against the same mesh on one node
    (`want`): the largest loss error in nats and the gradient norm's
    relative error, each within `bound` (0: bit for bit)."""
    steps = len(got["losses"]) == len(want["losses"])
    loss_err = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    norm_err = abs(got["grad_norm_step1"] - want["grad_norm_step1"]) / want["grad_norm_step1"]
    return {"mesh": name, "loss_err": loss_err, "grad_norm_rel_err": norm_err,
            "losses_equal": got["losses"] == want["losses"], "bound": bound,
            "ok": steps and loss_err <= bound and norm_err <= bound}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 4:
        print(f"multinode: two nodes of two cards need 4 CUDA cards; this host has {cards}",
              file=sys.stderr)
        return 1
    from .slam_recipe import nvidia_smi

    print(nvidia_smi(), flush=True)
    work = ROOT / "build" / "multinode"
    shutil.rmtree(work, ignore_errors=True)
    # the cards this process was given, never others of the host
    mine = [c.strip() for c in os.environ.get(
        "CUDA_VISIBLE_DEVICES", ",".join(map(str, range(cards)))).split(",")][:4]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ",".join(mine), "NCCL_DEBUG": "INFO"}
    halves = [{"CUDA_VISIBLE_DEVICES": ",".join(mine[:2])},
              {"CUDA_VISIBLE_DEVICES": ",".join(mine[2:])}]
    result, ok = {"cards": mine, "nvidia_smi": nvidia_smi()}, True

    def record(name: str, runs: list, logs: pathlib.Path):
        nonlocal ok
        out = _last_json(runs[0].stdout)
        result[name] = {"seconds": [r.seconds for r in runs],
                        "returncodes": [r.returncode for r in runs],
                        "nccl_transports": nccl_transports(logs), "result": out}
        print(runs[0].stdout[-5000:], flush=True)
        print(f"multinode {name}: exit {[r.returncode for r in runs]} in "
              f"{[round(r.seconds, 1) for r in runs]} s; NCCL transports "
              f"{result[name]['nccl_transports']}", flush=True)
        if out is None or any(r.returncode != 0 for r in runs):
            ok = False
            for r in runs:
                print(f"--- node {r.node} stderr ---\n{r.stderr[-4000:]}", file=sys.stderr,
                      flush=True)
        return out

    # (1) one node of four, (2) two nodes of two, (3) DP again on the two
    # nodes over NCCL's socket transport; each with its bound against (1)
    runs = {"one_node": ("nodes", 1, {}, None), "two_nodes": ("nodes", 2, {}, 0.0),
            "two_nodes_socket": ("nodes_dp", 2, SOCKET_ENV, SOCKET_BOUND)}
    one, deadline = None, time.perf_counter() + TIME_LIMIT
    for name, (legs, nodes, extra, bound) in runs.items():
        logs = work / name
        got = record(name, launch_nodes(
            _smoke(legs, nodes > 1), nodes=nodes, per_node=4 // nodes, cwds=[ROOT] * nodes,
            env={**env, **extra, "NCCL_DEBUG_FILE": str(logs / "nccl.%h.%p")},
            node_envs=halves if nodes > 1 else None,
            timeout=max(deadline - time.perf_counter(), 60), logs=logs), logs)
        if nodes == 1:
            one = got
        if got is None or one is None or nodes == 1:
            continue
        result[name]["vs_one_node"] = [
            compare(mesh, got["nodes"][mesh], one["nodes"][mesh], bound) for mesh in got["nodes"]]
        for c in result[name]["vs_one_node"]:
            print(f"multinode {name} {c['mesh']}: largest |d loss| over the steps "
                  f"{c['loss_err']:.3e}, step 1 gradient norm rel {c['grad_norm_rel_err']:.3e} "
                  f"against one node of 4 (<= {bound}); losses equal {c['losses_equal']}  "
                  f"{'ok' if c['ok'] else 'FAIL'}", flush=True)
            ok = ok and c["ok"]
    if one is not None and result["two_nodes_socket"]["result"] is not None:
        for name in ("one_node", "two_nodes", "two_nodes_socket"):
            row = (result[name]["result"] or {}).get("nodes", {}).get("dp")
            if row:
                p = row.get("profiled_step", {})
                print(f"multinode DP [4] {name}: {row['step_s']:.4f} s a step, "
                      f"{row['tokens_per_s']:.1f} tokens/s, all-reduce "
                      f"{p.get('all_reduce_share', 0):.4f} of a {p.get('wall_ms', 0):.1f} ms "
                      f"profiled step", flush=True)
    result["ok"] = ok
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
