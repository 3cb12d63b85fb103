"""Multi-process launcher — the cluster_train script slot (counterpart
of ``paddle_tpu/runtime/launch.py``, with the same env contract).

Reference: paddle/scripts/cluster_train/paddle.py (SSH fan-out of
pserver+trainer processes with --trainer_id etc.) and submit_local.sh.in
(the `paddle` CLI wrapper).

Every process is identical (no pserver role); the launcher just sets
the PADDLE_* env contract (rank, world size, coordinator address) and
execs the worker. Local mode spawns N processes on this machine — the
no-cluster simulation of a multi-host job used by the tests. The
contract is the JAX package's, key for key: it also writes
``PADDLE_PLATFORM=cpu`` (which ``distributed.init`` reads: gloo on the
CPU) and ``PADDLE_LOCAL_CPU_DEVICES`` (from ``devices_per_proc``; a port
rank drives one device, so ``init`` ignores it). The JAX package's
``multiprocess_cpu_supported`` probe (a JAX script) comes with the gang
supervisor (ROADMAP A10b).

Usage:
  python -m paddle_tpu_torch.runtime.launch --nprocs=2 \
      --devices-per-proc=4 worker.py [worker args...]
On a cluster, run one process per host with PADDLE_COORDINATOR pointing
at host 0 instead.
"""

import argparse
import os
import shlex
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_procs(nprocs: int, argv: Sequence[str],
                      devices_per_proc: int = 1,
                      coordinator_port: Optional[int] = None,
                      env_extra: Optional[dict] = None,
                      env_per_rank: Optional[Sequence[dict]] = None,
                      cluster: bool = True) -> List[subprocess.Popen]:
    """Spawn ``nprocs`` local worker processes WITHOUT waiting — the
    restartable-gang primitive the elastic supervisor re-forms on every
    coordination epoch. ``cluster=False`` omits PADDLE_COORDINATOR so
    workers run independent single-process runtimes (the CPU
    simulation path without multi-process collectives); a fresh
    coordinator port per call
    is the 'fresh coordination epoch' in cluster mode (no TIME_WAIT or
    zombie can hold the old port hostage)."""
    port = coordinator_port or free_port()
    procs = []
    for rank in range(nprocs):
        # update() chain, not dict(**kw): callers may legitimately
        # override the contract keys (env_extra={"PADDLE_PLATFORM":
        # ...}) and later layers must win, not TypeError
        env = dict(os.environ)
        env.update(PADDLE_NUM_PROCESSES=str(nprocs),
                   PADDLE_PROCESS_ID=str(rank),
                   PADDLE_PLATFORM="cpu",
                   PADDLE_LOCAL_CPU_DEVICES=str(devices_per_proc))
        env.update(env_extra or {})
        env.update(env_per_rank[rank] if env_per_rank else {})
        if cluster:
            env["PADDLE_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen([sys.executable, *argv], env=env))
    return procs


def terminate_procs(procs: Sequence[subprocess.Popen],
                    grace: float = 3.0) -> None:
    """Tear a gang down: close stdin pipes first (the ssh watchdog path
    — EOF TERM-then-KILLs the REMOTE tree), then TERM every local
    process, then KILL whatever ignored the TERM after ``grace``."""
    for p in procs:
        if p.stdin is not None and not p.stdin.closed:
            try:
                p.stdin.close()
            except OSError:
                pass
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.time() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    pass


def launch_local(nprocs: int, argv: Sequence[str],
                 devices_per_proc: int = 1,
                 coordinator_port: Optional[int] = None,
                 env_extra: Optional[dict] = None,
                 timeout: float = 600.0) -> List[int]:
    """Spawn ``nprocs`` local worker processes and wait; returns their
    return codes. Workers read the PADDLE_* contract to join the
    job."""
    procs = spawn_local_procs(nprocs, argv,
                              devices_per_proc=devices_per_proc,
                              coordinator_port=coordinator_port,
                              env_extra=env_extra)
    return _wait_all(procs, timeout)


def _wait_all(procs: Sequence[subprocess.Popen],
              timeout: float, grace: float = 5.0) -> List[int]:
    deadline = time.time() + timeout
    rcs = []
    for p in procs:
        remain = max(1.0, deadline - time.time())
        try:
            rcs.append(p.wait(timeout=remain))
        except subprocess.TimeoutExpired:
            # ssh-mode teardown: killing only the local
            # ssh client leaves the REMOTE worker tree running — and
            # holding the coordinator port. launch_ssh wraps every remote
            # command in a stdin watchdog (_wrap_remote), so closing our
            # end of the stdin pipe delivers EOF to the watchdog, which
            # TERM-then-KILLs the worker's whole process group; only then
            # is the local client killed if it still lingers.
            if p.stdin is not None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    rcs.append(p.wait(timeout=grace))
                    continue
                except subprocess.TimeoutExpired:
                    pass
            p.kill()
            rcs.append(-9)
    for p in procs:                 # close leftover stdin pipes (ssh mode)
        if p.stdin is not None and not p.stdin.closed:
            try:
                p.stdin.close()
            except OSError:
                pass
    return rcs


def _wrap_remote(cmd: str, grace: float = 3.0) -> str:
    """Wrap a remote command so its whole process tree dies when the ssh
    connection goes away (local timeout/kill, network drop). The worker
    runs in its own session (``setsid`` → its pid is the process-group
    id); a watchdog reads stdin and on EOF — which is what a closed ssh
    connection delivers — TERMs, then after ``grace`` seconds KILLs,
    that group. On normal completion the watchdog group is reaped and
    the worker's exit status is preserved (ssh propagates it)."""
    q = shlex.quote(cmd)
    return (
        # the connection's stdin must reach the BACKGROUNDED watchdog
        # explicitly (fd 3): POSIX shells give async jobs /dev/null as
        # stdin, which would EOF the watchdog instantly
        "exec 3<&0; "
        "if command -v setsid >/dev/null 2>&1; then S=setsid; else S=; fi; "
        f"$S sh -c {q} 3<&- & c=$!; "
        # 'kill -s SIG -- "-pid"' is the pgroup form every sh builtin
        # (dash included) actually parses; pid fallback for setsid-less
        # hosts where the group does not exist
        f"C=$c G={grace} $S sh -c "
        "'cat <&3 >/dev/null; kill -s TERM -- \"-$C\" 2>/dev/null || "
        "kill -s TERM \"$C\" 2>/dev/null; sleep $G; "
        "kill -s KILL -- \"-$C\" 2>/dev/null || "
        "kill -s KILL \"$C\" 2>/dev/null' "
        "& k=$!; exec 3<&-; "
        "wait $c; rc=$?; "
        "kill -s KILL -- \"-$k\" 2>/dev/null || kill -s KILL $k 2>/dev/null; "
        "exit $rc")


def launch_ssh(hosts: Sequence[str], argv: Sequence[str], *,
               port: int = 6007, workdir: Optional[str] = None,
               env_extra: Optional[dict] = None,
               ssh_cmd: Sequence[str] = ("ssh", "-o", "BatchMode=yes"),
               timeout: float = 86400.0) -> List[int]:
    """SSH fan-out: one worker process per host, rank = position in
    ``hosts``, coordinator = ``hosts[0]:port`` (the reference's
    paddle/scripts/cluster_train/paddle.py slot — but every process is
    identical here: no pserver role).

    The PADDLE_* env contract is injected via ``env`` on the remote
    command line, so nothing needs to be pre-configured on the hosts
    beyond the code and its interpreter being present (pass ``workdir``
    to cd into the repo checkout first). Workers read the PADDLE_*
    contract to join the job. Returns per-host return codes
    (ssh propagates the remote exit status).

    Every remote command runs under a process-group watchdog
    (``_wrap_remote``): if the ssh connection drops — including
    ``_wait_all`` timing out and closing the client's stdin — the whole
    remote worker tree is torn down instead of lingering and holding
    the coordinator port."""
    procs = spawn_ssh_procs(hosts, argv, port=port, workdir=workdir,
                            env_extra=env_extra, ssh_cmd=ssh_cmd)
    return _wait_all(procs, timeout)


def spawn_ssh_procs(hosts: Sequence[str], argv: Sequence[str], *,
                    port: int = 6007, workdir: Optional[str] = None,
                    env_extra: Optional[dict] = None,
                    env_per_rank: Optional[Sequence[dict]] = None,
                    ssh_cmd: Sequence[str] = ("ssh", "-o", "BatchMode=yes")
                    ) -> List[subprocess.Popen]:
    """The ssh fan-out WITHOUT waiting — the supervisor's remote-gang
    primitive: it re-invokes this with a patched ``hosts`` list
    (replacement-host injection) and a fresh port per coordination
    epoch, and tears the gang down via ``terminate_procs`` (the stdin
    watchdog reaches the remote trees). Each worker also gets
    ``PADDLE_GANG_HOST`` so host-scoped fault policies and logs can
    name the box they ran on."""
    envs_common = dict(env_extra or {})
    procs = []
    for rank, host in enumerate(hosts):
        envs = {"PADDLE_COORDINATOR": f"{hosts[0]}:{port}",
                "PADDLE_NUM_PROCESSES": str(len(hosts)),
                "PADDLE_PROCESS_ID": str(rank),
                "PADDLE_GANG_HOST": host, **envs_common,
                **(env_per_rank[rank] if env_per_rank else {})}
        exports = " ".join(f"{k}={shlex.quote(str(v))}"
                           for k, v in envs.items())
        cd = f"cd {shlex.quote(workdir)} && " if workdir else ""
        # exec so the wrapper's $c IS the worker process, not an
        # intermediate sh — on setsid-less hosts the watchdog's
        # pid-fallback kill then still reaches the worker itself
        remote = _wrap_remote(cd + "exec env " + exports + " "
                              + " ".join(shlex.quote(a) for a in argv))
        procs.append(subprocess.Popen([*ssh_cmd, host, remote],
                                      stdin=subprocess.PIPE))
    return procs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.runtime.launch",
        description="multi-process launcher: local simulation or ssh "
        "fan-out across hosts")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--hosts", default=None,
                    help="comma-separated host list: ssh mode, one "
                    "worker per host, coordinator on the first")
    ap.add_argument("--port", type=int, default=6007,
                    help="coordinator port (ssh mode)")
    ap.add_argument("--workdir", default=None,
                    help="remote directory to cd into (ssh mode)")
    ap.add_argument("--ssh-cmd", default="ssh -o BatchMode=yes",
                    help="ssh command prefix (ssh mode)")
    ap.add_argument("worker", nargs=argparse.REMAINDER,
                    help="worker script and args")
    args = ap.parse_args(argv)
    if not args.worker:
        ap.error("worker script required")
    if args.hosts:
        rcs = launch_ssh(args.hosts.split(","), args.worker,
                         port=args.port, workdir=args.workdir,
                         ssh_cmd=tuple(args.ssh_cmd.split()),
                         timeout=args.timeout)
    else:
        rcs = launch_local(args.nprocs, args.worker,
                           devices_per_proc=args.devices_per_proc,
                           timeout=args.timeout)
    print(f"launch: workers exited {rcs}")
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
