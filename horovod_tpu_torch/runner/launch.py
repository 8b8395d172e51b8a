"""``hvdrun`` for the port: the horovodrun-equivalent launcher
(counterpart of ``horovod_tpu/runner/launch.py``; ref: horovod/runner/
launch.py:715 CLI, gloo_run.py:65-258 worker spawn and env contract).

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch -np 4 -H h1:2,h2:2 python train.py
    python -m horovod_tpu_torch.runner.launch --min-np 2 --max-np 4 \\
        --host-discovery-script ./discover.sh python train.py

A static launch runs one process per slot and tears every worker down at
the first failure; ``--min-np``/``--host-discovery-script`` select the
elastic launch (``runner/elastic/launcher.py``). With no host given, the
job runs on ``localhost`` with ``-np`` slots, or one a card.

Each worker gets the HOROVOD_RANK/SIZE/LOCAL_*/CROSS_* contract, the
address of the launcher's HTTP rendezvous server and its HMAC secret, and
HOROVOD_STORE_PORT: the launcher hosts a ``torch.distributed.TCPStore``
at the rendezvous address, on which ``hvd.init()`` forms its process
groups (under the prefix HOROVOD_MESH_SCOPE), so the store lives in no
worker that can die. The JAX package's TCP-backend knobs
(HOROVOD_CONTROLLER, HOROVOD_CPU_OPERATIONS) are not set: the port has
no TCP backend (ROADMAP A6). Remote hosts launch over ssh. The
task-service launch (HVDRUN_USE_TASK_SERVICE) waits for ROADMAP A7.

Teardown sends each worker HOROVOD_PREEMPT_SIGNAL, the drain plane's
notice (``common/drain.py``), and waits out the drain grace before
SIGKILL: a worker drains, or exits 0.
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

from ..common import env as env_cfg
from . import config_parser
from .hosts import SlotInfo, default_hosts, get_host_assignments, parse_hostfile, parse_hosts
from .rendezvous_server import RendezvousServer

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def terminate_grace() -> float:
    """Seconds a worker has to exit after the preemption signal before
    SIGKILL: the drain grace (it may be writing its final checkpoint), at
    least 10."""
    return max(10.0, env_cfg.drain_grace_seconds())


def is_local_host(hostname: str) -> bool:
    # HVDRUN_FORCE_LOCAL treats every host as local: distinct fake host
    # names on one machine, without ssh.
    if os.environ.get("HVDRUN_FORCE_LOCAL"):
        return True
    if hostname in _LOCAL_NAMES:
        return True
    try:
        return hostname in (socket.gethostname(), socket.getfqdn())
    except OSError:  # pragma: no cover
        return False


def slot_env(
    slot: SlotInfo,
    rendezvous_addr: str,
    rendezvous_port: int,
    extra_env: Optional[Dict[str, str]] = None,
    elastic: bool = False,
    secret_key: Optional[bytes] = None,
    store_port: Optional[int] = None,
) -> Dict[str, str]:
    """The worker env contract (ref: gloo_run.py:65-198). Against the JAX
    package's: no HOROVOD_CONTROLLER/HOROVOD_CPU_OPERATIONS, and
    HOROVOD_STORE_PORT when the launcher hosts a store."""
    env = {
        env_cfg.RANK: str(slot.rank),
        env_cfg.SIZE: str(slot.size),
        env_cfg.LOCAL_RANK: str(slot.local_rank),
        env_cfg.LOCAL_SIZE: str(slot.local_size),
        env_cfg.CROSS_RANK: str(slot.cross_rank),
        env_cfg.CROSS_SIZE: str(slot.cross_size),
        env_cfg.RENDEZVOUS_ADDR: rendezvous_addr,
        env_cfg.RENDEZVOUS_PORT: str(rendezvous_port),
        env_cfg.HOSTNAME: slot.hostname,
    }
    if store_port is not None:
        env[env_cfg.STORE_PORT] = str(store_port)
    if elastic:
        env[env_cfg.ELASTIC] = "1"
    if secret_key is not None:
        from .util import secret as secret_util

        env[env_cfg.SECRET_KEY] = secret_util.key_to_env(secret_key)
    if extra_env:
        env.update(extra_env)
    return env


def build_ssh_command(hostname: str, command: Sequence[str], env: Dict[str, str],
                      ssh_port: Optional[int] = None,
                      ssh_identity_file: Optional[str] = None) -> List[str]:
    """ssh invocation for a remote slot (ref: runner/util/remote.py). The
    job secret never appears on a command line: the remote command reads
    it from stdin, where ``spawn_worker`` writes it."""
    env = dict(env)
    has_secret = env.pop(env_cfg.SECRET_KEY, None) is not None
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh += ["-i", ssh_identity_file]
    remote_cmd = f"cd {shlex.quote(os.getcwd())} && env {exports} " + " ".join(
        shlex.quote(c) for c in command)
    if has_secret:
        remote_cmd = (f"IFS= read -r {env_cfg.SECRET_KEY} && "
                      f"export {env_cfg.SECRET_KEY} && " + remote_cmd)
    return ssh + [hostname, remote_cmd]


class WorkerHandle:
    """One launched worker, in a process group of its own."""

    def __init__(self, slot: SlotInfo, proc: subprocess.Popen):
        self.slot = slot
        self.proc = proc
        self.threads: List[threading.Thread] = []

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.proc.wait(timeout=timeout)

    def _signal(self, sig):
        try:
            os.killpg(os.getpgid(self.proc.pid), sig)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self):
        # The teardown is a preemption notice (HOROVOD_PREEMPT_SIGNAL): a
        # worker drains or exits 0, as it would for the platform's.
        self._signal(env_cfg.preempt_signal())

    def kill(self):
        self._signal(signal.SIGKILL)


def _forward_stream(stream, sink, prefix: str):
    for line in iter(stream.readline, b""):
        try:
            sink.write(f"{prefix}{line.decode(errors='replace')}")
            sink.flush()
        except ValueError:  # sink closed
            break
    stream.close()


def spawn_worker(slot: SlotInfo, command: Sequence[str], env: Dict[str, str],
                 verbose: bool = False, prefix_output: bool = True,
                 ssh_port: Optional[int] = None,
                 ssh_identity_file: Optional[str] = None) -> WorkerHandle:
    full_env = dict(os.environ)
    full_env.update(env)
    remote = not is_local_host(slot.hostname)
    secret = env.get(env_cfg.SECRET_KEY) if remote else None
    argv = (build_ssh_command(slot.hostname, command, env, ssh_port, ssh_identity_file)
            if remote else list(command))
    proc = subprocess.Popen(
        argv, env=full_env,
        stdin=subprocess.PIPE if secret else None,
        stdout=subprocess.PIPE if prefix_output else None,
        stderr=subprocess.PIPE if prefix_output else None,
        start_new_session=True)  # own process group, for a clean teardown
    if secret:
        try:
            proc.stdin.write((secret + "\n").encode())
            proc.stdin.flush()
        except (BrokenPipeError, OSError):
            pass
    handle = WorkerHandle(slot, proc)
    if prefix_output:
        # The reference's "[1]<stdout>:" prefix (ref: gloo_run.py:149-162).
        for stream, sink, tag in ((proc.stdout, sys.stdout, "stdout"),
                                  (proc.stderr, sys.stderr, "stderr")):
            t = threading.Thread(target=_forward_stream,
                                 args=(stream, sink, f"[{slot.rank}]<{tag}>:"),
                                 daemon=True)
            t.start()
            handle.threads.append(t)
    return handle


def terminate_workers(handles: List[WorkerHandle]):
    for h in handles:
        if h.poll() is None:
            h.terminate()
    for h in handles:
        try:
            h.wait(timeout=terminate_grace())
        except subprocess.TimeoutExpired:
            h.kill()


def _check_task_service():
    if os.environ.get("HVDRUN_USE_TASK_SERVICE"):
        raise NotImplementedError(
            "HVDRUN_USE_TASK_SERVICE is set, but the task-service launch "
            "(runner/service.py) is not ported yet (ROADMAP A7); unset it to run")


def driver_addr(slots: Sequence[SlotInfo]) -> str:
    """The address workers reach the launcher at: loopback when every slot
    is local, else HVDRUN_DRIVER_ADDR or this host's name."""
    if all(is_local_host(s.hostname) for s in slots):
        return "127.0.0.1"
    return os.environ.get("HVDRUN_DRIVER_ADDR") or socket.gethostname()


def host_store():
    """The job's ``torch.distributed.TCPStore``, served from this process
    on every interface at a free port (``.port`` says which); workers reach
    it at the rendezvous address."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, None, True, timeout=timedelta(seconds=60),
                         wait_for_workers=False)


def launch_static(
    slots: List[SlotInfo],
    command: Sequence[str],
    extra_env: Optional[Dict[str, str]] = None,
    verbose: bool = False,
    rendezvous: Optional[RendezvousServer] = None,
    prefix_output: bool = True,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
) -> int:
    """One process per slot; the first failure tears everything down (ref:
    gloo_run.py:243-258). Returns the first nonzero exit code, or 0."""
    _check_task_service()
    own_server = rendezvous is None
    if own_server:
        from .util import secret as secret_util

        server = RendezvousServer(secret_key=secret_util.make_secret_key())
        port = server.start()
    else:
        server, port = rendezvous, rendezvous.port
    addr = driver_addr(slots)
    store = host_store()
    handles: List[WorkerHandle] = []
    exit_code = 0
    try:
        for slot in slots:
            handles.append(spawn_worker(
                slot, command,
                slot_env(slot, addr, port, extra_env, secret_key=server.secret_key,
                         store_port=store.port),
                verbose, prefix_output, ssh_port, ssh_identity_file))
        pending = set(range(len(handles)))
        while pending:
            for i in sorted(pending):
                rc = handles[i].poll()
                if rc is None:
                    continue
                pending.discard(i)
                if rc != 0:
                    exit_code = exit_code or rc
                    if verbose:
                        print(f"hvdrun: rank {handles[i].slot.rank} exited with {rc}; "
                              "terminating remaining workers", file=sys.stderr)
                    terminate_workers([handles[j] for j in pending])
                    pending.clear()
                    break
            else:
                time.sleep(0.05)
    except BaseException:
        terminate_workers(handles)
        raise
    finally:
        for h in handles:
            for t in h.threads:
                t.join(timeout=5)
        if own_server:
            server.stop()
        del store
    return exit_code


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun", description="Launch a horovod_tpu_torch distributed job "
        "(horovodrun equivalent)")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of processes")
    p.add_argument("-H", "--hosts", default=None, help='comma list "host1:slots,host2:slots"')
    p.add_argument("--hostfile", default=None, help="mpirun-style hostfile")
    p.add_argument("--network-interface", default=None,
                   help="NIC to bind (informational)")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None)
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print which frameworks and backends this build supports, "
                   "then exit (ref: horovodrun --check-build)")
    p.add_argument("--disable-output-prefix", action="store_true",
                   help="don't prefix worker output with [rank]<>")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None)
    p.add_argument("--slots-per-host", type=int, default=None)
    p.add_argument("--reset-limit", type=int, default=None)
    p.add_argument("--config-file", default=None,
                   help="YAML file of flag defaults (ref: horovodrun --config-file)")
    config_parser.add_engine_args(p)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command, e.g. python train.py")
    return p


def _apply_config_file(parser: argparse.ArgumentParser, args):
    """Fill flags still at their default from a YAML file (nested sections
    flattened, ``a-b`` read as ``a_b``); flags given on the command line win."""
    import yaml

    with open(args.config_file) as f:
        data = yaml.safe_load(f) or {}
    flat = {}

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            else:
                flat[str(k).replace("-", "_")] = v

    walk(data)
    known = {a.dest for a in parser._actions}
    unknown = sorted(set(flat) - known)
    if unknown:
        raise SystemExit(f"hvdrun: unknown config-file keys: {', '.join(unknown)}")
    for dest, val in flat.items():
        if getattr(args, dest, None) == parser.get_default(dest):
            setattr(args, dest, val)


def check_build() -> str:
    """What this build of the port runs on (ref: horovod/runner/launch.py:
    106-141 check_build)."""
    from .. import __version__
    from ..common import basics

    def chk(v) -> str:
        return "X" if v else " "

    return (
        f"Horovod-TPU-Torch v{__version__}:\n"
        "\n"
        "Available Frameworks:\n"
        "    [X] PyTorch\n"
        "\n"
        "Available Controllers:\n"
        f"    [{chk(basics.gloo_built())}] Gloo (torch.distributed)\n"
        f"    [{chk(basics.mpi_built())}] MPI\n"
        "\n"
        "Available Tensor Operations:\n"
        f"    [{chk(basics.nccl_built())}] NCCL\n"
        f"    [{chk(basics.gloo_built())}] Gloo\n"
        f"    [{chk(basics.cuda_built())}] CUDA kernels (sm_90a)\n"
    )


def run_commandline(argv: Optional[Sequence[str]] = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.check_build:
        print(check_build())
        return 0
    if args.config_file:
        _apply_config_file(parser, args)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    extra_env = config_parser.args_to_env(args)
    if args.host_discovery_script or args.min_np is not None:
        from .elastic.launcher import launch_elastic

        return launch_elastic(args, command, extra_env)
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = default_hosts(args.num_proc)
    np_ = args.num_proc or sum(h.slots for h in hosts)
    slots = get_host_assignments(hosts, np_, np_)
    if args.verbose:
        for s in slots:
            print(f"hvdrun: rank {s.rank} -> {s.hostname} "
                  f"(local {s.local_rank}/{s.local_size})")
    return launch_static(slots, command, extra_env, args.verbose,
                         prefix_output=not args.disable_output_prefix,
                         ssh_port=args.ssh_port, ssh_identity_file=args.ssh_identity_file)


def main():  # console entry point
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
