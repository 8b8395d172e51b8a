"""The port's launcher: the ``hvdrun`` CLI and the programmatic ``run()``
(counterpart of ``horovod_tpu/runner/__init__.py``; ref: horovod/runner/
__init__.py:90 horovod.run). ``python -m horovod_tpu_torch.runner.launch``
is the entry."""
from __future__ import annotations

import functools
import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

from .hosts import HostInfo, SlotInfo, get_host_assignments, parse_hosts
from .rendezvous_server import RendezvousServer


def __getattr__(name):
    # ``launch`` is imported on first use, so that ``python -m
    # horovod_tpu_torch.runner.launch`` runs it once, as __main__.
    if name in ("launch_static", "make_parser", "run_commandline"):
        from . import launch

        return getattr(launch, name)
    raise AttributeError(name)


def run(func: Callable[[], Any], args=(), kwargs=None, np: int = 1,
        hosts: Optional[str] = None, extra_env: Optional[Dict[str, str]] = None,
        verbose: bool = False) -> List[Any]:
    """Run ``func`` on ``np`` processes; the results in rank order (ref:
    horovod/runner/__init__.py:90). The function is pickled (cloudpickle
    when it is installed) and its results come back through the
    rendezvous KV. The workers inherit this process's environment."""
    try:
        import cloudpickle as pickler
    except ImportError:  # pragma: no cover
        pickler = pickle

    payload = pickler.dumps(functools.partial(func, *args, **(kwargs or {})))
    host_list = parse_hosts(hosts) if hosts else [HostInfo("localhost", np)]
    slots = get_host_assignments(host_list, np, np)

    from .launch import launch_static
    from .util import secret as secret_util

    server = RendezvousServer(secret_key=secret_util.make_secret_key())
    server.start()
    func_path = None
    try:
        with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
            f.write(payload)
            func_path = f.name
        env = dict(extra_env or {})
        # The repo root first, the caller's PYTHONPATH kept: the function
        # may need it to unpickle on the workers.
        inherited = os.environ.get("PYTHONPATH")
        parts = ([os.path.dirname(os.path.dirname(os.path.dirname(__file__)))]
                 + ([inherited] if inherited else []))
        env.setdefault("PYTHONPATH", os.pathsep.join(parts))
        command = [sys.executable, "-m", "horovod_tpu_torch.runner.run_func", func_path]
        rc = launch_static(slots, command, env, verbose, rendezvous=server,
                           prefix_output=not verbose)
        if rc != 0:
            raise RuntimeError(f"hvdrun function job failed with exit code {rc}")
        results = []
        for r in range(np):
            blob = server.handle_get(f"results/{r}")
            if blob is None:
                raise RuntimeError(f"rank {r} produced no result")
            results.append(pickle.loads(blob))
        return results
    finally:
        server.stop()
        if func_path is not None:
            try:
                os.unlink(func_path)
            except OSError:
                pass
