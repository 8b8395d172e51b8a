"""The elastic launch of ``hvdrun`` (``--min-np/--max-np/
--host-discovery-script``): the ElasticDriver, the rendezvous server, the
job's store and the worker processes (counterpart of
``horovod_tpu/runner/elastic/launcher.py``; ref: horovod/runner/
gloo_run.py:274-309 launch_gloo_elastic). The elasticity controller waits
for ROADMAP A7 (HOROVOD_CONTROLLER_INTERVAL_SECONDS raises at the
workers' ``init()``)."""
from __future__ import annotations

import sys
from typing import Dict, Sequence

from ..launch import driver_addr, host_store, slot_env, spawn_worker
from ..rendezvous_server import RendezvousServer
from .discovery import FixedHosts, HostDiscoveryScript
from .driver import ElasticDriver


def launch_elastic(args, command: Sequence[str], extra_env: Dict[str, str]) -> int:
    from ..launch import _check_task_service

    _check_task_service()
    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script, args.slots_per_host)
    elif args.hosts:
        from ..hosts import parse_hosts

        discovery = FixedHosts({h.hostname: h.slots for h in parse_hosts(args.hosts)})
    else:
        print("hvdrun: elastic mode needs --host-discovery-script or -H",
              file=sys.stderr)
        return 2
    np_ = args.num_proc or args.min_np or 1
    min_np = args.min_np or np_
    max_np = args.max_np or args.num_proc

    from ..util import secret as secret_util

    server = RendezvousServer(secret_key=secret_util.make_secret_key())
    port = server.start()
    driver = ElasticDriver(server, discovery, min_np=min_np, max_np=max_np,
                           reset_limit=args.reset_limit)
    store = host_store()

    def create_worker(slot, worker_extra_env):
        env = slot_env(slot, driver_addr([slot]), port, extra_env, elastic=True,
                       secret_key=server.secret_key, store_port=store.port)
        env.update(worker_extra_env)
        handle = spawn_worker(
            slot, list(command), env, verbose=args.verbose,
            prefix_output=not getattr(args, "disable_output_prefix", False),
            ssh_port=args.ssh_port, ssh_identity_file=args.ssh_identity_file)
        return handle.proc

    try:
        driver.start(create_worker)
        code = driver.wait()
        return code if code is not None else 1
    finally:
        driver.stop()
        server.stop()
        del store
