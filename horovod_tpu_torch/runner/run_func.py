"""``python -m horovod_tpu_torch.runner.run_func <func.pkl>``: the worker
side of ``runner.run`` (counterpart of the function mode of
``horovod_tpu/runner/task_runner.py``; ref: horovod/runner/launch.py:
552-574): load the pickled function, call it, PUT the pickled result to
the rendezvous KV under ``results/<rank>``."""
from __future__ import annotations

import pickle
import sys


def main(func_path: str):
    from ..backend.rendezvous import RendezvousClient
    from ..common import env as env_cfg

    with open(func_path, "rb") as f:
        fn = pickle.load(f)
    result = fn()
    client = RendezvousClient(env_cfg.get_str(env_cfg.RENDEZVOUS_ADDR, "127.0.0.1"),
                              env_cfg.get_int(env_cfg.RENDEZVOUS_PORT, 0))
    client.put("results", str(env_cfg.get_int(env_cfg.RANK, 0)), pickle.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1])
