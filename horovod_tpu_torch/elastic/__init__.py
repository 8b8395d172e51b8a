"""Elastic training: the worker's state and the fault-tolerant run loop
(counterpart of ``horovod_tpu/elastic/``; ref: horovod/common/
elastic.py:1-168; horovod/torch/elastic.py:51-84 TorchState, here
``horovod_tpu_torch.torch.elastic.TorchState``, also exported as
``hvd.elastic.TorchState``).

    @hvd.elastic.run
    def train(state):
        while state.batch < steps:
            ...
            state.batch += 1
            state.commit()

    train(hvd.elastic.TorchState(model, optimizer, batch=0))
"""
from ..torch.elastic import TorchState
from .run import reset_log, run, run_fn
from .state import ObjectState, State

__all__ = ["State", "ObjectState", "TorchState", "run", "run_fn", "reset_log"]
