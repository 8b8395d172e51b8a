"""Elastic state of a torch model and its optimizer (counterpart of
``horovod_tpu/torch/elastic.py``; ref: horovod/torch/elastic.py:51-84
TorchState).

A commit deep-copies the model's and the optimizer's ``state_dict()``
where they lie: on the card for CUDA tensors, so a commit is a
device-to-device copy and the commit holds as many device bytes again as
the parameters and the optimizer state (``saved_bytes``). ``restore``
copies out of the commit and never aliases it: ``load_state_dict`` of a
module copies into the live parameters, and an optimizer's keeps the
tensors it is given, so it is given a copy. Scalars ride ``ObjectState``.
``sync`` broadcasts the parameters and the optimizer state from rank 0.
"""
from __future__ import annotations

import copy

import torch

from ..common.functions import broadcast_optimizer_state, broadcast_parameters
from ..elastic.state import ObjectState


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class TorchState(ObjectState):
    """(ref: torch/elastic.py:51-84)"""

    def __init__(self, model=None, optimizer=None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._saved_model_state = None
        self._saved_opt_state = None
        super().__init__(**kwargs)

    def save(self):
        if self.model is not None:
            self._saved_model_state = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            self._saved_opt_state = copy.deepcopy(self.optimizer.state_dict())
        super().save()

    def restore(self):
        if self.model is not None and self._saved_model_state is not None:
            self.model.load_state_dict(self._saved_model_state)
        if self.optimizer is not None and self._saved_opt_state is not None:
            self.optimizer.load_state_dict(copy.deepcopy(self._saved_opt_state))
        super().restore()

    def sync(self):
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=0)
        super().sync()

    def saved_bytes(self, device_type: str = "cuda") -> int:
        """Bytes the commit holds on devices of ``device_type``."""
        return sum(t.numel() * t.element_size()
                   for saved in (self._saved_model_state, self._saved_opt_state)
                   for t in _tensors(saved) if t.device.type == device_type)
