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

The durability hooks (``common/checkpoint.py``) hand the checkpoint the
commit itself: ``checkpoint_trees`` lists its tensors in one order, the
model's ``state_dict`` in its own order, then the optimizer's state
tensors by parameter index and key; ``checkpoint_objects`` adds to the
scalars the rest of the optimizer's ``state_dict`` (its param groups and
any non-tensor state). Those tensors stay on the card: the writer thread
copies its range to the host. ``load_checkpoint`` rebuilds both against
the live model and optimizer (an optimizer with no state yet first gets
one, by a step on zero gradients that keeps the parameters) and raises
when the leaf counts, shapes or dtypes differ: the model changed since
the checkpoint. A dtype numpy lacks (bfloat16, the float8 types) travels
as the unsigned integers of its bits and is viewed back as the live
tensor's dtype, so every leaf round-trips bitwise.
"""
from __future__ import annotations

import copy

import torch

from ..common.functions import broadcast_optimizer_state, broadcast_parameters
from ..elastic.state import ObjectState

# The key of the optimizer's non-tensor state_dict in the checkpoint's
# objects, and the mark of a tensor in it (the tensor is a leaf).
OPTIMIZER_KEY = "__torch_optimizer__"
_LEAF = "__leaf__"


def _is_leaf(v) -> bool:
    return isinstance(v, str) and v == _LEAF


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
        objects = dict(self._saved)
        if self._saved_opt_state is not None:
            st = self._saved_opt_state["state"]
            objects[OPTIMIZER_KEY] = {
                "param_groups": self._saved_opt_state["param_groups"],
                "state": {pid: {k: _LEAF if isinstance(v, torch.Tensor) else v
                                for k, v in st[pid].items()} for pid in st}}
        self._saved_objects = objects

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

    # -- durability hooks ------------------------------------------------
    def checkpoint_objects(self) -> dict:
        return self._saved_objects

    def checkpoint_trees(self) -> dict:
        trees = {}
        if self._saved_model_state is not None:
            trees["model"] = list(self._saved_model_state.values())
        if self._saved_opt_state is not None:
            st = self._saved_opt_state["state"]
            trees["optimizer"] = [st[pid][k] for pid in sorted(st) for k in sorted(st[pid])
                                  if isinstance(st[pid][k], torch.Tensor)]
        return trees

    def load_checkpoint(self, objects: dict, trees: dict):
        from ..common.checkpoint import leaf_to_tensor

        objects = dict(objects)
        opt_doc = objects.pop(OPTIMIZER_KEY, None)
        if "model" in trees:
            if self.model is None:
                raise ValueError("checkpoint holds a model but this TorchState has none")
            live = self.model.state_dict()
            leaves = trees["model"]
            if len(leaves) != len(live):
                raise ValueError(f"checkpoint model has {len(leaves)} leaves but the live "
                                 f"model expects {len(live)}; the model structure changed "
                                 "since the checkpoint")
            self.model.load_state_dict({k: leaf_to_tensor(leaf, v) for (k, v), leaf in
                                        zip(live.items(), leaves)})
        if "optimizer" in trees:
            self._load_optimizer(opt_doc, trees["optimizer"])
        super().load_checkpoint(objects, {})

    def _load_optimizer(self, doc, leaves):
        from ..common.checkpoint import leaf_to_tensor
        from ..common.functions import _init_state

        if self.optimizer is None or doc is None:
            raise ValueError("checkpoint holds optimizer state but this TorchState has "
                             "no optimizer")
        n_live = sum(len(g["params"]) for g in self.optimizer.param_groups)
        n_ckpt = sum(len(g["params"]) for g in doc["param_groups"])
        want = sum(_is_leaf(v) for st in doc["state"].values() for v in st.values())
        if n_live != n_ckpt or want != len(leaves):
            raise ValueError(f"checkpoint optimizer has {len(leaves)} leaves over {n_ckpt} "
                             f"parameters but the live one has {n_live} parameters; the "
                             "model structure changed since the checkpoint")
        if doc["state"] and not self.optimizer.state:
            _init_state(self.optimizer)
        live = self.optimizer.state_dict()["state"]
        it = iter(leaves)
        state = {}
        for pid in sorted(doc["state"]):
            state[pid] = {}
            for k in sorted(doc["state"][pid]):
                v = doc["state"][pid][k]
                if _is_leaf(v):
                    like = live.get(pid, {}).get(k)
                    if not isinstance(like, torch.Tensor):
                        raise ValueError(f"checkpoint optimizer state {pid}.{k} has no "
                                         "counterpart in the live optimizer")
                    v = leaf_to_tensor(next(it), like).to(like.device)
                state[pid][k] = v
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": copy.deepcopy(doc["param_groups"])})
