"""Framework exceptions (counterpart of ``horovod_tpu/common/exceptions.py``;
ref: horovod/common/exceptions.py:17-31)."""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective fails."""


class NotInitializedError(RuntimeError):
    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call horovod_tpu_torch.init() first."
        )
