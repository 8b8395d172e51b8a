"""The elastic launcher (counterpart of ``horovod_tpu/runner/elastic/``;
ref: horovod/runner/elastic/)."""
from .discovery import FixedHosts, HostDiscovery, HostDiscoveryScript, HostManager, HostUpdateResult
from .driver import ElasticDriver
from .registration import WorkerStateRegistry
