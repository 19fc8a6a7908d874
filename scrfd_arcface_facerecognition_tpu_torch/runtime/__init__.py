"""Host runtime of the port: the native library's gallery bindings and the
request micro-batcher."""

from .microbatch import MicroBatcher, MicroBatcherClosed
from .native import (build_native, native_available, snapshot_read,
                     snapshot_write, uf_group_roots)

__all__ = ["MicroBatcher", "MicroBatcherClosed", "build_native", "native_available", "snapshot_read",
           "snapshot_write", "uf_group_roots"]
