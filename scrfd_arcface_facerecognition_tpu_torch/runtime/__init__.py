"""Host runtime of the port: the native library's gallery bindings."""

from .native import (build_native, native_available, snapshot_read,
                     snapshot_write, uf_group_roots)

__all__ = ["build_native", "native_available", "snapshot_read",
           "snapshot_write", "uf_group_roots"]
