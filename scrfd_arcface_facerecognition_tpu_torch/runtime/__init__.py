"""Host runtime of the port: the native library's bindings (the frame
ring, the gallery snapshots, the union-find, the video decoder), the video
readers, the multi-process decode pool and the request micro-batcher.
None of these modules imports torch."""

from .decode_pool import DecodePool
from .microbatch import MicroBatcher, MicroBatcherClosed
from .native import (FramePipe, NativeVideoReader, build_native,
                     native_available, snapshot_read, snapshot_write,
                     uf_group_roots)
from .video import BatchedFrameReader, MultiStreamReader, open_capture

__all__ = ["DecodePool", "MicroBatcher", "MicroBatcherClosed", "FramePipe",
           "NativeVideoReader", "build_native", "native_available",
           "snapshot_read", "snapshot_write", "uf_group_roots",
           "BatchedFrameReader", "MultiStreamReader", "open_capture"]
