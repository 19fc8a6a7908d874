"""Device-mesh parallelism, driven from one process.

Counterpart of the JAX package's ``parallel/``. The reference has no
distributed execution; its scaling axes are the frame batch B and the
gallery size G, and the trainers' batch and class count. Here those split
over a :class:`mesh.Mesh` of slots:

- frame DP: batches split on a 'data' axis (``shard_frames``); each slot
  runs the whole detect -> embed -> match path on its part with its
  device's replicas (``FacePipeline``, ``replicate``);
- gallery sharding: the [G, 512] matrix (``ShardedGallery``) or the PQ
  codes (``gallery.pq.PQGallery(mesh=)``, K2 on every shard) split by rows
  over an axis; a search is a local top-k a shard and a merge of the
  (Q, k) candidates on one device (``sharded_top_k``);
- stage disaggregation: detector weights on one group of slots, embedder
  and gallery on another, batches pipelined through both
  (``DisaggPipeline``);
- the trainers' mesh (``train/``): the ArcFace step DP x TP over
  ('data', 'model') with the class matrix in column shards, the SCRFD
  step DP over ('data',); the forward runs one thread a data slot, which
  meet at exchanges (``collectives``) where the step needs a value of the
  whole batch (BatchNorm's statistics), then one backward from the global
  loss;
- the copies between devices are ``.to(device)`` (NVLink between cards);
  ``initialize_distributed`` joins a ``torch.distributed`` group where a
  deployment spans processes.

The exports are imported when first used (PEP 562), so importing the
package imports no torch.
"""

import importlib

_EXPORTS = {
    "make_mesh": ".mesh", "make_hybrid_mesh": ".mesh",
    "initialize_distributed": ".mesh", "local_device_count": ".mesh",
    "device_slots": ".mesh", "card_slots": ".mesh", "Mesh": ".mesh",
    "Slot": ".mesh", "training_slots": ".mesh",
    "ShardedGallery": ".sharded_gallery", "sharded_top_k": ".sharded_gallery",
    "shard_frames": ".data_parallel", "replicate": ".data_parallel",
    "ShardedFrames": ".data_parallel",
    "DisaggPipeline": ".disagg", "split_devices": ".disagg",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
