"""Device-resident embedding gallery: the vector-store layer.

Counterpart of the JAX package's ``gallery/``: a dense [capacity, D] store
searched by one matmul + top-k, G x G duplicate detection, a
product-quantized tier whose distance scorer is the hand-written kernel K2
(``pq_adc.py``, ``csrc/pq_adc.cu``), and AutoGallery, which moves from the
dense tier to the PQ one by size. Each runs on the CUDA card unless given
``device="cpu"``.
"""

from .store import GalleryStore, SearchHit
from .dedup import (all_pairs_similarity, find_duplicate_pairs,
                    find_duplicate_pairs_blocked, duplicate_groups)
from .pq import PQCodec, PQGallery, adc_scores
from .auto import AutoGallery

__all__ = ["GalleryStore", "SearchHit", "AutoGallery",
           "all_pairs_similarity", "find_duplicate_pairs",
           "find_duplicate_pairs_blocked", "duplicate_groups",
           "PQCodec", "PQGallery", "adc_scores"]
