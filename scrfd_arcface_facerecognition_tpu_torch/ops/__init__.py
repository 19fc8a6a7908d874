"""Tensor ops of the port: cv2/skimage-semantics geometry, batched, on any
device. Each mirrors its namesake in the JAX package's ``ops/``."""

from .anchors import anchor_centers, scrfd_anchor_table
from .decode import distance2bbox, distance2kps
from .normalize import (normalize_image, SCRFD_MEAN, SCRFD_STD, ARCFACE_MEAN,
                        ARCFACE_STD)
from .resize import (resize_bilinear, resize_bilinear_u8_exact, letterbox,
                     letterbox_plan, tight_letterbox_plan, LetterboxPlan,
                     letterbox_matrices, letterbox_dynamic)
from .similarity import (l2_normalize, compute_similarity, cosine_matrix,
                         top_k_matches)
from .umeyama import umeyama_similarity, estimate_norm, ARCFACE_DST
from .warp import (invert_affine, norm_crop, warp_affine, warp_affine_batch,
                   warp_affine_flat, warp_affine_inv_flat)
from .nms import (iou_matrix_legacy, nms_mask, nms_mask_blocked,
                  compact_by_mask, select_top_faces, stable_top_k)
from .warp_align import warp_align_crops, warp_align_plain

__all__ = [
    "anchor_centers", "scrfd_anchor_table",
    "distance2bbox", "distance2kps",
    "normalize_image", "SCRFD_MEAN", "SCRFD_STD", "ARCFACE_MEAN", "ARCFACE_STD",
    "resize_bilinear", "resize_bilinear_u8_exact", "letterbox",
    "letterbox_plan", "tight_letterbox_plan", "LetterboxPlan",
    "letterbox_matrices", "letterbox_dynamic",
    "l2_normalize", "compute_similarity", "cosine_matrix", "top_k_matches",
    "umeyama_similarity", "estimate_norm", "ARCFACE_DST",
    "invert_affine", "warp_affine", "warp_affine_batch", "norm_crop",
    "warp_affine_flat", "warp_affine_inv_flat",
    "iou_matrix_legacy", "nms_mask", "nms_mask_blocked", "compact_by_mask",
    "select_top_faces", "stable_top_k",
    "warp_align_crops", "warp_align_plain",
]
