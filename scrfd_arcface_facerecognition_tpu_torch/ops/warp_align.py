"""Face-crop warp + ArcFace input prep: the wrapper of kernel K1.

Counterpart of the JAX package's Pallas kernel ``warp_crops_pallas``
(``ops/pallas_warp.py``). The CUDA kernel (``csrc/warp_align.cu``) computes
the exact bilinear warp of every crop in one pass and fuses what follows it
on the way into the embedder: BGR -> RGB, (x - 127.5) / 127.5 and the NCHW
layout. Its source note gives its bound on an H100 and its design.

``warp_align_crops`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``warp_align_plain``) for CPU tensors, and only for them;
there is no fallback from one to the other. ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .normalize import ARCFACE_MEAN, ARCFACE_STD, normalize_image
from .warp import warp_affine_inv_flat

NAME = "warp_align"
launches = 0
_launch_fn = None


def warp_align_plain(frames: torch.Tensor, minv: torch.Tensor,
                     frame_idx: torch.Tensor,
                     out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """The plain version: warp_affine_inv_flat, ArcFace normalize, NCHW.

    frames (B, H, W, 3) u8 BGR; minv (F, 2, 3) dst -> src; frame_idx (F,)
    -> (F, 3, h, w) float32 normalized RGB.
    """
    crops = warp_affine_inv_flat(frames, minv, frame_idx, out_hw)
    crops = normalize_image(crops, ARCFACE_MEAN, ARCFACE_STD)
    return crops.permute(0, 3, 1, 2).contiguous()


def _bind():
    """The C launch function, built and loaded at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ..cuda_build import library

        fn = library(NAME).warp_align_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def warp_align_crops(frames: torch.Tensor, minv: torch.Tensor,
                     frame_idx: torch.Tensor,
                     out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR frames, (F, 2, 3) f32 dst -> src matrices and
    (F,) int32 frame indices -> (F, 3, h, w) f32 ArcFace input.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise.
    """
    if frames.device.type == "cpu":
        return warp_align_plain(frames, minv, frame_idx, out_hw)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_align: unsupported device {frames.device}")
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError("warp_align: frames must be (B, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    f = minv.shape[0]
    if minv.shape != (f, 2, 3) or minv.dtype != torch.float32:
        raise ValueError("warp_align: minv must be (F, 2, 3) float32, got "
                         f"{tuple(minv.shape)} {minv.dtype}")
    if frame_idx.shape != (f,) or frame_idx.dtype != torch.int32:
        raise ValueError("warp_align: frame_idx must be (F,) int32, got "
                         f"{tuple(frame_idx.shape)} {frame_idx.dtype}")
    for t in (minv, frame_idx):
        if t.device != frames.device:
            raise ValueError("warp_align: inputs on different devices")
    if not (frames.is_contiguous() and minv.is_contiguous()
            and frame_idx.is_contiguous()):
        raise ValueError("warp_align: inputs must be contiguous")
    b, h, w, _ = frames.shape
    oh, ow = out_hw
    out = torch.empty((f, 3, oh, ow), dtype=torch.float32,
                      device=frames.device)
    if f == 0:
        return out
    fn = _bind()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    rc = fn(frames.data_ptr(), b, h, w, minv.data_ptr(), frame_idx.data_ptr(),
            f, out.data_ptr(), oh, ow, stream)
    if rc != 0:
        raise RuntimeError(f"warp_align kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
