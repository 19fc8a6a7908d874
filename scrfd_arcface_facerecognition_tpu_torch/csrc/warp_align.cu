// Face-crop warp fused with the ArcFace input prep, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel warp_crops_pallas
// (scrfd_arcface_facerecognition_tpu/ops/pallas_warp.py, pl.pallas_call at
// :430; body _make_kernel :283). That kernel splits the similarity warp into
// MXU scale passes and Paeth shear roll chains because gathers are slow on a
// TPU, and it needs an envelope, a canvas pyramid level and an XLA fallback
// for crops outside it. A GPU gathers cheaply, so this kernel computes the
// exact single-pass bilinear warp (cv2.warpAffine, INTER_LINEAR, zero
// border) for every crop, with no envelope and no fallback.
//
// Per crop f (one CTA) and output pixel (i, j) (the CTA's threads walk the
// OH*OW pixels):
//   sx = (m00*j + m01*i) + m02,  sy = (m10*j + m11*i) + m12   (dst -> src)
//   out[f, c, i, j] = (bilinear(frame[frame_idx[f]], sx, sy)[2 - c] - 127.5)
//                     * (1 / 127.5)
// i.e. the warp, BGR -> RGB and ArcFace's (x - 127.5) / 127.5, written as
// (F, 3, OH, OW) float32 NCHW, the layout the embedder's first conv takes.
//
// Bound on an H100: memory. Each crop writes 3*112*112*4 = 150,528 B of f32
// and reads its source footprint of u8 (about (112*sigma)^2 * 3 B, sigma the
// crop's source/dest scale); the arithmetic is ~60 flops a pixel, far below
// the card's rate. The design keeps the traffic at that floor: frames are
// read in place as NHWC u8 (no planarize, no padding, no float copy of the
// frame), the normalize and layout change are fused so the crop is written
// once, and the writes are coalesced (consecutive threads, consecutive
// pixels of one plane). The footprint reads are byte gathers served mostly
// by L1/L2, since neighbouring pixels share taps; every tap loads from a
// clamped, always-valid address, so no branch stands between a pixel's
// loads and they overlap. Staging the footprint in shared memory, and
// spreading a crop over several CTAs, is left for later work.
//
// Numerics: built with --fmad=false and written with explicit round-to-
// nearest intrinsics, so coordinates, weights and the left-to-right sum of
// the four taps are rounded exactly as the plain PyTorch version
// (ops/warp.py warp_affine_inv_flat + ops/normalize.py) rounds them. Each
// tap's inside mask is decided on the float coordinate before any integer
// conversion (float -> int of NaN or inf is undefined in CUDA); an outside
// tap adds value * (weight * 0), which is NaN when the weight is NaN, as in
// the plain version, so degenerate matrices give the same NaN crops.
// frame_idx outside [0, B) treats every tap as outside (it reads frame 0's
// first pixel only).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const uint8_t* __restrict__ src,
                                     bool frame_ok, int H, int W, float xt,
                                     float yt, float wgt, int c) {
  const bool inside = frame_ok && xt >= 0.f && xt <= (float)(W - 1) &&
                      yt >= 0.f && yt <= (float)(H - 1);
  // An outside tap loads pixel (0, 0) and is dropped by its zero weight:
  // with no branch around the load, a pixel's 12 loads are all in flight
  // at once instead of one after the other.
  const int xi = (int)(inside ? xt : 0.f);
  const int yi = (int)(inside ? yt : 0.f);
  const float v = (float)__ldg(src + ((size_t)yi * W + xi) * 3 + c);
  return __fmul_rn(v, __fmul_rn(wgt, inside ? 1.f : 0.f));
}

__global__ void __launch_bounds__(kThreads)
warp_align_kernel(const uint8_t* __restrict__ frames, int B, int H, int W,
                  const float* __restrict__ minv,
                  const int32_t* __restrict__ frame_idx,
                  float* __restrict__ out, int OH, int OW) {
  const int f = blockIdx.x;
  const float m00 = minv[f * 6 + 0], m01 = minv[f * 6 + 1],
              m02 = minv[f * 6 + 2];
  const float m10 = minv[f * 6 + 3], m11 = minv[f * 6 + 4],
              m12 = minv[f * 6 + 5];
  const int b = frame_idx[f];
  const bool frame_ok = b >= 0 && b < B;
  const uint8_t* src = frames + (frame_ok ? (size_t)b * H * W * 3 : 0);
  const int npix = OH * OW;
  float* dst = out + (size_t)f * 3 * npix;
  const float inv_std = (float)(1.0 / 127.5);

  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const float gx = (float)(p % OW);
    const float gy = (float)(p / OW);
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(m00, gx), __fmul_rn(m01, gy)), m02);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(m10, gx), __fmul_rn(m11, gy)), m12);
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
    const float gx0 = __fsub_rn(1.f, fx), gy0 = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gx0, gy0), w01 = __fmul_rn(fx, gy0);
    const float w10 = __fmul_rn(gx0, fy), w11 = __fmul_rn(fx, fy);
    const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = tap(src, frame_ok, H, W, x0, y0, w00, c);
      acc = __fadd_rn(acc, tap(src, frame_ok, H, W, x1, y0, w01, c));
      acc = __fadd_rn(acc, tap(src, frame_ok, H, W, x0, y1, w10, c));
      acc = __fadd_rn(acc, tap(src, frame_ok, H, W, x1, y1, w11, c));
      // BGR source channel c lands in RGB plane 2 - c
      dst[(size_t)(2 - c) * npix + p] =
          __fmul_rn(__fsub_rn(acc, 127.5f), inv_std);
    }
  }
}

}  // namespace

extern "C" int warp_align_launch(const void* frames, int B, int H, int W,
                                 const void* minv, const void* frame_idx,
                                 int F, void* out, int OH, int OW,
                                 void* stream) {
  if (F > 0) {
    warp_align_kernel<<<F, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, B, H, W, (const float*)minv,
        (const int32_t*)frame_idx, (float*)out, OH, OW);
  }
  return (int)cudaGetLastError();
}
