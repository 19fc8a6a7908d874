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
// Per crop f and output pixel (i, j):
//   sx = (m00*j + m01*i) + m02,  sy = (m10*j + m11*i) + m12   (dst -> src)
//   out[f, c, i, j] = (bilinear(frame[frame_idx[f]], sx, sy)[2 - c] - 127.5)
//                     * (1 / 127.5)
// i.e. the warp, BGR -> RGB and ArcFace's (x - 127.5) / 127.5, written as
// (F, 3, OH, OW) float32 NCHW, the layout the embedder's first conv takes.
//
// Bound on an H100: memory. Each crop writes 3*112*112*4 = 150,528 B of f32
// and reads its source footprint of u8 (about (112*sigma)^2 * 3 B, sigma the
// crop's source/dest scale); the arithmetic is ~60 flops a pixel, far below
// the card's rate. At the main path's 80 crops that is 0.0049 ms at
// 3.35 TB/s. Frames are read in place as NHWC u8 (no planarize, no padding,
// no float copy), and the normalize and layout change are fused, so the
// crop is written once.
//
// The design, against what holds a crop's warp back:
// - grid (tiles, crops): a CTA takes a tile of kRows = 4 output rows by
//   kCols = 112 columns of one crop, 28 CTAs a 112 x 112 crop: 2,240
//   CTAs at F = 80, 26,880 at F = 960 (crops past 65,535 loop in y). One
//   CTA a crop would run 80 CTAs on 132 SMs at F = 80, each walking its
//   crop in turn;
// - kThreads = 112 threads (4 rows x 28), 4 pixels a thread. A thread
//   computes its 4 pixels' coordinates and weights, then issues all 48
//   byte loads (4 pixels x 4 taps x 3 channels) from clamped, always-
//   valid addresses, with no branch between them, and only then sums;
// - a thread's 4 pixels lie 28 columns apart (tile_col), so one load
//   instruction of a warp reads the taps of neighbouring pixels, a few
//   128-byte lines; with the 4 consecutive pixels a thread stores, its
//   lanes would read pixels 4 apart, about four times the lines, and the
//   L1's wavefronts, not device-memory latency, set the time (the
//   ablation's quad_cols variant);
// - the results pass through a 5,376-byte shared-memory tile, so each
//   thread stores 4 consecutive pixels of its row as one 16-byte float4 a
//   plane (a 112-wide row is 28 of them; the wrapper's output is 16-byte
//   aligned). An OW that is not a multiple of 4 leaves rows off 16-byte
//   alignment: then the stores are scalars, up to OW.
// On an H100 the kernel takes 72 registers a thread, so the occupancy API
// (warp_align_occupancy, printed by chip_smoke.py phase 3) gives 7 CTAs an
// SM, 924 resident: 2.4 rounds at F = 80. tools/warp_align_ablate.py times
// the other choices (one CTA a crop, quad_cols, direct scalar stores with
// no tile, scalar stores from the tile, 2- and 8-row tiles; 2 rows read
// the same, 8 slower) and the kernel without its loads or its stores.
//
// Staging each tile's source box in shared memory is not done. The
// ablation's no_load variant (no source access at all) bounds what it
// could save: about half the cold time at 80 crops (PERF.md section 5).
// But a 4-row tile's taps lie on a thin strip, and the strip's bounding
// box, which a staged copy holds, grows with the rotation: at 45 deg and
// sigma 1 it is about 84 x 84 source pixels (21 KB), 12 times the bytes
// the taps read; the main path's faces come at any rotation.
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

constexpr int kRows = 4;                  // output rows a tile (one band)
constexpr int kQuad = 4;                  // output pixels a thread
constexpr int kQuads = 28;                // threads a tile row
constexpr int kCols = kQuads * kQuad;     // 112 output columns a tile
constexpr int kThreads = kRows * kQuads;  // 112
constexpr int kMaxGridY = 65535;

// The tile column of a thread's k-th pixel: neighbouring threads take
// neighbouring pixels, so one load instruction of a warp reads the taps
// of 28 adjacent pixels of a row.
__device__ __forceinline__ int tile_col(int q, int k) { return q + kQuads * k; }

__device__ __forceinline__ void store4(float* p, const float* t) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(t);
}

// The bilinear samples of output pixels (i, j[k]), k < kQuad, of one crop,
// normalized, in RGB order: res[plane][k].
__device__ __forceinline__ void warp_pixels(
    const uint8_t* __restrict__ src, bool frame_ok, int H, int W,
    float m00, float m01, float m02, float m10, float m11, float m12, int i,
    const int (&j)[kQuad], float (&res)[3][kQuad]) {
  const float inv_std = (float)(1.0 / 127.5);
  const float gy = (float)i;
  float wt[kQuad][4];
  int pix[kQuad][4];
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    const float gx = (float)j[k];
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(m00, gx), __fmul_rn(m01, gy)), m02);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(m10, gx), __fmul_rn(m11, gy)), m12);
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
    const float gx0 = __fsub_rn(1.f, fx), gy0 = __fsub_rn(1.f, fy);
    const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
    const float w[4] = {__fmul_rn(gx0, gy0), __fmul_rn(fx, gy0),
                        __fmul_rn(gx0, fy), __fmul_rn(fx, fy)};
    const float xs[4] = {x0, x1, x0, x1};
    const float ys[4] = {y0, y0, y1, y1};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool inside = frame_ok && xs[t] >= 0.f &&
                          xs[t] <= (float)(W - 1) && ys[t] >= 0.f &&
                          ys[t] <= (float)(H - 1);
      // An outside tap loads pixel (0, 0) and is dropped by its zero
      // weight, so no branch stands between the pixels' loads.
      const int xi = (int)(inside ? xs[t] : 0.f);
      const int yi = (int)(inside ? ys[t] : 0.f);
      pix[k][t] = yi * W + xi;
      wt[k][t] = __fmul_rn(w[t], inside ? 1.f : 0.f);
    }
  }
  // all 48 loads in flight before any is used
  float v[kQuad][4][3];
#pragma unroll
  for (int k = 0; k < kQuad; ++k)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[k][t][c] = (float)__ldg(src + (size_t)pix[k][t] * 3 + c);
#pragma unroll
  for (int k = 0; k < kQuad; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = __fmul_rn(v[k][0][c], wt[k][0]);
      acc = __fadd_rn(acc, __fmul_rn(v[k][1][c], wt[k][1]));
      acc = __fadd_rn(acc, __fmul_rn(v[k][2][c], wt[k][2]));
      acc = __fadd_rn(acc, __fmul_rn(v[k][3][c], wt[k][3]));
      // BGR source channel c lands in RGB plane 2 - c
      res[2 - c][k] = __fmul_rn(__fsub_rn(acc, 127.5f), inv_std);
    }
}

__global__ void __launch_bounds__(kThreads)
warp_align_kernel(const uint8_t* __restrict__ frames, int B, int H, int W,
                  const float* __restrict__ minv,
                  const int32_t* __restrict__ frame_idx, int F,
                  float* __restrict__ out, int OH, int OW) {
  __shared__ __align__(16) float tile[3][kRows][kCols];
  const int npix = OH * OW;
  const int nbands = (OH + kRows - 1) / kRows;
  const int nchunks = (OW + kCols - 1) / kCols;
  const int r = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const bool vec = OW % kQuad == 0;
  for (int f = blockIdx.y; f < F; f += gridDim.y) {
    const float m00 = minv[f * 6 + 0], m01 = minv[f * 6 + 1],
                m02 = minv[f * 6 + 2];
    const float m10 = minv[f * 6 + 3], m11 = minv[f * 6 + 4],
                m12 = minv[f * 6 + 5];
    const int b = frame_idx[f];
    const bool frame_ok = b >= 0 && b < B;
    const uint8_t* src = frames + (frame_ok ? (size_t)b * H * W * 3 : 0);
    float* dst = out + (size_t)f * 3 * npix;
    for (int t = blockIdx.x; t < nbands * nchunks; t += gridDim.x) {
      const int i = (t / nchunks) * kRows + r;
      const int c0 = (t % nchunks) * kCols;
      if (i < OH) {
        int j[kQuad];
#pragma unroll
        for (int k = 0; k < kQuad; ++k) j[k] = c0 + tile_col(q, k);
        float res[3][kQuad];
        warp_pixels(src, frame_ok, H, W, m00, m01, m02, m10, m11, m12, i, j,
                    res);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int k = 0; k < kQuad; ++k)
            tile[c][r][tile_col(q, k)] = res[c][k];
      }
      __syncthreads();
      // each thread stores the 4 consecutive pixels c0 + 4q .. + 3 of its
      // row: one float4 a plane, or scalars up to OW when rows are off
      // 16-byte alignment
      const int j0 = c0 + kQuad * q;
      if (i < OH && j0 < OW) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* p = dst + (size_t)c * npix + (size_t)i * OW + j0;
          if (vec) {
            store4(p, &tile[c][r][kQuad * q]);
          } else {
            for (int k = 0; k < kQuad && j0 + k < OW; ++k)
              p[k] = tile[c][r][kQuad * q + k];
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int warp_align_launch(const void* frames, int B, int H, int W,
                                 const void* minv, const void* frame_idx,
                                 int F, void* out, int OH, int OW,
                                 void* stream) {
  if (F > 0 && OH > 0 && OW > 0) {
    const int tiles = ((OH + kRows - 1) / kRows) * ((OW + kCols - 1) / kCols);
    const dim3 grid(tiles, F < kMaxGridY ? F : kMaxGridY);
    warp_align_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, B, H, W, (const float*)minv,
        (const int32_t*)frame_idx, F, (float*)out, OH, OW);
  }
  return (int)cudaGetLastError();
}

// The launch's shape and occupancy: threads a CTA, output rows a CTA,
// resident CTAs an SM (occupancy API) and registers a thread.
extern "C" int warp_align_occupancy(int* threads, int* rows,
                                    int* blocks_per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, warp_align_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, warp_align_kernel, kThreads, 0);
  *threads = kThreads;
  *rows = kRows;
  *regs = attr.numRegs;
  return (int)err;
}
