// The 5-pass band-mix face warp (kernel K3), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel warp_crops_band (tools/exp_warp2.py,
// pl.pallas_call at :188; body _band_kernel :99 and _band_mix :67), the
// production warp's predecessor. Per crop, five resampling passes over a
// Q x Q canvas (Q = 192): scale-y(sigma) from the u8 source (the frame,
// or the letterbox canvas at pyramid level 1), scale-x(sigma),
// shear-x(u), shear-y(v), shear-x(u). Each pass is
//   dst[i, l] = sum_{r in [j0, j0 + band)} max(0, 1 - |pos - r|) * src[r, l]
//   pos = (alpha * i + beta * l) + gamma
// where j0 is the aligned band start of output row i's 8-row group:
//   j0 = floor((alpha * base + min(0, beta * (W - 1))) + gamma) - 1,
// clipped to [0, src_rows - band] and aligned down to 16 (pass 1) or 8.
//
// The TPU kernel forms all `band` hat weights of every output because its
// vector unit has no gather. Here each output takes its taps floor(pos) and
// floor(pos) + 1, the only rows whose hat weight can be non-zero, each only
// if it lies inside the group's band window: the window keeps the TPU
// kernel's truncation of crops outside the envelope. Built with
// --fmad=false and written with round-to-nearest intrinsics in the plain
// version's order: the window's other rows add exact zeros to a sum of
// non-negative terms, so the result equals the band sum bit for bit. A NaN
// position gives NaN, as the band sum does.
//
// Launch shape: one launch per pass, one thread per output position and
// all three channels, f32 intermediates in device memory (the wrapper
// allocates them): pass 1 (F, 3, Q, 512) from the u8 source, passes 2-4
// (F, 3, Q, Q) in two buffers used in turn, each pass reading the previous
// one's rows or (as the TPU kernel's transposes) its columns through
// strides; pass 5 computes only the 112 lanes the crop keeps and writes
// the (F, 112, 112, 3) f32 crops.
//
// Bound on an H100: the crops written (F * 150,528 B) and the source
// pixels the crops depend on (traced back through the passes' taps, about
// (112 * sigma)^2 a crop), against about 26 f32 operations for each needed
// position (about 112 x 112 a pass); chip_smoke.py computes it from the
// run's crops. This design is far from it: it computes every position of
// every pass (221,440 a crop) and, with one launch a pass over all F crops,
// moves its f32 intermediates through HBM, not L2: pass 1 writes F * 1.18 MB
// (377 MB at F = 320) before pass 2 reads any of it, and the scratch is
// F * 2.06 MB a call (661 MB at F = 320). Passes 2, 4 and 5 also read with
// strided, uncoalesced loads. Fusing the passes per crop in shared memory
// removes that traffic; it is the work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 112;
constexpr int kQ = 192;
constexpr int kPW = 512;
constexpr int kG = 8;
constexpr int kLaneOff = 40;
constexpr float kCQ = 95.5f;
constexpr float kCQmC0 = 40.0f;   // CQ - C0

// j0 of the 8-row group starting at `base`. float -> int saturates and NaN
// maps to 0, as the reference's conversion does.
__device__ __forceinline__ int group_j0(float alpha, float beta_min,
                                        float gamma, int base, int src_rows,
                                        int band, int align) {
  float lo = floorf(__fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)base),
                                        beta_min), gamma));
  if (!(lo == lo)) lo = 0.f;
  lo = fminf(fmaxf(lo, -1073741824.f), 1073741824.f);
  int j0 = (int)lo - 1;
  const int hi = src_rows - band > 0 ? src_rows - band : 0;
  j0 = j0 < 0 ? 0 : (j0 > hi ? hi : j0);
  return (j0 / align) * align;
}

// The two taps of position `pos`: tap k is row t0 + k with weight w[k],
// or row -1 when it lies outside the window [j0, j0 + band).
struct Taps {
  int row[2];
  float w[2];
};

__device__ __forceinline__ Taps taps(float pos, int j0, int band) {
  Taps t;
  const float t0 = floorf(pos);
  const float lo = (float)j0, hi = (float)(j0 + band);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float rt = __fadd_rn(t0, (float)k);
    const bool in = rt >= lo && rt < hi;
    t.row[k] = in ? (int)rt : -1;
    t.w[k] = in ? fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, rt)))) : 0.f;
  }
  return t;
}

// Pass 1, scale-y from the u8 source: dst (F, 3, Q, PW), rows y of the
// canvas, lanes x of the crop's PW-lane window [ox, ox + PW) (zero past the
// source's width; a frame index outside [0, B) reads an all-zero frame).
__global__ void __launch_bounds__(kThreads)
band_pass1(const uint8_t* __restrict__ frames, int B, int fh, int fw,
           const uint8_t* __restrict__ canvas, int ch, int cw,
           const int32_t* __restrict__ ip, const float* __restrict__ fp,
           int F, float* __restrict__ dst) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)F * kQ * kPW) return;
  const int l = (int)(t % kPW);
  const int i = (int)((t / kPW) % kQ);
  const int f = (int)(t / ((long long)kPW * kQ));
  const int b = ip[f * 8 + 0], level = ip[f * 8 + 1], ox = ip[f * 8 + 3];
  const float sigma = fp[f * 8 + 0], my = fp[f * 8 + 3];
  const uint8_t* src = level == 0 ? frames : canvas;
  const int rows = level == 0 ? fh : ch;
  const int w = level == 0 ? fw : cw;
  const int x = ox + l;
  const bool col_ok = b >= 0 && b < B && x >= 0 && x < w;
  const size_t plane = (size_t)rows * w;
  if (col_ok) src += (size_t)b * 3 * plane + x;

  const float gamma = __fsub_rn(my, __fmul_rn(sigma, kCQ));
  const int j0 = group_j0(sigma, 0.f, gamma, (i / kG) * kG, rows, 32, 16);
  const float pos = __fadd_rn(__fadd_rn(__fmul_rn(sigma, (float)i),
                                        __fmul_rn(0.f, (float)l)), gamma);
  float acc[3] = {0.f, 0.f, 0.f};
  if (pos != pos) {
    acc[0] = acc[1] = acc[2] = __int_as_float(0x7fc00000);
  } else {
    const Taps tp = taps(pos, j0, 32);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (tp.row[k] < 0) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = (col_ok && tp.row[k] < rows)
            ? (float)__ldg(src + c * plane + (size_t)tp.row[k] * w) : 0.f;
        acc[c] = __fadd_rn(acc[c], __fmul_rn(v, tp.w[k]));
      }
    }
  }
  float* out = dst + (size_t)f * 3 * kQ * kPW + (size_t)i * kPW + l;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(size_t)c * kQ * kPW] = acc[c];
}

// Strides (in floats) of a per-crop f32 buffer seen as (crop, c, row, lane).
struct View {
  long long crop;
  int c, row, lane;
};

// Passes 2-5 on f32 sources. pass 2: scale-x (alpha sigma, gamma
// mx - sigma*CQ); 3: shear-x (beta u, gamma -u*CQ); 4: shear-y (beta v,
// gamma -v*CQ); 5: shear-x (beta u, gamma (CQ - C0) - u*CQ). Lanes
// [lane0, lane0 + n_lanes) of `width` are computed; output lane l goes to
// dst lane l - lane0.
__global__ void __launch_bounds__(kThreads)
band_pass(const float* __restrict__ src, View sv, int src_rows,
          float* __restrict__ dst, View dv, const float* __restrict__ fp,
          int F, int n_out, int width, int lane0, int n_lanes, int band,
          int pass) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)F * n_out * n_lanes) return;
  const int l = lane0 + (int)(t % n_lanes);
  const int i = (int)((t / n_lanes) % n_out);
  const int f = (int)(t / ((long long)n_lanes * n_out));
  const float sigma = fp[f * 8 + 0], u = fp[f * 8 + 1], v = fp[f * 8 + 2];
  const float mx = fp[f * 8 + 4];
  float alpha = 1.f, beta, gamma;
  if (pass == 2) {
    alpha = sigma;
    beta = 0.f;
    gamma = __fsub_rn(mx, __fmul_rn(sigma, kCQ));
  } else if (pass == 4) {
    beta = v;
    gamma = __fmul_rn(-v, kCQ);
  } else {
    beta = u;
    gamma = pass == 3 ? __fmul_rn(-u, kCQ)
                      : __fsub_rn(kCQmC0, __fmul_rn(u, kCQ));
  }
  const float beta_min = fminf(__fmul_rn(beta, 0.f),
                               __fmul_rn(beta, (float)(width - 1)));
  const int j0 = group_j0(alpha, beta_min, gamma, (i / kG) * kG, src_rows,
                          band, 8);
  const float pos = __fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)i),
                                        __fmul_rn(beta, (float)l)), gamma);
  float acc[3] = {0.f, 0.f, 0.f};
  if (pos != pos) {
    acc[0] = acc[1] = acc[2] = __int_as_float(0x7fc00000);
  } else {
    const Taps tp = taps(pos, j0, band);
    const float* s = src + (long long)f * sv.crop + (long long)l * sv.lane;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (tp.row[k] < 0 || tp.row[k] >= src_rows) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float val = s[(long long)c * sv.c + (long long)tp.row[k] * sv.row];
        acc[c] = __fadd_rn(acc[c], __fmul_rn(val, tp.w[k]));
      }
    }
  }
  float* out = dst + (long long)f * dv.crop + (long long)i * dv.row
      + (long long)(l - lane0) * dv.lane;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(long long)c * dv.c] = acc[c];
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// frames (B, 3, fh, fw) u8 and canvas (B, 3, ch, cw) u8, planar; ip / fp
// the (F, 8) int32 / f32 WarpParams rows; a (F, 3, Q, 512), b and c
// (F, 3, Q, Q) f32 scratch; out (F, 112, 112, 3) f32. Returns the first
// CUDA error of the five launches (0 when all were accepted).
extern "C" int warp_band_launch(const void* frames, int B, int fh, int fw,
                                const void* canvas, int ch, int cw,
                                const void* ip, const void* fp, int F,
                                void* a, void* b, void* c, void* out,
                                void* stream) {
  if (F <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fpp = (const float*)fp;
  float* fa = (float*)a;
  float* fb = (float*)b;
  float* fc = (float*)c;
  const long long qq = (long long)kQ * kQ;
  const View a_t{3LL * kQ * kPW, kQ * kPW, 1, kPW};   // pass 1 out, transposed
  const View rows_x{3 * qq, (int)qq, kQ, 1};          // (row, lane) as stored
  const View cols{3 * qq, (int)qq, 1, kQ};            // transposed
  const View crop{3LL * kOut * kOut, 1, 3, kOut * 3}; // (F, y, x, c): row x, lane y

  band_pass1<<<blocks((long long)F * kQ * kPW), kThreads, 0, s>>>(
      (const uint8_t*)frames, B, fh, fw, (const uint8_t*)canvas, ch, cw,
      (const int32_t*)ip, fpp, F, fa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // pass 2: rows x (pass 1's lanes), lanes y -> b
  band_pass<<<blocks((long long)F * kQ * kQ), kThreads, 0, s>>>(
      fa, a_t, kPW, fb, rows_x, fpp, F, kQ, kQ, 0, kQ, 40, 2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // pass 3: rows x, lanes y -> c
  band_pass<<<blocks((long long)F * kQ * kQ), kThreads, 0, s>>>(
      fb, rows_x, kQ, fc, rows_x, fpp, F, kQ, kQ, 0, kQ, 48, 3);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // pass 4: rows y, lanes x (pass 3 transposed) -> b
  band_pass<<<blocks((long long)F * kQ * kQ), kThreads, 0, s>>>(
      fc, cols, kQ, fb, rows_x, fpp, F, kQ, kQ, 0, kQ, 72, 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // pass 5: rows x, lanes y (pass 4 transposed), the crop's 112 lanes -> out
  band_pass<<<blocks((long long)F * kOut * kOut), kThreads, 0, s>>>(
      fb, cols, kQ, (float*)out, crop, fpp, F, kOut, kQ, kLaneOff, kOut, 48,
      5);
  return (int)cudaGetLastError();
}
