// Narrow-channel 3x3 stride-1 conv with a fused affine + ReLU (kernel K4),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pallas_conv3x3 (tools/exp_pallas_conv.py,
// pl.pallas_call at :110; body _kern :41), which packs the three dx taps
// into one K = 3C contraction on the MXU and sums the dy taps by rolls of
// the f32 partial products. Its function, for x (B, C, H, Wp) bf16 and
// w3 (3, 3C, F) bf16 (w3[dy] rows ordered (dx, c)):
//   P_dy[b, f, h, w] = sum_{dx, c} w3[dy, dx*C + c, f]
//                                  * x[b, c, h + dy - 1, (w + dx - 1) mod Wp]
//   y[b, f, h, w] = bf16_rn(act(((P_0 + P_1) + P_2) * scale[f] + bias[f]))
// with rows zero-padded and lanes circular (all Wp lanes are computed; lane
// Wp - 1 reads lane 0 as its right neighbour, as the TPU kernel's roll
// does), f32 sums, act = ReLU or the identity (ReLU keeps NaN).
//
// Design: CUDA cores, one thread per output position and a tile of 8
// output channels, f32 accumulators per dy (3 x 8 registers), FMAs over the
// 9C taps. A block is one output row of one image for one channel tile;
// its weights (3 x 3C x 8, as f32) are staged in shared memory, where every
// thread of the block reads the same entry (a broadcast). The product of
// two bf16 values is exact in f32, so each FMA rounds only its sum, and
// each P_dy is summed over k = dx * C + c in order, as the plain version
// sums it: the two are equal bit for bit.
//
// Bound on an H100: at the experiment's shapes (B=64, H=96, Wp=256,
// C=F=56) the bytes: 176 MB of x and 176 MB of y (0.105 ms at 3.35 TB/s)
// against 88.8 GFLOP (0.090 ms at the bf16 tensor-core rate). On CUDA
// cores at 67 TFLOP/s f32 the same work needs 1.3 ms at least, and this
// kernel also issues a shared-memory load for every few FMAs. The tensor
// cores (mma.sync / wgmma on bf16 fragments, the dx-packed K = 3C layout of
// the TPU kernel) are the work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFT = 8;   // output channels a thread computes

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w3,
               const float* __restrict__ scale,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
               int C, int H, int Wp, int F, int relu) {
  extern __shared__ float wsm[];   // [dy][dx * C + c][j], f0 + j < F else 0
  const int nft = (F + kFT - 1) / kFT;
  const int h = blockIdx.x;
  const int b = blockIdx.y / nft;
  const int f0 = (blockIdx.y % nft) * kFT;
  const int K = 3 * C;
  for (int idx = threadIdx.x; idx < 3 * K * kFT; idx += blockDim.x) {
    const int j = idx % kFT;
    const int k = (idx / kFT) % K;
    const int dy = idx / (kFT * K);
    wsm[idx] = f0 + j < F
        ? __bfloat162float(w3[((size_t)dy * K + k) * F + f0 + j]) : 0.f;
  }
  __syncthreads();

  const size_t plane = (size_t)H * Wp;
  const __nv_bfloat16* xb = x + (size_t)b * C * plane;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    const int wl = w == 0 ? Wp - 1 : w - 1;
    const int wr = w == Wp - 1 ? 0 : w + 1;
    float acc[3][kFT];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int j = 0; j < kFT; ++j) acc[dy][j] = 0.f;
      const int hh = h + dy - 1;
      if (hh < 0 || hh >= H) continue;   // a zero row: P_dy = 0
      const __nv_bfloat16* xr = xb + (size_t)hh * Wp;
      const float* wd = wsm + dy * K * kFT;
      // k = dx * C + c in order: the plain version's sum order
      for (int dx = 0; dx < 3; ++dx) {
        const int wx = dx == 0 ? wl : (dx == 1 ? w : wr);
        const float* wk = wd + dx * C * kFT;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float v = __bfloat162float(xr[(size_t)c * plane + wx]);
#pragma unroll
          for (int j = 0; j < kFT; ++j)
            acc[dy][j] = __fmaf_rn(v, wk[c * kFT + j], acc[dy][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFT; ++j) {
      const int f = f0 + j;
      if (f >= F) break;
      const float s = __fadd_rn(__fadd_rn(acc[0][j], acc[1][j]), acc[2][j]);
      float o = __fadd_rn(__fmul_rn(s, scale[f]), bias[f]);
      if (relu && !(o != o)) o = fmaxf(o, 0.f);
      y[((size_t)(b * F + f) * H + h) * Wp + w] = __float2bfloat16_rn(o);
    }
  }
}

}  // namespace

// x (B, C, H, Wp) bf16, w3 (3, 3C, F) bf16, scale / bias (F,) f32, y
// (B, F, H, Wp) bf16, all contiguous on the card. Returns the CUDA error of
// the launch (0 when it was accepted); weights too large for a block's
// shared memory are refused by the launch.
extern "C" int conv3x3_launch(const void* x, const void* w3, const void* scale,
                              const void* bias, void* y, int B, int C, int H,
                              int Wp, int F, int relu, void* stream) {
  if (B <= 0 || H <= 0 || Wp <= 0 || F <= 0) return 0;
  const int nft = (F + kFT - 1) / kFT;
  const size_t smem = (size_t)3 * 3 * C * kFT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)H, (unsigned)(B * nft));
  conv3x3_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w3, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)y, C, H, Wp, F, relu);
  return (int)cudaGetLastError();
}
