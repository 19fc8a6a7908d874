// PQ asymmetric-distance scores (ADC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adc_scores_mxu
// (scrfd_arcface_facerecognition_tpu/gallery/pq.py:264, pl.pallas_call at
// :302; body _adc_mxu_kernel :221). That kernel turns the table lookup into
// one-hot x LUT matmuls on the MXU because gathers are slow on a TPU. A GPU
// reads a table in shared memory cheaply, and the same sums as one-hot
// products on the tensor cores would cost Q*K*G*M*2 operations (5.2 TFLOP
// at Q=80, K=256, G=2M, M=64), so this kernel looks the entries up:
//
//   score[q, g] = sum_{m=0..M-1} LUT[q, m, codes[g, m]]
//
// lut (Q, M, K) f32, codes (G, M) u8, out (Q, G) f32, all contiguous.
// Two modes, both summed in f32 in the order m = 0..M-1 from 0.0f, as the
// plain scan (gallery/pq_adc.py adc_scores_plain) sums them:
//   hi = 0 ("hilo"): the exact f32 LUT;
//   hi = 1 ("hi"):   the LUT rounded to bf16 (round to nearest even, as
//                    torch's .to(bfloat16)) and widened back, exactly what
//                    the TPU kernel's single bf16 pass sums.
// Built with --fmad=false, each score equals the plain version's bit for
// bit; NaN and inf entries propagate as the scan propagates them.
//
// Bound on an H100: bytes. The kernel must read G*M code bytes and Q*M*K
// LUT entries and write Q*G f32 scores: 773 MB at Q=80, G=2M, M=64, K=256
// (0.23 ms at 3.35 TB/s), against Q*G*M = 10.2 G adds (0.15 ms at
// 67 TFLOP/s f32).
//
// Design. A block stages a chunk of queries' tables in dynamic shared
// memory (64 KB a query in f32 at M=64, K=256, so 3 fit in the 227 KB a
// block may use; 32 KB in bf16, so 7 fit), then its threads walk the code
// rows, one row a thread at a time: 16 code bytes a load (one 16-byte load
// when M % 16 == 0 and the codes are 16-byte aligned), kept in registers
// while every query of the chunk sums its lookups, then one coalesced store
// per query along G. The grid is persistent (as many blocks as fit on the
// card, each looping over rows), so each block stages every LUT entry once:
// L2 -> shared traffic is (number of blocks) x Q*M*K*4 bytes, not
// (G / rows per block) x that. The codes are read again for each query
// chunk (ceil(Q / chunk) passes over G*M bytes, 27 at Q=80 in f32) rather
// than keeping more queries per pass, which would need more shared memory
// than a block has: a pass over 128 MB of codes costs ~40 us of bandwidth,
// less than the lookups of one chunk. What holds this simple kernel back is
// expected to be the shared-memory lookups themselves: Q*G*M random 4-byte
// (or 2-byte) reads, of which a warp's 32 land in random banks and conflict.
// Codes must be < K (PQCodec.encode guarantees it); the kernel does not
// check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxQ = 8;   // queries per chunk: accumulators per thread

template <bool HI>
struct Table;

template <>
struct Table<false> {
  using T = float;
  static __device__ __forceinline__ T stage(float x) { return x; }
  static __device__ __forceinline__ float get(const T* p) { return *p; }
};

template <>
struct Table<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T stage(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float get(const T* p) {
    return __bfloat162float(*p);
  }
};

template <bool HI, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              float* __restrict__ out, int Q, int M, int K, long long G,
              int qc) {
  using T = typename Table<HI>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  const int per_q = M * K;
  const long long stride = (long long)gridDim.x * blockDim.x;

  for (int q0 = 0; q0 < Q; q0 += qc) {
    const int nq = min(qc, Q - q0);
    __syncthreads();  // every lookup of the previous chunk is done
    const float* src = lut + (size_t)q0 * per_q;
    for (int i = threadIdx.x; i < nq * per_q; i += blockDim.x)
      table[i] = Table<HI>::stage(__ldg(src + i));
    __syncthreads();

    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < G; g += stride) {
      float acc[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
      const uint8_t* row = codes + g * M;
      for (int m0 = 0; m0 < M; m0 += 16) {
        unsigned w[4];
        int nm = 16;
        if (VEC) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + m0));
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
          nm = min(16, M - m0);
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = 0u;
#pragma unroll
          for (int j = 0; j < 16; ++j)  // unrolled: w stays in registers
            if (j < nm)
              w[j >> 2] |= (unsigned)__ldg(row + m0 + j) << ((j & 3) * 8);
        }
        const T* t0 = table + (size_t)m0 * K;
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          if (q < nq) {
            const T* tq = t0 + (size_t)q * per_q;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              if (j < nm) {
                const int c = (w[j >> 2] >> ((j & 3) * 8)) & 0xff;
                acc[q] = __fadd_rn(acc[q], Table<HI>::get(tq + j * K + c));
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < nq) out[(size_t)(q0 + q) * G + g] = acc[q];
    }
  }
}

template <bool HI, bool VEC>
int launch(const float* lut, const uint8_t* codes, float* out, int Q, int M,
           int K, long long G, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_max = 0, n_sm = 0;
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t per_q = (size_t)M * K * (HI ? 2 : 4);
  int qc = (int)((size_t)smem_max / per_q);
  if (qc < 1) return (int)cudaErrorInvalidValue;  // one table exceeds smem
  qc = qc < kMaxQ ? qc : kMaxQ;
  qc = qc < Q ? qc : Q;
  const size_t smem = per_q * qc;
  auto kern = pq_adc_kernel<HI, VEC>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long need = (G + kThreads - 1) / kThreads;
  const long long fill = (long long)n_sm * per_sm;
  const int grid = (int)(need < fill ? need : fill);
  kern<<<grid, kThreads, smem, stream>>>(lut, codes, out, Q, M, K, G, qc);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the CUDA error; cudaErrorInvalidValue when one query's table
// (M*K entries, 4 bytes each, 2 in "hi") exceeds a block's shared memory.
extern "C" int pq_adc_launch(const void* lut, const void* codes, void* out,
                             int Q, int M, int K, long long G, int hi,
                             void* stream) {
  if (Q <= 0 || G <= 0) return 0;
  const bool vec = (M % 16 == 0) && ((uintptr_t)codes % 16 == 0);
  const float* l = (const float*)lut;
  const uint8_t* c = (const uint8_t*)codes;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (hi) {
    return vec ? launch<true, true>(l, c, o, Q, M, K, G, s)
               : launch<true, false>(l, c, o, Q, M, K, G, s);
  }
  return vec ? launch<false, true>(l, c, o, Q, M, K, G, s)
             : launch<false, false>(l, c, o, Q, M, K, G, s);
}
