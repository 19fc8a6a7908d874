// PQ asymmetric-distance scores (ADC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adc_scores_mxu
// (scrfd_arcface_facerecognition_tpu/gallery/pq.py:264, pl.pallas_call at
// :302; body _adc_mxu_kernel :221). That kernel turns the table lookup into
// one-hot x LUT matmuls on the MXU because gathers are slow on a TPU. A GPU
// reads a table in shared memory cheaply, and the same sums as one-hot
// products on the tensor cores would cost Q*K*G*M*2 operations (5.2 TFLOP
// at Q=80, K=256, G=2M, M=64: 5.3 ms at the bf16 peak, and the mma's own
// sum order would lose bit equality), so this kernel looks the entries up:
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
// 67 TFLOP/s f32). No lookup design reaches it: the instruction rate is the
// floor, about 2.5-3 instructions an entry (a share of the load and of the
// code's address, a widen, an f32 add), 0.8 ms over 132 SMs.
//
// What held the first design back, measured (tools/pq_adc_ablate.py at
// Q=80, M=64, K=256, G=2M, "hi", warm, H100 at 700 W; PERF.md section 5):
// it staged 7 queries' bf16 tables as [q][m][c] and fetched one 2-byte
// entry a shared-memory load, one code row a thread. 4.46 ms; its lookups
// alone (no code loads, no stores) 3.89; everything but the lookups 2.14.
// A warp's 32 random codes fall in random banks: about 2.8 wavefronts
// (shared-memory cycles) per 32 entries.
//
// Design. The table is staged query-innermost: one 16-byte record per
// (m, c) holding the entries of a chunk of W queries side by side (8 bf16
// in "hi", 4 f32 in "hilo"), so one lane's one 16-byte load fetches every
// query's entry for its code. A 16-byte load is served a quarter-warp at
// a time, about 2.5 wavefronts per 8 lanes: 10 per 256 bf16 entries, 2.2x
// fewer than before. A bf16 in the high half of a 32-bit word with a zero
// low half is that f32, so each entry is widened by one integer op (a
// shift or a mask). Packing changes where entries sit, not the order of
// the sum. A chunk of 8 bf16 queries takes 256 KB at M=64, K=256, more
// than a block's 227 KB, so the table is staged in slabs of equal size
// (2 x 32 subspaces): the first slab stores partial scores, the next one
// starts from them, so each score is still summed in m order from 0.0f;
// this costs one more write and read of the scores (640 MB), against 2x
// fewer chunks and so 2x fewer passes over the codes. Fewer queries than 8
// (4 in "hilo") take the least power of two >= Q, so one query reads 2
// bytes a lookup. The tables are staged from the f32 LUT in the kernel
// (__float2bfloat16_rn in "hi"), four records a thread from 16-byte LUT
// loads where K % 4 == 0 and the LUT is 16-byte aligned, else one record
// a thread; padded slots of a chunk are zeros and are never stored. Each
// thread walks two code rows at a time, 32 codes a step, the next step's
// codes loaded while this step's lookups run. The grid is persistent (as
// many blocks as fit on the card, each looping over rows), so each block
// stages every table slab once. Codes must be < K (PQCodec.encode
// guarantees it); the kernel does not check.
//
// Measured, same script and card: "hi" 2.08 ms warm on uniform random
// codes, its lookups alone 1.90-1.96, everything but the lookups 1.63;
// 8-byte groups of 4 (one slab, 20 chunks) 2.29; slabs of 48 + 16
// subspaces instead of 32 + 32 (less L1 left for the codes) 2.29; one row
// a thread 2.30; staging one record a thread from 4-byte LUT loads 2.17
// (equal in "hilo"). "hilo" 3.73-3.75 warm, 8-byte groups of 2 4.43-4.46.
// At Q=1 the one-query group reads 0.079 ms ("hi"; 0.085 "hilo") against
// 0.199 (0.193) with the widest group, at Q=4 0.123 against 0.206. The
// gallery's PQ tier is scored whole, and on the gallery path half of its
// 2M rows are empty slots with zero codes, whose lookups broadcast from
// one address: the same uniform codes with rows 1M.. zero read "hi" 1.95,
// "hilo" 3.03 warm, what chip_smoke.py reads cold on the path (1.96,
// 3.03). The lookups' wavefront count (10.24 G entries / 256 x 10.2, over
// 132 SMs) is 1.56 ms at the 1.98 GHz boost clock, and the code and score
// traffic (3.2 GB a call, 0.96 ms at 3.35 TB/s) is close behind what the
// lookups leave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 2;    // code rows in flight a thread
constexpr int kStep = 32;   // codes of a row a step

// Queries a chunk at most: one 16-byte group of bf16 ("hi") or f32
// ("hilo") entries. A chunk takes the least power of two >= Q below it.
constexpr int kHiMaxW = 8;
constexpr int kLoMaxW = 4;

// One group: W entries of one (m, c), 2 bytes each in "hi", 4 in "hilo",
// read with one shared-memory load.
template <bool HI, int W>
struct Group {
  static constexpr int kBytes = W * (HI ? 2 : 4);
  static constexpr int kWords = (kBytes + 3) / 4;

  static __device__ __forceinline__ void put(uint32_t (&w)[kWords], int e,
                                             float x) {
    if constexpr (HI) {
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
      w[e >> 1] |= b << ((e & 1) * 16);
    } else {
      w[e] = __float_as_uint(x);
    }
  }
  // entry e as f32: a bf16 widened by placing it in the high half
  static __device__ __forceinline__ float get(const uint32_t (&w)[kWords],
                                              int e) {
    if constexpr (HI)
      return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                     : (w[e >> 1] << 16));
    else
      return __uint_as_float(w[e]);
  }
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (kBytes == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
  }
  static __device__ __forceinline__ void store(unsigned char* p,
                                               const uint32_t (&w)[kWords]) {
    if constexpr (kBytes == 2) {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// Codes m0 .. m0 + kStep - 1 of each row, 4 a word (zeros from mhi on, or
// for a row past G). VEC: 16-byte loads (m0 and mhi multiples of 16,
// 16-byte aligned rows).
template <bool VEC>
__device__ __forceinline__ void load_codes(
    uint32_t (&w)[kRows][kStep / 4], const uint8_t* const (&row)[kRows],
    const bool (&ok)[kRows], int m0, int mhi) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (VEC) {
#pragma unroll
      for (int h = 0; h < kStep / 16; ++h) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok[r] && m0 + 16 * h < mhi)
          v = __ldg(reinterpret_cast<const uint4*>(row[r] + m0 + 16 * h));
        w[r][4 * h] = v.x; w[r][4 * h + 1] = v.y;
        w[r][4 * h + 2] = v.z; w[r][4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStep / 4; ++i) w[r][i] = 0u;
      if (ok[r]) {
        const int nm = min(kStep, mhi - m0);
#pragma unroll
        for (int j = 0; j < kStep; ++j)  // unrolled: w stays in registers
          if (j < nm)
            w[r][j >> 2] |= (uint32_t)__ldg(row[r] + m0 + j) << ((j & 3) * 8);
      }
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Stage n records from src (query e's entries at src + e * mk, e < nq):
// record i is entry i of each query side by side, zeros past nq. vec_lut
// (K % 4 == 0, 16-byte aligned LUT): four records a thread at a time from
// 16-byte LUT loads, all of them before any store.
template <bool HI, int W>
__device__ __forceinline__ void stage(unsigned char* table,
                                      const float* __restrict__ src, int nq,
                                      int mk, int n, bool vec_lut) {
  using Grp = Group<HI, W>;
  if (vec_lut) {
#pragma unroll 2
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
      float4 x[W];
#pragma unroll
      for (int e = 0; e < W; ++e)
        x[e] = e < nq ? __ldg(reinterpret_cast<const float4*>(
                            src + (size_t)e * mk + i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t w[Grp::kWords] = {};
#pragma unroll
        for (int e = 0; e < W; ++e) Grp::put(w, e, lane_of(x[e], k));
        Grp::store(table + (i + k) * Grp::kBytes, w);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      uint32_t w[Grp::kWords] = {};
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (e < nq) Grp::put(w, e, __ldg(src + (size_t)e * mk + i));
      Grp::store(table + i * Grp::kBytes, w);
    }
  }
}

// Chunks of W queries; each chunk's table in slabs of ms subspaces (one
// slab when it fits). A slab after the first starts from the scores the
// one before it stored, so every score is still summed in m order.
template <bool HI, int W, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              float* __restrict__ out, int Q, int M, int K, long long G,
              int ms, bool vec_lut) {
  using Grp = Group<HI, W>;
  constexpr int GB = Grp::kBytes;
  extern __shared__ __align__(16) unsigned char table[];
  const int mk = M * K;
  const long long tile = (long long)kThreads * kRows;

  for (int q0 = 0; q0 < Q; q0 += W) {
    const int nq = min(W, Q - q0);
    for (int mlo = 0; mlo < M; mlo += ms) {
      const int mhi = min(M, mlo + ms);
      __syncthreads();  // every lookup of the previous slab is done
      stage<HI, W>(table, lut + (size_t)q0 * mk + mlo * K, nq, mk,
                   (mhi - mlo) * K, vec_lut);
      __syncthreads();

      for (long long t0 = (long long)blockIdx.x * tile; t0 < G;
           t0 += (long long)gridDim.x * tile) {
        long long g[kRows];
        bool ok[kRows];
        const uint8_t* row[kRows];
        float acc[kRows][W];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          g[r] = t0 + r * kThreads + threadIdx.x;
          ok[r] = g[r] < G;
          row[r] = codes + (ok[r] ? g[r] : 0) * M;
#pragma unroll
          for (int q = 0; q < W; ++q)
            acc[r][q] = mlo > 0 && ok[r] && q < nq
                ? out[(size_t)(q0 + q) * G + g[r]] : 0.f;
        }
        uint32_t cur[kRows][kStep / 4], nxt[kRows][kStep / 4];
        load_codes<VEC>(cur, row, ok, mlo, mhi);
        for (int m0 = mlo; m0 < mhi; m0 += kStep) {
          if (m0 + kStep < mhi) load_codes<VEC>(nxt, row, ok, m0 + kStep, mhi);
          const int nm = min(kStep, mhi - m0);
          const unsigned char* tm = table + (m0 - mlo) * K * GB;
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            if (j < nm) {
              const unsigned char* tj = tm + j * K * GB;
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const int c =
                    __byte_perm(cur[r][j >> 2], 0u, 0x4440u | (j & 3));
                uint32_t w[Grp::kWords];
                Grp::load(tj + c * GB, w);
#pragma unroll
                for (int e = 0; e < W; ++e)
                  acc[r][e] = __fadd_rn(acc[r][e], Grp::get(w, e));
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int i = 0; i < kStep / 4; ++i) cur[r][i] = nxt[r][i];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int q = 0; q < W; ++q)
            if (ok[r] && q < nq) out[(size_t)(q0 + q) * G + g[r]] = acc[r][q];
      }
    }
  }
}

struct Card {
  int smem_max = 0, n_sm = 0;
};

template <bool HI, int W, bool VEC>
int launch(const Card& card, const float* lut, const uint8_t* codes,
           float* out, int Q, int M, int K, long long G,
           cudaStream_t stream) {
  // subspaces a slab: all M if they fit, else the fewest slabs that fit,
  // of equal size (the more L1 is left beside them), multiples of 16 so
  // that VEC's code loads stay aligned
  const int per_m = K * Group<HI, W>::kBytes;
  int ms = card.smem_max / per_m;
  if (VEC) ms &= ~15;
  if (ms < 1) return (int)cudaErrorInvalidValue;
  if (ms < M) {
    const int nslab = (M + ms - 1) / ms;
    ms = (M + nslab - 1) / nslab;
    if (VEC) ms = (ms + 15) & ~15;
  } else {
    ms = M;
  }
  const size_t smem = (size_t)ms * per_m;
  auto kern = pq_adc_kernel<HI, W, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long rows = (long long)kThreads * kRows;
  const long long need = (G + rows - 1) / rows;
  const long long fill = (long long)card.n_sm * per_sm;
  const int grid = (int)(need < fill ? need : fill);
  const bool vec_lut = K % 4 == 0 && (uintptr_t)lut % 16 == 0;
  kern<<<grid, kThreads, smem, stream>>>(lut, codes, out, Q, M, K, G, ms,
                                         vec_lut);
  return (int)cudaGetLastError();
}

template <bool HI, int W>
int launch_vec(const Card& card, bool vec, const float* lut,
               const uint8_t* codes, float* out, int Q, int M, int K,
               long long G, cudaStream_t s) {
  return vec ? launch<HI, W, true>(card, lut, codes, out, Q, M, K, G, s)
             : launch<HI, W, false>(card, lut, codes, out, Q, M, K, G, s);
}

// W: the least power of two >= Q, at most MaxW
template <bool HI, int MaxW>
int launch_mode(const Card& card, bool vec, const float* lut,
                const uint8_t* codes, float* out, int Q, int M, int K,
                long long G, cudaStream_t s) {
  const int want = Q;
  if constexpr (MaxW >= 8) {
    if (want > 4)
      return launch_vec<HI, 8>(card, vec, lut, codes, out, Q, M, K, G, s);
  }
  if constexpr (MaxW >= 4) {
    if (want > 2)
      return launch_vec<HI, 4>(card, vec, lut, codes, out, Q, M, K, G, s);
  }
  if constexpr (MaxW >= 2) {
    if (want > 1)
      return launch_vec<HI, 2>(card, vec, lut, codes, out, Q, M, K, G, s);
  }
  return launch_vec<HI, 1>(card, vec, lut, codes, out, Q, M, K, G, s);
}

}  // namespace

// Returns 0 or the CUDA error.
extern "C" int pq_adc_launch(const void* lut, const void* codes, void* out,
                             int Q, int M, int K, long long G, int hi,
                             void* stream) {
  if (Q <= 0 || G <= 0) return 0;
  Card card;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&card.smem_max,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&card.n_sm, cudaDevAttrMultiProcessorCount, dev);
  const bool vec = (M % 16 == 0) && ((uintptr_t)codes % 16 == 0);
  const float* l = (const float*)lut;
  const uint8_t* c = (const uint8_t*)codes;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (hi) return launch_mode<true, kHiMaxW>(card, vec, l, c, o, Q, M, K, G, s);
  return launch_mode<false, kLoMaxW>(card, vec, l, c, o, Q, M, K, G, s);
}
