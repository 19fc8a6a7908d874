// Narrow-channel 3x3 stride-1 conv with a fused affine + ReLU (kernel K4),
// for Hopper (sm_90a), on the tensor cores.
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
// Bound on an H100: at the experiment's shapes (B=64, H=96, Wp=256,
// C=F=56) the bytes, 176 MB of x read and 176 MB of y written, take
// 0.105 ms at 3.35 TB/s; the 88.8 GFLOP take 0.090 ms at the dense bf16
// tensor-core rate. So the kernel is bound by bytes, and its products must
// run on the tensor cores: on the CUDA cores at 67 TFLOP/s f32 the same
// work needs 1.3 ms at least.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 sums in
// registers). M = output channels (a tile of 64, four m16 tiles), N =
// output positions along w, K = (dy, dx, c), c padded per dx to a multiple
// of 16 (CP, a template parameter, so the k loop unrolls) with zeros in
// both x and w3 (a zero weight against stale NaN bits would give NaN). A
// block is one image, one band of 8 output rows, one tile of 256 positions
// and one tile of 64 channels; its 8 warps each own 32 positions x 64
// channels (64 f32 accumulators a thread).
//   - Weights: staged once per block in shared memory as [dy][f][dx*CP + c],
//     row pitch 3*CP + 8 elements, an odd number of 16-byte units, so the
//     A fragments' ldmatrix.x4 reads hit 8 distinct bank groups.
//   - Input: staged transposed, [position][c] with an 8-element skew (row
//     pitch (CP + 8) * 2 bytes, again an odd number of 16-byte units), so
//     the dx shift is a whole-row offset and every ldmatrix row address is
//     16-byte aligned; the B fragments come straight from ldmatrix.x4.
//     Slot position p holds lane (w0 - 1 + p) mod Wp: the halo lanes -1
//     and Wp are the circular lanes Wp - 1 and 0.
//   - Rows: a ring of three input-row slots walks the band, so each input
//     row is staged once per band (10 rows for 8 outputs); rows -1 and H
//     are never staged, their dy taps are skipped (a zero row adds 0).
//     Where Wp % 8 == 0, row h + 2 streams in while row h computes: 16-byte
//     cp.async copies of each channel's lanes into a raw buffer [c][lane]
//     (the halo lanes into registers), then, after row h, a shared-memory
//     transpose (byte permutes, 8 bank groups a quarter warp) into the slot
//     row h - 1 has left. Other widths stage lane by lane between barriers.
//   - C above 64 runs in chunks of 64 that restage the weights and the
//     three rows and sum into the same registers; F above 64 and Wp above
//     256 are grid dimensions. Ragged tiles are masked at the store.
//   - Epilogue: all nine taps sum in one accumulator, then the affine
//     (a rounded multiply, then a rounded add), the NaN-keeping ReLU and
//     round-to-nearest bf16, into the raw buffer as a [f][position] tile;
//     the block then writes each output channel's row contiguously (16-byte
//     stores where Wp % 8 == 0).
// The tensor cores sum in an order of their own, so the kernel is not bit
// equal to the plain version: it is held to it within one bf16 step plus
// |scale| * 2^-12 * sum |w| |x| over the taps (tools/exp_pallas_conv.py
// sum_tolerance_ratio).
//
// What holds it back now (tools/conv3x3_ablate.py times the parts): one
// block an SM (222 KB of shared memory at C >= 64, 255 registers a
// thread), so while the block transposes, writes its tile and waits at
// its four barriers a row, the tensor cores idle; and mma.sync itself,
// fed by ldmatrix from registers, reaches a fraction of the card's bf16
// rate. At C = F = 56 the padding to 64 adds 31 % to the products.
// wgmma, TMA with a producer warp, and persistent blocks are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 32 * kWarps;      // positions a block computes
constexpr int kSlotPos = kNT + 2;     // with the two halo lanes
constexpr int kMT = 64;               // output channels a block computes
constexpr int kCC = 64;               // input channels a chunk stages
constexpr int kRB = 8;                // output rows a block computes
constexpr int kRing = 3;              // input-row slots
constexpr int kSkew = 8;              // elements of skew a shared row
constexpr int kRawPitch = kNT + kSkew;  // raw rows [c][lane], the out tile

// shared memory of the kernel for cp padded channels a chunk: weights,
// the ring, and the raw buffer (an input row as it lies in x, then the
// output tile)
__host__ __device__ constexpr int smem_elems(int cp) {
  return 3 * kMT * (3 * cp + kSkew) + kRing * kSlotPos * (cp + kSkew) +
         kMT * kRawPitch;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Weights of channels [c0, c0 + cc) and outputs [f0, f0 + 64) into
// wsm[dy][f][dx * cp + c], zeros where c >= cc or f0 + f >= F. Each thread
// has kWBatch loads in flight before it stores.
constexpr int kWBatch = 16;

template <int CP>
__device__ void stage_weights(__nv_bfloat16* wsm, const __nv_bfloat16* w3,
                              int C, int F, int f0, int c0, int cc) {
  constexpr int kp = 3 * CP + kSkew;
  constexpr int total = 3 * 3 * CP * kMT;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int base = threadIdx.x; base < total; base += kThreads * kWBatch) {
    __nv_bfloat16 v[kWBatch];
#pragma unroll
    for (int j = 0; j < kWBatch; ++j) {
      const int idx = base + j * kThreads;
      const int f = idx % kMT;             // f fastest: coalesced reads
      const int k = idx / kMT;
      const int c = k % CP;
      const int dx = (k / CP) % 3;
      const int dy = k / (3 * CP);
      v[j] = idx < total && c < cc && f0 + f < F
          ? w3[((size_t)dy * 3 * C + dx * C + c0 + c) * F + f0 + f] : zero;
    }
#pragma unroll
    for (int j = 0; j < kWBatch; ++j) {
      const int idx = base + j * kThreads;
      if (idx >= total) break;
      const int f = idx % kMT;
      const int k = idx / kMT;
      const int c = k % CP;
      const int dx = (k / CP) % 3;
      const int dy = k / (3 * CP);
      wsm[(dy * kMT + f) * kp + dx * CP + c] = v[j];
    }
  }
}

// Where one chunk of one image's input rows comes from.
struct RowSrc {
  const __nv_bfloat16* x;
  size_t plane;               // H * Wp
  int b, C, Wp, w0, nvalid, c0, cc;
  bool vec;                   // Wp % 8 == 0 and x 16-byte aligned

  // lane (w0 - 1 + p) mod Wp for 0 <= p <= nvalid + 1
  __device__ int lane(int p) const {
    int l = w0 - 1 + p;
    if (l < 0) l += Wp;
    else if (l >= Wp) l -= Wp;
    return l;
  }
  __device__ const __nv_bfloat16* at(int c, int r, int l) const {
    return x + ((size_t)b * C + c0 + c) * plane + (size_t)r * Wp + l;
  }
};

// One lane, channels g * 8 .. g * 8 + 7 of row r, as raw bits (0 where
// the channel is >= cc), and its 16-byte store to a slot position.
__device__ __forceinline__ void load_lane(uint32_t (&u)[8], const RowSrc& s,
                                          int r, int g, int l) {
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(s.at(g * 8, r, l));
#pragma unroll
  for (int e = 0; e < 8; ++e)
    u[e] = g * 8 + e < s.cc ? __ldg(src + e * s.plane) : 0u;
}

__device__ __forceinline__ void store_lane(__nv_bfloat16* dst,
                                           const uint32_t (&u)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(u[0] | (u[1] << 16), u[2] | (u[3] << 16),
                 u[4] | (u[5] << 16), u[6] | (u[7] << 16));
}

// The vector path. Row r's lanes [w0, w0 + nvalid) of channels < cc go
// into raw[c][lane - w0] by 16-byte cp.async (neighbouring threads on
// neighbouring 16 bytes of a channel row); the caller waits for them.
__device__ void row_to_raw(__nv_bfloat16* raw, const RowSrc& s, int r) {
  const int octs = s.nvalid / 8;
  for (int idx = threadIdx.x; idx < s.cc * octs; idx += kThreads) {
    const int c = idx / octs, o = idx % octs;
    cp_async16(raw + c * kRawPitch + 8 * o, s.at(c, r, s.w0 + 8 * o));
  }
}

// raw -> slot, transposed: thread task (o, g) moves channels g * 8 .. + 7
// of lanes 8 * o .. + 7 to slot positions 8 * o + 1 .. + 8, four channels
// at a time (byte permutes pair the channels). A quarter warp takes 8
// distinct o and, at 8 groups, 8 distinct g: its raw reads and slot
// writes hit 8 distinct bank groups. Channels >= cc are written as zeros.
template <int CP>
__device__ void raw_to_slot(__nv_bfloat16* slot, const __nv_bfloat16* raw,
                            const RowSrc& s) {
  constexpr int groups = CP / 8, pitch = CP + kSkew;
  const int q = threadIdx.x % 8, rr = threadIdx.x / 8;
  const int o = 8 * (rr / groups) + q, g = (q + rr) % groups;
  if (8 * o >= s.nvalid) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t v[4][4];   // v[c][k]: channel g * 8 + half * 4 + c, lanes 2k, 2k+1
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = g * 8 + half * 4 + c;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (ch < s.cc)
        w = *reinterpret_cast<const uint4*>(raw + ch * kRawPitch + 8 * o);
      v[c][0] = w.x; v[c][1] = w.y; v[c][2] = w.z; v[c][3] = w.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      *reinterpret_cast<uint2*>(slot + (8 * o + 1 + j) * pitch + g * 8 +
                                half * 4) =
          make_uint2(__byte_perm(v[0][j / 2], v[1][j / 2], sel),
                     __byte_perm(v[2][j / 2], v[3][j / 2], sel));
    }
  }
}

// The halo lanes (slot positions 0 and nvalid + 1) of the vector path:
// threads below 2 * (CP / 8) each load and store one lane's 8 channels.
template <int CP>
__device__ __forceinline__ bool halo_task(int& p, int& g, const RowSrc& s) {
  constexpr int groups = CP / 8;
  if (threadIdx.x >= 2 * groups) return false;
  p = threadIdx.x < groups ? 0 : s.nvalid + 1;
  g = threadIdx.x % groups;
  return true;
}

// Input row r into slot, at once: slot position p holds lane
// (w0 - 1 + p) mod Wp for p <= nvalid + 1, zeros in the padded channels
// c >= cc. Positions past nvalid + 1 feed only masked outputs and are left
// as they are. Ends with the slot complete for the whole block.
constexpr int kLaneBatch = 4;

template <int CP>
__device__ void stage_row(__nv_bfloat16* slot, __nv_bfloat16* raw,
                          const RowSrc& s, int r) {
  constexpr int groups = CP / 8, pitch = CP + kSkew;
  if (s.vec) {
    row_to_raw(raw, s, r);
    int p, g;
    uint32_t u[8];
    const bool halo = halo_task<CP>(p, g, s);
    if (halo) load_lane(u, s, r, g, s.lane(p));
    cp_async_wait_all();
    __syncthreads();
    raw_to_slot<CP>(slot, raw, s);
    if (halo) store_lane(slot + p * pitch + g * 8, u);
    __syncthreads();                       // raw is free again
    return;
  }
  const int n = s.nvalid + 2;
  for (int base = threadIdx.x; base < n * groups;
       base += kThreads * kLaneBatch) {
    uint32_t u[kLaneBatch][8];
#pragma unroll
    for (int q = 0; q < kLaneBatch; ++q) {
      const int idx = base + q * kThreads;   // position fastest: coalesced
      if (idx < n * groups) load_lane(u[q], s, r, idx / n, s.lane(idx % n));
    }
#pragma unroll
    for (int q = 0; q < kLaneBatch; ++q) {
      const int idx = base + q * kThreads;
      if (idx < n * groups)
        store_lane(slot + (idx % n) * pitch + (idx / n) * 8, u[q]);
    }
  }
  __syncthreads();
}

// acc += the taps of one dy: KS k16 steps for each dx. a_base: the warp's
// lane address in this dy's weights; b_base: in the input row.
template <int CP>
__device__ __forceinline__ void mma_row(float (&acc)[4][4][4],
                                        uint32_t a_base, uint32_t b_base,
                                        int nmt) {
  constexpr int kp = 3 * CP + kSkew, pitch = CP + kSkew;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int ks = 0; ks < CP / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (mt < nmt)
          ldmatrix_x4(a[mt], a_base + 2 * (mt * 16 * kp + dx * CP + ks * 16));
      uint32_t bq[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bq[np], b_base + 2 * ((np * 16 + dx) * pitch + ks * 16));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= nmt) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bq[nt / 2][2 * (nt % 2)],
                   bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w3,
               const float* __restrict__ scale,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
               int C, int H, int Wp, int F, int relu, int vec) {
  constexpr int kp = 3 * CP + kSkew;       // weight row pitch, elements
  constexpr int pitch = CP + kSkew;        // input row pitch, elements
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = wsm + 3 * kMT * kp;
  __nv_bfloat16* raw = ring + kRing * kSlotPos * pitch;

  const int bands = H / kRB;
  const int b = blockIdx.x / bands;
  const int h0 = (blockIdx.x % bands) * kRB;
  const int w0 = blockIdx.y * kNT;
  const int f0 = blockIdx.z * kMT;
  const int nvalid = min(kNT, Wp - w0);
  const int nmt = min(4, (F - f0 + 15) / 16);
  const int nch = (C + kCC - 1) / kCC;
  // the ring slot of input row r (rows h0 - 1 .. h0 + kRB)
  auto slot_of = [&](int r) {
    return ring + ((r - h0 + 1) % kRing) * kSlotPos * pitch;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pw = warp * 32;                // the warp's first position
  const bool active = pw < nvalid;
  const int g = lane / 4, t = lane % 4;

  // per-lane ldmatrix offsets (elements): A rows f = lane % 16 at k
  // (lane / 16) * 8; B rows n = lane % 8 + 8 * (lane / 16) at k
  // 8 * ((lane / 8) % 2)
  const int a_off = (lane % 16) * kp + (lane / 16) * 8;
  const int b_off = (pw + lane % 8 + 8 * (lane / 16)) * pitch +
                    8 * ((lane / 8) % 2);

  RowSrc src{x, (size_t)H * Wp, b, C, Wp, w0, nvalid, 0, min(kCC, C),
             vec != 0};
  float acc[4][4][4];
  for (int i = 0; i < kRB; ++i) {
    const int h = h0 + i;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // the vector path with one chunk streams row h + 2 in while row h
    // computes: cp.async into raw, the halo lanes in registers
    const int rn = h + 2;
    const bool stream = src.vec && nch == 1 && i + 2 <= kRB && rn < H;
    int hp = 0, hg = 0;
    uint32_t hu[8];
    bool halo = false;
    for (int ch = 0; ch < nch; ++ch) {
      src.c0 = ch * kCC;
      src.cc = min(kCC, C - src.c0);
      __syncthreads();                     // the last reads are done
      if (nch > 1 || i == 0) {
        stage_weights<CP>(wsm, w3, C, F, f0, src.c0, src.cc);
        for (int r = h - 1; r <= h + 1; ++r)
          if (r >= 0 && r < H) stage_row<CP>(slot_of(r), raw, src, r);
      } else if (!src.vec && h + 1 < H) {  // lane by lane, no overlap
        stage_row<CP>(slot_of(h + 1), raw, src, h + 1);
      }
      if (stream) {
        row_to_raw(raw, src, rn);
        halo = halo_task<CP>(hp, hg, src);
        if (halo) load_lane(hu, src, rn, hg, src.lane(hp));
      }
      for (int dy = 0; dy < 3; ++dy) {
        const int r = h + dy - 1;
        if (active && r >= 0 && r < H)     // a zero row adds nothing
          mma_row<CP>(acc, smem_addr(wsm + dy * kMT * kp + a_off),
                      smem_addr(slot_of(r) + b_off), nmt);
      }
    }
    if (stream) cp_async_wait_all();
    __syncthreads();                       // row h - 1's last reads, raw
    if (stream) {                          // row h + 2 into h - 1's slot
      raw_to_slot<CP>(slot_of(rn), raw, src);
      if (halo) store_lane(slot_of(rn) + hp * pitch + hg * 8, hu);
      __syncthreads();
    }

    // epilogue: the block's 64 x 256 tile of row h, through raw
    __nv_bfloat16* tile = raw;
    if (active) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= nmt) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int fl = mt * 16 + g + 8 * hf;
          const int f = min(f0 + fl, F - 1);   // rows >= F are not stored
          const float sc = scale[f], bi = bias[f];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              o[e] = __fadd_rn(__fmul_rn(acc[mt][nt][2 * hf + e], sc), bi);
              if (relu && !(o[e] != o[e])) o[e] = fmaxf(o[e], 0.f);
            }
            *reinterpret_cast<__nv_bfloat162*>(
                tile + fl * kRawPitch + pw + nt * 8 + 2 * t) =
                __floats2bfloat162_rn(o[0], o[1]);
          }
        }
      }
    }
    __syncthreads();
    const int nf = min(kMT, F - f0);
    const size_t out0 = (((size_t)b * F + f0) * H + h) * Wp + w0;
    const size_t fstride = (size_t)H * Wp;
    if (src.vec) {                         // 16-byte stores, 512 B a row
      for (int idx = threadIdx.x; idx < nf * (kNT / 8); idx += kThreads) {
        const int fl = idx / (kNT / 8), o = idx % (kNT / 8);
        if (8 * o < nvalid)
          *reinterpret_cast<uint4*>(y + out0 + fl * fstride + 8 * o) =
              *reinterpret_cast<const uint4*>(tile + fl * kRawPitch + 8 * o);
      }
    } else {
      for (int idx = threadIdx.x; idx < nf * nvalid; idx += kThreads) {
        const int fl = idx / nvalid, p = idx % nvalid;
        y[out0 + fl * fstride + p] = tile[fl * kRawPitch + p];
      }
    }
  }
}

template <int CP>
int launch(const void* x, const void* w3, const void* scale,
           const void* bias, void* y, int B, int C, int H, int Wp, int F,
           int relu, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)smem_elems(CP) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * (H / kRB)), (unsigned)((Wp + kNT - 1) / kNT),
                  (unsigned)((F + kMT - 1) / kMT));
  conv3x3_kernel<CP><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w3, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)y, C, H, Wp, F, relu, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, H, Wp) bf16, w3 (3, 3C, F) bf16, scale / bias (F,) f32, y
// (B, F, H, Wp) bf16, all contiguous on the card; H a multiple of 8.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int conv3x3_launch(const void* x, const void* w3, const void* scale,
                              const void* bias, void* y, int B, int C, int H,
                              int Wp, int F, int relu, void* stream) {
  if (B <= 0 || H <= 0 || Wp <= 0 || F <= 0) return 0;
  if (H % kRB) return (int)cudaErrorInvalidValue;
  const int vec = Wp % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  // channels of a chunk, padded to the mma's k of 16
  const int ks = C >= kCC ? 4 : (C + 15) / 16;
  decltype(&launch<64>) fn = ks <= 1 ? &launch<16> : ks == 2 ? &launch<32>
                           : ks == 3 ? &launch<48> : &launch<64>;
  return fn(x, w3, scale, bias, y, B, C, H, Wp, F, relu, vec,
            (cudaStream_t)stream);
}
