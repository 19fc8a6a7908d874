// The 5-pass band-mix face warp (kernel K3), for Hopper (sm_90a), fused
// into one launch a call.
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
// non-negative terms, so the result equals the band sum bit for bit.
// A NaN or infinite sigma, u or v, or a NaN my or mx, makes some pass's
// positions NaN everywhere, and the band sum then carries NaN through every
// window into every pixel of the crop: such a crop is written all NaN.
//
// Bound on an H100: the bytes, 0.0186 ms at 16 x 1080p / 320 crops (the
// f32 crops written, F * 150,528 B, and the source pixels the crops depend
// on, about (112 * sigma)^2 a crop, read once; chip_smoke.py computes it
// from the run's crops). The work is about 26 f32 operations for each
// needed position, about 112 x 112 a pass.
//
// Design: one block per crop, each thread all three channels (the taps are
// shared), walks the canvas's y in 8-row groups, and nothing between
// passes reaches device memory:
//   stage       the source bytes of the next 8 p3 rows y (both pass-1 tap
//               rows, the lanes pass 2 reads) into shared memory with
//               16-byte cp.async copies, issued while the current rows'
//               passes 3-5 run;
//   passes 1-2  p2[x, y] of those rows, each pass-1 value a1[y, t] formed
//               where pass 2 taps it from the staged bytes (pass 1's taps
//               depend on y alone, pass 2's on x alone: both are tables);
//   pass 3      p3[x, y] of those rows into a ring of RING (= 72) p3 rows y
//               in shared memory, slot y % RING;
//   pass 4      once the ring holds the rows y that group g's 72-row window
//               reads, p4 rows y of the group into shared memory;
//   pass 5      the crop's pixels (y - 40, x_out) of the group, to `out`
//               as whole (x, c) rows.
// Only the positions the crop depends on are computed: pass 5's 112 x 112;
// pass 4 at the x lanes [L4lo, L4hi) pass 5 can tap; passes 1-3 at the p3
// rows [Ylo, Yhi) pass 4 can tap; pass 2 at the x rows [L3lo, L3hi) pass 3
// can tap. Each range is the union of the band windows of the groups that
// read it, cut to the span of floor(pos) .. floor(pos) + 1 over the box of
// positions read (pos is monotone in i and l, so the corners give it).
// tools/exp_warp2.py fused_plan states the same arithmetic, and the CPU
// tests hold it to cover every tap; RING arrives as a launch argument, and
// with a non-null `plan` the kernel writes the ranges it used, for
// chip_smoke.py to hold against fused_plan. A group's rows lie in its
// 72-row window, and rows of group g + 1 are produced only after pass 4 of
// group g has read the ring (a barrier between), so 72 slots suffice.
//
// Shared memory a block: 3 x (RING + 8) x 192 f32 (the ring; one 8-row
// buffer for p2, then p4) and 8 x 6 x 512 staged bytes, 208,896 B
// dynamic, and 7,456 B static (the tap tables), so one block (16 warps)
// an SM: 320 blocks are 2.42 waves on 132 SMs at F = 320 and 80 are 0.61
// at F = 80 (chip_smoke.py prints the occupancy API's count). A block is
// bound by its own serial walk: about 15 steps of 4 phases, each a few
// positions a thread, with barriers between (tools/warp_band_ablate.py
// splits the time).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kOut = 112;
constexpr int kQ = 192;
constexpr int kPW = 512;
constexpr int kG = 8;
constexpr int kLaneOff = 40;
constexpr int kBatch = 8;                   // p3 rows produced a step
static_assert(kBatch == kG, "p2b and p4b share one channel stride");
constexpr int kQG = kQ / kG;                // 24 groups of Q rows
constexpr int kG4 = kLaneOff / kG;          // first pass-4 group kept (5)
constexpr int kNG4 = kOut / kG;             // pass-4 groups kept (14)
constexpr int kNG5 = kOut / kG;             // pass-5 groups (14)
constexpr int kPlanCols = 8 + 2 * kNG4;     // fused_plan's columns
constexpr float kCQ = 95.5f;
constexpr float kCQmC0 = 40.0f;             // CQ - C0

// floor(x) as an int: saturating, NaN to 0, as the reference's conversion.
__device__ __forceinline__ int sat_floor(float x) {
  float lo = floorf(x);
  if (!(lo == lo)) lo = 0.f;
  lo = fminf(fmaxf(lo, -1073741824.f), 1073741824.f);
  return (int)lo;
}

// j0 of the 8-row group starting at `base`.
__device__ __forceinline__ int group_j0(float alpha, float beta_min,
                                        float gamma, int base, int src_rows,
                                        int band, int align) {
  int j0 = sat_floor(__fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)base),
                                         beta_min), gamma)) - 1;
  const int hi = src_rows - band > 0 ? src_rows - band : 0;
  j0 = j0 < 0 ? 0 : (j0 > hi ? hi : j0);
  return (j0 / align) * align;
}

__device__ __forceinline__ float positionf(float alpha, float beta,
                                           float gamma, float i, float l) {
  return __fadd_rn(__fadd_rn(__fmul_rn(alpha, i), __fmul_rn(beta, l)),
                   gamma);
}

__device__ __forceinline__ float position(float alpha, float beta,
                                          float gamma, int i, int l) {
  return positionf(alpha, beta, gamma, (float)i, (float)l);
}

// min(0 * beta, (Q - 1) * beta), in the reference's order.
__device__ __forceinline__ float beta_min(float beta) {
  return fminf(__fmul_rn(beta, 0.f), __fmul_rn(beta, (float)(kQ - 1)));
}

// [floor(min pos), floor(max pos) + 2) over i in [i0, i1], l in [l0, l1].
__device__ void tap_span(float alpha, float beta, float gamma, int i0,
                         int i1, int l0, int l1, int* lo, int* hi) {
  const float a = position(alpha, beta, gamma, i0, l0);
  const float b = position(alpha, beta, gamma, i0, l1);
  const float c = position(alpha, beta, gamma, i1, l0);
  const float d = position(alpha, beta, gamma, i1, l1);
  *lo = sat_floor(fminf(fminf(a, b), fminf(c, d)));
  *hi = sat_floor(fmaxf(fmaxf(a, b), fmaxf(c, d))) + 2;
}

// The two taps of position `pos`: tap k is row t0 + k with weight w[k],
// or row -1 when it lies outside the window [j0, j0 + band).
struct Taps {
  int row[2];
  float w[2];
};

// The window is [lo, hi) = [j0, j0 + band) as floats. floor(pos) comes from
// the round-to-nearest of pos + 1.5 * 2^23, exact for |pos| < 2^22 (a
// position beyond that has no tap inside a window of [0, 512) either
// way), so a tap costs full-rate FP32 and integer operations, no
// conversion.
constexpr float kRound = 12582912.f;        // 1.5 * 2^23

__device__ __forceinline__ Taps taps(float pos, float lo, float hi) {
  Taps t;
  const float m = __fadd_rn(pos, kRound);
  const float r = __fsub_rn(m, kRound);      // pos rounded to nearest
  const bool up = r > pos;
  const float t0 = up ? __fsub_rn(r, 1.f) : r;   // floor(pos)
  const int i0 = __float_as_int(m) - __float_as_int(kRound) - (up ? 1 : 0);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float rt = __fadd_rn(t0, (float)k);
    const bool in = rt >= lo && rt < hi;
    t.row[k] = in ? i0 + k : -1;
    t.w[k] = in ? fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, rt)))) : 0.f;
  }
  return t;
}

// A staged source byte as f32, exactly, without a conversion.
__device__ __forceinline__ float u8_to_f32(uint8_t b) {
  return __fsub_rn(__int_as_float(0x4B000000 | b), 8388608.f);
}


__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Sum of two taps' values in tap order, (0 + a * w0) + b * w1. A tap
// outside its window has weight 0 and its value is read as 0, which adds
// the exact zero the window's other rows add; a NaN position gives NaN.
__device__ __forceinline__ float sum2(float pos, float a, float w0, float b,
                                      float w1) {
  const float acc = __fadd_rn(__fadd_rn(0.f, __fmul_rn(a, w0)),
                              __fmul_rn(b, w1));
  return pos != pos ? nan_f() : acc;
}

// A pass's taps where they depend on one coordinate only (pass 1 on y,
// pass 2 on x): rows (-1 outside the window, or past the source for pass
// 1) and weights; a NaN position has rows 0 and NaN weights.
struct TapRow {
  int r0, r1;
  float w0, w1;
};

__device__ __forceinline__ TapRow tap_row(float pos, int j0, int band,
                                          int src_rows) {
  const Taps t = taps(pos, (float)j0, (float)(j0 + band));
  TapRow tr{t.row[0] < src_rows ? t.row[0] : -1,
            t.row[1] < src_rows ? t.row[1] : -1, t.w[0], t.w[1]};
  if (pos != pos) tr = TapRow{0, 0, nan_f(), nan_f()};
  return tr;
}

// Per-block ranges (see the head note; fused_plan's columns 0-5), and the
// pass-1 lanes [tlo, thi) pass 2 taps, tlo aligned down to 16.
struct Limits {
  int l4lo, l4hi, l3lo, l3hi, ylo, yhi, tlo, thi;
};

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `n` are zero-filled.
__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Threads work on 8 rows at a time, 64 lanes each, all 3 channels.
constexpr int kLanes = 64;
static_assert(kThreads == kG * kLanes, "a thread for each row and lane");

__global__ void __launch_bounds__(kThreads, 1)
warp_band_fused(const uint8_t* __restrict__ frames, int B, int fh, int fw,
                const uint8_t* __restrict__ canvas, int ch, int cw,
                const int32_t* __restrict__ ip, const float* __restrict__ fp,
                int ring_rows, float* __restrict__ out,
                int32_t* __restrict__ plan) {
  extern __shared__ __align__(16) float smem[];
  // ring and buf are 3 channel planes of rows x Q f32
  const int ring_c = ring_rows * kQ;       // the ring: p3 rows y, lanes x
  float* ring = smem;
  float* p2b = ring + 3 * ring_c;          // kBatch p2 rows y, lanes x ...
  float* p4b = p2b;                        // ... then G p4 rows y, lanes x
  constexpr int kBufC = kG * kQ;           // their channel stride
  // the source bytes of a batch: for each p3 row y, pass-1 tap and
  // channel, lanes [tlo, tlo + PW) of the source row
  uint8_t* st = (uint8_t*)(p2b + 3 * kBufC);
  __shared__ TapRow tab1[kQ], tab2[kQ];    // pass 1 by y, pass 2 by x
  __shared__ int slot_of[kQ];              // ring offset of p3 row y
  __shared__ int j0_3[kQG], j0_4[kQG], j0_5[kNG5];
  __shared__ float fj0_3[kQG], fj0_5[kNG5];  // the same, as floats
  __shared__ int rd_lo[kNG4], rd_hi[kNG4];
  __shared__ Limits lim;

  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kLanes, rs = tid / kLanes;
  const int b = ip[f * 8 + 0], level = ip[f * 8 + 1], ox = ip[f * 8 + 3];
  const float sigma = fp[f * 8 + 0], u = fp[f * 8 + 1], v = fp[f * 8 + 2];
  const float my = fp[f * 8 + 3], mx = fp[f * 8 + 4];
  float* o = out + (size_t)f * kOut * kOut * 3;
  const bool dead = !(isfinite(sigma) && isfinite(u) && isfinite(v))
      || my != my || mx != mx;
  if (dead) {
    for (int k = tid; k < kOut * kOut * 3; k += kThreads) o[k] = nan_f();
    if (plan != nullptr && tid == 0) {
      for (int k = 0; k < kPlanCols; ++k) plan[f * kPlanCols + k] = 0;
      plan[f * kPlanCols + 6] = 1;
    }
    return;
  }

  const uint8_t* src = level == 0 ? frames : canvas;
  const int rows = level == 0 ? fh : ch;
  const int w = level == 0 ? fw : cw;
  const size_t plane = (size_t)rows * w;
  const bool frame_ok = b >= 0 && b < B;
  if (frame_ok) src += (size_t)b * 3 * plane;
  const float g1 = __fsub_rn(my, __fmul_rn(sigma, kCQ));
  const float g2 = __fsub_rn(mx, __fmul_rn(sigma, kCQ));
  const float g3 = __fmul_rn(-u, kCQ);
  const float g4 = __fmul_rn(-v, kCQ);
  const float g5 = __fsub_rn(kCQmC0, __fmul_rn(u, kCQ));
  const float bm_u = beta_min(u), bm_v = beta_min(v);

  for (int k = tid; k < kQ; k += kThreads) {
    const int base = (k / kG) * kG;
    tab1[k] = tap_row(position(sigma, 0.f, g1, k, 0),
                      group_j0(sigma, 0.f, g1, base, rows, 32, 16), 32, rows);
    tab2[k] = tap_row(position(sigma, 0.f, g2, k, 0),
                      group_j0(sigma, 0.f, g2, base, kPW, 40, 8), 40, kPW);
    slot_of[k] = (k % ring_rows) * kQ;
    if (k % kG == 0) {
      j0_3[k / kG] = group_j0(1.f, bm_u, g3, base, kQ, 48, 8);
      fj0_3[k / kG] = (float)j0_3[k / kG];
      j0_4[k / kG] = group_j0(1.f, bm_v, g4, base, kQ, 72, 8);
      if (k < kOut) {
        j0_5[k / kG] = group_j0(1.f, bm_u, g5, base, kQ, 48, 8);
        fj0_5[k / kG] = (float)j0_5[k / kG];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    Limits L{0, 0, 0, 0, 0, 0, 0, 0};
    int lo, hi;
    tap_span(1.f, u, g5, 0, kOut - 1, kLaneOff, kLaneOff + kOut - 1, &lo,
             &hi);
    L.l4lo = max(j0_5[0], lo);
    L.l4hi = max(min(min(j0_5[kNG5 - 1] + 48, hi), kQ), L.l4lo);
    for (int g = 0; g < kNG4; ++g) {
      int a = 0, z = 0;
      if (L.l4hi > L.l4lo) {
        const int y0 = (kG4 + g) * kG;
        tap_span(1.f, v, g4, y0, y0 + kG - 1, L.l4lo, L.l4hi - 1, &lo, &hi);
        a = max(j0_4[kG4 + g], lo);
        z = max(min(min(j0_4[kG4 + g] + 72, hi), kQ), a);
      }
      rd_lo[g] = a;
      rd_hi[g] = z;
      L.ylo = g == 0 ? a : min(L.ylo, a);
      L.yhi = g == 0 ? z : max(L.yhi, z);
    }
    if (L.yhi > L.ylo) {
      tap_span(1.f, u, g3, L.l4lo, L.l4hi - 1, L.ylo, L.yhi - 1, &lo, &hi);
      L.l3lo = max(j0_3[L.l4lo / kG], lo);
      L.l3hi = max(min(min(j0_3[(L.l4hi - 1) / kG] + 48, hi), kQ), L.l3lo);
    }
    // pass 2's taps are monotone in x: the first and last valid ones
    // bound the lanes it reads
    for (int x = L.l3lo; x < L.l3hi && L.thi == 0; ++x) {
      const TapRow t = tab2[x];
      if (t.r0 >= 0 || t.r1 >= 0) {
        L.tlo = (t.r0 >= 0 ? t.r0 : t.r1) & ~15;
        for (int z = L.l3hi - 1; z >= x; --z) {
          const TapRow e = tab2[z];
          if (e.r1 >= 0 || e.r0 >= 0) {
            L.thi = (e.r1 >= 0 ? e.r1 : e.r0) + 1;
            break;
          }
        }
      }
    }
    lim = L;
    if (plan != nullptr) {
      int32_t* p = plan + f * kPlanCols;
      p[0] = L.l4lo; p[1] = L.l4hi; p[2] = L.l3lo; p[3] = L.l3hi;
      p[4] = L.ylo; p[5] = L.yhi; p[6] = 0; p[7] = 0;
      for (int g = 0; g < kNG4; ++g) {
        p[8 + g] = rd_lo[g];
        p[8 + kNG4 + g] = rd_hi[g];
      }
    }
  }
  __syncthreads();
  const Limits L = lim;

  // Stage the source bytes of p3 rows [y0, y0 + kBatch): 16-byte chunks,
  // asynchronously where the rows are 16-byte aligned, else byte by byte.
  // Rows outside the window, or of a frame index outside [0, B), are not
  // read (pass 2 does not read them either).
  const bool vec = w % 16 == 0 && ox % 16 == 0
      && ((uintptr_t)src & 15) == 0;
  const int n16 = (L.thi - L.tlo + 15) / 16;
  auto stage = [&](int y0) {
    for (int k = tid; k < kBatch * 6 * n16; k += kThreads) {
      const int seg = k / n16, j = k - seg * n16;
      const int c = seg % 3, q = (seg / 3) & 1, y = y0 + seg / 6;
      if (y >= kQ || !frame_ok) continue;
      const int row = q ? tab1[y].r1 : tab1[y].r0;
      if (row < 0) continue;
      const int col = ox + L.tlo + 16 * j;
      uint8_t* d = st + seg * kPW + 16 * j;
      const uint8_t* s = src + c * plane + (size_t)row * w;
      if (vec) {
        const int n = min(max(w - col, 0), 16);
        copy16_async(d, n > 0 ? s + col : s, n);
      } else {
        for (int i = 0; i < 16; ++i) d[i] = col + i < w ? s[col + i] : 0;
      }
    }
    async_commit();
  };

  int made = L.ylo;                        // p3 rows [ylo, made) produced
  if (L.yhi > L.ylo) stage(made);
  for (int g = 0; g < kNG4; ++g) {
    const int want = rd_hi[g];
    bool synced = false;
    while (made < want) {
      const int y0 = made, nr = min(kBatch, want - made);
      async_wait_all();
      __syncthreads();                     // the staged bytes; p4b is free
      // passes 1-2: p2[x, y] for x in [l3lo, l3hi), rows y0 + r; pass 1's
      // a1[y, t] formed at the two lanes t each p2 value taps
      if (rs < nr) {
        const int r = rs;
        const TapRow t1 = tab1[y0 + r];
        const uint8_t* s0 = st + r * 6 * kPW - L.tlo;
        const uint8_t* s1 = s0 + 3 * kPW;
        for (int x = L.l3lo + lane; x < L.l3hi; x += kLanes) {
          const TapRow t2 = tab2[x];
          float v8[2][2][3];                // [pass-2 tap][pass-1 tap][c]
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int t = k == 0 ? t2.r0 : t2.r1;
            const bool col = t >= 0 && frame_ok && ox + t >= 0 && ox + t < w;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              v8[k][0][c] = (col && t1.r0 >= 0)
                  ? u8_to_f32(s0[c * kPW + t]) : 0.f;
              v8[k][1][c] = (col && t1.r1 >= 0)
                  ? u8_to_f32(s1[c * kPW + t]) : 0.f;
            }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float a = t2.r0 >= 0
                ? sum2(0.f, v8[0][0][c], t1.w0, v8[0][1][c], t1.w1) : 0.f;
            const float bb = t2.r1 >= 0
                ? sum2(0.f, v8[1][0][c], t1.w0, v8[1][1][c], t1.w1) : 0.f;
            p2b[c * kBufC + r * kQ + x] = sum2(0.f, a, t2.w0, bb, t2.w1);
          }
        }
      }
      __syncthreads();
      if (y0 + nr < L.yhi) stage(y0 + nr);   // the next batch's bytes
      // pass 3: p3[x, y] for x in [l4lo, l4hi) into the ring
      if (rs < nr) {
        const int y = y0 + rs;
        const float yf = (float)y;
        const float* row = p2b + rs * kQ;
        float* dst = ring + slot_of[y];
        float xf = (float)(L.l4lo + lane);
        for (int x = L.l4lo + lane; x < L.l4hi; x += kLanes, xf += kLanes) {
          const float pos = positionf(1.f, u, g3, xf, yf);
          const float lo = fj0_3[x / kG];
          const Taps t = taps(pos, lo, __fadd_rn(lo, 48.f));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float a = t.row[0] >= 0 ? row[c * kBufC + t.row[0]] : 0.f;
            const float bb = t.row[1] >= 0 ? row[c * kBufC + t.row[1]] : 0.f;
            dst[c * ring_c + x] = sum2(pos, a, t.w[0], bb, t.w[1]);
          }
        }
      }
      __syncthreads();
      made += nr;
      synced = true;
    }
    if (!synced) __syncthreads();          // pass 5 of g - 1 read p4b
    // pass 4: p4[y, x] for the group's 8 rows y, x in [l4lo, l4hi)
    const int gy = (kG4 + g) * kG;
    {
      const float yf = (float)(gy + rs), lo = (float)j0_4[kG4 + g];
      const float hi = __fadd_rn(lo, 72.f);
      float xf = (float)(L.l4lo + lane);
      for (int x = L.l4lo + lane; x < L.l4hi; x += kLanes, xf += kLanes) {
        const float pos = positionf(1.f, v, g4, yf, xf);
        const Taps t = taps(pos, lo, hi);
        const int sa = t.row[0] >= 0 ? slot_of[t.row[0]] + x : 0;
        const int sb = t.row[1] >= 0 ? slot_of[t.row[1]] + x : 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float a = t.row[0] >= 0 ? ring[c * ring_c + sa] : 0.f;
          const float bb = t.row[1] >= 0 ? ring[c * ring_c + sb] : 0.f;
          p4b[c * kBufC + rs * kQ + x] = sum2(pos, a, t.w[0], bb, t.w[1]);
        }
      }
    }
    __syncthreads();
    // pass 5: the crop's pixels (y - 40, x_out) of the group
    {
      const int y = gy + rs;
      const float yf = (float)y;
      const float* row = p4b + rs * kQ;
      float* dst = o + (size_t)(y - kLaneOff) * kOut * 3;
      float xf = (float)lane;
      for (int xo = lane; xo < kOut; xo += kLanes, xf += kLanes) {
        const float pos = positionf(1.f, u, g5, xf, yf);
        const float lo = fj0_5[xo / kG];
        const Taps t = taps(pos, lo, __fadd_rn(lo, 48.f));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float a = t.row[0] >= 0 ? row[c * kBufC + t.row[0]] : 0.f;
          const float bb = t.row[1] >= 0 ? row[c * kBufC + t.row[1]] : 0.f;
          dst[xo * 3 + c] = sum2(pos, a, t.w[0], bb, t.w[1]);
        }
      }
    }
  }
}

inline size_t dyn_smem(int ring_rows) {
  return (size_t)3 * (ring_rows + kBatch) * kQ * sizeof(float)
      + (size_t)kBatch * 6 * kPW;
}

}  // namespace

// frames (B, 3, fh, fw) u8 and canvas (B, 3, ch, cw) u8, planar; ip / fp
// the (F, 8) int32 / f32 WarpParams rows; ring_rows the p3 rows kept in
// shared memory (fused_plan's RING, at least the pass-4 band of 72);
// out (F, 112, 112, 3) f32; plan null, or (F, 36) int32 that receives each
// crop's ranges (fused_plan's layout). Returns the launch's CUDA error (0
// when it was accepted).
extern "C" int warp_band_launch(const void* frames, int B, int fh, int fw,
                                const void* canvas, int ch, int cw,
                                const void* ip, const void* fp, int F,
                                int ring_rows, void* out, void* plan,
                                void* stream) {
  if (F <= 0) return 0;
  if (ring_rows < 72) return (int)cudaErrorInvalidValue;
  const size_t smem = dyn_smem(ring_rows);
  cudaError_t err = cudaFuncSetAttribute(
      warp_band_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  warp_band_fused<<<(unsigned)F, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, B, fh, fw, (const uint8_t*)canvas, ch, cw,
      (const int32_t*)ip, (const float*)fp, ring_rows, (float*)out,
      (int32_t*)plan);
  return (int)cudaGetLastError();
}

// The occupancy of a launch with `ring_rows`: shared memory a block
// (dynamic plus static, bytes), blocks an SM and registers a thread.
extern "C" int warp_band_occupancy(int ring_rows, int* smem_bytes,
                                   int* blocks_per_sm, int* regs) {
  const size_t smem = dyn_smem(ring_rows);
  cudaError_t err = cudaFuncSetAttribute(
      warp_band_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, warp_band_fused)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, warp_band_fused, kThreads, smem);
  *smem_bytes = (int)(smem + attr.sharedSizeBytes);
  *regs = attr.numRegs;
  return (int)err;
}
