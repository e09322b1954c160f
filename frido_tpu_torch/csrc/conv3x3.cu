// 3x3 / stride-1 / pad-1 convolution for Hopper (sm_90a) on the tensor
// cores, fp32 and bf16, NCHW, with an optional GroupNorm -> SPADE -> SiLU
// prologue.
//
// Replaces two TPU kernels of frido_tpu/ops/pallas/conv_pallas.py:
// - :177 `conv3x3_pallas` (`_conv_forward` :146, `_conv_kernel` :74):
//   y = conv(x, w) + bias, accumulated in fp32;
// - :376 `conv3x3_norm_silu_pallas` (`_fused_forward` :275,
//   `_fused_kernel` :199): the UNet ResBlock prologue folded into the same
//   conv. Per input element, in fp32: GroupNorm (x - mean) * rstd * w + b
//   (folded here into x * scale_nc + shift_nc), then, with SPADE,
//   * (1 + gamma) + beta with per-pixel gamma and beta, then SiLU, then ONE
//   rounding to the activation dtype (conv_pallas.py:230-236). The zero
//   padding comes after the prologue (`jnp.pad(xn)`, :237): a halo tap
//   reads 0, not prologue(0).
// The bias arrives in the activation dtype and is added in fp32, with one
// rounding at the store.
//
// What bounds it: at the UNet's sites (M = N*H*W = 64 .. 4096 pixels,
// Cout = 4 .. 960, K = 9*Cin = 36 .. 17280) the work is 2*M*Cout*K
// operations against a few MB: bound by arithmetic at 32^2 and 16^2, and by
// the weight's bytes at 4^2 and 8^2 (M = 64: the [960, 1920, 3, 3] weight
// is 33 MB for 2.1 GFLOP). The decoder's 256^2 fp32 sites (M = 262,144,
// Cout = Cin = 128) are bound by arithmetic. What held the first version
// back: fp32 FMA on the CUDA cores, synchronous single-buffered staging,
// every input element gathered once per tap and Cout tile (and the
// prologue recomputed 27 times at [4, 576, 32, 32] -> 192), and 15 blocks
// on 132 SMs at [4, 1920, 4, 4] -> 960.
//
// Design (mma.sync fed by cp.async; the host plan, `conv_plan` in
// frido_tpu_torch/ops/cuda/conv.py, picks every tile and the grid; the
// launcher rejects a plan that does not fit this layout):
// - Implicit GEMM in tap-major order, as the Pallas kernels compute it:
//   nine shifted dots over a staged, padded input patch. Cout is the mma's
//   M side, pixels its N side: C^T = W . X^T, so the output tile stores
//   along NCHW rows.
// - A block owns 64 output channels x a pixel tile of NB whole images or
//   TH rows x TW columns of one image (64 or 128 pixels: NT = 2 or 4 n8
//   tiles per warp; 8 warps as 2 (Cout) x 4 (pixels), each 32 x 8*NT).
//   K goes through in Cin chunks (BK = 16 bf16, 8 fp32), each with all
//   nine taps.
// - Weights: a pack launch re-lays [Cout, Cin, 3, 3] as [9, Cout, Cin8]
//   (Cin zero-padded to 16 bytes), and in fp32 splits it once into tf32 hi
//   and lo (3xTF32, attention_mma.cuh), so each chunk's [9][64][BK] tile
//   is a run of 16-byte cp.async copies and its A fragments are ldmatrix
//   loads with no further work. The pack reads and writes the weight once
//   per call; it is counted in the call's time.
// - Input: each chunk stages the raw NCHW rows of the patch (the tile plus
//   a one-pixel halo) by cp.async (16, 8 or 4 bytes where the row allows,
//   else element by element), and the SPADE gamma and beta rows with them.
//   A convert pass then applies the prologue ONCE per staged element,
//   rounds it to bf16 (fp32: splits it into tf32 hi and lo), and writes it
//   transposed, channel-contiguous, into the compute patch; halo pixels
//   and channels past Cin get 0. The nine taps read shifted windows of that
//   patch by ldmatrix: each lane gives the address of its own pixel, so the
//   shift costs nothing.
// - Pipeline, one barrier a chunk: while chunk c is multiplied, chunk
//   c + 1's raw rows are converted into the second compute patch, and
//   chunk c + 1's weights and chunk c + 2's raw rows are in flight (two
//   slots of each, two patches); every copy has a chunk's work to land.
//   Dynamic
//   shared memory up to 227 KB, opted in once per kernel and device.
// - Products: bf16 m16n8k16 mma with fp32 accumulators; fp32 as 3xTF32
//   (three m16n8k8 tf32 products, lo*hi + hi*lo + hi*hi), which keeps fp32
//   accuracy where one tf32 pass does not (1.4e-3 of the output RMS at
//   K = 1152).
// - Filling the card: where pixel tiles x Cout tiles give fewer than 132
//   blocks, the plan splits K over Cin chunks (grid z); each split writes
//   fp32 partials to a workspace and a reduce launch sums them in split
//   order, adds the bias and rounds: the same inputs give the same bits.
//   [4, 1920, 4, 4] -> 960: 15 tiles x 9 splits = 135 blocks.
// - Ragged edges: pixels past the image and Cout past the channel count
//   are masked at the store; Cin is zero-padded to the chunk in shared
//   memory (Cin = 4 gives K = 36 over one chunk).
// The fused op launches the statistics kernel (one block per (sample,
// group), group_stats.cuh: scale and shift [N, Cin] in fp32), the pack,
// the conv and, with split-K, the reduce; the plain op the last three.
// All of them are one counted call.
//
// Each C entry point returns cudaGetLastError() (or the configuration
// error) as an int; the Python wrapper raises on anything but 0.

#include "attention_mma.cuh"
#include "group_stats.cuh"

#include <math.h>

namespace {

using namespace frido::attn;

constexpr int BM = 64;           // output channels per block
constexpr int THREADS = 256;     // 8 warps: 2 (Cout) x 4 (pixels)
constexpr int STATS_THREADS = 512;
constexpr int MAX_SMEM = 232448;

// staged patch pixels (NB * PH * PW) a block may hold, and the convert
// items (a pixel's 4 channels) a thread then owns
__host__ __device__ constexpr int max_patch(int nt) {
  return nt == 8 ? 384 : 256;
}
__host__ __device__ constexpr int max_items(int nt) { return nt == 8 ? 6 : 4; }

// x * sigmoid(x) in fp32; the fast exp and divide stay within a few fp32
// ulps, far below the one rounding to bf16 that follows
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

template <typename T>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BK = F32 ? 8 : 16;            // Cin chunk
  static constexpr int LD = BK + (F32 ? 4 : 8);      // 48-byte rows
  static constexpr int PARTS = F32 ? 2 : 1;          // tf32 hi, lo
  static constexpr int VE = 16 / (int)sizeof(T);     // elements in 16 B
};

struct ConvParams {
  const void* x;
  const void* wp;      // packed weight [PARTS][9][cout][cinp]
  const void* bias;
  const float* scale;  // [n, cin] (fused)
  const float* shift;
  const void* gamma;   // [n, cin, h, w] or null
  const void* beta;
  void* y;
  float* ws;           // split-K partials [split][n, cout, h, w]
  int n, cin, h, w, cout, cinp;
  int nb, th, tw, tiles_x, tiles_y, split, cps, xcopy, rs;
};

// Shared memory: A_SLOTS weight tiles [PARTS][9][64][LD]; X_SLOTS of raw
// rows [BK][NB][PH][RS] of x (and gamma, beta) with the fused scale and
// shift [2][NB][BK] fp32; two compute patches [PARTS][NPIX][LD].
constexpr int A_SLOTS = 2;  // chunk i multiplied, i + 1 flying
constexpr int X_SLOTS = 2;  // chunk i + 1 converted, i + 2 flying

struct Layout {
  int ph, pw, npix, vc, nv, plane;
  int a_bytes, x_bytes, ss_bytes, xs_bytes, b_bytes, smem;
  __host__ __device__ Layout(int isz, int bk, int ld, int parts, int nb,
                             int th, int tw, int rs, int xcopy, bool fused,
                             bool spade) {
    ph = th + 2;
    pw = tw + 2;
    npix = nb * ph * pw;
    vc = xcopy ? xcopy / isz : 1;
    nv = 1 + (tw + 1 + vc - 1) / vc;
    plane = nb * ph * rs;
    a_bytes = parts * 9 * BM * ld * isz;
    x_bytes = bk * plane * isz * (spade ? 3 : 1);
    ss_bytes = fused ? 2 * nb * bk * 4 : 0;
    ss_bytes = (ss_bytes + 15) / 16 * 16;
    xs_bytes = x_bytes + ss_bytes;
    b_bytes = parts * npix * ld * isz;
    smem = A_SLOTS * a_bytes + X_SLOTS * xs_bytes + 2 * b_bytes;
  }
};

// floor(i / d) for 0 <= i < 2^15 by one float multiply, exact there:
// (i + 1/2) / d lies at least 1/(2d) from an integer, and the product's
// relative error (2^-23) moves it by at most 2^-8 / d. The set-up and the
// store divide by the tile's runtime sizes; an integer division costs
// about twenty instructions.
struct SmallDiv {
  float inv;  // 1 / d, correctly rounded
  __device__ __forceinline__ explicit SmallDiv(int d) : inv(1.f / (float)d) {}
  __device__ __forceinline__ int operator()(int i) const {
    return (int)(((float)i + 0.5f) * inv);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T, int NT, bool FUSED>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const ConvParams p) {
  using C = Cfg<T>;
  constexpr int BK = C::BK, LD = C::LD, PARTS = C::PARTS, VE = C::VE;
  constexpr int A_PART = 9 * BM * LD;  // elements of one weight part
  constexpr int MAX_ITEMS = max_items(NT);
  extern __shared__ __align__(16) unsigned char smem[];
  const bool spade = FUSED && p.gamma != nullptr;
  const Layout L((int)sizeof(T), BK, LD, PARTS, p.nb, p.th, p.tw, p.rs,
                 p.xcopy, FUSED, spade);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int h = p.h, w = p.w, cin = p.cin, hw = h * w;

  int bx = blockIdx.x;
  const int x0 = (bx % p.tiles_x) * p.tw;
  bx /= p.tiles_x;
  const int y0 = (bx % p.tiles_y) * p.th;
  const int b0 = (bx / p.tiles_y) * p.nb;
  const int co0 = blockIdx.y * BM;
  const int nch = (cin + BK - 1) / BK;
  const int kc0 = blockIdx.z * p.cps;
  const int nk = min(nch, kc0 + p.cps) - kc0;
  const int tpix = p.nb * p.th * p.tw;
  const T* x = static_cast<const T*>(p.x);
  const T* gam = static_cast<const T*>(p.gamma);
  const T* bet = static_cast<const T*>(p.beta);

  // --- this thread's staging geometry, the same for every chunk
  // raw rows: one (image, patch row, vector) each, channels slot, slot +
  // cstep, ... (the plan keeps NB * PH * NV <= THREADS)
  const int ipc = p.nb * L.ph * L.nv;
  const SmallDiv by_nv(L.nv), by_ph(L.ph), by_pw(L.pw), by_npix(L.npix),
      by_tile(p.th * p.tw), by_tw(p.tw);
  const int cstep = THREADS / ipc;
  const int xslot = SmallDiv(ipc)(tid);
  bool xok;
  size_t xsrc;
  int xdst;
  {
    const int r = tid - xslot * ipc;
    const int q = by_nv(r), v = r - q * L.nv;
    const int b = by_ph(q), py = q - b * L.ph;
    const int gx = x0 - L.vc + v * L.vc, gy = y0 - 1 + py, bi = b0 + b;
    xok = xslot < cstep && bi < p.n && gy >= 0 && gy < h && gx >= 0 &&
          gx < w;
    xsrc = xok ? (size_t)bi * cin * hw + (size_t)gy * w + gx : 0;
    xdst = (b * L.ph + py) * p.rs + v * L.vc;
  }
  // convert: (patch pixel, 4 channels) items; raw offset, compute offset,
  // first channel, scale index (-1: outside the image, writes 0)
  int roff[MAX_ITEMS], coff[MAX_ITEMS], cil[MAX_ITEMS], sidx[MAX_ITEMS];
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    const int i = tid + k * THREADS;
    coff[k] = -1;
    if (i < L.npix * (BK / 4)) {
      const int gi = by_npix(i), pp = i - gi * L.npix;
      const int q = by_pw(pp), px = pp - q * L.pw;
      const int b = by_ph(q), py = q - b * L.ph;
      const int gx = x0 - 1 + px, gy = y0 - 1 + py;
      const bool in = b0 + b < p.n && gx >= 0 && gx < w && gy >= 0 && gy < h;
      cil[k] = 4 * gi;
      roff[k] = ((4 * gi * p.nb + b) * L.ph + py) * p.rs + px + L.vc - 1;
      coff[k] = pp * LD + 4 * gi;
      sidx[k] = in ? b * BK + 4 * gi : -1;
    }
  }
  // ldmatrix rows: A row = co, B row = pixel, each 16-byte half of k
  const int arow = wm * 32 + (lane & 15);
  const int acol = (lane >> 4) * VE;
  const int koff = ((lane >> 3) & 1) * VE;
  int pbase[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const int n = wn * 8 * NT + j * 16 + (lane & 7) + 8 * (lane >> 4);
    int base = 0;
    if (n < tpix) {
      const int b = by_tile(n), r = n - b * p.th * p.tw;
      const int yy = by_tw(r), xx = r - yy * p.tw;
      base = (b * L.ph + yy) * L.pw + xx;
    }
    pbase[j] = base;
  }

  unsigned char* const xbase = smem + A_SLOTS * L.a_bytes;
  unsigned char* const pbuf = xbase + X_SLOTS * L.xs_bytes;
  auto stage_a = [&](int kc) {
    return reinterpret_cast<T*>(smem + (kc % A_SLOTS) * L.a_bytes);
  };
  auto stage_x = [&](int kc) {
    return reinterpret_cast<T*>(xbase + (kc % X_SLOTS) * L.xs_bytes);
  };
  auto stage_ss = [&](int kc) {
    return reinterpret_cast<float*>(xbase + (kc % X_SLOTS) * L.xs_bytes +
                                    L.x_bytes);
  };
  auto patch = [&](int kc) {
    return reinterpret_cast<T*>(pbuf + (kc & 1) * L.b_bytes);
  };

  // chunk kc's weight tile: rows (part, tap, co) of BK channels = 2 x 16
  // bytes of the packed weight
  auto issue_a = [&](int kc) {
    const int c0 = kc * BK;
    T* a = stage_a(kc);
    const T* wp = static_cast<const T*>(p.wp);
    for (int i = tid; i < PARTS * 9 * BM * 2; i += THREADS) {
      const int v = i & 1, row = i >> 1;
      const int part = row / (9 * BM), r = row - part * 9 * BM;
      const int tap = r / BM, col = r - tap * BM;
      const int co = co0 + col, ci = c0 + v * VE;
      const bool ok = co < p.cout && ci < p.cinp;
      const T* src =
          ok ? wp + ((size_t)(part * 9 + tap) * p.cout + co) * p.cinp + ci
             : wp;
      cp_async(a + part * A_PART + (tap * BM + col) * LD + v * VE, src, 16,
               ok);
    }
  };
  // chunk kc's raw rows of x (and gamma, beta): in-image vectors only
  auto issue_x = [&](int kc) {
    const int c0 = kc * BK;
    T* xs = stage_x(kc);
    const int tables = spade ? 3 : 1;
    for (int t = 0; t < tables; ++t) {
      const T* src = t == 0 ? x : (t == 1 ? gam : bet);
      T* dst = xs + t * BK * L.plane + xdst;
      for (int ci_l = xslot; ci_l < BK; ci_l += cstep) {
        const int ci = c0 + ci_l;
        if (!xok || ci >= cin) continue;
        const T* g = src + xsrc + (size_t)ci * hw;
        if (p.xcopy)
          cp_async(dst + ci_l * L.plane, g, p.xcopy, true);
        else
          dst[ci_l * L.plane] = *g;
      }
    }
    if (FUSED && tid < p.nb * BK) {
      const int b = tid / BK, ci = c0 + tid % BK;
      if (b0 + b < p.n && ci < cin) {
        float* ss = stage_ss(kc);
        const size_t nc = (size_t)(b0 + b) * cin + ci;
        cp_async(ss + tid, p.scale + nc, 4, true);
        cp_async(ss + p.nb * BK + tid, p.shift + nc, 4, true);
      }
    }
  };

  // prologue (if any) once per staged element, rounded (bf16) or split
  // (fp32), transposed into the compute patch; 0 outside the image
  auto convert = [&](int kc) {
    const int c0 = kc * BK;
    const T* xs = stage_x(kc);
    const float* ss = stage_ss(kc);
    T* const bpatch = patch(kc);
#pragma unroll
    for (int k = 0; k < MAX_ITEMS; ++k) {
      if (coff[k] < 0) continue;
      if constexpr (!FUSED && !C::F32) {  // bf16 as it is: move the bits
        const unsigned short* raw =
            reinterpret_cast<const unsigned short*>(xs) + roff[k];
        uint32_t u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          u[j] = sidx[k] >= 0 && c0 + cil[k] + j < cin ? raw[j * L.plane] : 0u;
        *reinterpret_cast<uint2*>(bpatch + coff[k]) =
            make_uint2(u[0] | (u[1] << 16), u[2] | (u[3] << 16));
        continue;
      }
      float v[4], sc[4] = {}, sh[4] = {};
      if (FUSED && sidx[k] >= 0) {
        const float4 a = *reinterpret_cast<const float4*>(ss + sidx[k]);
        const float4 b = *reinterpret_cast<const float4*>(ss + p.nb * BK +
                                                          sidx[k]);
        sc[0] = a.x, sc[1] = a.y, sc[2] = a.z, sc[3] = a.w;
        sh[0] = b.x, sh[1] = b.y, sh[2] = b.z, sh[3] = b.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float val = 0.f;
        if (sidx[k] >= 0 && c0 + cil[k] + j < cin) {
          const int o = roff[k] + j * L.plane;
          val = frido::to_f32(xs[o]);
          if (FUSED) {
            val = fmaf(val, sc[j], sh[j]);
            if (spade)
              val = fmaf(val, 1.f + frido::to_f32(xs[BK * L.plane + o]),
                         frido::to_f32(xs[2 * BK * L.plane + o]));
            val = frido::to_f32(frido::from_f32<T>(silu_fast(val)));
          }
        }
        v[j] = val;
      }
      if constexpr (C::F32) {
        uint4 hi, lo;
        split_tf32(v[0], hi.x, lo.x);
        split_tf32(v[1], hi.y, lo.y);
        split_tf32(v[2], hi.z, lo.z);
        split_tf32(v[3], hi.w, lo.w);
        *reinterpret_cast<uint4*>(bpatch + coff[k]) = hi;
        *reinterpret_cast<uint4*>(bpatch + L.npix * LD + coff[k]) = lo;
      } else {
        *reinterpret_cast<uint2*>(bpatch + coff[k]) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
    }
  };

  // acc: the block's sums; part: one chunk's, which the tensor cores
  // accumulate (their fp32 adds truncate, an error that grows with the
  // number of terms), promoted into acc by rounding adds after each chunk
  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto multiply = [&](int kc) {
    const T* a = stage_a(kc);
    const T* bpatch = patch(kc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * L.pw + tap % 3;
      if constexpr (C::F32) {
        uint32_t ah[2][4], al[2][4], bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* pa = a + (tap * BM + arow + mt * 16) * LD + acol;
          ldsm_x4(ah[mt], pa);
          ldsm_x4(al[mt], pa + A_PART);
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          const T* pb = bpatch + (pbase[j] + shift) * LD + koff;
          ldsm_x4(bh[j], pb);
          ldsm_x4(bl[j], pb + L.npix * LD);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_3xtf32(part[mt][nt], ah[mt], al[mt],
                       &bh[nt >> 1][2 * (nt & 1)], &bl[nt >> 1][2 * (nt & 1)]);
      } else {
        uint32_t af[2][4], bf[NT / 2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(af[mt], a + (tap * BM + arow + mt * 16) * LD + acol);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          ldsm_x4(bf[j], bpatch + (pbase[j] + shift) * LD + koff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(part[mt][nt], af[mt], &bf[nt >> 1][2 * (nt & 1)]);
      }
    }
  };

  // software pipeline, one barrier a chunk: while chunk kc is multiplied,
  // chunk kc + 1's raw rows are converted into the other patch, and chunk
  // kc + 1's weights and chunk kc + 2's raw rows are in flight; each copy
  // has one chunk's work to land
  const int kc1 = kc0 + nk;
  issue_x(kc0);
  issue_a(kc0);
  if (kc0 + 1 < kc1) issue_x(kc0 + 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  convert(kc0);
  for (int kc = kc0; kc < kc1; ++kc) {
    cp_async_wait<0>();
    // chunk kc's weights and chunk kc + 1's raw rows landed, chunk kc's
    // patch is written; chunk kc - 1's weight slot and patch and chunk
    // kc's raw rows are free
    __syncthreads();
    if (kc + 1 < kc1) issue_a(kc + 1);
    if (kc + 2 < kc1) issue_x(kc + 2);
    cp_async_commit();
    if (kc + 1 < kc1) convert(kc + 1);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[a][j][e] = 0.f;
    multiply(kc);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][j][e] = __fadd_rn(acc[a][j][e], part[a][j][e]);
  }

  // store through shared memory: the fp32 tile [64][tpix] (c0 (co g,
  // pixel 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)), then rows of
  // consecutive pixels as 16-byte stores (bf16 outputs 8 at a time, fp32
  // outputs and split partials 4)
  constexpr int LDT = 32 * NT + 4;
  __syncthreads();  // every warp is done with the stages
  float* const tile = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[(wm * 32 + mt * 16 + g + 8 * (e >> 1)) * LDT + wn * 8 * NT +
               nt * 8 + 2 * t + (e & 1)] = acc[mt][nt][e];
  }
  __syncthreads();
  const size_t total = (size_t)p.n * p.cout * hw;
  T* y = static_cast<T*>(p.y);
  const T* bias = static_cast<const T*>(p.bias);
  const bool partial = p.split > 1;
  const int vec = partial ? 4 : VE;
  // vectors need whole runs inside a tile row and aligned rows in memory
  const bool vec_ok = p.tw % vec == 0 && w % vec == 0;
  const int run = vec_ok ? vec : 1;
  const int per_co = tpix / run;
  const SmallDiv by_per_co(per_co);
  for (int u = tid; u < BM * per_co; u += THREADS) {
    const int col = by_per_co(u), n0 = (u - col * per_co) * run;
    const int co = co0 + col;
    const int b = by_tile(n0), r = n0 - b * p.th * p.tw;
    const int yy = by_tw(r), xx = r - yy * p.tw;
    const int bi = b0 + b, gy = y0 + yy, gx = x0 + xx;
    if (co >= p.cout || bi >= p.n || gy >= h || gx >= w) continue;
    const size_t o = ((size_t)bi * p.cout + co) * hw + (size_t)gy * w + gx;
    const float* src = tile + col * LDT + n0;
    if (partial) {
      float* dst = p.ws + blockIdx.z * total + o;
      if (run == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0], src[1], src[2], src[3]);
      else
        *dst = src[0];
      continue;
    }
    const float bc = frido::to_f32(bias[co]);
    if (run == 1) {
      y[o] = frido::from_f32<T>(src[0] + bc);
    } else if constexpr (C::F32) {
      *reinterpret_cast<float4*>(y + o) =
          make_float4(src[0] + bc, src[1] + bc, src[2] + bc, src[3] + bc);
    } else {
      *reinterpret_cast<uint4*>(y + o) = make_uint4(
          pack_bf16(src[0] + bc, src[1] + bc),
          pack_bf16(src[2] + bc, src[3] + bc),
          pack_bf16(src[4] + bc, src[5] + bc),
          pack_bf16(src[6] + bc, src[7] + bc));
    }
  }
}

// [Cout, Cin, 3, 3] -> [PARTS][9][Cout][cinp], channels past Cin 0; fp32
// splits each weight once into tf32 hi and lo
template <typename T>
__global__ void __launch_bounds__(256)
pack_weight_kernel(const T* __restrict__ w, T* __restrict__ wp, int cout,
                   int cin, int cinp) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= cout * cinp) return;
  const int co = i / cinp, ci = i - co * cinp;
  const size_t part = (size_t)9 * cout * cinp;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const T v = ci < cin ? w[((size_t)co * cin + ci) * 9 + tap] : T(0.f);
    const size_t o = ((size_t)tap * cout + co) * cinp + ci;
    if constexpr (Cfg<T>::F32) {
      uint32_t hi, lo;
      split_tf32(frido::to_f32(v), hi, lo);
      reinterpret_cast<uint32_t*>(wp)[o] = hi;
      reinterpret_cast<uint32_t*>(wp)[part + o] = lo;
    } else {
      wp[o] = v;
    }
  }
}

// y = sum over splits, in split order, + bias, rounded once
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ bias,
                     T* __restrict__ y, int split, size_t total, int cout,
                     int hw) {
  for (size_t i = blockIdx.x * (size_t)256 + threadIdx.x; i < total;
       i += (size_t)gridDim.x * 256) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += ws[k * total + i];
    const int co = (int)((i / hw) % cout);
    y[i] = frido::from_f32<T>(s + frido::to_f32(bias[co]));
  }
}

// scale = rstd * w_c and shift = b_c - mean * scale for every (n, c)
template <typename T, bool VEC>
__global__ void __launch_bounds__(STATS_THREADS)
group_affine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ scale,
                    float* __restrict__ shift, int c, int groups, int hw,
                    float eps) {
  __shared__ float red[64];
  const int ng = blockIdx.x;  // n * groups + g
  const int cg = c / groups;
  const int count = cg * hw;
  const float2 st = frido::group_mean_rstd<T, STATS_THREADS, VEC>(
      x + (size_t)ng * count, count, eps, red);
  const int nc0 = ng * cg;              // n * c + g * cg
  const int c0 = (ng % groups) * cg;
  for (int i = threadIdx.x; i < cg; i += STATS_THREADS) {
    const float a = st.y * w[c0 + i];
    scale[nc0 + i] = a;
    shift[nc0 + i] = b[c0 + i] - st.x * a;
  }
}

// The plan the host computed (conv_plan), checked against this layout.
struct Plan {
  int nt, nb, th, tw, split, cps, xcopy, rs, smem;
};

template <typename T>
int check(const ConvParams& p, const Plan& q, bool fused, bool spade) {
  using C = Cfg<T>;
  const int isz = (int)sizeof(T);
  if (p.n <= 0 || p.cin <= 0 || p.h <= 0 || p.w <= 0 || p.cout <= 0 ||
      (long long)p.n * p.cin * p.h * p.w > 2147483647LL ||
      (long long)p.n * p.cout * p.h * p.w > 2147483647LL ||
      (long long)p.cout * p.cin * 9 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int nch = (p.cin + C::BK - 1) / C::BK;
  const int tiles_x = (p.w + q.tw - 1) / q.tw;
  const int tiles_y = (p.h + q.th - 1) / q.th;
  const int tiles_b = (p.n + q.nb - 1) / q.nb;
  const int vc = q.xcopy ? q.xcopy / isz : 1;
  const Layout L(isz, C::BK, C::LD, C::PARTS, q.nb, q.th, q.tw, q.rs,
                 q.xcopy, fused, spade);
  const bool bad =
      (q.nt != 2 && q.nt != 4 && q.nt != 8) || q.nb < 1 || q.th < 1 ||
      q.tw < 1 ||
      q.th > p.h || q.tw > p.w || q.nb > p.n ||
      q.nb * q.th * q.tw > 32 * q.nt ||
      (q.nb > 1 && (q.th != p.h || q.tw != p.w)) || q.split < 1 ||
      q.cps < 1 || (long long)q.split * q.cps < nch ||
      (q.split - 1) * q.cps >= nch || q.split > 65535 ||
      (q.split > 1) != (p.ws != nullptr) || p.wp == nullptr ||
      (q.xcopy != 0 && q.xcopy != 4 && q.xcopy != 8 && q.xcopy != 16) ||
      (q.xcopy != 0 && (q.xcopy < isz || (p.w * isz) % q.xcopy != 0 ||
                        (tiles_x > 1 && q.tw % vc != 0))) ||
      q.rs < L.nv * L.vc || (q.rs * isz) % 16 != 0 ||
      q.nb * L.ph * L.nv > THREADS || L.npix > max_patch(q.nt) ||
      L.npix * (C::BK / 4) > max_items(q.nt) * THREADS || q.smem != L.smem ||
      q.smem < BM * (32 * q.nt + 4) * 4 ||  // the output tile fits
      q.smem > MAX_SMEM ||
      (long long)tiles_x * tiles_y * tiles_b > 2147483647LL ||
      (p.cout + BM - 1) / BM > 65535 ||
      p.cinp != (p.cin + C::VE - 1) / C::VE * C::VE;
  return bad ? (int)cudaErrorInvalidValue : 0;
}

template <typename T, int NT, bool FUSED>
int launch_conv(ConvParams p, const Plan& q, cudaStream_t s) {
  static unsigned configured = 0;  // opt in to 227 KB once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(conv3x3_kernel<T, NT, FUSED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  p.tiles_x = (p.w + q.tw - 1) / q.tw;
  p.tiles_y = (p.h + q.th - 1) / q.th;
  const dim3 grid(p.tiles_x * p.tiles_y * ((p.n + q.nb - 1) / q.nb),
                  (p.cout + BM - 1) / BM, q.split);
  conv3x3_kernel<T, NT, FUSED><<<grid, THREADS, q.smem, s>>>(p);
  return (int)cudaGetLastError();
}

// pack, conv, reduce (split-K); x, w, bias, y already in p
template <typename T, bool FUSED>
int run(ConvParams p, const void* w, const Plan& q, cudaStream_t s) {
  p.nb = q.nb;
  p.th = q.th;
  p.tw = q.tw;
  p.split = q.split;
  p.cps = q.cps;
  p.xcopy = q.xcopy;
  p.rs = q.rs;
  const int packed = p.cout * p.cinp;
  pack_weight_kernel<T><<<(packed + 255) / 256, 256, 0, s>>>(
      static_cast<const T*>(w), static_cast<T*>(const_cast<void*>(p.wp)),
      p.cout, p.cin, p.cinp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = q.nt == 8   ? launch_conv<T, 8, FUSED>(p, q, s)
                 : q.nt == 4 ? launch_conv<T, 4, FUSED>(p, q, s)
                             : launch_conv<T, 2, FUSED>(p, q, s);
  if (rc != 0 || q.split == 1) return rc;
  const size_t total = (size_t)p.n * p.cout * p.h * p.w;
  const size_t blocks = (total + 255) / 256;
  splitk_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                            s>>>(p.ws, static_cast<const T*>(p.bias),
                                 static_cast<T*>(p.y), q.split, total, p.cout,
                                 p.h * p.w);
  return (int)cudaGetLastError();
}

template <typename T>
ConvParams params(const void* x, const void* wp, const void* b, void* y,
                  void* ws, int n, int cin, int h, int wd, int cout) {
  ConvParams p{};
  p.x = x;
  p.wp = wp;
  p.bias = b;
  p.y = y;
  p.ws = static_cast<float*>(ws);
  p.n = n;
  p.cin = cin;
  p.h = h;
  p.w = wd;
  p.cout = cout;
  p.cinp = (cin + Cfg<T>::VE - 1) / Cfg<T>::VE * Cfg<T>::VE;
  return p;
}

template <typename T>
int conv(const void* x, const void* w, const void* b, void* y, void* wp,
         void* ws, int n, int cin, int h, int wd, int cout, const Plan& q,
         void* stream) {
  const ConvParams p = params<T>(x, wp, b, y, ws, n, cin, h, wd, cout);
  if (int err = check<T>(p, q, false, false)) return err;
  return run<T, false>(p, w, q, (cudaStream_t)stream);
}

template <typename T>
int conv_norm_silu(const void* x, const void* w, const void* b,
                   const void* norm_w, const void* norm_b, const void* gamma,
                   const void* beta, void* scale, void* shift, void* y,
                   void* wp, void* ws, int n, int cin, int h, int wd,
                   int cout, int groups, float eps, const Plan& q,
                   void* stream) {
  ConvParams p = params<T>(x, wp, b, y, ws, n, cin, h, wd, cout);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.gamma = gamma;
  p.beta = beta;
  if (int err = check<T>(p, q, true, gamma != nullptr)) return err;
  if (groups <= 0 || cin % groups != 0 ||
      (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw = h * wd;
  const T* xt = static_cast<const T*>(x);
  const float* nw = static_cast<const float*>(norm_w);
  const float* nb = static_cast<const float*>(norm_b);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  if (((cin / groups) * hw) % 4 == 0)
    group_affine_kernel<T, true><<<n * groups, STATS_THREADS, 0, s>>>(
        xt, nw, nb, sc, sh, cin, groups, hw, eps);
  else
    group_affine_kernel<T, false><<<n * groups, STATS_THREADS, 0, s>>>(
        xt, nw, nb, sc, sh, cin, groups, hw, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return run<T, true>(p, w, q, s);
}

}  // namespace

#define FRIDO_PLAN_ARGS                                                    \
  int nt, int nb, int th, int tw, int split, int cps, int xcopy, int rs,    \
      int smem
#define FRIDO_PLAN Plan{nt, nb, th, tw, split, cps, xcopy, rs, smem}

extern "C" int frido_conv3x3_f32(const void* x, const void* w, const void* b,
                                 void* y, void* wp, void* ws, int n, int cin,
                                 int h, int wd, int cout, FRIDO_PLAN_ARGS,
                                 void* stream) {
  return conv<float>(x, w, b, y, wp, ws, n, cin, h, wd, cout, FRIDO_PLAN,
                     stream);
}

extern "C" int frido_conv3x3_bf16(const void* x, const void* w, const void* b,
                                  void* y, void* wp, void* ws, int n, int cin,
                                  int h, int wd, int cout, FRIDO_PLAN_ARGS,
                                  void* stream) {
  return conv<__nv_bfloat16>(x, w, b, y, wp, ws, n, cin, h, wd, cout,
                             FRIDO_PLAN, stream);
}

extern "C" int frido_conv3x3_norm_silu_f32(
    const void* x, const void* w, const void* b, const void* norm_w,
    const void* norm_b, const void* gamma, const void* beta, void* scale,
    void* shift, void* y, void* wp, void* ws, int n, int cin, int h, int wd,
    int cout, int groups, float eps, FRIDO_PLAN_ARGS, void* stream) {
  return conv_norm_silu<float>(x, w, b, norm_w, norm_b, gamma, beta, scale,
                               shift, y, wp, ws, n, cin, h, wd, cout, groups,
                               eps, FRIDO_PLAN, stream);
}

extern "C" int frido_conv3x3_norm_silu_bf16(
    const void* x, const void* w, const void* b, const void* norm_w,
    const void* norm_b, const void* gamma, const void* beta, void* scale,
    void* shift, void* y, void* wp, void* ws, int n, int cin, int h, int wd,
    int cout, int groups, float eps, FRIDO_PLAN_ARGS, void* stream) {
  return conv_norm_silu<__nv_bfloat16>(x, w, b, norm_w, norm_b, gamma, beta,
                                       scale, shift, y, wp, ws, n, cin, h, wd,
                                       cout, groups, eps, FRIDO_PLAN, stream);
}

extern "C" const char* frido_conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
