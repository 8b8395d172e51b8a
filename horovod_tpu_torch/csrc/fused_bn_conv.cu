// Fused BatchNorm-apply + ReLU + 1x1-conv + output stats for Hopper
// (sm_90a), in its two schedules, with a plain C interface loaded through
// ctypes (horovod_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Function (horovod_tpu/ops/fused_bn_conv.py): for x (M, Cin) bf16, the
// per-channel mu, var, gamma, beta (Cin,) f32 and w (Cin, Cout) bf16,
//   a  = relu((x - mu) * (rsqrt(var + eps) * gamma) + beta), in f32, cast to bf16
//   y  = a @ w, accumulated in f32, written as bf16 (M, Cout)
//   s1 = sum over rows of y, s2 = sum over rows of y*y, both from the f32
//        accumulator (not from the rounded y), (Cout,) f32.
// All arrays are contiguous and row-major; rows past M are masked. K3 takes
// Cin a multiple of 64 up to 512 and Cout a multiple of 8 (its tensor maps'
// 64-column boxes and 16-byte row strides); K4 takes Cin a multiple of 32 up
// to 512 and any Cout.
//
// Both kernels build the normalised row tile `a` in shared memory as x
// arrives, so the BN + ReLU prologue costs no extra pass over x, and take
// each column's partial sums over their rows in a fixed order. Partial sums
// land in an f32 workspace and a second small kernel reduces them over the
// partitions in a fixed order: no atomics, so s1 and s2 are bitwise equal
// from launch to launch.
//
// Bound on the H100, at the ResNet-50 path shape (stage 1 at B=256, 224^2:
// M = 200,704, Cin 128 -> Cout 512): 2*M*Cin*Cout = 26.3 GFLOP against
// 256.9 MB of x + y + w, about 100 operations a byte, so device-memory bound
// (floor ~0.077 ms at 3.35 TB/s), y being 80% of the bytes. K3 (Hopper:
// persistent blocks, TMA in and out, wgmma, stats from registers) is built
// for that bound; K4 (WMMA, synchronous loads, the accumulator through
// shared memory) is the simple first port of the second schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows per tile (K4)
constexpr int KC = 32;        // the k-step of K4's shape rule
constexpr int MAX_CIN = 512;
constexpr int K4_BN = 64;     // output columns per tile, w-stationary
constexpr int K4_TARGET_BLOCKS = 2 * 132;   // two blocks per SM of the H100

template <int BN>
struct Cfg {
  static constexpr int NW = 2 * (BN / 32);   // warps: 2 row halves x BN/32 column quarters
  static constexpr int NT = NW * 32;
  static constexpr int LDB = BN + 8;         // bf16 row stride of a w tile
  static constexpr int LDC = BN + 4;         // f32 row stride of the accumulator tile
};

struct Args {
  const bf16* x; const float* mu; const float* var; const float* gamma; const float* beta;
  const bf16* w;
  bf16* y;
  float* s;       // (2, Cout): s1 then s2
  float* ws;      // (2, parts, Cout) partial sums
  int M, Cin, Cout, parts, per;   // per: row tiles per partition (K4)
  float eps;
  int vec;        // Cout % 8 == 0: 16-byte loads of w and stores of y
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// mu, rsqrt(var + eps) * gamma and beta of every channel, once per block.
template <int NT>
__device__ __forceinline__ void load_params(float* mu_s, float* sc_s, float* be_s, const Args& a) {
  for (int c = threadIdx.x; c < a.Cin; c += NT) {
    mu_s[c] = a.mu[c];
    sc_s[c] = rsqrtf(a.var[c] + a.eps) * a.gamma[c];
    be_s[c] = a.beta[c];
  }
}

// Rows row0 .. row0+63 of x, normalised and ReLU'd in f32 as they are
// loaded, stored as bf16 into the shared tile A (ld Cin + 8). Rows past M
// are zeros. 16-byte loads, neighbouring threads on neighbouring chunks.
template <int NT>
__device__ __forceinline__ void load_norm_tile(bf16* A, const Args& a, int row0, const float* mu_s,
                                               const float* sc_s, const float* be_s) {
  const int cpr = a.Cin / 8, lda = a.Cin + 8;
  for (int i = threadIdx.x; i < BM * cpr; i += NT) {
    const int r = i / cpr, c8 = (i - r * cpr) * 8;
    const int row = row0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.M) {
      const uint4 v = *reinterpret_cast<const uint4*>(a.x + (long long)row * a.Cin + c8);
      const bf16* xv = reinterpret_cast<const bf16*>(&v);
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(xv[j]);
        ov[j] = __float2bfloat16(fmaxf((f - mu_s[c8 + j]) * sc_s[c8 + j] + be_s[c8 + j], 0.f));
      }
    }
    *reinterpret_cast<uint4*>(A + r * lda + c8) = out;
  }
}

// Rows k0 .. k0+nrows-1, columns n0 .. n0+BN-1 of w into the shared tile W
// (ld BN + 8); columns past Cout are zeros.
template <int BN>
__device__ __forceinline__ void load_w(bf16* W, const Args& a, int k0, int nrows, int n0) {
  constexpr int cpr = BN / 8;
  for (int i = threadIdx.x; i < nrows * cpr; i += Cfg<BN>::NT) {
    const int r = i / cpr, c8 = (i - r * cpr) * 8;
    const int col = n0 + c8;
    const bf16* src = a.w + (long long)(k0 + r) * a.Cout + col;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (a.vec) {
      if (col + 8 <= a.Cout) out = *reinterpret_cast<const uint4*>(src);
    } else {
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col + j < a.Cout) ov[j] = src[j];
    }
    *reinterpret_cast<uint4*>(W + r * Cfg<BN>::LDB + c8) = out;
  }
}

// acc (this warp's 32 x 32) += A[:, ka : ka + 16*ksteps] . W[kw : kw + 16*ksteps, :].
template <int BN>
__device__ __forceinline__ void mma_tile(FragC (&acc)[2][2], const bf16* A, int lda, int ka,
                                         const bf16* W, int kw, int ksteps) {
  const int warp = threadIdx.x >> 5;
  const int wr = warp / (BN / 32), wc = warp % (BN / 32);
  for (int kk = 0; kk < ksteps; ++kk) {
    FragA fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], A + (wr * 32 + i * 16) * lda + ka + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], W + (kw + kk * 16) * Cfg<BN>::LDB + wc * 32 + j * 16,
                             Cfg<BN>::LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Writes the tile's y (bf16) and returns, in threads below BN, the sums of
// column n0 + threadIdx.x over the tile's valid rows, rows in ascending
// order within each half and the two halves added last. C and red are
// shared scratch; the function ends with every thread past its last read.
template <int BN>
__device__ __forceinline__ void epilogue(FragC (&acc)[2][2], float* C, float* red, const Args& a,
                                         int row0, int n0, float& t1, float& t2) {
  constexpr int NT = Cfg<BN>::NT, LDC = Cfg<BN>::LDC;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / (BN / 32), wc = warp % (BN / 32);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(C + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  constexpr int cpr = BN / 8;
  for (int i = threadIdx.x; i < BM * cpr; i += NT) {
    const int r = i / cpr, c8 = (i - r * cpr) * 8;
    const int row = row0 + r, col = n0 + c8;
    if (row >= a.M) continue;
    const float* src = C + r * LDC + c8;
    bf16* dst = a.y + (long long)row * a.Cout + col;
    if (a.vec && col + 8 <= a.Cout) {
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(src[j]);
      *reinterpret_cast<uint4*>(dst) = out;
    } else {
      for (int j = 0; j < 8; ++j)
        if (col + j < a.Cout) dst[j] = __float2bfloat16(src[j]);
    }
  }

  // NT == 2 * BN: thread (half, col) sums rows half*32 .. half*32+31.
  const int col = threadIdx.x % BN, half = threadIdx.x / BN;
  float p1 = 0.f, p2 = 0.f;
  const int rows = min(BM / 2, a.M - row0 - half * (BM / 2));
  for (int r = 0; r < rows; ++r) {
    const float v = C[(half * (BM / 2) + r) * LDC + col];
    p1 += v;
    p2 += v * v;
  }
  red[half * BN + col] = p1;
  red[2 * BN + half * BN + col] = p2;
  __syncthreads();
  if (threadIdx.x < BN) {
    t1 = red[col] + red[BN + col];
    t2 = red[2 * BN + col] + red[3 * BN + col];
  }
  __syncthreads();
}

template <int BN>
constexpr size_t smem_common(int cin) {
  return 3 * cin * sizeof(float) + (size_t)BM * (cin + 8) * sizeof(bf16) +
         (size_t)BM * Cfg<BN>::LDC * sizeof(float) + 4 * BN * sizeof(float);
}
size_t k4_smem(int cin) { return smem_common<K4_BN>(cin) + (size_t)cin * Cfg<K4_BN>::LDB * sizeof(bf16); }

// Carves the dynamic shared memory: params, the normalised x tile A, the
// accumulator tile C, the column-sum scratch, then the w tile.
template <int BN>
struct Smem {
  float *mu, *sc, *be, *C, *red;
  bf16 *A, *W;
  __device__ Smem(unsigned char* base, int cin) {
    mu = reinterpret_cast<float*>(base);
    sc = mu + cin;
    be = sc + cin;
    A = reinterpret_cast<bf16*>(be + cin);
    C = reinterpret_cast<float*>(A + BM * (cin + 8));
    red = C + BM * Cfg<BN>::LDC;
    W = reinterpret_cast<bf16*>(red + 4 * BN);
  }
};

// ---------------------------------------------------------------------------
// K3, x-stationary, for Hopper. Replaces the Pallas kernel of
// horovod_tpu/ops/fused_bn_conv.py `fused_bn_relu_matmul(accum="scratch")`,
// whose grid runs the Cout blocks innermost so each x block is fetched once
// and the stats ride a VMEM scratch across the sequential grid.
//
// Persistent blocks, one per SM (at most one per row tile): block b takes
// the 128-row tiles b, b + G, b + 2G, ... in ascending order, a static
// assignment, so the stats are summed in the same order on every launch.
// Three warpgroups: one thread of the producer issues every TMA load; the
// two consumers own 64 rows of the tile each.
// * x is read once: the tile arrives by TMA (Cin/64 boxes of 128 rows x 64
//   columns, 128-byte swizzle, rows past M as zeros) into one of two buffers
//   (one at Cin 512), so the next tile's x loads while this one computes.
//   Each consumer normalises its 64 rows in place (channel of a 16-byte
//   chunk = chunk index XOR row % 8), writing zeros for rows past M, then
//   fences them over to the async proxy.
// * w streams through a ring of 64-row x 128-column chunks (two swizzled
//   64 x 64 boxes); both consumers read each chunk, so the block reads all
//   of w from L2 once per 128-row tile.
// * Each 128-column step is four m64n128k16 wgmma per chunk, A the
//   normalised tile (K-major), B the w chunk (MN-major, transpose bit).
// * The epilogue works on the f32 accumulator in registers: y is packed to
//   bf16 into a swizzled staging tile and leaves by TMA store, which runs on
//   while the next step's products do; the column sums of y and y*y are
//   folded over the 8 lanes that share a column (three shuffle steps, each
//   halving what a lane holds), then over the 4 warps in order through
//   shared memory, and added to the consumer's running sums: its own row of
//   the (2, 2G, Cout) workspace, read and written by the same thread.
// ---------------------------------------------------------------------------
namespace k3 {

constexpr int NT = 384;                 // producer warpgroup + two consumers
constexpr int BM = 128, WG_ROWS = 64;   // rows per tile, per consumer
constexpr int BN = 128;                 // output columns per step (m64n128)
constexpr int KCH = 64;                 // rows of w per ring stage
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BOX_BYTES = BM * 128;             // a 128 x 64 box of x
constexpr int STAGE_BYTES = KCH * BN * 2;       // a ring stage: two 64 x 64 boxes of w
constexpr int Y_BYTES = WG_ROWS * BN * 2;       // a consumer's y staging: two 64 x 64 boxes
constexpr int RED_FLOATS = 4 * 32 * 8;          // a consumer's per-warp partial sums
constexpr int MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448;                // the H100's per-block limit

// Byte offsets from the 1024-aligned base of the dynamic shared memory.
struct Layout {
  int nxb, stages, ring, ystage, red, params, bars, total;
};

__host__ __device__ inline Layout layout(int cin) {
  Layout L;
  L.nxb = cin <= 256 ? 2 : 1;
  const int xbytes = BM * cin * 2;
  const int fixed = L.nxb * xbytes + 2 * Y_BYTES + 2 * RED_FLOATS * 4 + 3 * cin * 4 +
                    8 * (4 + 2 * MAX_STAGES) + 1024;
  const int fit = (SMEM_MAX - fixed) / STAGE_BYTES;
  L.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  L.ring = L.nxb * xbytes;
  L.ystage = L.ring + L.stages * STAGE_BYTES;
  L.red = L.ystage + 2 * Y_BYTES;
  L.params = L.red + 2 * RED_FLOATS * 4;
  L.bars = L.params + 3 * cin * 4;
  L.total = L.bars + 8 * (4 + 2 * L.stages) + 1024;   // + slack for the alignment
  return L;
}

// Consumer c's 64 rows of the x tile at xt, normalised and ReLU'd in place
// (rows past M become zeros). 16-byte chunks, neighbouring threads on
// neighbouring chunks.
__device__ __forceinline__ void normalize_rows(unsigned char* xt, int c, int ct, int row0, int M,
                                               int nbox, const float* mu_s, const float* sc_s,
                                               const float* be_s) {
  for (int box = 0; box < nbox; ++box) {
    unsigned char* base = xt + box * BOX_BYTES + c * WG_ROWS * 128;
#pragma unroll
    for (int it = 0; it < WG_ROWS * 8 / 128; ++it) {
      const int q = it * 128 + ct, r = q >> 3, p = q & 7;
      uint4* ptr = reinterpret_cast<uint4*>(base + r * 128 + p * 16);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + c * WG_ROWS + r < M) {
        const uint4 v = *ptr;
        const int ch = box * 64 + ((p ^ (r & 7)) << 3);
        const bf16* xv = reinterpret_cast<const bf16*>(&v);
        bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = __bfloat162float(xv[e]);
          ov[e] = __float2bfloat16(fmaxf((f - mu_s[ch + e]) * sc_s[ch + e] + be_s[ch + e], 0.f));
        }
      }
      *ptr = out;
    }
  }
}

// One step of the column-sum fold: a lane keeps half of its 2*HALF values
// (the upper half where `upper`) and adds the partner lane's copy of it.
template <int HALF>
__device__ __forceinline__ void fold(float (&v)[64], bool upper, int mask) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

}  // namespace k3

__global__ void __launch_bounds__(k3::NT, 1)
    fused_bn_conv_scratch_kernel(const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_w,
                                 const __grid_constant__ CUtensorMap tm_y, const Args a) {
  using namespace sm90;
  using k3::BM, k3::BN, k3::KCH, k3::WG_ROWS, k3::BOX_BYTES, k3::STAGE_BYTES, k3::Y_BYTES;
  using k3::RED_FLOATS, k3::Layout, k3::layout, k3::fold;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Layout L = layout(a.Cin);
  unsigned char* ring = smem + L.ring;
  float* mu_s = reinterpret_cast<float*>(smem + L.params);
  float* sc_s = mu_s + a.Cin;
  float* be_s = sc_s + a.Cin;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* x_empty = x_full + 2;
  uint64_t* w_full = x_empty + 2;
  uint64_t* w_empty = w_full + L.stages;

  const int G = gridDim.x;
  const int my_tiles = (cdiv(a.M, BM) - (int)blockIdx.x + G - 1) / G;
  const int nsteps = cdiv(a.Cout, BN), kch = a.Cin / KCH;
  const int xbytes = BM * a.Cin * 2;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&x_full[b], 1);
      mbar_init(&x_empty[b], 2 * 4);   // one arrival per consumer warp
    }
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 2 * 4);
    }
    fence_barrier_init();
  }
  load_params<k3::NT>(mu_s, sc_s, be_s, a);
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<k3::PRODUCER_REGS>();
    const CUtensorMap* x_map = &tm_x;
    if (threadIdx.x == 0) {
      // The x tile of this block's i-th tile, into buffer i % nxb once the
      // consumers have released it.
      const auto load_x = [=](int i) {
        const int b = i % L.nxb;
        mbar_wait(&x_empty[b], ((i / L.nxb) & 1) ^ 1);
        mbar_arrive_expect_tx(&x_full[b], xbytes);
        const int row0 = ((int)blockIdx.x + i * G) * BM;
        for (int j = 0; j < kch; ++j)
          tma_load_2d(smem + b * xbytes + j * BOX_BYTES, x_map, &x_full[b], j * 64, row0);
      };
      // With two x buffers the next tile's x is asked for once the ring has
      // been refilled for this tile (by then the tile before has released
      // its buffer); with one, after this tile's last chunk.
      const int nq = nsteps * kch;
      const int prefetch_at = (L.stages < nq ? L.stages : nq) - 1;
      int slot = 0;
      uint32_t phase = 0;
      load_x(0);
      for (int i = 0; i < my_tiles; ++i) {
        const bool next = i + 1 < my_tiles;
        for (int q = 0; q < nq; ++q) {
          const int n0 = (q / kch) * BN, k0 = (q % kch) * KCH;
          mbar_wait(&w_empty[slot], phase ^ 1);
          mbar_arrive_expect_tx(&w_full[slot], STAGE_BYTES);
          unsigned char* dst = ring + slot * STAGE_BYTES;
          tma_load_2d(dst, &tm_w, &w_full[slot], n0, k0);
          tma_load_2d(dst + STAGE_BYTES / 2, &tm_w, &w_full[slot], n0 + 64, k0);
          if (++slot == L.stages) {
            slot = 0;
            phase ^= 1;
          }
          if (next && L.nxb == 2 && q == prefetch_at) load_x(i + 1);
        }
        if (next && L.nxb == 1) load_x(i + 1);
      }
    }
  } else {
    setmaxnreg_inc<k3::CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1, ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, t = lane % 4;
    const int r_lo = warp * 16 + lane / 4;   // this thread's rows of the 64: r_lo, r_lo + 8
    unsigned char* ys = smem + L.ystage + c * Y_BYTES;
    float* red = reinterpret_cast<float*>(smem + L.red) + c * RED_FLOATS;
    const int part = 2 * (int)blockIdx.x + c;
    float* ws1 = a.ws + (long long)part * a.Cout;
    float* ws2 = a.ws + ((long long)a.parts + part) * a.Cout;
    const int bar = 1 + c;   // this consumer's named barrier
    // The lane (q = 0; q = 1 is 4 lanes up) and the slot within it that
    // hold column ct's sums after the fold.
    const int fn = ct >> 3;
    const int f_lane = ((ct >> 1) & 3) + 8 * (fn >> 3) + 16 * ((fn >> 2) & 1);
    const int f_slot = 2 * (fn & 3) + (ct & 1);
    int slot = 0;
    uint32_t phase = 0;

    for (int i = 0; i < my_tiles; ++i) {
      const int tile = (int)blockIdx.x + i * G;
      const int b = i % L.nxb;
      unsigned char* xt = smem + b * xbytes;
      mbar_wait(&x_full[b], (i / L.nxb) & 1);
      k3::normalize_rows(xt, c, ct, tile * BM, a.M, kch, mu_s, sc_s, be_s);
      fence_proxy_async();
      named_bar_sync(bar, 128);

      for (int nb = 0; nb < nsteps; ++nb) {
        const int n0 = nb * BN, col = n0 + ct;
        const bool col_ok = col < a.Cout;
        const float prev1 = i > 0 && col_ok ? ws1[col] : 0.f;
        const float prev2 = i > 0 && col_ok ? ws2[col] : 0.f;

        float acc[64];
        int held = 0;
        wgmma_fence();
        for (int kc = 0; kc < kch; ++kc) {
          mbar_wait(&w_full[slot], phase);
          const unsigned char* wt = ring + slot * STAGE_BYTES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128<1>(acc, desc_kmajor(xt, BM, c * WG_ROWS, 4 * kc + kk),
                             desc_mnmajor(wt, KCH, kk), kc > 0 || kk > 0);
          wgmma_commit();
          if (kc > 0) {   // the chunk before is read: hand its stage back
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) mbar_arrive(&w_empty[held]);
          }
          held = slot;
          if (++slot == L.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&w_empty[held]);
          if (nb == nsteps - 1) mbar_arrive(&x_empty[b]);
        }

        // The staging tile has been read out by the last step's store, and
        // every thread is past its reads of `red`.
        if (ct == 0) bulk_wait_read<0>();
        named_bar_sync(bar, 128);

        // y: rows r_lo + 8i, columns 8n + 2t, +1 as a bf16 pair, at chunk
        // (n % 8) XOR (row % 8) of the 128-byte row of box n / 8.
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int r = r_lo + 8 * i2;
            unsigned char* dst =
                ys + (n / 8) * (WG_ROWS * 128) + r * 128 + (((n % 8) ^ (r % 8)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * n + 2 * i2], acc[4 * n + 2 * i2 + 1]);
          }

        // Column sums over this thread's two rows (slots 2n + j: s1 in
        // 0..31, s2 in 32..63), folded over lane bits 2, 3, 4: lane l ends
        // with the sums of its warp's 16 rows for q = bit 2 and columns
        // 8n + 2(l % 4) + j, n = 8 bit3 + 4 bit4 + m, in slot 2m + j.
        float v[64];
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float y0 = acc[4 * n + j], y1 = acc[4 * n + 2 + j];
            v[2 * n + j] = y0 + y1;
            v[32 + 2 * n + j] = y0 * y0 + y1 * y1;
          }
        fold<32>(v, lane & 4, 4);
        fold<16>(v, lane & 8, 8);
        fold<8>(v, lane & 16, 16);
        float4* rd = reinterpret_cast<float4*>(red + warp * 256 + lane * 8);
        rd[0] = make_float4(v[0], v[1], v[2], v[3]);
        rd[1] = make_float4(v[4], v[5], v[6], v[7]);

        fence_proxy_async();
        named_bar_sync(bar, 128);
        if (ct == 0) {
          const int row0 = tile * BM + c * WG_ROWS;
          if (row0 < a.M) {
            tma_store_2d(&tm_y, ys, n0, row0);
            if (n0 + 64 < a.Cout) tma_store_2d(&tm_y, ys + WG_ROWS * 128, n0 + 64, row0);
          }
          bulk_commit();
        }
        if (col_ok) {
          float t1 = 0.f, t2 = 0.f;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            t1 += red[w * 256 + f_lane * 8 + f_slot];
            t2 += red[w * 256 + (f_lane + 4) * 8 + f_slot];
          }
          ws1[col] = prev1 + t1;
          ws2[col] = prev2 + t2;
        }
      }
    }
    if (ct == 0) bulk_wait_read<0>();
  }
}

// ---------------------------------------------------------------------------
// K4, w-stationary. Replaces the Pallas kernel of
// `fused_bn_relu_matmul(accum="revisit")`, whose grid runs the row blocks
// innermost and accumulates the stats in the revisited (1, block_n) output
// block, re-reading x once per Cout block.
//
// Here one block holds one 64-column tile of w (all Cin rows) in shared
// memory and walks its partition of the row tiles in ascending order,
// normalising each x tile as it loads it; the column sums accumulate in
// registers across the walk. x is re-read once per Cout tile, the price of
// this schedule. M is split into `parts` partitions so that about two blocks
// run on each SM; the reduce kernel sums the partitions in a fixed order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(Cfg<K4_BN>::NT) fused_bn_conv_revisit_kernel(Args a) {
  constexpr int BN = K4_BN;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<BN> s(smem, a.Cin);
  const int n0 = blockIdx.x * BN, part = blockIdx.y;
  const int lda = a.Cin + 8;
  const int t0 = part * a.per, t1 = min(cdiv(a.M, BM), t0 + a.per);

  load_params<Cfg<BN>::NT>(s.mu, s.sc, s.be, a);
  load_w<BN>(s.W, a, 0, a.Cin, n0);
  __syncthreads();

  float acc1 = 0.f, acc2 = 0.f;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();   // every warp is done with the previous A tile
    load_norm_tile<Cfg<BN>::NT>(s.A, a, t * BM, s.mu, s.sc, s.be);
    __syncthreads();
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    mma_tile<BN>(acc, s.A, lda, 0, s.W, 0, a.Cin / 16);
    float p1 = 0.f, p2 = 0.f;
    epilogue<BN>(acc, s.C, s.red, a, t * BM, n0, p1, p2);
    acc1 += p1;
    acc2 += p2;
  }
  const int col = n0 + threadIdx.x;
  if (threadIdx.x < BN && col < a.Cout) {
    a.ws[(long long)part * a.Cout + col] = acc1;
    a.ws[((long long)a.parts + part) * a.Cout + col] = acc2;
  }
}

// s[q][c] = sum over p of ws[q][p][c], p in a fixed order: thread (tx, ty)
// sums partitions ty, ty+32, ... of column c, then ty = 0 adds the 32
// partial sums in order.
__global__ void __launch_bounds__(1024) stats_reduce_kernel(Args a) {
  __shared__ float sm[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y, q = blockIdx.y;
  const int col = blockIdx.x * 32 + tx;
  const float* src = a.ws + (long long)q * a.parts * a.Cout;
  float acc = 0.f;
  if (col < a.Cout)
    for (int p = ty; p < a.parts; p += 32) acc += src[(long long)p * a.Cout + col];
  sm[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < a.Cout) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += sm[i][tx];
    a.s[q * a.Cout + col] = t;
  }
}

// Error codes of the entry points besides cudaError_t values.
constexpr int ERR_SHAPE = -1;         // a shape the kernel does not take
constexpr int ERR_NO_ENCODER = -2;    // cuTensorMapEncodeTiled is not available
constexpr int ERR_TENSOR_MAP = -3;    // cuTensorMapEncodeTiled refused a tensor map

// K3's blocks: one per SM, at most one per row tile. Each block's two
// consumers own a partition of the workspace.
int k3_grid(int M) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::min(cdiv(M, k3::BM), sms);
}

bool k3_shape_ok(int M, int Cin, int Cout) {
  return M > 0 && Cin > 0 && Cin % k3::KCH == 0 && Cin <= MAX_CIN && Cout > 0 && Cout % 8 == 0;
}

// A row-major (rows, cols) bf16 array in boxes of box_rows x 64 columns with
// the 128-byte swizzle; elements past the edges read as zeros and are not
// written.
int map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Partitions of the row tiles for K4, and the row tiles in each: enough
// blocks to give each SM about two, no partition empty.
void k4_split(int M, int Cout, int* parts, int* per) {
  const int tiles = cdiv(M, BM), ncol = cdiv(Cout, K4_BN);
  int p = std::min(tiles, std::max(1, cdiv(K4_TARGET_BLOCKS, ncol)));
  *per = cdiv(tiles, p);
  *parts = cdiv(tiles, *per);
}

Args make_args(const void* x, const void* mu, const void* var, const void* gamma,
               const void* beta, const void* w, void* y, void* s, void* ws, int M, int Cin,
               int Cout, float eps) {
  Args a = {};
  a.x = (const bf16*)x; a.mu = (const float*)mu; a.var = (const float*)var;
  a.gamma = (const float*)gamma; a.beta = (const float*)beta; a.w = (const bf16*)w;
  a.y = (bf16*)y; a.s = (float*)s; a.ws = (float*)ws;
  a.M = M; a.Cin = Cin; a.Cout = Cout; a.eps = eps;
  a.vec = Cout % 8 == 0;
  return a;
}

bool shape_ok(int M, int Cin, int Cout) {
  return M > 0 && Cout > 0 && Cin > 0 && Cin % KC == 0 && Cin <= MAX_CIN;
}

// Above 48 KB a block's shared memory must be opted into once per kernel;
// `ready` remembers that it was, for the largest Cin.
template <typename K, typename... Maps>
int launch(K kernel, size_t max_smem, size_t smem, dim3 grid, int nt, const Args& a,
           cudaStream_t stream, bool& ready, const Maps&... maps) {
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<grid, nt, smem, stream>>>(maps..., a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<dim3(cdiv(a.Cout, 32), 2), dim3(32, 32), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int k3_launch(const void* x, const void* mu, const void* var, const void* gamma,
              const void* beta, const void* w, void* y, void* s, void* ws, int M, int Cin,
              int Cout, float eps, void* stream) {
  if (!k3_shape_ok(M, Cin, Cout)) return ERR_SHAPE;
  Args a = make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps);
  const int grid = k3_grid(M);
  a.parts = 2 * grid;
  CUtensorMap mx, mw, my;
  int err;
  if ((err = map_2d(&mx, x, M, Cin, k3::BM)) || (err = map_2d(&mw, w, Cin, Cout, k3::KCH)) ||
      (err = map_2d(&my, y, M, Cout, k3::WG_ROWS)))
    return err;
  static bool ready = false;
  return launch(fused_bn_conv_scratch_kernel, k3::SMEM_MAX, k3::layout(Cin).total, dim3(grid),
                k3::NT, a, (cudaStream_t)stream, ready, mx, mw, my);
}

}  // namespace

// Partitions of the workspace each entry point needs: ws is (2, parts, Cout) f32.
extern "C" int hvd_fused_bn_conv_scratch_parts(int M, int Cout) { return 2 * k3_grid(M); }

extern "C" int hvd_fused_bn_conv_revisit_parts(int M, int Cout) {
  int parts, per;
  k4_split(M, Cout, &parts, &per);
  return parts;
}

// Each entry point launches its kernel and the stats reduction on the given
// stream and returns cudaGetLastError() (0 on success), ERR_SHAPE for a
// shape the kernel does not take, or a tensor-map error code (K3).
extern "C" int hvd_fused_bn_conv_scratch(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  return k3_launch(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps, stream);
}

extern "C" int hvd_fused_bn_conv_revisit(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  if (!shape_ok(M, Cin, Cout)) return ERR_SHAPE;
  Args a = make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps);
  k4_split(M, Cout, &a.parts, &a.per);
  static bool ready = false;
  return launch(fused_bn_conv_revisit_kernel, k4_smem(MAX_CIN), k4_smem(Cin),
                dim3(cdiv(Cout, K4_BN), a.parts), Cfg<K4_BN>::NT, a, (cudaStream_t)stream,
                ready);
}
