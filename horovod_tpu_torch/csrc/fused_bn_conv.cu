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
// All arrays are contiguous and row-major; rows past M are masked. Both
// kernels take Cin a multiple of 64 up to 512 and Cout a multiple of 8 (their
// tensor maps' 64-column boxes and 16-byte row strides).
//
// Both kernels normalise x in shared memory as it arrives, so the BN + ReLU
// prologue costs no extra pass over x, and take each column's partial sums
// over their rows in a fixed order. Partial sums land in an f32 workspace
// and a second small kernel reduces them over the partitions in a fixed
// order: no atomics, so s1 and s2 are bitwise equal from launch to launch.
//
// Bound on the H100, at the ResNet-50 path shape (stage 1 at B=256, 224^2:
// M = 200,704, Cin 128 -> Cout 512): 2*M*Cin*Cout = 26.3 GFLOP against
// 256.9 MB of x + y + w, about 100 operations a byte, so device-memory bound
// (floor ~0.077 ms at 3.35 TB/s), y being 80% of the bytes. Both kernels are
// built for that bound: persistent blocks, TMA in and out, wgmma, stats from
// the accumulator registers. K4's schedule reads x once per 128-column tile
// of w; it leans on L2 to keep that re-read off device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_CIN = 512;

struct Args {
  const bf16* x; const float* mu; const float* var; const float* gamma; const float* beta;
  const bf16* w;
  bf16* y;
  float* s;       // (2, Cout): s1 then s2
  float* ws;      // (2, parts, Cout) partial sums
  int M, Cin, Cout, parts;
  float eps;
};

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

// Consumer c's 64 rows of the nbox 128 x 64 boxes of x at xt, the first
// holding channels ch0 .. ch0 + 63, normalised and ReLU'd in place (rows past
// M become zeros). Thread ct takes 16-byte chunk ct % 8 of rows ct / 8 + 16i
// (neighbouring threads on neighbouring chunks); under the swizzle those are
// the same 8 channels of a box, so their parameters are read once a box.
__device__ __forceinline__ void normalize_rows(unsigned char* xt, int c, int ct, int row0, int M,
                                               int nbox, int ch0, const float* mu_s,
                                               const float* sc_s, const float* be_s) {
  const int r0 = ct >> 3, p = ct & 7;
  const int rows = M - row0 - c * WG_ROWS;   // rows of the consumer's 64 that are in x
  for (int box = 0; box < nbox; ++box) {
    unsigned char* base = xt + box * BOX_BYTES + c * WG_ROWS * 128 + r0 * 128 + p * 16;
    const int ch = ch0 + box * 64 + ((p ^ (r0 & 7)) << 3);
    float mu[8], sc[8], be[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(mu + 4 * h) = reinterpret_cast<const float4*>(mu_s + ch)[h];
      *reinterpret_cast<float4*>(sc + 4 * h) = reinterpret_cast<const float4*>(sc_s + ch)[h];
      *reinterpret_cast<float4*>(be + 4 * h) = reinterpret_cast<const float4*>(be_s + ch)[h];
    }
#pragma unroll
    for (int it = 0; it < WG_ROWS / 16; ++it) {
      uint4* ptr = reinterpret_cast<uint4*>(base + it * 16 * 128);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + 16 * it < rows) {
        const uint4 v = *ptr;
        const bf16* xv = reinterpret_cast<const bf16*>(&v);
        bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = __bfloat162float(xv[e]);
          ov[e] = __float2bfloat16(fmaxf((f - mu[e]) * sc[e] + be[e], 0.f));
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

// The column sums of y and y*y over this thread's two rows of an m64n128
// accumulator, in slots 2n + j (s1) and 32 + 2n + j (s2) for columns
// 8n + 2t + j: written to v, or added to it where ACCUMULATE.
template <bool ACCUMULATE>
__device__ __forceinline__ void row_sums(const float (&acc)[64], float (&v)[64]) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float y0 = acc[4 * n + j], y1 = acc[4 * n + 2 + j];
      const float s1 = y0 + y1, s2 = y0 * y0 + y1 * y1;
      if constexpr (ACCUMULATE) {
        v[2 * n + j] += s1;
        v[32 + 2 * n + j] += s2;
      } else {
        v[2 * n + j] = s1;
        v[32 + 2 * n + j] = s2;
      }
    }
}

// row_sums' v folded over lane bits 2, 3, 4: lane l ends with the sums of
// its warp's rows for q = bit 2 and columns 8n + 2(l % 4) + j, n = 8 bit3 +
// 4 bit4 + m, in slot 2m + j, which it writes to the consumer's `red` for
// warp_sums.
__device__ __forceinline__ void fold_sums(float (&v)[64], float* red, int ct) {
  const int warp = ct / 32, lane = ct % 32;
  fold<32>(v, lane & 4, 4);
  fold<16>(v, lane & 8, 8);
  fold<8>(v, lane & 16, 16);
  float4* rd = reinterpret_cast<float4*>(red + warp * 256 + lane * 8);
  rd[0] = make_float4(v[0], v[1], v[2], v[3]);
  rd[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The epilogue of one m64n128 step of consumer c (thread ct of its 128,
// named barrier `bar`) on the f32 accumulator in registers. y is packed to
// bf16 into the consumer's swizzled staging tile ys (rows r_lo + 8i, columns
// 8n + 2t, +1 as a bf16 pair, at chunk (n % 8) XOR (row % 8) of the 128-byte
// row of box n / 8) and leaves by TMA store to rows row0.., columns n0..
// (what lies past M or Cout is not written), which runs on while the next
// step's products do. `sums()` takes the step's column sums meanwhile.
template <typename Sums>
__device__ __forceinline__ void epilogue(const float (&acc)[64], unsigned char* ys,
                                         const CUtensorMap* tm_y, int bar, int ct, int row0,
                                         int n0, int M, int Cout, Sums sums) {
  using namespace sm90;
  const int warp = ct / 32, lane = ct % 32, t = lane % 4;
  const int r_lo = warp * 16 + lane / 4;   // this thread's rows of the 64: r_lo, r_lo + 8

  // The staging tile has been read out by the last step's store, and every
  // thread is past its reads of the last step's sums.
  if (ct == 0) bulk_wait_read<0>();
  named_bar_sync(bar, 128);

#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = r_lo + 8 * i2;
      unsigned char* dst =
          ys + (n / 8) * (WG_ROWS * 128) + r * 128 + (((n % 8) ^ (r % 8)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * n + 2 * i2], acc[4 * n + 2 * i2 + 1]);
    }
  sums();

  fence_proxy_async();
  named_bar_sync(bar, 128);
  if (ct == 0) {
    if (row0 < M) {
      tma_store_2d(tm_y, ys, n0, row0);
      if (n0 + 64 < Cout) tma_store_2d(tm_y, ys + WG_ROWS * 128, n0 + 64, row0);
    }
    bulk_commit();
  }
}

// Column ct's sums over the consumer's 64 rows from `red`, the 4 warps in
// order. The lane (q = 0; q = 1 is 4 lanes up) and the slot within it that
// hold the column's sums after the fold:
__device__ __forceinline__ void warp_sums(const float* red, int ct, float& t1, float& t2) {
  const int fn = ct >> 3;
  const int f_lane = ((ct >> 1) & 3) + 8 * (fn >> 3) + 16 * ((fn >> 2) & 1);
  const int f_slot = 2 * (fn & 3) + (ct & 1);
  t1 = 0.f;
  t2 = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    t1 += red[w * 256 + f_lane * 8 + f_slot];
    t2 += red[w * 256 + (f_lane + 4) * 8 + f_slot];
  }
}

}  // namespace k3

__global__ void __launch_bounds__(k3::NT, 1)
    fused_bn_conv_scratch_kernel(const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_w,
                                 const __grid_constant__ CUtensorMap tm_y, const Args a) {
  using namespace sm90;
  using k3::BM, k3::BN, k3::KCH, k3::WG_ROWS, k3::BOX_BYTES, k3::STAGE_BYTES, k3::Y_BYTES;
  using k3::RED_FLOATS, k3::Layout, k3::layout;
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
    const int lane = ct % 32;
    unsigned char* ys = smem + L.ystage + c * Y_BYTES;
    float* red = reinterpret_cast<float*>(smem + L.red) + c * RED_FLOATS;
    const int part = 2 * (int)blockIdx.x + c;
    float* ws1 = a.ws + (long long)part * a.Cout;
    float* ws2 = a.ws + ((long long)a.parts + part) * a.Cout;
    const int bar = 1 + c;   // this consumer's named barrier
    int slot = 0;
    uint32_t phase = 0;

    for (int i = 0; i < my_tiles; ++i) {
      const int tile = (int)blockIdx.x + i * G;
      const int b = i % L.nxb;
      unsigned char* xt = smem + b * xbytes;
      mbar_wait(&x_full[b], (i / L.nxb) & 1);
      k3::normalize_rows(xt, c, ct, tile * BM, a.M, kch, 0, mu_s, sc_s, be_s);
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

        k3::epilogue(acc, ys, &tm_y, bar, ct, tile * BM + c * WG_ROWS, n0, a.M, a.Cout, [&] {
          float v[64];
          k3::row_sums<false>(acc, v);
          k3::fold_sums(v, red, ct);
        });
        if (col_ok) {
          float t1, t2;
          k3::warp_sums(red, ct, t1, t2);
          ws1[col] = prev1 + t1;
          ws2[col] = prev2 + t2;
        }
      }
    }
    if (ct == 0) bulk_wait_read<0>();
  }
}

// ---------------------------------------------------------------------------
// K4, w-stationary, for Hopper. Replaces the Pallas kernel of
// `fused_bn_relu_matmul(accum="revisit")`, whose grid runs the row blocks
// innermost and accumulates the stats in the revisited (1, block_n) output
// block, re-reading x once per Cout block.
//
// Persistent blocks, at most one per SM: block b holds the 128-column tile
// j = b % ncol of w (all Cin rows) and walks the row partition p = b / ncol,
// a contiguous range of 128-row tiles, in ascending order, so the stats are
// summed in the same order on every launch. The same three warpgroups, the
// same products and the same y epilogue as K3, with the roles of x and w
// swapped:
// * w arrives once, by TMA, as Cin/64 chunks of 64 rows x 128 columns (two
//   swizzled 64 x 64 boxes each) and stays.
// * x streams through a ring of 128 x 64 boxes, one k-chunk of a row tile a
//   stage; each consumer normalises its 64 rows of the chunk in place
//   (zeros past M), fences them to the async proxy and runs four
//   m64n128k16 wgmma on it, then hands the stage back. The ring, not a whole
//   x tile, is what lets one schedule hold a w tile of every Cin up to 512.
// * y leaves by TMA store from the consumer's staging tile. A block's
//   columns never change, so each thread adds its two rows' column sums of
//   every tile to 64 running sums in registers; they are folded over the
//   lanes and the warps once, after the walk, and written once, to the
//   consumer's own row of the (2, 2P, Cout) workspace. The per-tile
//   epilogue is then y alone.
// x is read once per Cout tile, the price of this schedule. The ncol blocks
// of a partition are neighbours in blockIdx, all resident, walking the same
// row tiles at the same pace, so all but the first read of an x tile can
// come from L2 rather than device memory.
// ---------------------------------------------------------------------------
namespace k4 {

constexpr int MAX_STAGES = 6;
constexpr int CHUNK_BYTES = k3::KCH * k3::BN * 2;   // 64 rows of the w tile

// Byte offsets from the 1024-aligned base of the dynamic shared memory; the
// w tile is at 0.
struct Layout {
  int stages, ring, ystage, red, params, bars, total;
};

__host__ __device__ inline Layout layout(int cin) {
  using namespace k3;
  Layout L;
  const int wbytes = cin / KCH * CHUNK_BYTES;
  const int fixed = wbytes + 2 * Y_BYTES + 2 * RED_FLOATS * 4 + 3 * cin * 4 +
                    8 * (1 + 2 * MAX_STAGES) + 1024;
  const int fit = (SMEM_MAX - fixed) / BOX_BYTES;
  L.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  L.ring = wbytes;
  L.ystage = L.ring + L.stages * BOX_BYTES;
  L.red = L.ystage + 2 * Y_BYTES;
  L.params = L.red + 2 * RED_FLOATS * 4;
  L.bars = L.params + 3 * cin * 4;
  L.total = L.bars + 8 * (1 + 2 * L.stages) + 1024;   // + slack for the alignment
  return L;
}

}  // namespace k4

__global__ void __launch_bounds__(k3::NT, 1)
    fused_bn_conv_revisit_kernel(const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_w,
                                 const __grid_constant__ CUtensorMap tm_y, const Args a) {
  using namespace sm90;
  using k3::BM, k3::BN, k3::KCH, k3::WG_ROWS, k3::BOX_BYTES, k3::Y_BYTES, k3::RED_FLOATS;
  using k4::CHUNK_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const k4::Layout L = k4::layout(a.Cin);
  unsigned char* ring = smem + L.ring;
  float* mu_s = reinterpret_cast<float*>(smem + L.params);
  float* sc_s = mu_s + a.Cin;
  float* be_s = sc_s + a.Cin;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* x_full = w_full + 1;
  uint64_t* x_empty = x_full + L.stages;

  const int ncol = cdiv(a.Cout, BN), nparts = gridDim.x / ncol;
  const int n0 = ((int)blockIdx.x % ncol) * BN, p = (int)blockIdx.x / ncol;
  const long long tiles = cdiv(a.M, BM);
  const int t0 = (int)(p * tiles / nparts), t1 = (int)((p + 1) * tiles / nparts);
  const int kch = a.Cin / KCH;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], 2 * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  load_params<k3::NT>(mu_s, sc_s, be_s, a);
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<k3::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(w_full, kch * CHUNK_BYTES);
      for (int kc = 0; kc < kch; ++kc) {
        unsigned char* dst = smem + kc * CHUNK_BYTES;
        tma_load_2d(dst, &tm_w, w_full, n0, kc * KCH);
        tma_load_2d(dst + CHUNK_BYTES / 2, &tm_w, w_full, n0 + 64, kc * KCH);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t)
        for (int kc = 0; kc < kch; ++kc) {
          mbar_wait(&x_empty[slot], phase ^ 1);
          mbar_arrive_expect_tx(&x_full[slot], BOX_BYTES);
          tma_load_2d(ring + slot * BOX_BYTES, &tm_x, &x_full[slot], kc * KCH, t * BM);
          if (++slot == L.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    setmaxnreg_inc<k3::CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1, ct = threadIdx.x % 128;
    const int lane = ct % 32;
    unsigned char* ys = smem + L.ystage + c * Y_BYTES;
    float* red = reinterpret_cast<float*>(smem + L.red) + c * RED_FLOATS;
    const int bar = 1 + c;   // this consumer's named barrier
    float sums[64] = {};   // this thread's row_sums over the walk
    int slot = 0;
    uint32_t phase = 0;
    mbar_wait(w_full, 0);

    for (int t = t0; t < t1; ++t) {
      float acc[64];
      int held = 0;
      wgmma_fence();
      for (int kc = 0; kc < kch; ++kc) {
        mbar_wait(&x_full[slot], phase);
        unsigned char* xs = ring + slot * BOX_BYTES;
        k3::normalize_rows(xs, c, ct, t * BM, a.M, 1, kc * KCH, mu_s, sc_s, be_s);
        fence_proxy_async();
        named_bar_sync(bar, 128);
        const unsigned char* wt = smem + kc * CHUNK_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128<1>(acc, desc_kmajor(xs, BM, c * WG_ROWS, kk), desc_mnmajor(wt, KCH, kk),
                           kc > 0 || kk > 0);
        wgmma_commit();
        if (kc > 0) {   // the chunk before is read: hand its stage back
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&x_empty[held]);
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
      if (lane == 0) mbar_arrive(&x_empty[held]);

      k3::epilogue(acc, ys, &tm_y, bar, ct, t * BM + c * WG_ROWS, n0, a.M, a.Cout,
                   [&] { k3::row_sums<true>(acc, sums); });
    }
    k3::fold_sums(sums, red, ct);
    named_bar_sync(bar, 128);
    const int col = n0 + ct;
    if (col < a.Cout) {
      float s1, s2;
      k3::warp_sums(red, ct, s1, s2);
      const int part = 2 * p + c;
      a.ws[(long long)part * a.Cout + col] = s1;
      a.ws[((long long)a.parts + part) * a.Cout + col] = s2;
    }
    if (ct == 0) bulk_wait_read<0>();
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

// The card's SMs (132 on the H100).
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// K3's blocks: one per SM, at most one per row tile. Each block's two
// consumers own a partition of the workspace.
int k3_grid(int M) { return std::min(cdiv(M, k3::BM), sm_count()); }

// K4's row partitions: as many as leave every Cout tile one block on an SM
// of its own (at least one, at most one per row tile). The grid is the Cout
// tiles times the partitions; each partition's two consumers own a
// partition of the workspace.
int k4_parts(int M, int Cout) {
  const int ncol = std::max(1, cdiv(Cout, k3::BN));
  return std::min(cdiv(M, k3::BM), std::max(1, sm_count() / ncol));
}

// Both kernels' shape rules.
bool shape_ok(int M, int Cin, int Cout) {
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

Args make_args(const void* x, const void* mu, const void* var, const void* gamma,
               const void* beta, const void* w, void* y, void* s, void* ws, int M, int Cin,
               int Cout, float eps) {
  Args a = {};
  a.x = (const bf16*)x; a.mu = (const float*)mu; a.var = (const float*)var;
  a.gamma = (const float*)gamma; a.beta = (const float*)beta; a.w = (const bf16*)w;
  a.y = (bf16*)y; a.s = (float*)s; a.ws = (float*)ws;
  a.M = M; a.Cin = Cin; a.Cout = Cout; a.eps = eps;
  return a;
}

// Launches `kernel` (K3 or K4: k3::NT threads a block, x, w and y through
// tensor maps of 64-column boxes) on `grid` blocks with `smem` bytes of
// shared memory and 2 * parts workspace rows, then the stats reduction.
// Above 48 KB a block's shared memory must be opted into once per kernel;
// `ready` remembers that it was, for the largest Cin.
template <typename K>
int launch(K kernel, size_t smem, int grid, int parts, Args a, void* stream, bool& ready) {
  if (!shape_ok(a.M, a.Cin, a.Cout)) return ERR_SHAPE;
  a.parts = 2 * parts;
  CUtensorMap mx, mw, my;
  if (int err = map_2d(&mx, a.x, a.M, a.Cin, k3::BM)) return err;
  if (int err = map_2d(&mw, a.w, a.Cin, a.Cout, k3::KCH)) return err;
  if (int err = map_2d(&my, a.y, a.M, a.Cout, k3::WG_ROWS)) return err;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           k3::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  kernel<<<grid, k3::NT, smem, st>>>(mx, mw, my, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<dim3(cdiv(a.Cout, 32), 2), dim3(32, 32), 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Partitions of the workspace each entry point needs: ws is (2, parts, Cout) f32.
extern "C" int hvd_fused_bn_conv_scratch_parts(int M, int Cout) { return 2 * k3_grid(M); }

extern "C" int hvd_fused_bn_conv_revisit_parts(int M, int Cout) { return 2 * k4_parts(M, Cout); }

// K4's Cout tile: its grid is cdiv(Cout, tile) blocks for each row partition.
extern "C" int hvd_fused_bn_conv_revisit_tile_n() { return k3::BN; }

// Each entry point launches its kernel and the stats reduction on the given
// stream and returns cudaGetLastError() (0 on success), ERR_SHAPE for a
// shape the kernel does not take, or a tensor-map error code.
extern "C" int hvd_fused_bn_conv_scratch(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  static bool ready = false;
  const int grid = k3_grid(M);
  return launch(fused_bn_conv_scratch_kernel, k3::layout(Cin).total, grid, grid,
                make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps), stream,
                ready);
}

extern "C" int hvd_fused_bn_conv_revisit(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  static bool ready = false;
  const int parts = k4_parts(M, Cout);
  return launch(fused_bn_conv_revisit_kernel, k4::layout(Cin).total, cdiv(Cout, k3::BN) * parts,
                parts, make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps),
                stream, ready);
}
