// Flash attention for Hopper (sm_90a): the forward kernel and the two
// kernels of the backward, with a plain C interface loaded through ctypes
// (horovod_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Layout: q, k, v are (B, S, H, D) bf16 with the last dimension contiguous
// and any (b, s, h) strides that are multiples of 8 elements, so the three
// strided views that a split of the fused qkv projection gives are read in
// place. dO and O are contiguous (B, S, H, D). Every output (O, dQ, dK, dV)
// is written contiguous (B, S, H, D) in bf16; the per-row logsumexp is
// (B, H, S) f32. The optional key mask is (B, S) f32, 1 = attend.
//
// Numerics follow horovod_tpu/ops/flash_attention.py: scores in f32, scaled
// by 1/sqrt(D) after the product; masked scores are -1e30 (not -inf) and
// their probabilities are zeroed explicitly, so a fully masked row gives
// O = 0 and lse = -1e30; p is cast to bf16 before the P.V product; the
// backward recomputes p = exp(s*scale - lse) from the saved lse. The
// exponentials are exp2 of log2(e)-prescaled scores; lse stays in natural
// log.
//
// Design, shared by the three kernels (hopper_sm90.cuh has the primitives):
// * a block holds 128 stationary rows (query rows in the forward and dQ
//   kernels, key rows in the dK/dV kernel) and streams the other operand's
//   tiles through a ring of shared-memory stages;
// * three warpgroups: warpgroup 0 is the producer, one thread of which
//   issues every TMA load (and gives its registers back with setmaxnreg);
//   warpgroups 1 and 2 are consumers, each owning 64 of the stationary rows;
//   full and empty mbarriers per stage hand the tiles over;
// * TMA reads the strided (B, S, H, D) views in place through a 4-D tensor
//   map (dims D, H, S, B), one map per operand built at every launch, with
//   the 128-byte swizzle wgmma reads; rows past S arrive as zeros;
// * every tile product is a wgmma (m64, bf16 in, f32 accumulate). Score,
//   probability and gradient-of-score tiles stay in the accumulator
//   registers; p and dS are packed to bf16 in registers and fed as the
//   register A operand of the next product, whose B operand (V, dO, Q or K,
//   stored with the head dim contiguous) is read through the descriptor's
//   transpose bit;
// * a tile wholly below the causal diagonal, with no key mask and S a
//   multiple of 128, runs a body without any mask test (the TPU kernel's
//   `plain` split); a diagonal tile, or every tile when there is a key mask
//   or a ragged S, runs the masked body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

typedef __nv_bfloat16 bf16;
using namespace sm90;

namespace {

constexpr int NCONS = 2;               // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);  // and the producer warpgroup
constexpr int WG_ROWS = 64;            // stationary rows of one consumer
constexpr int TILE = NCONS * WG_ROWS;  // stationary rows of a block
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float NEG = -1e30f;          // the masked score, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const float* mask;                      // (B, S) or null
  const float* lse; const float* delta;   // backward inputs, (B, H, S)
  bf16* out0; bf16* out1;                 // fwd: O, -; dkdv: dK, dV; dq: dQ, -
  float* lse_out;                         // fwd only
  int S, H, causal;
  float scale;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// `R` rows from row s0 of head h, batch b: D/64 boxes of R x 64, one after
// the other in shared memory.
template <int D, int R>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int s0, int h, int b) {
#pragma unroll
  for (int j = 0; j < D / 64; ++j) tma_load_4d(dst + j * R * 128, map, bar, j * 64, h, s0, b);
}

// Bit 2n + j: key k0 + 8n + 2t + j (this thread's columns of an N-wide
// accumulator) exists and is not padding.
template <int N>
__device__ __forceinline__ uint32_t key_bits(const float* mrow, int k0, int S, int t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + 8 * n + 2 * t + j;
      const bool ok = key < S && (mrow == nullptr || mrow[key] > 0.f);
      bits |= (ok ? 1u : 0u) << (2 * n + j);
    }
  return bits;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 and r0 + 8 of an (m64 x D) f32 accumulator, divided by div[i],
// written as bf16 to a contiguous (B, S, H, D) output.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           const float (&div)[2], int r0, int S, int H, int h,
                                           int b, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= S) continue;
    bf16* dst = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / div[i], acc[4 * n + 2 * i + 1] / div[i]);
  }
}

// ---------------------------------------------------------------------------
// K1, forward. Replaces horovod_tpu/ops/flash_attention.py `_kernel`
// (launched by `_flash_fwd`).
//
// Bound on the H100: at the GPT-2-small path shape (B=4, S=2048, H=12, D=64,
// causal) the two tile products are 4*B*H*D*S(S+1)/2 ~ 25.8 GFLOP against
// ~50 MB of q/k/v/o, about 500 operations a byte: compute-bound, with a
// floor of ~26 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design against that bound: one block per (128-row query tile, b*h), the
// heaviest causal tiles first; Q loaded once, K and V through a two-stage
// ring (separate full barriers, so S = Q.K^T starts before V lands). Each
// consumer warpgroup runs S = Q.K^T (wgmma, both operands in shared memory),
// the online softmax on its accumulator registers (a row lives in a quad of
// lanes: two shuffles for its max and its sum), then O += P.V with P packed
// to bf16 in registers. The two consumer warpgroups overlap each other's
// softmax with their products; within a warpgroup the products and the
// softmax run in turn. Two schedules that overlap more measured slower at
// the path shape on the H100: a software pipeline within the warpgroup (S
// of tile j in flight with P.V of tile j-1), and the consumers taking turns
// at the tensor cores through named barriers (FlashAttention-3's
// ping-pong).
// ---------------------------------------------------------------------------
template <int D>
struct Fwd {
  static constexpr int BQ = TILE, BK = 128, STAGES = 2;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// One key tile of the online softmax on the S accumulator (in place: sc
// becomes p): the running max m and partial sums l (this thread's columns
// only; summed over the quad at the end) move on, p is packed to bf16, and
// corr gets the factor by which O must be rescaled.
template <int BK, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], uint32_t (&p)[BK / 4],
                                             uint32_t kbits, int k0, int r0, bool causal,
                                             float scale, float sl2, int t) {
  uint32_t vb[2] = {0u, 0u};
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = 4 * n + 2 * i + j;
        bool valid = true;
        if (MASKED) {
          valid = ((kbits >> (2 * n + j)) & 1u) && (!causal || k0 + 8 * n + 2 * t + j <= r0 + 8 * i);
          vb[i] |= (valid ? 1u : 0u) << (2 * n + j);
        }
        mx[i] = fmaxf(mx[i], valid ? sc[idx] * scale : NEG);
      }
  float mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    corr[i] = ex2((m[i] - m_new) * LOG2E);
    m[i] = m_new;
    mb[i] = m_new * LOG2E;
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = 4 * n + 2 * i + j;
        float pv = ex2(fmaf(sc[idx], sl2, -mb[i]));
        if (MASKED && !((vb[i] >> (2 * n + j)) & 1u)) pv = 0.f;
        sc[idx] = pv;
        sum[i] += pv;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
  for (int k = 0; k < BK / 4; ++k) p[k] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using C = Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + ST * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  int nkt = (S + BK - 1) / BK;
  if (a.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NCONS * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      load_rows<D, BQ>(Qs, &tm_q, q_full, q0, h, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % ST;
        mbar_wait(&empty[s], ((kt / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], C::KV_BYTES);
        load_rows<D, BK>(Ks + s * C::KV_BYTES, &tm_k, &k_full[s], kt * BK, h, b);
        mbar_arrive_expect_tx(&v_full[s], C::KV_BYTES);
        load_rows<D, BK>(Vs + s * C::KV_BYTES, &tm_v, &v_full[s], kt * BK, h, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row_lo = q0 + c * WG_ROWS;
    const int r0 = row_lo + warp * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
    const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const bool mask_all = mrow != nullptr || S % TILE != 0;
    const float sl2 = a.scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % ST;
      const uint32_t ph = (kt / ST) & 1;
      const int k0 = kt * BK;
      const unsigned char* Kt = Ks + s * C::KV_BYTES;
      const unsigned char* Vt = Vs + s * C::KV_BYTES;

      float sc[BK / 2];
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, desc_kmajor(Qs, BQ, c * WG_ROWS, kk), desc_kmajor(Kt, BK, 0, kk), kk > 0);
      wgmma_commit();
      const bool masked = mask_all || (a.causal && k0 + BK - 1 > row_lo);
      const uint32_t kbits = masked ? key_bits<BK>(mrow, k0, S, t) : 0u;
      wgmma_wait<0>();
      fence_regs(sc);

      uint32_t p[BK / 4];
      float corr[2];
      if (masked)
        softmax_tile<BK, true>(sc, m, l, corr, p, kbits, k0, r0, a.causal, a.scale, sl2, t);
      else
        softmax_tile<BK, false>(sc, m, l, corr, p, kbits, k0, r0, a.causal, a.scale, sl2, t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * n + 2 * i] *= corr[i];
          o[4 * n + 2 * i + 1] *= corr[i];
        }

      mbar_wait(&v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    desc_mnmajor(Vt, BK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    float l_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) l_safe[i] = fmaxf(quad_sum(l[i]), 1e-30f);
    store_rows<D>(a.out0, o, l_safe, r0, S, H, h, b, t);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < S) a.lse_out[(long long)bh * S + r0 + 8 * i] = m[i] + logf(l_safe[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, backward, first of two kernels: dK and dV. Together with
// flash_bwd_dq_kernel it replaces horovod_tpu/ops/flash_attention.py
// `_dqkv_kernel` (launched by `_flash_bwd`).
//
// The TPU kernel makes one sweep over key blocks and carries dQ in scratch
// memory from one grid step to the next, which relies on the grid running
// in order. Blocks on the GPU run in parallel and in no order, so the
// backward takes two passes: this kernel (one block per 128-row key tile, a
// loop over 64-row query tiles from the diagonal down) owns dK and dV, and
// the dQ kernel (one block per 128-row query tile, a loop over key tiles up
// to the diagonal) owns dQ. Each output element is written by one block, so
// the result is the same from run to run; the price is that p and dP are
// computed in both kernels (7 tile products instead of 5).
//
// Bound on the H100: four tile products (S^T, dP^T, dV, dK) over the causal
// half, 8*B*H*D*S(S+1)/2 ~ 51.6 GFLOP at the path shape against ~75 MB:
// compute-bound, floor ~52 us at 989 TFLOP/s.
//
// Design against that bound: K and V stationary (64 key rows per consumer
// warpgroup); Q and dO tiles, with their lse and delta slices read from L2,
// through a ring. S^T = K.Q^T and dP^T = V.dO^T are issued back to back
// (both operands in shared memory), P^T is formed while dP^T is still in
// flight, then dV += P^T.dO and dK += dS^T.Q take P^T and dS^T as register
// A operands. dK and dV stay f32 in registers until the epilogue.
// ---------------------------------------------------------------------------
template <int D>
struct Dkdv {
  static constexpr int BK = TILE, BQ = 64, STAGES = D == 64 ? 3 : 2;
  static constexpr int KV_BYTES = BK * D * 2, QD_BYTES = BQ * D * 2;
  static constexpr int BAR_OFF = 2 * KV_BYTES + 2 * STAGES * QD_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using C = Dkdv<D>;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Qs = Vs + C::KV_BYTES;
  unsigned char* Ds = Qs + ST * C::QD_BYTES;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int nqt = (S + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      load_rows<D, BK>(Ks, &tm_k, kv_full, k0, h, b);
      load_rows<D, BK>(Vs, &tm_v, kv_full, k0, h, b);
      for (int qt = qt0; qt < nqt; ++qt) {
        const int i = qt - qt0, s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::QD_BYTES);
        load_rows<D, BQ>(Qs + s * C::QD_BYTES, &tm_q, &full[s], qt * BQ, h, b);
        load_rows<D, BQ>(Ds + s * C::QD_BYTES, &tm_do, &full[s], qt * BQ, h, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int key_lo = k0 + c * WG_ROWS;
    const int r0 = key_lo + warp * 16 + lane / 4;   // this thread's keys: r0, r0 + 8
    const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const bool mask_all = mrow != nullptr || S % TILE != 0;
    const float sl2 = a.scale * LOG2E;
    const float* lse = a.lse + (long long)bh * S;
    const float* delta = a.delta + (long long)bh * S;
    bool kok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = r0 + 8 * i;
      kok[i] = key < S && (mrow == nullptr || mrow[key] > 0.f);
    }

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int qt = qt0; qt < nqt; ++qt) {
      const int it = qt - qt0, s = it % ST;
      const int q0 = qt * BQ;
      const unsigned char* Qt = Qs + s * C::QD_BYTES;
      const unsigned char* Dt = Ds + s * C::QD_BYTES;
      mbar_wait(&full[s], (it / ST) & 1);
      if (a.causal && q0 + BQ - 1 < key_lo) {   // every query of the tile precedes every key
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const bool masked = mask_all || (a.causal && key_lo + WG_ROWS - 1 > q0);

      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(st, desc_kmajor(Ks, BK, c * WG_ROWS, kk), desc_kmajor(Qt, BQ, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dpt, desc_kmajor(Vs, BK, c * WG_ROWS, kk), desc_kmajor(Dt, BQ, 0, kk), kk > 0);
      wgmma_commit();

      // lse (log2 units) and delta of this thread's query columns.
      float lb[BQ / 4], dl[BQ / 4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = q0 + 8 * n + 2 * t + j;
          const bool in = !masked || q < S;
          lb[2 * n + j] = in ? lse[q] * LOG2E : 0.f;
          dl[2 * n + j] = in ? delta[q] : 0.f;
        }

      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = 4 * n + 2 * i + j;
            float pv = ex2(fmaf(st[idx], sl2, -lb[2 * n + j]));
            if (masked) {
              const int q = q0 + 8 * n + 2 * t + j;
              const bool valid = kok[i] && q < S && (!a.causal || r0 + 8 * i <= q);
              pv = valid ? pv : 0.f;
            }
            st[idx] = pv;
          }
      wgmma_wait<0>();
      fence_regs(dpt);
      uint32_t pp[BQ / 4], dd[BQ / 4];
#pragma unroll
      for (int k = 0; k < BQ / 4; ++k) {
        // accumulator pair k: query columns 8n + 2t + j, j = 0, 1, with n = k/2
        const int n = k / 2;
        const float ds0 = st[2 * k] * (dpt[2 * k] - dl[2 * n]) * a.scale;
        const float ds1 = st[2 * k + 1] * (dpt[2 * k + 1] - dl[2 * n + 1]) * a.scale;
        pp[k] = pack_bf16(st[2 * k], st[2 * k + 1]);
        dd[k] = pack_bf16(ds0, ds1);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D>(dv, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
                    desc_mnmajor(Dt, BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D>(dk, dd[4 * kk], dd[4 * kk + 1], dd[4 * kk + 2], dd[4 * kk + 3],
                    desc_mnmajor(Qt, BQ, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_rows<D>(a.out0, dk, one, r0, S, H, h, b, t);
    store_rows<D>(a.out1, dv, one, r0, S, H, h, b, t);
  }
}

// ---------------------------------------------------------------------------
// K2, backward, second kernel: dQ (see flash_bwd_dkdv_kernel for the split).
// One block per (128-row query tile, b*h), a loop over key tiles up to the
// diagonal; dQ accumulates in registers and is written once.
//
// Bound on the H100: three tile products (S, dP, dQ) over the causal half,
// 6*B*H*D*S(S+1)/2 ~ 38.7 GFLOP at the path shape against ~75 MB:
// compute-bound, floor ~39 us at 989 TFLOP/s.
//
// Design against that bound: Q and dO stationary, K and V through a ring
// (128-row key tiles at D = 64, 64-row at D = 128 to fit the registers).
// S = Q.K^T and dP = dO.V^T are issued back to back, P is formed while dP
// is in flight, and dQ += dS.K takes dS as the register A operand.
// ---------------------------------------------------------------------------
template <int D>
struct Dq {
  static constexpr int BQ = TILE, BK = D == 64 ? 128 : 64, STAGES = 2;
  static constexpr int QD_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int BAR_OFF = 2 * QD_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using C = Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ds = Qs + C::QD_BYTES;
  unsigned char* Ks = Ds + C::QD_BYTES;
  unsigned char* Vs = Ks + ST * C::KV_BYTES;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + ST;

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  int nkt = (S + BK - 1) / BK;
  if (a.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qd_full, 2 * C::QD_BYTES);
      load_rows<D, BQ>(Qs, &tm_q, qd_full, q0, h, b);
      load_rows<D, BQ>(Ds, &tm_do, qd_full, q0, h, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % ST;
        mbar_wait(&empty[s], ((kt / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_rows<D, BK>(Ks + s * C::KV_BYTES, &tm_k, &full[s], kt * BK, h, b);
        load_rows<D, BK>(Vs + s * C::KV_BYTES, &tm_v, &full[s], kt * BK, h, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row_lo = q0 + c * WG_ROWS;
    const int r0 = row_lo + warp * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
    const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const bool mask_all = mrow != nullptr || S % TILE != 0;
    const float sl2 = a.scale * LOG2E;
    float lb[2], dl[2];
    bool rok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      rok[i] = row < S;
      lb[i] = rok[i] ? a.lse[(long long)bh * S + row] * LOG2E : 0.f;
      dl[i] = rok[i] ? a.delta[(long long)bh * S + row] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(qd_full, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % ST;
      const int k0 = kt * BK;
      const unsigned char* Kt = Ks + s * C::KV_BYTES;
      const unsigned char* Vt = Vs + s * C::KV_BYTES;
      mbar_wait(&full[s], (kt / ST) & 1);
      if (a.causal && k0 > row_lo + WG_ROWS - 1) {   // every key of the tile follows every row
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const bool masked = mask_all || (a.causal && k0 + BK - 1 > row_lo);

      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, desc_kmajor(Qs, BQ, c * WG_ROWS, kk), desc_kmajor(Kt, BK, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, desc_kmajor(Ds, BQ, c * WG_ROWS, kk), desc_kmajor(Vt, BK, 0, kk), kk > 0);
      wgmma_commit();
      const uint32_t kbits = masked ? key_bits<BK>(mrow, k0, S, t) : 0u;

      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = 4 * n + 2 * i + j;
            float pv = ex2(fmaf(sc[idx], sl2, -lb[i]));
            if (masked) {
              const bool valid = rok[i] && ((kbits >> (2 * n + j)) & 1u) &&
                                 (!a.causal || k0 + 8 * n + 2 * t + j <= r0 + 8 * i);
              pv = valid ? pv : 0.f;
            }
            sc[idx] = pv;
          }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dd[BK / 4];
#pragma unroll
      for (int k = 0; k < BK / 4; ++k) {
        const int i = k % 2;   // accumulator pair k holds row r0 + 8i
        dd[k] = pack_bf16(sc[2 * k] * (dp[2 * k] - dl[i]) * a.scale,
                          sc[2 * k + 1] * (dp[2 * k + 1] - dl[i]) * a.scale);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(dq, dd[4 * kk], dd[4 * kk + 1], dd[4 * kk + 2], dd[4 * kk + 3],
                    desc_mnmajor(Kt, BK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_rows<D>(a.out0, dq, one, r0, S, H, h, b, t);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Error codes of the entry points besides cudaError_t values.
constexpr int ERR_HEAD_DIM = -1;      // D is not 64 or 128
constexpr int ERR_NO_ENCODER = -2;    // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = -3;    // the driver refused a tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out its
// address, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (B, S, H, D) bf16 view with element strides (sb, ss, sh) and D
// contiguous, read in boxes of `rows` x 64 with the 128-byte swizzle; rows
// past S read as zeros.
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
             long long ss, long long sh, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Above 48 KB a block's shared memory must be opted into once per kernel;
// `ready` remembers that it was (setting it twice from two threads is
// harmless).
template <typename K, typename... Maps>
int launch(K kernel, int smem, dim3 grid, void* stream, bool& ready, const Args& a,
           const Maps&... maps) {
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(maps..., a);
  return (int)cudaGetLastError();
}

Args make_args(const void* mask, int S, int H, int causal, float scale) {
  Args a = {};
  a.mask = (const float*)mask;
  a.S = S; a.H = H;
  a.causal = causal; a.scale = scale;
  return a;
}

struct View {
  const void* p;
  long long sb, ss, sh;
};

template <int D>
int fwd(const View& q, const View& k, const View& v, const Args& a, int B, void* stream) {
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = make_map(&mq, q.p, B, a.S, a.H, D, q.sb, q.ss, q.sh, Fwd<D>::BQ)) ||
      (err = make_map(&mk, k.p, B, a.S, a.H, D, k.sb, k.ss, k.sh, Fwd<D>::BK)) ||
      (err = make_map(&mv, v.p, B, a.S, a.H, D, v.sb, v.ss, v.sh, Fwd<D>::BK)))
    return err;
  static bool ready = false;
  const dim3 grid((a.S + Fwd<D>::BQ - 1) / Fwd<D>::BQ, B * a.H);
  return launch(flash_fwd_kernel<D>, Fwd<D>::SMEM, grid, stream, ready, a, mq, mk, mv);
}

// dO is contiguous (B, S, H, D).
template <int D, int BQ, int BK>
int bwd_maps(CUtensorMap* m, const View& q, const View& k, const View& v, const void* dout,
             const Args& a, int B) {
  const long long hd = (long long)a.H * D;
  int err;
  if ((err = make_map(&m[0], q.p, B, a.S, a.H, D, q.sb, q.ss, q.sh, BQ)) ||
      (err = make_map(&m[1], k.p, B, a.S, a.H, D, k.sb, k.ss, k.sh, BK)) ||
      (err = make_map(&m[2], v.p, B, a.S, a.H, D, v.sb, v.ss, v.sh, BK)) ||
      (err = make_map(&m[3], dout, B, a.S, a.H, D, hd * a.S, hd, D, BQ)))
    return err;
  return 0;
}

template <int D>
int bwd_dkdv(const View& q, const View& k, const View& v, const void* dout, const Args& a, int B,
             void* stream) {
  using C = Dkdv<D>;
  CUtensorMap m[4];
  if (int err = bwd_maps<D, C::BQ, C::BK>(m, q, k, v, dout, a, B)) return err;
  static bool ready = false;
  const dim3 grid((a.S + C::BK - 1) / C::BK, B * a.H);
  return launch(flash_bwd_dkdv_kernel<D>, C::SMEM, grid, stream, ready, a, m[0], m[1], m[2], m[3]);
}

template <int D>
int bwd_dq(const View& q, const View& k, const View& v, const void* dout, const Args& a, int B,
           void* stream) {
  using C = Dq<D>;
  CUtensorMap m[4];
  if (int err = bwd_maps<D, C::BQ, C::BK>(m, q, k, v, dout, a, B)) return err;
  static bool ready = false;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, B * a.H);
  return launch(flash_bwd_dq_kernel<D>, C::SMEM, grid, stream, ready, a, m[0], m[1], m[2], m[3]);
}

}  // namespace

// Each entry point launches one kernel on the given stream and returns
// cudaGetLastError() (0 on success) or one of the ERR_* codes above.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int S, int H, int D, int sqb,
                             int sqs, int sqh, int skb, int sks, int skh, int svb, int svs,
                             int svh, int causal, float scale, void* stream) {
  Args a = make_args(mask, S, H, causal, scale);
  a.out0 = (bf16*)o; a.lse_out = (float*)lse;
  const View vq = {q, sqb, sqs, sqh}, vk = {k, skb, sks, skh}, vv = {v, svb, svs, svh};
  if (D == 64) return fwd<64>(vq, vk, vv, a, B, stream);
  if (D == 128) return fwd<128>(vq, vk, vv, a, B, stream);
  return ERR_HEAD_DIM;
}

extern "C" int hvd_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int S, int H,
                                  int D, int sqb, int sqs, int sqh, int skb, int sks, int skh,
                                  int svb, int svs, int svh, int causal, float scale,
                                  void* stream) {
  Args a = make_args(mask, S, H, causal, scale);
  a.lse = (const float*)lse; a.delta = (const float*)delta;
  a.out0 = (bf16*)dk; a.out1 = (bf16*)dv;
  const View vq = {q, sqb, sqs, sqh}, vk = {k, skb, sks, skh}, vv = {v, svb, svs, svh};
  if (D == 64) return bwd_dkdv<64>(vq, vk, vv, dout, a, B, stream);
  if (D == 128) return bwd_dkdv<128>(vq, vk, vv, dout, a, B, stream);
  return ERR_HEAD_DIM;
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                int B, int S, int H, int D, int sqb, int sqs, int sqh, int skb,
                                int sks, int skh, int svb, int svs, int svh, int causal,
                                float scale, void* stream) {
  Args a = make_args(mask, S, H, causal, scale);
  a.lse = (const float*)lse; a.delta = (const float*)delta;
  a.out0 = (bf16*)dq;
  const View vq = {q, sqb, sqs, sqh}, vk = {k, skb, sks, skh}, vv = {v, svb, svs, svh};
  if (D == 64) return bwd_dq<64>(vq, vk, vv, dout, a, B, stream);
  if (D == 128) return bwd_dq<128>(vq, vk, vv, dout, a, B, stream);
  return ERR_HEAD_DIM;
}
