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
// backward recomputes p = exp(s*scale - lse) from the saved lse.
//
// Tiles: 64 query rows by 64 key rows, four warps of 16 rows each. The tile
// products use WMMA (bf16 in, f32 accumulate, mma.sync underneath); the
// score and probability tiles go through shared memory, where each warp
// runs the softmax on its own 16 rows (two lanes per row). The ragged edge
// (S not a multiple of 64) is masked inside the kernels: rows past S load
// as zeros and are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NT = NWARPS * 32;
constexpr float NEG = -1e30f; // the masked score, as in the TPU kernel

template <int D>
struct Cfg {
  static constexpr int LDH = D + 8;                       // bf16 tile row stride
  static constexpr int LDW = (BK > D ? BK : D) + 4;       // f32 warp scratch stride
  static constexpr int LDP = BK + 8;                      // bf16 warp scratch stride
  static constexpr int TILE = 64 * LDH;                   // elements of one bf16 tile
  static constexpr int WF = 16 * LDW;                     // floats of one warp's f32 scratch
  static constexpr int WP = 16 * LDP;                     // elements of one warp's bf16 scratch
};

struct Args {
  const bf16* q; const bf16* k; const bf16* v;
  const float* mask;          // (B, S) or null
  const bf16* o; const bf16* dout;   // backward only, contiguous (B, S, H, D)
  const float* lse; const float* delta;  // backward inputs, (B, H, S)
  bf16* out0; bf16* out1;     // fwd: O, -; dkdv: dK, dV; dq: dQ, -
  float* lse_out;             // fwd only
  int B, S, H;
  int sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal;
  float scale;
};

// 64 rows x D columns of a (B, S, H, D) view into a padded shared tile;
// rows at or past S load as zeros. 16-byte loads, one row chunk per thread.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int ss,
                                          int row0, int S) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < 64 * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(base + (long long)s * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::LDH + c * 8) = val;
  }
}

// kvalid[c] = 1 when key k0 + c exists and is not padding.
__device__ __forceinline__ void load_kvalid(float* kvalid, const float* mrow, int k0, int S) {
  for (int c = threadIdx.x; c < BK; c += NT) {
    const int kp = k0 + c;
    float ok = kp < S ? 1.f : 0.f;
    if (mrow != nullptr && kp < S && !(mrow[kp] > 0.f)) ok = 0.f;
    kvalid[c] = ok;
  }
}

// Rows of a warp's 16 x D f32 scratch, written as bf16 to a contiguous
// (B, S, H, D) output; lane pairs write one row, half a row each.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float* w, int row0,
                                           int S, int H, int h, int b, int lane) {
  const int rw = lane >> 1, half = lane & 1;
  const int s = row0 + rw;
  if (s >= S) return;
  bf16* dst = out + (((long long)b * S + s) * H + h) * D + half * (D / 2);
  const float* src = w + rw * Cfg<D>::LDW + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 2; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(src[j], src[j + 1]);
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// out(16 x 64, f32, ld LDW) = A(16 x D, held in fragments) . T^T, where T is
// a 64 x D shared tile (row r of T is column r of the product).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out, const FragA* a, const bf16* T) {
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBc bfr;
      wmma::load_matrix_sync(bfr, T + n * 16 * Cfg<D>::LDH + kk * 16, Cfg<D>::LDH);
      wmma::mma_sync(c, a[kk], bfr, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, Cfg<D>::LDW, wmma::mem_row_major);
  }
}

// acc[n] += P(16 x 64, bf16 scratch, ld LDP) . T(64 x D shared tile).
template <int D>
__device__ __forceinline__ void scratch_times_tile(FragC* acc, const bf16* P, const bf16* T) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, P + kk * 16, Cfg<D>::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr bfr;
      wmma::load_matrix_sync(bfr, T + kk * 16 * Cfg<D>::LDH + n * 16, Cfg<D>::LDH);
      wmma::mma_sync(acc[n], a, bfr, acc[n]);
    }
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
// Design against that bound: one block per (q tile, b*h), a loop over key
// tiles inside the block, so scores never reach device memory; a causal
// block stops at the diagonal tile (half the products skipped) and the
// heaviest (last) q tiles are scheduled first; products run on the tensor
// cores through WMMA. What it does not yet do: the f32 score tile takes a
// round trip through shared memory, loads are synchronous, and WMMA is
// mma.sync, not wgmma, so it stays well under the tensor-core peak.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + C::TILE;
  bf16* Vs = Ks + C::TILE;
  float* Wf = reinterpret_cast<float*>(Vs + C::TILE);   // NWARPS x 16 x LDW
  bf16* Wp = reinterpret_cast<bf16*>(Wf + NWARPS * C::WF);  // NWARPS x 16 x LDP
  float* kvalid = reinterpret_cast<float*>(Wp + NWARPS * C::WP);

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nqt = gridDim.x;
  const int qt = a.causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + rw;
  float* Sw = Wf + warp * C::WF;
  bf16* Pw = Wp + warp * C::WP;
  const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile<D>(Qs, a.q + (long long)b * a.sqb + (long long)h * a.sqh, a.sqs, q0, S);
  __syncthreads();
  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * C::LDH + kk * 16, C::LDH);

  int nkt = (S + BK - 1) / BK;
  if (a.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);

  float m_i = NEG, l_i = 0.f;
  float o_acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;

  const bf16* kbase = a.k + (long long)b * a.skb + (long long)h * a.skh;
  const bf16* vbase = a.v + (long long)b * a.svb + (long long)h * a.svh;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kbase, a.sks, k0, S);
    load_tile<D>(Vs, vbase, a.svs, k0, S);
    load_kvalid(kvalid, mrow, k0, S);
    __syncthreads();

    rows_times_tile_t<D>(Sw, qf, Ks);
    __syncwarp();

    // Online softmax over this lane's 32 columns of its row.
    float sv[32];
    uint32_t vbits = 0u;
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const int kp = k0 + col;
      const bool valid = kvalid[col] > 0.f && (!a.causal || kp <= qrow);
      const float s = valid ? Sw[rw * C::LDW + col] * a.scale : NEG;
      vbits |= (valid ? 1u : 0u) << j;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = ((vbits >> j) & 1u) ? expf(sv[j] - m_new) : 0.f;
      sum += p;
      Pw[rw * C::LDP + half * 32 + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + sum;
    m_i = m_new;
    __syncwarp();

    // P.V for this tile into the (now free) f32 scratch, then fold it into
    // the running output with the correction factor.
    FragC pv[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(pv[n], 0.f);
    scratch_times_tile<D>(pv, Pw, Vs);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(Sw + n * 16, pv[n], C::LDW, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 2; ++j)
      o_acc[j] = o_acc[j] * corr + Sw[rw * C::LDW + half * (D / 2) + j];
    __syncwarp();
  }

  const float l_safe = fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 2; ++j) Sw[rw * C::LDW + half * (D / 2) + j] = o_acc[j] / l_safe;
  __syncwarp();
  store_rows<D>(a.out0, Sw, q0 + warp * 16, S, H, h, b, lane);
  if (half == 0 && qrow < S) a.lse_out[(long long)bh * S + qrow] = m_i + logf(l_safe);
}

// ---------------------------------------------------------------------------
// K2, backward, first of two kernels: dK and dV. Together with
// flash_bwd_dq_kernel it replaces horovod_tpu/ops/flash_attention.py
// `_dqkv_kernel` (launched by `_flash_bwd`).
//
// The TPU kernel makes one sweep over key blocks and carries dQ in scratch
// memory from one grid step to the next, which relies on the grid running
// in order. Blocks on the GPU run in parallel and in no order, so the
// backward takes two passes: this kernel (one block per key tile, a loop
// over query tiles from the diagonal down) owns dK and dV, and the dQ
// kernel (one block per query tile, a loop over key tiles up to the
// diagonal) owns dQ. Each output element is written by one block, so the
// result is the same from run to run; the price is that p and dP are
// computed in both kernels (7 tile products instead of 5).
//
// Bound on the H100: four tile products (S^T, dP^T, dV, dK) over the causal
// half, 8*B*H*D*S(S+1)/2 ~ 51.6 GFLOP at the path shape against ~75 MB:
// compute-bound, floor ~52 us at 989 TFLOP/s.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::TILE;
  bf16* Qs = Vs + C::TILE;
  bf16* dOs = Qs + C::TILE;
  float* Wf = reinterpret_cast<float*>(dOs + C::TILE);      // NWARPS x 16 x LDW
  bf16* Wp = reinterpret_cast<bf16*>(Wf + NWARPS * C::WF);  // P^T scratch
  bf16* Wd = Wp + NWARPS * C::WP;                           // dS^T scratch
  float* kvalid = reinterpret_cast<float*>(Wd + NWARPS * C::WP);
  float* lse_s = kvalid + BK;
  float* delta_s = lse_s + BQ;

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kt = blockIdx.x, k0 = kt * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = lane >> 1, half = lane & 1;
  const int kpos = k0 + warp * 16 + rw;
  float* St = Wf + warp * C::WF;
  bf16* Pt = Wp + warp * C::WP;
  bf16* dSt = Wd + warp * C::WP;
  const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile<D>(Ks, a.k + (long long)b * a.skb + (long long)h * a.skh, a.sks, k0, S);
  load_tile<D>(Vs, a.v + (long long)b * a.svb + (long long)h * a.svh, a.svs, k0, S);
  load_kvalid(kvalid, mrow, k0, S);
  __syncthreads();
  FragA kf[D / 16], vf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * C::LDH + kk * 16, C::LDH);
    wmma::load_matrix_sync(vf[kk], Vs + warp * 16 * C::LDH + kk * 16, C::LDH);
  }
  const bool kv = kvalid[warp * 16 + rw] > 0.f;
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nqt = (S + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  const bf16* qbase = a.q + (long long)b * a.sqb + (long long)h * a.sqh;
  const bf16* dobase = a.dout + (long long)b * S * H * D + (long long)h * D;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D>(Qs, qbase, a.sqs, q0, S);
    load_tile<D>(dOs, dobase, H * D, q0, S);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < S;
      lse_s[r] = ok ? a.lse[(long long)bh * S + q0 + r] : 0.f;
      delta_s[r] = ok ? a.delta[(long long)bh * S + q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K_w . Q^T ; P^T = exp(S^T * scale - lse), zero where masked.
    rows_times_tile_t<D>(St, kf, Qs);
    __syncwarp();
    float preg[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = half * 32 + j;
      const int qp = q0 + qc;
      const bool valid = kv && qp < S && (!a.causal || kpos <= qp);
      const float p = valid ? expf(St[rw * C::LDW + qc] * a.scale - lse_s[qc]) : 0.f;
      preg[j] = p;
      Pt[rw * C::LDP + qc] = __float2bfloat16(p);
    }
    __syncwarp();
    // dP^T = V_w . dO^T ; dS^T = P^T (dP^T - delta) * scale.
    rows_times_tile_t<D>(St, vf, dOs);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = half * 32 + j;
      const float ds = preg[j] * (St[rw * C::LDW + qc] - delta_s[qc]) * a.scale;
      dSt[rw * C::LDP + qc] = __float2bfloat16(ds);
    }
    __syncwarp();
    scratch_times_tile<D>(dv_acc, Pt, dOs);   // dV += P^T . dO
    scratch_times_tile<D>(dk_acc, dSt, Qs);   // dK += dS^T . Q
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(St + n * 16, dk_acc[n], C::LDW, wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(a.out0, St, k0 + warp * 16, S, H, h, b, lane);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(St + n * 16, dv_acc[n], C::LDW, wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(a.out1, St, k0 + warp * 16, S, H, h, b, lane);
}

// ---------------------------------------------------------------------------
// K2, backward, second kernel: dQ (see flash_bwd_dkdv_kernel for the split).
// One block per (q tile, b*h), a loop over key tiles up to the diagonal;
// dQ accumulates in tensor-core fragments and is written once.
//
// Bound on the H100: three tile products (S, dP, dQ) over the causal half,
// 6*B*H*D*S(S+1)/2 ~ 38.7 GFLOP at the path shape against ~75 MB:
// compute-bound, floor ~39 us at 989 TFLOP/s.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + C::TILE;
  bf16* Ks = dOs + C::TILE;
  bf16* Vs = Ks + C::TILE;
  float* Wf = reinterpret_cast<float*>(Vs + C::TILE);
  bf16* Wd = reinterpret_cast<bf16*>(Wf + NWARPS * C::WF);
  float* kvalid = reinterpret_cast<float*>(Wd + NWARPS * C::WP);

  const int S = a.S, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nqt = gridDim.x;
  const int qt = a.causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + rw;
  float* Sw = Wf + warp * C::WF;
  bf16* dSw = Wd + warp * C::WP;
  const float* mrow = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile<D>(Qs, a.q + (long long)b * a.sqb + (long long)h * a.sqh, a.sqs, q0, S);
  load_tile<D>(dOs, a.dout + (long long)b * S * H * D + (long long)h * D, H * D, q0, S);
  __syncthreads();
  FragA qf[D / 16], dof[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * C::LDH + kk * 16, C::LDH);
    wmma::load_matrix_sync(dof[kk], dOs + warp * 16 * C::LDH + kk * 16, C::LDH);
  }
  const float lse_r = qrow < S ? a.lse[(long long)bh * S + qrow] : 0.f;
  const float delta_r = qrow < S ? a.delta[(long long)bh * S + qrow] : 0.f;
  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  int nkt = (S + BK - 1) / BK;
  if (a.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  const bf16* kbase = a.k + (long long)b * a.skb + (long long)h * a.skh;
  const bf16* vbase = a.v + (long long)b * a.svb + (long long)h * a.svh;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(Ks, kbase, a.sks, k0, S);
    load_tile<D>(Vs, vbase, a.svs, k0, S);
    load_kvalid(kvalid, mrow, k0, S);
    __syncthreads();

    rows_times_tile_t<D>(Sw, qf, Ks);      // S = Q_w . K^T
    __syncwarp();
    float preg[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const int kp = k0 + col;
      const bool valid = qrow < S && kvalid[col] > 0.f && (!a.causal || kp <= qrow);
      preg[j] = valid ? expf(Sw[rw * C::LDW + col] * a.scale - lse_r) : 0.f;
    }
    __syncwarp();
    rows_times_tile_t<D>(Sw, dof, Vs);     // dP = dO_w . V^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float ds = preg[j] * (Sw[rw * C::LDW + col] - delta_r) * a.scale;
      dSw[rw * C::LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    scratch_times_tile<D>(dq_acc, dSw, Ks);  // dQ += dS . K
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(Sw + n * 16, dq_acc[n], C::LDW, wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(a.out0, Sw, q0 + warp * 16, S, H, h, b, lane);
}

template <int D>
constexpr size_t fwd_smem() {
  return 3 * Cfg<D>::TILE * sizeof(bf16) + NWARPS * Cfg<D>::WF * sizeof(float) +
         NWARPS * Cfg<D>::WP * sizeof(bf16) + BK * sizeof(float);
}
template <int D>
constexpr size_t dkdv_smem() {
  return 4 * Cfg<D>::TILE * sizeof(bf16) + NWARPS * Cfg<D>::WF * sizeof(float) +
         2 * NWARPS * Cfg<D>::WP * sizeof(bf16) + (BK + 2 * BQ) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return 4 * Cfg<D>::TILE * sizeof(bf16) + NWARPS * Cfg<D>::WF * sizeof(float) +
         NWARPS * Cfg<D>::WP * sizeof(bf16) + BK * sizeof(float);
}

// Above 48 KB a block's shared memory must be opted into once per kernel;
// `ready` remembers that it was (setting it twice from two threads is
// harmless).
template <typename K>
int launch(K kernel, size_t smem, dim3 grid, const Args& a, void* stream, bool& ready) {
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* mask, int B, int S,
               int H, int sqb, int sqs, int sqh, int skb, int sks, int skh, int svb, int svs,
               int svh, int causal, float scale) {
  Args a = {};
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.mask = (const float*)mask;
  a.B = B; a.S = S; a.H = H;
  a.sqb = sqb; a.sqs = sqs; a.sqh = sqh;
  a.skb = skb; a.sks = sks; a.skh = skh;
  a.svb = svb; a.svs = svs; a.svh = svh;
  a.causal = causal; a.scale = scale;
  return a;
}

}  // namespace

// Each entry point launches one kernel on the given stream and returns
// cudaGetLastError() (0 on success); D other than 64 or 128 returns -1.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int S, int H, int D, int sqb,
                             int sqs, int sqh, int skb, int sks, int skh, int svb, int svs,
                             int svh, int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, mask, B, S, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
                     causal, scale);
  a.out0 = (bf16*)o; a.lse_out = (float*)lse;
  static bool ready[2] = {false, false};
  dim3 grid((S + BQ - 1) / BQ, B * H);
  if (D == 64) return launch(flash_fwd_kernel<64>, fwd_smem<64>(), grid, a, stream, ready[0]);
  if (D == 128) return launch(flash_fwd_kernel<128>, fwd_smem<128>(), grid, a, stream, ready[1]);
  return -1;
}

extern "C" int hvd_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int S, int H,
                                  int D, int sqb, int sqs, int sqh, int skb, int sks, int skh,
                                  int svb, int svs, int svh, int causal, float scale,
                                  void* stream) {
  Args a = make_args(q, k, v, mask, B, S, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
                     causal, scale);
  a.dout = (const bf16*)dout; a.lse = (const float*)lse; a.delta = (const float*)delta;
  a.out0 = (bf16*)dk; a.out1 = (bf16*)dv;
  static bool ready[2] = {false, false};
  dim3 grid((S + BK - 1) / BK, B * H);
  if (D == 64) return launch(flash_bwd_dkdv_kernel<64>, dkdv_smem<64>(), grid, a, stream, ready[0]);
  if (D == 128) return launch(flash_bwd_dkdv_kernel<128>, dkdv_smem<128>(), grid, a, stream, ready[1]);
  return -1;
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                int B, int S, int H, int D, int sqb, int sqs, int sqh, int skb,
                                int sks, int skh, int svb, int svs, int svh, int causal,
                                float scale, void* stream) {
  Args a = make_args(q, k, v, mask, B, S, H, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
                     causal, scale);
  a.dout = (const bf16*)dout; a.lse = (const float*)lse; a.delta = (const float*)delta;
  a.out0 = (bf16*)dq;
  static bool ready[2] = {false, false};
  dim3 grid((S + BQ - 1) / BQ, B * H);
  if (D == 64) return launch(flash_bwd_dq_kernel<64>, dq_smem<64>(), grid, a, stream, ready[0]);
  if (D == 128) return launch(flash_bwd_dq_kernel<128>, dq_smem<128>(), grid, a, stream, ready[1]);
  return -1;
}
