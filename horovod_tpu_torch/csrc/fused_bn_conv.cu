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
// All arrays are contiguous and row-major. Cin is a multiple of 32, at most
// 512; any M and Cout (rows past M and columns past Cout are masked).
//
// Tiles: 64 rows by BN output columns, 2 x (BN/32) warps of 32 x 32 each;
// the products use WMMA (bf16 in, f32 accumulate, mma.sync underneath). The
// normalised row tile `a` (64 x Cin bf16) is built in shared memory as x is
// loaded, so the BN + ReLU prologue costs no extra pass over x. The
// accumulator tile goes through shared memory for the epilogue, which writes
// y and takes each column's partial sums over the tile's rows in a fixed
// order. Partial sums land in an f32 workspace and a second small kernel
// reduces them over the partitions in a fixed order: no atomics, so s1 and
// s2 are bitwise equal from launch to launch.
//
// Bound on the H100, at the ResNet-50 path shape (stage 1 at B=256, 224^2:
// M = 200,704, Cin 128 -> Cout 512): 2*M*Cin*Cout = 26.3 GFLOP against
// 256.9 MB of x + y + w, about 100 operations a byte, so device-memory bound
// (floor ~0.077 ms at 3.35 TB/s). The design keeps the normalised
// activation out of device memory and reads x once (K3); what it does not
// yet do: loads are synchronous (no cp.async/TMA ring) and the products are
// mma.sync, not wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows per tile
constexpr int KC = 32;        // rows of w per streamed chunk (K3), the k-step
constexpr int MAX_CIN = 512;
constexpr int K3_BN = 128;    // output columns per tile, x-stationary
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
size_t k3_smem(int cin) { return smem_common<K3_BN>(cin) + (size_t)KC * Cfg<K3_BN>::LDB * sizeof(bf16); }
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
// K3, x-stationary. Replaces the Pallas kernel of
// horovod_tpu/ops/fused_bn_conv.py `fused_bn_relu_matmul(accum="scratch")`,
// whose grid runs the Cout blocks innermost so each x block is fetched once
// and the stats ride a VMEM scratch across the sequential grid.
//
// Here one block owns one 64-row tile of x: it normalises the tile into
// shared memory once, then sweeps every 128-column tile of w (streamed from
// L2 in 32-row chunks), so x crosses device memory exactly once. Blocks run
// in no order, so instead of a scratch carried across the grid each block
// writes its tile's column sums to the workspace (one row per row tile) and
// the reduce kernel sums them in a fixed order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(Cfg<K3_BN>::NT) fused_bn_conv_scratch_kernel(Args a) {
  constexpr int BN = K3_BN;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<BN> s(smem, a.Cin);
  const int tile = blockIdx.x, row0 = tile * BM;
  const int lda = a.Cin + 8;

  load_params<Cfg<BN>::NT>(s.mu, s.sc, s.be, a);
  __syncthreads();
  load_norm_tile<Cfg<BN>::NT>(s.A, a, row0, s.mu, s.sc, s.be);

  for (int n0 = 0; n0 < a.Cout; n0 += BN) {
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < a.Cin; k0 += KC) {
      __syncthreads();   // A is complete; every warp is done with the last chunk
      load_w<BN>(s.W, a, k0, KC, n0);
      __syncthreads();
      mma_tile<BN>(acc, s.A, lda, k0, s.W, 0, KC / 16);
    }
    float t1 = 0.f, t2 = 0.f;
    epilogue<BN>(acc, s.C, s.red, a, row0, n0, t1, t2);
    const int col = n0 + threadIdx.x;
    if (threadIdx.x < BN && col < a.Cout) {
      a.ws[(long long)tile * a.Cout + col] = t1;
      a.ws[((long long)a.parts + tile) * a.Cout + col] = t2;
    }
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

int k3_parts(int M) { return cdiv(M, BM); }

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
template <typename K>
int launch(K kernel, size_t max_smem, size_t smem, dim3 grid, int nt, const Args& a,
           cudaStream_t stream, bool& ready) {
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<grid, nt, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<dim3(cdiv(a.Cout, 32), 2), dim3(32, 32), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Partitions of the workspace each entry point needs: ws is (2, parts, Cout) f32.
extern "C" int hvd_fused_bn_conv_scratch_parts(int M, int Cout) { return k3_parts(M); }

extern "C" int hvd_fused_bn_conv_revisit_parts(int M, int Cout) {
  int parts, per;
  k4_split(M, Cout, &parts, &per);
  return parts;
}

// Each entry point launches its kernel and the stats reduction on the given
// stream and returns cudaGetLastError() (0 on success); a shape the kernels
// do not take returns -1.
extern "C" int hvd_fused_bn_conv_scratch(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  if (!shape_ok(M, Cin, Cout)) return -1;
  Args a = make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps);
  a.parts = k3_parts(M);
  static bool ready = false;
  return launch(fused_bn_conv_scratch_kernel, k3_smem(MAX_CIN), k3_smem(Cin), dim3(a.parts),
                Cfg<K3_BN>::NT, a, (cudaStream_t)stream, ready);
}

extern "C" int hvd_fused_bn_conv_revisit(const void* x, const void* mu, const void* var,
                                         const void* gamma, const void* beta, const void* w,
                                         void* y, void* s, void* ws, int M, int Cin, int Cout,
                                         float eps, void* stream) {
  if (!shape_ok(M, Cin, Cout)) return -1;
  Args a = make_args(x, mu, var, gamma, beta, w, y, s, ws, M, Cin, Cout, eps);
  k4_split(M, Cout, &a.parts, &a.per);
  static bool ready = false;
  return launch(fused_bn_conv_revisit_kernel, k4_smem(MAX_CIN), k4_smem(Cin),
                dim3(cdiv(Cout, K4_BN), a.parts), Cfg<K4_BN>::NT, a, (cudaStream_t)stream,
                ready);
}
