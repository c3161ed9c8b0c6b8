// Fused ConvNeXt-v2 MLP + GRN for Hopper (sm_90a), plain C interface: the
// forward here, the backward (passes C and D) further down.
//
// The forward replaces the TPU Pallas kernels viscy_tpu/ops/pallas/
// fused_block.py::_stats_kernel (pass A) and ::_apply_kernel (pass B). It computes
//
//     out = shortcut + fc2(GRN(gelu(fc1(LN(x)))))        x, shortcut: (B, S, C)
//
// without ever writing an M-wide (M = 4C hidden) tensor to device memory:
//
// - pass A (stats): one block per (row tile, sample). It runs LN -> fc1 ->
//   exact-erf GELU on chip, M in chunks of 64, and writes the tile's sum over
//   rows of v^2 (v masked if a mask is given) to a (B, nTiles, M) float
//   scratch. Blocks run in no order, so there is no cross-block carry and no
//   float atomics: the caller reduces the scratch over tiles in a fixed order
//   (deterministic), then forms nx = gx / (mean_m gx + eps) on (B, M).
// - pass B (apply): the block recomputes its tile's v chunk by chunk,
//   applies GRN with nx, and accumulates fc2 over M into a float (rows, C)
//   accumulator in shared memory; the epilogue adds b2, applies the mask and
//   the residual, and writes the output tile once.
//
// Value semantics follow the flax modules op for op: LN statistics in f32
// with the fast variance max(E[x^2] - mu^2, 0); every intermediate rounded
// to the compute type T where flax rounds it (fc1/fc2 outputs, the bias
// adds, each GELU step, v * nx); the GRN combine gamma * t + beta + v in
// f32 and rounded to T before fc2. The weights arrive in T (the caller casts
// them, as flax casts its f32 parameters to the compute dtype); biases, LN
// and GRN parameters arrive in f32 and are rounded to T where flax rounds.
//
// What bounds it on an H100: the function needs 4 B S C M operations (fc1
// and fc2 once each) against about 3 B S C activation elements moved once
// (x, shortcut, out) plus the weights, i.e. ~1.3k FLOP/byte at (S, C, M) =
// (6400, 480, 1920) in bf16: compute. This kernel does 6 B S C M, because
// pass B recomputes fc1 rather than write the M-wide v to memory and read
// it back (2 B S M bytes each way; with the activations about 0.99 ms of
// HBM traffic at that shape, against its 1.17 ms operation bound), so it
// can reach at most 2/3 of the bound. Two paths:
//
// - bf16 with C and M multiples of 16 (every flagship block): both products
//   on the tensor cores through nvcuda::wmma (16x16x16 bf16, f32
//   accumulate). A fragments (LN output, GRN output) come from shared
//   memory; each warp loads its weight (B) fragments straight from L2, so
//   the fc1 loop has no staging and no barriers. Tiles of 64 or 32 rows,
//   the larger that lets two blocks share an SM (the fc2 accumulator is a
//   rows x C float tile in shared memory).
// - float32 (and bf16 at other C): products on the CUDA cores in f32, 2x4
//   register micro tiles over shared-memory tiles, 32-row tiles. TF32
//   tensor cores would not keep the f32 model exact, so f32 stays here.
//
// Every block reads all of w1 and w2 from L2. Moving to wgmma with TMA-fed,
// multi-stage weight tiles and register-resident fc2 accumulators is the
// way to the bound and is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block (8 warps) on both paths
constexpr int MC = 64;   // hidden columns per chunk
constexpr int CC = 64;   // fc2 output columns staged per step
constexpr float kSqrt2 = 1.4142135623730951f;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<bf16> {
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(bf16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ bf16 store(float v) { return __float2bfloat16_rn(v); }
};

// exact-erf GELU evaluated in T as the JAX kernel writes it:
// u * (erf(u / sqrt2) + 1) / 2 with sqrt2 itself rounded to T (a weakly
// typed constant in JAX), a rounding to T after every operation and erf
// evaluated in f32
template <typename T>
__device__ __forceinline__ float gelu_exact(float u) {
  float a = Num<T>::rnd(__fdiv_rn(u, Num<T>::rnd(kSqrt2)));
  float e = Num<T>::rnd(erff(a));
  float s = Num<T>::rnd(__fadd_rn(e, 1.0f));
  float p = Num<T>::rnd(__fmul_rn(u, s));
  return Num<T>::rnd(p * 0.5f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of the tile's rows into lns (row stride ldl), one warp per row;
// rowmask[r] = mask value (1 without a mask) for rows inside S, 0 past it
template <typename T, int TS>
__device__ void ln_tile(const T* __restrict__ xt, const float* __restrict__ mrow,
                        const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                        T* lns, int ldl, float* rowmask, int rows, int C, float eps_ln) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TS; r += NT / 32) {
    T* lrow = lns + (size_t)r * ldl;
    if (r < rows) {
      const T* xr = xt + (size_t)r * C;
      float s = 0.f, q = 0.f;
      for (int c = lane; c < C; c += 32) {
        T v = xr[c];
        float f = Num<T>::load(v);
        s += f;
        q += f * f;
        lrow[c] = v;
      }
      s = warp_sum(s);
      q = warp_sum(q);
      const float mu = s / (float)C;
      const float var = fmaxf(q / (float)C - mu * mu, 0.f);
      const float rstd = rsqrtf(var + eps_ln);
      __syncwarp();
      for (int c = lane; c < C; c += 32) {
        float f = Num<T>::load(lrow[c]);
        lrow[c] = Num<T>::store((f - mu) * (rstd * ln_s[c]) + ln_b[c]);
      }
    } else {
      for (int c = lane; c < C; c += 32) lrow[c] = Num<T>::store(0.f);
    }
    if (lane == 0) rowmask[r] = r < rows ? (mrow ? mrow[r] : 1.f) : 0.f;
  }
}

// fc1 output (f32 sum) of hidden column gm -> pass A value (v * mask)^2 or
// pass B value y = T(gamma * T(v * T(nx)) + beta + v)
template <typename T, bool APPLY>
__device__ __forceinline__ float hidden_value(float acc, int gm, float rmask, size_t bm,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ nx,
                                              const float* __restrict__ gg,
                                              const float* __restrict__ gb) {
  const float u = Num<T>::rnd(__fadd_rn(Num<T>::rnd(acc), Num<T>::rnd(b1[gm])));
  const float v = gelu_exact<T>(u);
  if (!APPLY) {
    const float vm = Num<T>::rnd(__fmul_rn(v, rmask));
    return vm * vm;
  }
  const float t = Num<T>::rnd(__fmul_rn(v, Num<T>::rnd(nx[bm + gm])));
  return Num<T>::rnd(__fadd_rn(__fadd_rn(__fmul_rn(gg[gm], t), gb[gm]), v));
}

// out = shortcut + mask * T(T(z) + T(b2)), one coalesced pass over the tile
template <typename T>
__device__ void store_out(const float* zacc, int ldz, const T* __restrict__ sct,
                          T* __restrict__ outt, const float* __restrict__ b2,
                          const float* rowmask, int rows, int C) {
  for (int e = threadIdx.x; e < rows * C; e += NT) {
    const int r = e / C, c = e % C;
    float z = Num<T>::rnd(zacc[r * ldz + c]);
    z = Num<T>::rnd(__fadd_rn(z, Num<T>::rnd(b2[c])));
    z = Num<T>::rnd(__fmul_rn(z, rowmask[r]));
    outt[e] = Num<T>::store(__fadd_rn(Num<T>::load(sct[e]), z));
  }
}

struct Args {
  const void* x;
  const void* sc;
  const float* mask;
  const float* ln_s;
  const float* ln_b;
  const void* w1;  // (M, C) in the compute type
  const float* b1;
  const float* nx;
  const float* gg;
  const float* gb;
  const void* w2;  // (C, M) in the compute type
  const float* b2;
  float* partial;
  void* out;
  int S, C, M;
  float eps_ln;
};

// ---------------------------------------------------------------------------
// CUDA-core path (float32; bf16 when C % 16 != 0)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int TS = 32;  // rows per block
constexpr int KC = 32;  // fc1 reduction depth staged per step
constexpr int WBUF = (KC * (MC + 1) > MC * (CC + 1)) ? KC * (MC + 1) : MC * (CC + 1);

__host__ __device__ constexpr size_t smem_bytes(bool apply, int elem, int c) {
  return (size_t)(apply ? TS * c : 0) * sizeof(float)  // fc2 accumulator
         + (size_t)TS * MC * sizeof(float)              // y / v^2 chunk
         + (size_t)WBUF * sizeof(float)                 // weight tile
         + (size_t)TS * sizeof(float)                   // row mask
         + (size_t)TS * c * elem;                       // LN output tile
}

template <typename T, bool APPLY>
__global__ void __launch_bounds__(NT) fmg_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = a.S, C = a.C, M = a.M;
  float* zacc = reinterpret_cast<float*>(smem_raw);
  float* ys = zacc + (APPLY ? TS * C : 0);
  float* wbuf = ys + TS * MC;
  float* rowmask = wbuf + WBUF;
  T* lns = reinterpret_cast<T*>(rowmask + TS);

  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row0 = tile * TS;
  const int rows = min(TS, S - row0);
  const size_t base = ((size_t)b * S + row0) * C;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);

  ln_tile<T, TS>(static_cast<const T*>(a.x) + base, a.mask ? a.mask + (size_t)b * S + row0 : nullptr,
                 a.ln_s, a.ln_b, lns, C, rowmask, rows, C, a.eps_ln);
  if (APPLY) {
    for (int i = tid; i < TS * C; i += NT) zacc[i] = 0.f;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 2;
  const int j0 = tx * 4;

  for (int m0 = 0; m0 < M; m0 += MC) {
    // fc1 chunk: u[TS, MC] = ln[TS, C] . w1[m0:m0+MC, :]^T
    float acc[2][4] = {};
    for (int k0 = 0; k0 < C; k0 += KC) {
      for (int e = tid; e < MC * KC; e += NT) {
        const int mm = e / KC, kk = e % KC;
        const int gm = m0 + mm, gk = k0 + kk;
        wbuf[kk * (MC + 1) + mm] = (gm < M && gk < C) ? Num<T>::load(w1[(size_t)gm * C + gk]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(KC, C - k0);
      const T* a0p = lns + (size_t)r0 * C + k0;
      const T* a1p = a0p + C;
      for (int kk = 0; kk < kmax; ++kk) {
        const float a0 = Num<T>::load(a0p[kk]);
        const float a1 = Num<T>::load(a1p[kk]);
        const float* wr = wbuf + kk * (MC + 1) + j0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(a0, wr[j], acc[0][j]);
          acc[1][j] = fmaf(a1, wr[j], acc[1][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gm = m0 + j0 + j;
        ys[(r0 + i) * MC + j0 + j] =
            gm < M ? hidden_value<T, APPLY>(acc[i][j], gm, rowmask[r0 + i], (size_t)b * M,
                                            a.b1, a.nx, a.gg, a.gb)
                   : 0.f;
      }
    }
    __syncthreads();

    if (!APPLY) {
      // column sums over the tile's rows in a fixed order
      if (tid < MC && m0 + tid < M) {
        float s = 0.f;
        for (int r = 0; r < TS; ++r) s += ys[r * MC + tid];
        a.partial[((size_t)b * gridDim.x + tile) * M + m0 + tid] = s;
      }
      __syncthreads();
      continue;
    }

    // fc2 chunk: zacc[TS, C] += y[TS, MC] . w2[:, m0:m0+MC]^T
    const int mmax = min(MC, M - m0);
    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int e = tid; e < CC * MC; e += NT) {
        const int cc = e / MC, mm = e % MC;
        const int gc = c0 + cc, gm = m0 + mm;
        wbuf[mm * (CC + 1) + cc] = (gc < C && gm < M) ? Num<T>::load(w2[(size_t)gc * M + gm]) : 0.f;
      }
      __syncthreads();
      float z[2][4] = {};
      const float* y0p = ys + r0 * MC;
      const float* y1p = y0p + MC;
      for (int mm = 0; mm < mmax; ++mm) {
        const float a0 = y0p[mm];
        const float a1 = y1p[mm];
        const float* wr = wbuf + mm * (CC + 1) + j0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[0][j] = fmaf(a0, wr[j], z[0][j]);
          z[1][j] = fmaf(a1, wr[j], z[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = c0 + j0 + j;
          if (gc < C) zacc[(r0 + i) * C + gc] += z[i][j];
        }
      }
      __syncthreads();
    }
  }

  if (APPLY) {
    store_out<T>(zacc, C, static_cast<const T*>(a.sc) + base, static_cast<T*>(a.out) + base,
                 a.b2, rowmask, rows, C);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tensor-core path (bf16, C % 16 == 0)
// ---------------------------------------------------------------------------
namespace tc {

namespace wmma = nvcuda::wmma;

constexpr int LDU = MC + 4;  // f32 fc1 output chunk
constexpr int LDY = MC + 8;  // bf16 y chunk

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~(size_t)127; }

struct Layout {
  size_t zacc, lns, ubuf, ybuf, rowmask, total;
};

// byte offsets of the shared buffers; every wmma pointer is 32-byte aligned
__host__ __device__ inline Layout layout(bool apply, int ts, int c) {
  Layout l{};
  size_t off = 0;
  l.zacc = off;
  off = align128(off + (apply ? (size_t)ts * (c + 4) * sizeof(float) : 0));
  l.lns = off;
  off = align128(off + (size_t)ts * (c + 8) * sizeof(bf16));
  l.ubuf = off;
  off = align128(off + (size_t)ts * LDU * sizeof(float));
  l.ybuf = off;
  off = align128(off + (apply ? (size_t)ts * LDY * sizeof(bf16) : 0));
  l.rowmask = off;
  l.total = off + (size_t)ts * sizeof(float);
  return l;
}

template <int TS, bool APPLY>
__global__ void __launch_bounds__(NT) fmg_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, C = a.C, M = a.M;
  const Layout L = layout(APPLY, TS, C);
  const int ldz = C + 4, ldl = C + 8;
  float* zacc = reinterpret_cast<float*>(smem + L.zacc);
  bf16* lns = reinterpret_cast<bf16*>(smem + L.lns);
  float* ubuf = reinterpret_cast<float*>(smem + L.ubuf);
  bf16* ybuf = reinterpret_cast<bf16*>(smem + L.ybuf);
  float* rowmask = reinterpret_cast<float*>(smem + L.rowmask);

  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  const int row0 = tile * TS;
  const int rows = min(TS, S - row0);
  const size_t base = ((size_t)b * S + row0) * C;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);

  ln_tile<bf16, TS>(static_cast<const bf16*>(a.x) + base,
                    a.mask ? a.mask + (size_t)b * S + row0 : nullptr, a.ln_s, a.ln_b, lns, ldl,
                    rowmask, rows, C, a.eps_ln);
  if (APPLY) {
    for (int i = tid; i < TS * ldz; i += NT) zacc[i] = 0.f;
  }
  __syncthreads();

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  // fc1: a (TS x 64) chunk is RF x 4 fragments; warp w owns column fragment
  // w % 4 and row fragments w / 4, w / 4 + 2, ... so its B fragment serves
  // all its rows
  constexpr int RF = TS / 16;
  constexpr int RPW = RF / 2;
  const int cf = warp % 4;

  for (int m0 = 0; m0 < M; m0 += MC) {
    // fc1 chunk: u[TS, 64] = ln[TS, C] . w1[m0:m0+64, :]^T; w1's rows read
    // in place as B in column-major order (element (k, n) at w1[n * C + k])
    FragC acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) wmma::fill_fragment(acc[i], 0.f);
    if (m0 + cf * 16 < M) {
      const bf16* w1p = w1 + (size_t)(m0 + cf * 16) * C;
      for (int k = 0; k < C; k += 16) {
        FragB fb;
        wmma::load_matrix_sync(fb, w1p + k, C);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, lns + (warp / 4 + 2 * i) * 16 * ldl + k, ldl);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      wmma::store_matrix_sync(ubuf + (warp / 4 + 2 * i) * 16 * LDU + cf * 16, acc[i], LDU,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int e = tid; e < TS * MC; e += NT) {
      const int r = e / MC, j = e % MC, gm = m0 + j;
      const float val = gm < M ? hidden_value<bf16, APPLY>(ubuf[r * LDU + j], gm, rowmask[r],
                                                           (size_t)b * M, a.b1, a.nx, a.gg, a.gb)
                               : 0.f;
      if (APPLY)
        ybuf[r * LDY + j] = __float2bfloat16_rn(val);
      else
        ubuf[r * LDU + j] = val;
    }
    __syncthreads();

    if (!APPLY) {
      if (tid < MC && m0 + tid < M) {
        float s = 0.f;
        for (int r = 0; r < TS; ++r) s += ubuf[r * LDU + tid];
        a.partial[((size_t)b * gridDim.x + tile) * M + m0 + tid] = s;
      }
      __syncthreads();
      continue;
    }

    // fc2 chunk: zacc[TS, C] += y[TS, 64] . w2[:, m0:m0+64]^T; fragment f =
    // (row rf, column cz) goes to warp f % 8, neighbours share a B fragment
    // (w2 read in place, element (k, n) at w2[n * M + k])
    const int kend = min(MC, M - m0);
    for (int f = warp; f < RF * (C / 16); f += NT / 32) {
      const int rf = f % RF, cz = f / RF;
      float* zp = zacc + rf * 16 * ldz + cz * 16;
      const bf16* w2p = w2 + (size_t)cz * 16 * M + m0;
      FragC fz;
      wmma::load_matrix_sync(fz, zp, ldz, wmma::mem_row_major);
      for (int kk = 0; kk < kend; kk += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ybuf + rf * 16 * LDY + kk, LDY);
        wmma::load_matrix_sync(fb, w2p + kk, M);
        wmma::mma_sync(fz, fa, fb, fz);
      }
      wmma::store_matrix_sync(zp, fz, ldz, wmma::mem_row_major);
    }
    __syncthreads();
  }

  if (APPLY) {
    store_out<bf16>(zacc, ldz, static_cast<const bf16*>(a.sc) + base,
                    static_cast<bf16*>(a.out) + base, a.b2, rowmask, rows, C);
  }
}

}  // namespace tc

// largest dynamic shared memory a block may take (H100: 227 KB)
int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

bool use_tc(int dtype, int c, int m) { return dtype == 1 && c % 16 == 0 && m % 16 == 0; }

// rows per block for pass `apply` at (dtype, C, M); 0 when no path fits.
// Tensor-core path: the larger tile that lets two blocks share an SM, else
// the larger that fits at all.
int tile_rows(int dtype, bool apply, int c, int m) {
  const size_t limit = (size_t)max_smem();
  if (use_tc(dtype, c, m)) {
    for (int ts : {64, 32})
      if (2 * (tc::layout(apply, ts, c).total + 1024) <= limit) return ts;
    for (int ts : {64, 32})
      if (tc::layout(apply, ts, c).total <= limit) return ts;
    return 0;
  }
  if (dtype == 0 || dtype == 1)
    return simt::smem_bytes(apply, dtype == 0 ? 4 : 2, c) <= limit ? simt::TS : 0;
  return 0;
}

template <typename K>
int launch_kernel(K kern, size_t smem, int ts, int B, const Args& a, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + ts - 1) / ts, B);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool APPLY>
int launch(int dtype, const Args& a, int B, void* stream) {
  if (B <= 0 || B > 65535 || a.S <= 0 || a.C <= 0 || a.M <= 0) return (int)cudaErrorInvalidValue;
  const int ts = tile_rows(dtype, APPLY, a.C, a.M);
  if (ts == 0) return (int)cudaErrorInvalidValue;
  if (use_tc(dtype, a.C, a.M)) {
    const size_t smem = tc::layout(APPLY, ts, a.C).total;
    return ts == 64 ? launch_kernel(tc::fmg_kernel<64, APPLY>, smem, ts, B, a, stream)
                    : launch_kernel(tc::fmg_kernel<32, APPLY>, smem, ts, B, a, stream);
  }
  const size_t smem = simt::smem_bytes(APPLY, dtype == 0 ? 4 : 2, a.C);
  return dtype == 0 ? launch_kernel(simt::fmg_kernel<float, APPLY>, smem, ts, B, a, stream)
                    : launch_kernel(simt::fmg_kernel<bf16, APPLY>, smem, ts, B, a, stream);
}

// ---------------------------------------------------------------------------
// backward: passes C and D
// ---------------------------------------------------------------------------
//
// Replaces viscy_tpu/ops/pallas/fused_block.py::_bwd_stats_kernel (pass C)
// and ::_bwd_main_kernel (pass D). Like the forward, nothing M-wide reaches
// device memory: every block recomputes fc1 -> GELU for its rows and hidden
// columns. The TPU kernels carry the weight-gradient sums from one
// grid step to the next; Hopper blocks run in no order, so here every sum
// across blocks goes to a per-block partial that the caller reduces in a
// fixed order (no float atomics: two runs give bit-identical gradients).
//
// - A prep grid writes the LayerNorm output, dz and the row statistics once
//   per call (C-wide scratch), so no grid recomputes the LayerNorm.
// - Column-ordered grids (pass C, and the weight-gradient half of pass D):
//   a block owns one 64-wide hidden chunk and a fixed run of row tiles of
//   one sample (a static schedule: grid = chunks x (B * splits)). Per tile
//   it computes u = LN(x) . w1_chunk^T and dy = dz . w2_chunk on the tensor
//   cores, the chunk's elementwise GRN/GELU terms, and accumulates
//     pass C: P[b, m] = sum dy * v, d grn_beta = sum dy (registers),
//             d fc2 (C x 64) += dz^T . y, d fc2 bias = sum dz;
//     pass D: d fc1 (64 x C) += du^T . LN(x), d fc1 bias = sum du.
//   The weight-gradient slab of a block lives in its own slot of a float
//   partial (read, added and written back per tile; it stays in L2).
// - Row-ordered grid (the dx half of pass D): a block owns a row tile,
//   loops over all hidden chunks to accumulate dln = du . w1 in shared
//   memory, then runs the LayerNorm backward and writes dx, with per-tile
//   partials of d ln_scale and d ln_bias.
//
// The function needs 8 B S C M operations (dy, d fc2, d fc1, dln); the
// kernels do 18 (fc1 and dy are each computed in all three grids), so they can reach
// at most 4/9 of the operation bound. bf16 with C, M multiples of 16 runs
// every product through nvcuda::wmma (bf16 in, f32 accumulate); float32 (and
// bf16 at other C) runs them on the CUDA cores in f32.
namespace bwd {

constexpr int LDU = MC + 4;  // f32 u / dy chunk
constexpr int LDH = MC + 8;  // y or du chunk in the compute type
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

enum Mode { kStats = 0, kWgrad = 1, kDx = 2 };

struct BwdArgs {
  const void* x;
  const void* g;
  const float* mask;
  const float* ln_s;
  const float* ln_b;
  const void* w1;  // (M, C) in the compute type
  const float* b1;
  const float* nx;  // (B, M)
  const float* gg;
  const float* gb;
  const void* w2;  // (C, M) in the compute type
  const float* coef1;  // (B, M)
  const float* coef2;  // (B, M)
  float* p_part;    // (B * splits, M)
  float* dbg_part;  // (B * splits, M)
  float* dw2_part;  // (B * splits, C, M)
  float* db2_part;  // (B * splits, C)
  void* dx;         // (B, S, C)
  float* dw1_part;  // (B * splits, M, C)
  float* db1_part;  // (B * splits, M)
  float* dls_part;  // (B * row tiles, C)
  float* dlb_part;  // (B * row tiles, C)
  void* ln_buf;     // (B, S, C) LayerNorm output in the compute type
  void* dz_buf;     // (B, S, C) dz = T(g) * mask in the compute type
  float* mu_buf;    // (B, S) row means
  float* rstd_buf;  // (B, S) row 1 / std
  int S, C, M, splits;
  float eps_ln;
};

struct Layout {
  size_t lns, dzs, ubuf, dybuf, hbuf, rowmask, mu, rstd, dln, total;
};

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~(size_t)127; }

__host__ __device__ inline Layout layout(bool dx, int ts, int c, int elem) {
  Layout l{};
  size_t off = 0;
  l.lns = off;
  off = align128(off + (size_t)ts * (c + 8) * elem);
  l.dzs = off;
  off = align128(off + (size_t)ts * (c + 8) * elem);
  l.ubuf = off;
  off = align128(off + (size_t)ts * LDU * sizeof(float));
  l.dybuf = off;
  off = align128(off + (size_t)ts * LDU * sizeof(float));
  l.hbuf = off;
  off = align128(off + (size_t)ts * LDH * elem);
  l.rowmask = off;
  off = align128(off + (size_t)ts * sizeof(float));
  l.mu = off;
  off = align128(off + (size_t)ts * sizeof(float));
  l.rstd = off;
  off = align128(off + (size_t)ts * sizeof(float));
  l.dln = off;
  l.total = off + (dx ? (size_t)ts * (c + 4) * sizeof(float) : 0);
  return l;
}

__device__ __forceinline__ float gelu_grad_f32(float u) {
  const float phi = expf(-0.5f * u * u) * kInvSqrt2Pi;
  const float cdf = 0.5f * (erff(u / kSqrt2) + 1.0f);
  return cdf + u * phi;
}

// acc(i, j) (+)= sum_k a(i, k) b(k, j), i < I, j < J, on the CUDA cores in
// f32: each thread owns a 4 x 4 output tile and sums k in order
template <typename FA, typename FB>
__device__ void simt_gemm(float* acc, int ldc, int I, int J, int K, FA a, FB b, bool zero) {
  const int ti = (I + 3) / 4, tj = (J + 3) / 4;
  for (int t = threadIdx.x; t < ti * tj; t += NT) {
    const int i0 = (t / tj) * 4, j0 = (t % tj) * 4;
    float c[4][4] = {};
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        av[q] = i0 + q < I ? a(i0 + q, k) : 0.f;
        bv[q] = j0 + q < J ? b(k, j0 + q) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[p][q] = fmaf(av[p], bv[q], c[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i0 + p < I && j0 + q < J) {
          float* o = acc + (size_t)(i0 + p) * ldc + j0 + q;
          *o = zero ? c[p][q] : *o + c[p][q];
        }
  }
}

namespace wmma = nvcuda::wmma;

template <typename L>
__device__ __forceinline__ const bf16* a_at(const bf16* a, int ld, int i, int k) {
  if constexpr (std::is_same<L, wmma::row_major>::value)
    return a + (size_t)i * ld + k;
  else
    return a + i + (size_t)k * ld;
}

template <typename L>
__device__ __forceinline__ const bf16* b_at(const bf16* b, int ld, int k, int j) {
  if constexpr (std::is_same<L, wmma::row_major>::value)
    return b + (size_t)k * ld + j;
  else
    return b + k + (size_t)j * ld;
}

// acc (I x J, row-major float, shared or global) (+)= A (I x K) . B (K x J);
// I, J, K multiples of 16. A work item is R row fragments of one column
// fragment: each B fragment is loaded once for the R products. Warp w takes
// items w, w + 8, ...
template <typename LA, typename LB, int R>
__device__ void wmma_gemm_r(float* acc, int ldc, int I, int J, int K, const bf16* A, int lda,
                            const bf16* B, int ldb, bool zero) {
  const int warp = threadIdx.x / 32;
  const int fin = I / 16, fjn = J / 16, groups = (fin + R - 1) / R;
  for (int item = warp; item < fjn * groups; item += NT / 32) {
    const int fj = item % fjn, f0 = (item / fjn) * R;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (f0 + r >= fin) continue;
      if (zero)
        wmma::fill_fragment(fc[r], 0.f);
      else
        wmma::load_matrix_sync(fc[r], acc + (size_t)(f0 + r) * 16 * ldc + fj * 16, ldc,
                               wmma::mem_row_major);
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fb, b_at<LB>(B, ldb, k, fj * 16), ldb);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (f0 + r >= fin) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
        wmma::load_matrix_sync(fa, a_at<LA>(A, lda, (f0 + r) * 16, k), lda);
        wmma::mma_sync(fc[r], fa, fb, fc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (f0 + r >= fin) continue;
      wmma::store_matrix_sync(acc + (size_t)(f0 + r) * 16 * ldc + fj * 16, fc[r], ldc,
                              wmma::mem_row_major);
    }
  }
}

// two row fragments share each B fragment when that still keeps all eight
// warps busy, else one
template <typename LA, typename LB>
__device__ void wmma_gemm(float* acc, int ldc, int I, int J, int K, const bf16* A, int lda,
                          const bf16* B, int ldb, bool zero) {
  if ((J / 16) * ((I / 16 + 1) / 2) >= NT / 32)
    wmma_gemm_r<LA, LB, 2>(acc, ldc, I, J, K, A, lda, B, ldb, zero);
  else
    wmma_gemm_r<LA, LB, 1>(acc, ldc, I, J, K, A, lda, B, ldb, zero);
}

// one product of the backward: acc (I x J) (+)= A . B with A and B of the
// compute type in the given layouts (row_major: element (i, k) at i*ld + k)
template <typename T, bool TC, typename LA, typename LB>
__device__ void gemm(float* acc, int ldc, int I, int J, int K, const T* A, int lda, const T* B,
                     int ldb, bool zero) {
  if constexpr (TC) {
    wmma_gemm<LA, LB>(acc, ldc, I, J, K, reinterpret_cast<const bf16*>(A), lda,
                      reinterpret_cast<const bf16*>(B), ldb, zero);
  } else {
    constexpr bool ra = std::is_same<LA, wmma::row_major>::value;
    constexpr bool rb = std::is_same<LB, wmma::row_major>::value;
    simt_gemm(
        acc, ldc, I, J, K,
        [=](int i, int k) {
          return Num<T>::load(ra ? A[(size_t)i * lda + k] : A[i + (size_t)k * lda]);
        },
        [=](int k, int j) {
          return Num<T>::load(rb ? B[(size_t)k * ldb + j] : B[k + (size_t)j * ldb]);
        },
        zero);
  }
}

// LayerNorm output, dz = T(g) * mask and the row statistics of every row,
// written once per backward call (C-wide: nothing M-wide reaches memory) so
// that no grid recomputes the LayerNorm per hidden chunk. One warp per row,
// the arithmetic of ln_tile.
template <typename T>
__global__ void __launch_bounds__(NT) prep_kernel(BwdArgs a, long long n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * (NT / 32) + warp;
  if (r >= n_rows) return;
  const int C = a.C;
  const T* xr = static_cast<const T*>(a.x) + r * C;
  const T* gr = static_cast<const T*>(a.g) + r * C;
  T* lr = static_cast<T*>(a.ln_buf) + r * C;
  T* dr = static_cast<T*>(a.dz_buf) + r * C;
  float s = 0.f, q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float f = Num<T>::load(xr[c]);
    s += f;
    q += f * f;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float mu = s / (float)C;
  const float var = fmaxf(q / (float)C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + a.eps_ln);
  const float mk = a.mask ? a.mask[r] : 1.f;
  for (int c = lane; c < C; c += 32) {
    const float f = Num<T>::load(xr[c]);
    lr[c] = Num<T>::store((f - mu) * (rstd * a.ln_s[c]) + a.ln_b[c]);
    dr[c] = Num<T>::store(Num<T>::rnd(__fmul_rn(Num<T>::load(gr[c]), mk)));
  }
  if (lane == 0) {
    a.mu_buf[r] = mu;
    a.rstd_buf[r] = rstd;
  }
}

// rows [0, rows) of a (., C) array into a (TS, C + 8) shared tile, 16-byte
// vectors where rows allow; rows past `rows` are zero
template <typename T, int TS>
__device__ void copy_rows(T* dst, const T* src, int C, int rows) {
  const int ldl = C + 8;
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0) {
    const int vpr = C / V;
    for (int e = threadIdx.x; e < TS * vpr; e += NT) {
      const int r = e / vpr, v = e % vpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * C) + v);
      reinterpret_cast<uint4*>(dst + (size_t)r * ldl)[v] = val;
    }
  } else {
    for (int e = threadIdx.x; e < TS * C; e += NT) {
      const int r = e / C, c = e % C;
      dst[(size_t)r * ldl + c] = r < rows ? src[(size_t)r * C + c] : Num<T>::store(0.f);
    }
  }
}

// the tile's LayerNorm output into lns, its dz into dzs, its mask values
// (0 past S), means and 1 / std
template <typename T, int TS>
__device__ void load_tile(const BwdArgs& a, int b, int row0, int rows, T* lns, T* dzs,
                          float* rowmask, float* mu, float* rstd) {
  const size_t r0 = (size_t)b * a.S + row0;
  copy_rows<T, TS>(lns, static_cast<const T*>(a.ln_buf) + r0 * a.C, a.C, rows);
  copy_rows<T, TS>(dzs, static_cast<const T*>(a.dz_buf) + r0 * a.C, a.C, rows);
  for (int r = threadIdx.x; r < TS; r += NT) {
    const bool in = r < rows;
    rowmask[r] = in ? (a.mask ? a.mask[r0 + r] : 1.f) : 0.f;
    mu[r] = in ? a.mu_buf[r0 + r] : 0.f;
    rstd[r] = in ? a.rstd_buf[r0 + r] : 0.f;
  }
}

// u = LN . w1_chunk^T and dy = dz . w2_chunk for hidden columns [m0, m0 + mw)
template <typename T, bool TC, int TS>
__device__ void chunk_products(const BwdArgs& a, const T* lns, const T* dzs, int m0, int mw,
                               float* ubuf, float* dybuf) {
  const int C = a.C, M = a.M, ldl = C + 8;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  // w1 rows read in place as B column-major: element (k, n) at w1[(m0 + n) * C + k]
  gemm<T, TC, wmma::row_major, wmma::col_major>(ubuf, LDU, TS, mw, C, lns, ldl,
                                                w1 + (size_t)m0 * C, C, true);
  // w2 as B row-major: element (k, n) at w2[k * M + m0 + n]
  gemm<T, TC, wmma::row_major, wmma::row_major>(dybuf, LDU, TS, mw, C, dzs, ldl, w2 + m0, M,
                                                true);
}

// the chunk's elementwise terms. kStats: hbuf = y, ubuf = dy * v (dybuf
// keeps dy). kWgrad / kDx: hbuf = T(du), ubuf = du (f32). Zero past the
// chunk's width and (du) past the tile's rows.
template <typename T, int MODE, int TS>
__device__ void chunk_terms(const BwdArgs& a, int b, int m0, int mw, int rows, float* ubuf,
                            const float* dybuf, T* hbuf, const float* rowmask) {
  const size_t bm = (size_t)b * a.M;
  for (int e = threadIdx.x; e < TS * MC; e += NT) {
    const int r = e / MC, j = e % MC, gm = m0 + j;
    float h = 0.f, s = 0.f;
    if (j < mw) {
      const float u = Num<T>::rnd(__fadd_rn(Num<T>::rnd(ubuf[r * LDU + j]), Num<T>::rnd(a.b1[gm])));
      const float v = gelu_exact<T>(u);
      const float dy = dybuf[r * LDU + j];
      if (MODE == kStats) {
        const float t = Num<T>::rnd(__fmul_rn(v, Num<T>::rnd(a.nx[bm + gm])));
        h = Num<T>::rnd(__fadd_rn(__fadd_rn(__fmul_rn(a.gg[gm], t), a.gb[gm]), v));
        s = __fmul_rn(dy, v);
      } else if (r < rows) {
        // the statistics path saw v * mask, so its cotangent carries mask^2
        const float mk = rowmask[r];
        const float sv = __fmul_rn(v, __fmul_rn(mk, mk));
        const float dv = __fadd_rn(__fmul_rn(dy, a.coef1[bm + gm]), __fmul_rn(sv, a.coef2[bm + gm]));
        s = __fmul_rn(dv, gelu_grad_f32(u));
        h = Num<T>::rnd(s);
      }
    }
    ubuf[r * LDU + j] = s;
    hbuf[r * LDH + j] = Num<T>::store(h);
  }
}

template <typename T, bool TC, int TS, int MODE>
__global__ void __launch_bounds__(NT) bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, C = a.C, M = a.M, ldl = C + 8, tid = threadIdx.x;
  const Layout L = layout(MODE == kDx, TS, C, sizeof(T));
  T* lns = reinterpret_cast<T*>(smem + L.lns);
  T* dzs = reinterpret_cast<T*>(smem + L.dzs);
  float* ubuf = reinterpret_cast<float*>(smem + L.ubuf);
  float* dybuf = reinterpret_cast<float*>(smem + L.dybuf);
  T* hbuf = reinterpret_cast<T*>(smem + L.hbuf);
  float* rowmask = reinterpret_cast<float*>(smem + L.rowmask);
  float* mu = reinterpret_cast<float*>(smem + L.mu);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int nt = (S + TS - 1) / TS;

  if constexpr (MODE == kDx) {
    float* dln = reinterpret_cast<float*>(smem + L.dln);
    const int ldz = C + 4;
    const int tile = blockIdx.x, b = blockIdx.y;
    const int row0 = tile * TS, rows = min(TS, S - row0);
    load_tile<T, TS>(a, b, row0, rows, lns, dzs, rowmask, mu, rstd);
    for (int i = tid; i < TS * ldz; i += NT) dln[i] = 0.f;
    __syncthreads();
    const T* w1 = static_cast<const T*>(a.w1);
    for (int m0 = 0; m0 < M; m0 += MC) {
      const int mw = min(MC, M - m0);
      chunk_products<T, TC, TS>(a, lns, dzs, m0, mw, ubuf, dybuf);
      __syncthreads();
      chunk_terms<T, MODE, TS>(a, b, m0, mw, rows, ubuf, dybuf, hbuf, rowmask);
      __syncthreads();
      // dln (TS x C) += du (TS x mw) . w1[m0:m0+mw, :] (row-major, ld C)
      gemm<T, TC, wmma::row_major, wmma::row_major>(dln, ldz, TS, C, mw, hbuf, LDH,
                                                    w1 + (size_t)m0 * C, C, false);
      __syncthreads();
    }
    const T* xt = static_cast<const T*>(a.x) + ((size_t)b * S + row0) * C;
    // per-tile partials of d ln_scale = sum dln * xhat and d ln_bias = sum dln
    const size_t pt = ((size_t)b * nt + tile) * C;
    for (int c = tid; c < C; c += NT) {
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float xhat = (Num<T>::load(xt[(size_t)r * C + c]) - mu[r]) * rstd[r];
        const float d = dln[r * ldz + c];
        s1 += d * xhat;
        s2 += d;
      }
      a.dls_part[pt + c] = s1;
      a.dlb_part[pt + c] = s2;
    }
    // LayerNorm backward, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    T* dxt = static_cast<T*>(a.dx) + ((size_t)b * S + row0) * C;
    for (int r = warp; r < rows; r += NT / 32) {
      float sd = 0.f, sdx = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (Num<T>::load(xt[(size_t)r * C + c]) - mu[r]) * rstd[r];
        const float dxhat = dln[r * ldz + c] * a.ln_s[c];
        sd += dxhat;
        sdx += dxhat * xhat;
      }
      const float mean_d = warp_sum(sd) / (float)C;
      const float mean_dx = warp_sum(sdx) / (float)C;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (Num<T>::load(xt[(size_t)r * C + c]) - mu[r]) * rstd[r];
        const float dxhat = dln[r * ldz + c] * a.ln_s[c];
        dxt[(size_t)r * C + c] = Num<T>::store(rstd[r] * (dxhat - mean_d - xhat * mean_dx));
      }
    }
  } else {
    const int chunk = blockIdx.x, grp = blockIdx.y;
    const int b = grp / a.splits, split = grp % a.splits;
    const int m0 = chunk * MC, mw = min(MC, M - m0);
    const int per = (nt + a.splits - 1) / a.splits;
    const int t_begin = split * per, t_end = min(nt, t_begin + per);
    float acc0 = 0.f, acc1 = 0.f;  // thread tid < MC owns hidden column m0 + tid
    for (int t = t_begin; t < t_end; ++t) {
      const int row0 = t * TS, rows = min(TS, S - row0);
      load_tile<T, TS>(a, b, row0, rows, lns, dzs, rowmask, mu, rstd);
      __syncthreads();
      chunk_products<T, TC, TS>(a, lns, dzs, m0, mw, ubuf, dybuf);
      __syncthreads();
      chunk_terms<T, MODE, TS>(a, b, m0, mw, rows, ubuf, dybuf, hbuf, rowmask);
      __syncthreads();
      if (tid < MC) {
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < TS; ++r) {
          s0 += ubuf[r * LDU + tid];
          s1 += dybuf[r * LDU + tid];
        }
        acc0 += s0;
        acc1 += s1;
      }
      if (MODE == kStats) {
        // d fc2 slab (C x mw, ld M) += dz^T (C x TS) . y (TS x mw)
        gemm<T, TC, wmma::col_major, wmma::row_major>(
            a.dw2_part + (size_t)grp * C * M + m0, M, C, mw, TS, dzs, ldl, hbuf, LDH, false);
        if (chunk == 0) {
          for (int c = tid; c < C; c += NT) {
            float s = 0.f;
            for (int r = 0; r < TS; ++r) s += Num<T>::load(dzs[r * ldl + c]);
            a.db2_part[(size_t)grp * C + c] += s;
          }
        }
      } else {
        // d fc1 slab (mw x C, ld C) += du^T (mw x TS) . LN (TS x C)
        gemm<T, TC, wmma::col_major, wmma::row_major>(
            a.dw1_part + ((size_t)grp * M + m0) * C, C, mw, C, TS, hbuf, LDH, lns, ldl, false);
      }
      __syncthreads();
    }
    if (tid < mw) {
      const size_t o = (size_t)grp * M + m0 + tid;
      if (MODE == kStats) {
        a.p_part[o] = acc0;
        a.dbg_part[o] = acc1;
      } else {
        a.db1_part[o] = acc0;
      }
    }
  }
}

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return v;
}

// rows per block of the column-ordered (dx = false) or row-ordered grid; 0
// when no tile fits the shared memory
int tile_rows(int dtype, bool dx, int c) {
  const size_t limit = (size_t)max_smem();
  const int elem = dtype == 0 ? 4 : 2;
  // row-ordered grid: the larger tile that lets two blocks share an SM;
  // column-ordered grids: the largest tile (both measured faster than the
  // other choice)
  if (dx)
    for (int ts : {64, 32, 16})
      if (2 * (layout(dx, ts, c, elem).total + 1024) <= limit) return ts;
  for (int ts : {64, 32, 16})
    if (layout(dx, ts, c, elem).total <= limit) return ts;
  return 0;
}

template <typename T, bool TC, int MODE>
int launch_ts(int ts, dim3 grid, size_t smem, const BwdArgs& a, void* stream) {
  auto go = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  };
  if (ts == 64) return go(bwd_kernel<T, TC, 64, MODE>);
  if (ts == 32) return go(bwd_kernel<T, TC, 32, MODE>);
  return go(bwd_kernel<T, TC, 16, MODE>);
}

template <int MODE>
int launch(int dtype, const BwdArgs& a, int B, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || B > 65535 || a.S <= 0 || a.C <= 0 || a.M <= 0 || a.splits <= 0)
    return (int)cudaErrorInvalidValue;
  const bool dx = MODE == kDx;
  const int ts = tile_rows(dtype, dx, a.C);
  if (ts == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(dx, ts, a.C, dtype == 0 ? 4 : 2).total;
  const dim3 grid = dx ? dim3((a.S + ts - 1) / ts, B) : dim3((a.M + MC - 1) / MC, B * a.splits);
  if (use_tc(dtype, a.C, a.M)) return launch_ts<bf16, true, MODE>(ts, grid, smem, a, stream);
  return dtype == 0 ? launch_ts<float, false, MODE>(ts, grid, smem, a, stream)
                    : launch_ts<bf16, false, MODE>(ts, grid, smem, a, stream);
}

}  // namespace bwd

}  // namespace

extern "C" {

// rows per block of the stats pass: the caller sizes the (B, ceil(S / rows),
// M) scratch from it. 0 means no path takes this (dtype, C, M).
int fmg_stats_tile_rows(int dtype, int c, int m) { return tile_rows(dtype, false, c, m); }

// 1 when the apply pass has a path for (dtype, C, M)
int fmg_apply_supported(int dtype, int c, int m) { return tile_rows(dtype, true, c, m) > 0; }

// dtype: 0 = float32, 1 = bfloat16 for x, shortcut, out, w1 (M, C) and
// w2 (C, M); everything else float32
int fmg_stats(int dtype, const void* x, const float* mask, const float* ln_s,
              const float* ln_b, const void* w1, const float* b1, float* partial, int B,
              int S, int C, int M, float eps_ln, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a{x, nullptr, mask, ln_s, ln_b, w1, b1, nullptr, nullptr, nullptr, nullptr, nullptr,
         partial, nullptr, S, C, M, eps_ln};
  return launch<false>(dtype, a, B, stream);
}

int fmg_apply(int dtype, const void* x, const void* sc, const float* mask, const float* ln_s,
              const float* ln_b, const void* w1, const float* b1, const float* nx,
              const float* gg, const float* gb, const void* w2, const float* b2, void* out,
              int B, int S, int C, int M, float eps_ln, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a{x, sc, mask, ln_s, ln_b, w1, b1, nx, gg, gb, w2, b2, nullptr, out, S, C, M, eps_ln};
  return launch<true>(dtype, a, B, stream);
}

// backward plan at (dtype, B, S, C, M): plan[0] = splits of each sample's row
// tiles in the column-ordered grids (enough blocks for two per SM), plan[1]
// = rows per tile of the row-ordered dx grid. The caller sizes the partials
// from them. Returns 0 when no tile fits.
int fmg_bwd_plan(int dtype, int B, int S, int C, int M, int* plan) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || S <= 0 || C <= 0 || M <= 0) return 0;
  const int ts_col = bwd::tile_rows(dtype, false, C);
  const int ts_dx = bwd::tile_rows(dtype, true, C);
  if (ts_col == 0 || ts_dx == 0) return 0;
  const int chunks = (M + MC - 1) / MC;
  const int nt = (S + ts_col - 1) / ts_col;
  const int want = 2 * bwd::sm_count();
  int splits = (want + chunks * B - 1) / (chunks * B);
  splits = splits < 1 ? 1 : (splits > nt ? nt : splits);
  plan[0] = splits;
  plan[1] = ts_dx;
  return 1;
}

// pass C: first the LayerNorm output, dz and row statistics into the
// (B, S, C) / (B, S) scratch buffers (pass D reads them too), then the
// partials of P (B * splits, M), d grn_beta (B * splits, M), d fc2
// (B * splits, C, M) and d fc2 bias (B * splits, C), all zero on entry
int fmg_bwd_stats(int dtype, const void* x, const void* g, const float* mask, const float* ln_s,
                  const float* ln_b, const void* w1, const float* b1, const float* nx,
                  const float* gg, const float* gb, const void* w2, float* p_part,
                  float* dbg_part, float* dw2_part, float* db2_part, void* ln_buf, void* dz_buf,
                  float* mu_buf, float* rstd_buf, int B, int S, int C, int M, int splits,
                  float eps_ln, void* stream) {
  bwd::BwdArgs a{};
  a.ln_buf = ln_buf, a.dz_buf = dz_buf, a.mu_buf = mu_buf, a.rstd_buf = rstd_buf;
  a.x = x, a.g = g, a.mask = mask, a.ln_s = ln_s, a.ln_b = ln_b, a.w1 = w1, a.b1 = b1;
  a.nx = nx, a.gg = gg, a.gb = gb, a.w2 = w2;
  a.p_part = p_part, a.dbg_part = dbg_part, a.dw2_part = dw2_part, a.db2_part = db2_part;
  a.S = S, a.C = C, a.M = M, a.splits = splits, a.eps_ln = eps_ln;
  if ((dtype != 0 && dtype != 1) || B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)B * S;
  const dim3 grid((unsigned)((n_rows + NT / 32 - 1) / (NT / 32)));
  if (dtype == 0)
    bwd::prep_kernel<float><<<grid, NT, 0, (cudaStream_t)stream>>>(a, n_rows);
  else
    bwd::prep_kernel<bf16><<<grid, NT, 0, (cudaStream_t)stream>>>(a, n_rows);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return bwd::launch<bwd::kStats>(dtype, a, B, stream);
}

// pass D, after pass C on the same stream (it reads pass C's scratch
// buffers): the column-ordered weight-gradient grid (partials of d fc1
// (B * splits, M, C) and its bias (B * splits, M), zero on entry), then the
// row-ordered grid writing dx (B, S, C) and per-tile partials of d
// ln_scale / d ln_bias (B * ceil(S / plan[1]), C)
int fmg_bwd_main(int dtype, const void* x, const void* g, const float* mask, const float* ln_s,
                 const float* ln_b, const void* w1, const float* b1, const void* w2,
                 const float* coef1, const float* coef2, void* dx, float* dw1_part,
                 float* db1_part, float* dls_part, float* dlb_part, void* ln_buf, void* dz_buf,
                 float* mu_buf, float* rstd_buf, int B, int S, int C, int M, int splits,
                 float eps_ln, void* stream) {
  bwd::BwdArgs a{};
  a.ln_buf = ln_buf, a.dz_buf = dz_buf, a.mu_buf = mu_buf, a.rstd_buf = rstd_buf;
  a.x = x, a.g = g, a.mask = mask, a.ln_s = ln_s, a.ln_b = ln_b, a.w1 = w1, a.b1 = b1;
  a.w2 = w2, a.coef1 = coef1, a.coef2 = coef2;
  a.dx = dx, a.dw1_part = dw1_part, a.db1_part = db1_part, a.dls_part = dls_part,
  a.dlb_part = dlb_part;
  a.S = S, a.C = C, a.M = M, a.splits = splits, a.eps_ln = eps_ln;
  const int rc = bwd::launch<bwd::kWgrad>(dtype, a, B, stream);
  if (rc) return rc;
  return bwd::launch<bwd::kDx>(dtype, a, B, stream);
}

}  // extern "C"
