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
// and ::_bwd_main_kernel (pass D). The TPU kernels recompute fc1 per row
// tile and carry the weight-gradient sums from one grid step to the next in
// VMEM. Hopper blocks run in no order and hold at most 227 KB of shared
// memory, so here the backward is a short chain of ordinary tiled products,
// each with its elementwise work fused into its epilogue:
//
//   prep      LayerNorm output, dz = T(g) * mask, row mean and 1 / std,
//             written once (C wide); per-block column sums of dz (d fc2 bias)
//   front C   u = LN . w1^T and dy = dz . w2 for one (row tile, hidden tile);
//             epilogue: v = GELU(u), y in T to an M-wide scratch, per-row-tile
//             column sums of dy * v (P) and dy (d grn_beta)
//   d fc2     dz^T . y, split over the rows (K = B S)
//   (the (B, M) glue runs in torch between the passes)
//   front D   the same dual product; epilogue: du in T to an M-wide scratch,
//             per-row-tile column sums of du in f32 (d fc1 bias)
//   d fc1     du^T . LN, split over the rows
//   dln       du . w1 (K = M) in f32 to a C-wide scratch
//   LN bwd    one warp per row: dx, per-block column sums of dln * xhat and
//             dln (d ln_scale, d ln_bias)
//
// Row tiles of the front products never straddle two samples (P is a sum
// per sample). Every sum across blocks goes to a partial slot of its own,
// which the caller reduces in a fixed order: no float atomics, and two runs
// give bit-identical gradients.
//
// One main loop serves every product: a block tile of 8 warps (2 along its
// rows, 4 along its columns), operand tiles brought into a ring of
// shared-memory stages by cp.async (zero-filled past the valid rows,
// columns and K), so the next tiles load while the current one is
// multiplied. bf16 runs on the tensor cores (ldmatrix, transposing where an
// operand is stored with its M or N dimension contiguous, and mma.sync
// m16n8k16 with f32 accumulators in registers); float32 runs the same
// tiling on the CUDA cores, each thread owning exactly the accumulator
// elements of the mma layout, so the epilogues are shared. The front
// products take 64 x 128 tiles (two products' accumulators in 64 registers
// a thread), so two blocks share an SM and one block's long elementwise
// epilogue overlaps the other's main loop; the others take 128 x 128. Both
// step K by 64.
//
// What bounds it on an H100: the function needs 8 B S C M operations (dy,
// d fc2, d fc1, dln); these kernels do 14 (front D recomputes u and dy
// rather than store dy in f32). The M-wide scratch moves 2 B S M elements
// of T out and 3 B S M back in (y read once, du twice), dln 4 B S C bytes
// each way: at (B, S, C, M) = (16, 9216, 480, 1920) about 3.4 GB, some 1 ms
// of HBM time against a 1.1 ms operation bound. mma.sync reaches only part
// of the tensor cores' wgmma rate; wgmma with TMA is the next step.
namespace bwd {

constexpr int LNR = 64;  // rows per block of the row kernels

// a block tile of BM_ x BN_ with a K step of BK_ and a ring of ST_ stages in
// bf16 (two in f32), over 8 warps, 2 along its rows and 4 along its
// columns; each warp owns MT m16 tiles by NT8 n8 tiles
template <int BM_, int BN_, int BK_, int ST_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WN = 4, MT = BM / 32, NT8 = BN / 32;
  template <typename T>
  __host__ __device__ static constexpr int stages() {
    return std::is_same<T, float>::value ? 2 : ST_;
  }
};
// the front products (two per block): 64 rows, so two blocks share an SM
// and one block's epilogue overlaps the other's main loop
using Front = Tiling<64, 128, 64, 2>;
// the weight-gradient and dln products
using Wide = Tiling<128, 128, 64, 3>;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <typename T>
struct Cfg {  // bf16: 8-element row padding (16 bytes)
  static constexpr int PAD = 8;
};
template <>
struct Cfg<float> {
  static constexpr int PAD = 4;
};

// elements of one operand tile (MN rows or columns) in shared memory:
// K-contiguous operands are stored MN rows x (BK + PAD), the others BK rows
// x (MN + PAD); either padding keeps the eight rows of an ldmatrix on
// distinct banks
template <typename T, bool KC, int MN, int BK>
__host__ __device__ constexpr int tile_elems() {
  return KC ? MN * (BK + Cfg<T>::PAD) : BK * (MN + Cfg<T>::PAD);
}

// one operand of a product, at the block's tile origin and its first K:
// element (mn, k) at p[mn * ld + k] when K-contiguous, else p[k * ld + mn];
// mn < mn_valid holds data, the rest of the tile reads as zero
struct Opnd {
  const void* p;
  long long ld;
  int mn_valid;
};

template <bool KC, typename T>
__device__ __forceinline__ Opnd opnd(const T* base, long long ld, long long mn0, long long k0,
                                     int mn_valid) {
  return {KC ? base + mn0 * ld + k0 : base + k0 * ld + mn0, ld, mn_valid};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tile of K steps [k0, k0 + BK) of operand o (k_valid: K extent of this
// block) into s. vec: 16-byte cp.async (every contiguous extent a multiple
// of 16 bytes, every pointer aligned); else plain loads.
template <typename T, bool KC, int MN, int BK>
__device__ __forceinline__ void load_tile(T* s, const Opnd& o, int k0, int k_valid, bool vec) {
  constexpr int OUT = KC ? MN : BK;  // shared rows
  constexpr int IN = KC ? BK : MN;   // valid width of a shared row
  constexpr int LD = IN + Cfg<T>::PAD;
  const T* p = static_cast<const T*>(o.p);
  const int o_valid = KC ? o.mn_valid : k_valid - k0;
  const int i_valid = KC ? k_valid - k0 : o.mn_valid;
  const T* g = KC ? p + k0 : p + (long long)k0 * o.ld;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = IN / V;
    for (int e = threadIdx.x; e < OUT * CPR; e += NT) {
      const int r = e / CPR, i = (e % CPR) * V;
      const bool in = r < o_valid && i < i_valid;
      cp_async16(s + r * LD + i, in ? g + (long long)r * o.ld + i : p, in);
    }
  } else {
    for (int e = threadIdx.x; e < OUT * IN; e += NT) {
      const int r = e / IN, i = e % IN;
      s[r * LD + i] = (r < o_valid && i < i_valid) ? g[(long long)r * o.ld + i] : Num<T>::store(0.f);
    }
  }
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class TL>
using Acc = float[TL::MT][TL::NT8][4];

// warp (wm, wn) accumulator element (mt, nt, e) sits at tile row
// wm * BM / 2 + mt * 16 + lane / 4 + (e / 2) * 8 and column
// wn * BN / 4 + nt * 8 + (lane % 4) * 2 + e % 2 (the mma.sync C layout)
template <class TL>
__device__ __forceinline__ int acc_row(int wm, int mt, int e) {
  return wm * (TL::BM / 2) + mt * 16 + (threadIdx.x % 32) / 4 + (e / 2) * 8;
}
template <class TL>
__device__ __forceinline__ int acc_col(int wn, int nt, int e) {
  return wn * (TL::BN / 4) + nt * 8 + (threadIdx.x % 4) * 2 + e % 2;
}

// acc += A_tile . B_tile over one K step, tensor cores
template <class TL, bool AKC, bool BKC>
__device__ __forceinline__ void tile_product(Acc<TL>& acc, const bf16* As, const bf16* Bs, int wm,
                                             int wn) {
  constexpr int MT = TL::MT, NT8 = TL::NT8, BK = TL::BK;
  constexpr int LDK = BK + 8, LDA = TL::BM + 8, LDB = TL::BN + 8;
  const int lane = threadIdx.x % 32, q = lane / 8, r = lane % 8;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    unsigned a[MT][4], b[NT8][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = wm * (TL::BM / 2) + mt * 16;
      if constexpr (AKC)
        ldsm_x4<false>(a[mt], As + (m + lane % 16) * LDK + ks + (lane / 16) * 8);
      else
        ldsm_x4<true>(a[mt], As + (ks + r + (q / 2) * 8) * LDA + m + (q % 2) * 8);
    }
#pragma unroll
    for (int np = 0; np < NT8 / 2; ++np) {
      const int n = wn * (TL::BN / 4) + np * 16;
      unsigned t[4];
      if constexpr (BKC)
        ldsm_x4<false>(t, Bs + (n + r + (q / 2) * 8) * LDK + ks + (q % 2) * 8);
      else
        ldsm_x4<true>(t, Bs + (ks + r + (q % 2) * 8) * LDB + n + (q / 2) * 8);
      b[2 * np][0] = t[0];
      b[2 * np][1] = t[1];
      b[2 * np + 1][0] = t[2];
      b[2 * np + 1][1] = t[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) mma16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// the same on the CUDA cores in f32, K summed in order
template <class TL, bool AKC, bool BKC>
__device__ __forceinline__ void tile_product(Acc<TL>& acc, const float* As, const float* Bs,
                                             int wm, int wn) {
  constexpr int MT = TL::MT, NT8 = TL::NT8, BK = TL::BK;
  constexpr int LDK = BK + 4, LDA = TL::BM + 4, LDB = TL::BN + 4;
  for (int k = 0; k < BK; ++k) {
    float a[MT][2], b[NT8][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = acc_row<TL>(wm, mt, 2 * h);
        a[mt][h] = AKC ? As[m * LDK + k] : As[k * LDA + m];
      }
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = acc_col<TL>(wn, nt, e);
        b[nt][e] = BKC ? Bs[n * LDK + k] : Bs[k * LDB + n];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = fmaf(a[mt][e / 2], b[nt][e % 2], acc[mt][nt][e]);
  }
}

// shared-memory ring of NP operand pairs (A_p, B_p); AKp / BKp: whether the
// operand is K-contiguous
template <typename T, class TL, int NP, bool AK0, bool BK0, bool AK1, bool BK1>
struct Ring {
  static constexpr int A0 = 0;
  static constexpr int B0 = A0 + tile_elems<T, AK0, TL::BM, TL::BK>();
  static constexpr int A1 = B0 + tile_elems<T, BK0, TL::BN, TL::BK>();
  static constexpr int B1 = A1 + (NP > 1 ? tile_elems<T, AK1, TL::BM, TL::BK>() : 0);
  static constexpr int STAGE = B1 + (NP > 1 ? tile_elems<T, BK1, TL::BN, TL::BK>() : 0);
  static constexpr size_t bytes = (size_t)STAGE * TL::template stages<T>() * sizeof(T);
};

// acc[p] = sum over K of A_p . B_p for the block's tile, operands ops[2p]
// (A) and ops[2p + 1] (B); k_valid = the block's K extent. Ends with the
// ring free for reuse.
template <typename T, class TL, int NP, bool AK0, bool BK0, bool AK1 = true, bool BK1 = true>
__device__ __forceinline__ void gemm_loop(Acc<TL> (&acc)[NP], const Opnd* ops, int k_valid,
                                          bool vec, T* ring) {
  using R = Ring<T, TL, NP, AK0, BK0, AK1, BK1>;
  constexpr int S = TL::template stages<T>(), MT = TL::MT, NT8 = TL::NT8, BK = TL::BK;
  const int warp = threadIdx.x / 32, wm = warp / TL::WN, wn = warp % TL::WN;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mt][nt][e] = 0.f;
  const int nk = (k_valid + BK - 1) / BK;
  auto load = [&](int kt) {
    T* st = ring + (kt % S) * R::STAGE;
    load_tile<T, AK0, TL::BM, BK>(st + R::A0, ops[0], kt * BK, k_valid, vec);
    load_tile<T, BK0, TL::BN, BK>(st + R::B0, ops[1], kt * BK, k_valid, vec);
    if constexpr (NP > 1) {
      load_tile<T, AK1, TL::BM, BK>(st + R::A1, ops[2], kt * BK, k_valid, vec);
      load_tile<T, BK1, TL::BN, BK>(st + R::B1, ops[3], kt * BK, k_valid, vec);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + S - 1 < nk) load(kt + S - 1);
    cp_async_commit();
    const T* st = ring + (kt % S) * R::STAGE;
    tile_product<TL, AK0, BK0>(acc[0], st + R::A0, st + R::B0, wm, wn);
    if constexpr (NP > 1) tile_product<TL, AK1, BK1>(acc[1], st + R::A1, st + R::B1, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float gelu_grad_f32(float u) {
  const float phi = expf(-0.5f * u * u) * kInvSqrt2Pi;
  const float cdf = 0.5f * (erff(u / kSqrt2) + 1.0f);
  return cdf + u * phi;
}

// p[0], p[1] = T(v[0]), T(v[1]): one 4- or 8-byte store when pair (p aligned
// for it), else p[0] alone and p[1] if second
template <typename T>
__device__ __forceinline__ void store_pair(T* p, const float (&v)[2], bool pair, bool second) {
  if (pair) {
    if constexpr (std::is_same<T, bf16>::value)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    return;
  }
  p[0] = Num<T>::store(v[0]);
  if (second) p[1] = Num<T>::store(v[1]);
}

// column sums of a warp's 64 rows (cs: this thread's rows, summed in row
// order) -> red[wm][column] in shared memory; lanes 0-3 hold the result of
// the fixed butterfly
template <class TL>
__device__ __forceinline__ void warp_col_sums(float (&cs)[TL::NT8][2], float* red, int wm, int wn) {
#pragma unroll
  for (int nt = 0; nt < TL::NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[nt][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (threadIdx.x % 32 < 4) red[wm * TL::BN + acc_col<TL>(wn, nt, e)] = v;
    }
}

// LayerNorm output, dz = T(g) * mask and the row statistics, one warp per
// row (the arithmetic of ln_tile); block k of LNR rows also writes the
// column sums of its dz (f32) to db2_part[k]
struct PrepArgs {
  const void* x;
  const void* g;
  const float* mask;
  const float* ln_s;
  const float* ln_b;
  void* ln;
  void* dz;
  float* mu;
  float* rstd;
  float* db2_part;
  long long n_rows;
  int C;
  float eps_ln;
};

template <typename T>
__global__ void __launch_bounds__(NT) prep_kernel(PrepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* colacc = reinterpret_cast<float*>(smem);  // (8 warps, C)
  const int C = a.C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wacc = colacc + (size_t)warp * C;
  for (int c = lane; c < C; c += 32) wacc[c] = 0.f;
  const long long row0 = (long long)blockIdx.x * LNR;
  for (int i = warp; i < LNR; i += NT / 32) {
    const long long r = row0 + i;
    if (r >= a.n_rows) break;
    const T* xr = static_cast<const T*>(a.x) + r * C;
    const T* gr = static_cast<const T*>(a.g) + r * C;
    T* lr = static_cast<T*>(a.ln) + r * C;
    T* dr = static_cast<T*>(a.dz) + r * C;
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
      const float d = Num<T>::rnd(__fmul_rn(Num<T>::load(gr[c]), mk));
      dr[c] = Num<T>::store(d);
      wacc[c] += d;
    }
    if (lane == 0) {
      a.mu[r] = mu;
      a.rstd[r] = rstd;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += colacc[(size_t)w * C + c];
    a.db2_part[(size_t)blockIdx.x * C + c] = s;
  }
}

// front C (kStats) / front D (kMain): block (hidden tile x, row tile y) of
// sample y / tiles_per_sample
enum FrontMode { kStats = 0, kMain = 1 };

struct FrontArgs {
  const void* ln;  // (B S, C) LayerNorm output
  const void* dz;  // (B S, C)
  const void* w1;  // (M, C)
  const void* w2;  // (C, M)
  const float* mask;
  const float* b1;
  const float* nx;     // (B, M), front C
  const float* gg;
  const float* gb;
  const float* coef1;  // (B, M), front D
  const float* coef2;  // (B, M), front D
  void* hout;          // (B S, M): y (front C) or du (front D) in T
  float* part0;        // (row tiles, M): dy * v (C) or du (D)
  float* part1;        // (row tiles, M): dy (C)
  int S, C, M, vec;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(NT, 2) front_kernel(FrontArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using TL = Front;
  constexpr int BM = TL::BM, BN = TL::BN, MT = TL::MT, NT8 = TL::NT8;
  const int S = a.S, C = a.C, M = a.M;
  const int tps = (S + BM - 1) / BM;
  const int b = blockIdx.y / tps, t = blockIdx.y % tps;
  const int rows = min(BM, S - t * BM);
  const long long r0 = (long long)b * S + (long long)t * BM;
  const int n0 = blockIdx.x * BN, nv = min(BN, M - n0);
  const T* ln = static_cast<const T*>(a.ln);
  const T* dz = static_cast<const T*>(a.dz);
  const Opnd ops[4] = {
      opnd<true>(ln, C, r0, 0, rows),
      opnd<true>(static_cast<const T*>(a.w1), C, n0, 0, nv),
      opnd<true>(dz, C, r0, 0, rows),
      opnd<false>(static_cast<const T*>(a.w2), M, n0, 0, nv),
  };
  Acc<TL> acc[2];  // u, dy
  gemm_loop<T, TL, 2, true, true, true, false>(acc, ops, C, a.vec, reinterpret_cast<T*>(smem));

  const int warp = threadIdx.x / 32, wm = warp / TL::WN, wn = warp % TL::WN;
  const size_t bm = (size_t)b * M;
  const bool pairs = M % 2 == 0;  // two neighbouring columns share one aligned store
  float mk[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row<TL>(wm, mt, 2 * h);
      mk[mt][h] = MODE == kMain && a.mask && r < rows ? a.mask[r0 + r] : 1.f;
    }
  float cs0[NT8][2], cs1[NT8][2];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    // this thread's two columns: their parameters once, then its rows in order
    const int gm0 = n0 + acc_col<TL>(wn, nt, 0);
    float pb[2] = {}, p1[2] = {}, p2[2] = {}, p3[2] = {};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cs0[nt][e] = cs1[nt][e] = 0.f;
      const int gm = gm0 + e;
      if (gm >= M) continue;
      pb[e] = Num<T>::rnd(a.b1[gm]);
      if (MODE == kStats) {
        p1[e] = Num<T>::rnd(a.nx[bm + gm]);
        p2[e] = a.gg[gm];
        p3[e] = a.gb[gm];
      } else {
        p1[e] = a.coef1[bm + gm];
        p2[e] = a.coef2[bm + gm];
      }
    }
    if (gm0 >= M) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row<TL>(wm, mt, 2 * h);
        if (r >= rows) continue;
        float o[2] = {};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (gm0 + e >= M) continue;
          const float dy = acc[1][mt][nt][2 * h + e];
          const float u = Num<T>::rnd(__fadd_rn(Num<T>::rnd(acc[0][mt][nt][2 * h + e]), pb[e]));
          const float v = gelu_exact<T>(u);
          if (MODE == kStats) {
            const float tt = Num<T>::rnd(__fmul_rn(v, p1[e]));
            o[e] = Num<T>::rnd(__fadd_rn(__fadd_rn(__fmul_rn(p2[e], tt), p3[e]), v));
            cs0[nt][e] += __fmul_rn(dy, v);
            cs1[nt][e] += dy;
          } else {
            // the statistics path saw v * mask, so its cotangent carries mask^2
            const float sv = __fmul_rn(v, __fmul_rn(mk[mt][h], mk[mt][h]));
            o[e] = __fmul_rn(__fadd_rn(__fmul_rn(dy, p1[e]), __fmul_rn(sv, p2[e])), gelu_grad_f32(u));
            cs0[nt][e] += o[e];
          }
        }
        store_pair<T>(static_cast<T*>(a.hout) + (r0 + r) * M + gm0, o, pairs && gm0 + 1 < M,
                      gm0 + 1 < M);
      }
  }
  // the ring is free (gemm_loop ended on a barrier): per-warp column sums,
  // then the two row halves of the tile added in order
  float* red = reinterpret_cast<float*>(smem);
  warp_col_sums<TL>(cs0, red, wm, wn);
  if (MODE == kStats) warp_col_sums<TL>(cs1, red + 2 * BN, wm, wn);
  __syncthreads();
  const int j = threadIdx.x;
  if (j < nv) {
    const size_t o = (size_t)blockIdx.y * M + n0 + j;
    a.part0[o] = red[j] + red[BN + j];
    if (MODE == kStats) a.part1[o] = red[2 * BN + j] + red[3 * BN + j];
  }
}

// out[z] (I x J, f32, row stride ldo) = A . B over K steps
// [z * kps, min(K, (z + 1) * kps)); block (column tile x, row tile y, split z)
struct GemmArgs {
  const void* a;
  const void* b;
  float* out;
  long long lda, ldb, ldo, zstride;
  int I, J, K, kps, vec;
};

template <typename T, bool AKC, bool BKC>
__global__ void __launch_bounds__(NT, 2) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  using TL = Wide;
  constexpr int BM = TL::BM, BN = TL::BN;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const long long k0 = (long long)blockIdx.z * g.kps;
  const int kv = (int)min((long long)g.kps, g.K - k0);
  const Opnd ops[2] = {
      opnd<AKC>(static_cast<const T*>(g.a), g.lda, i0, k0, min(BM, g.I - i0)),
      opnd<BKC>(static_cast<const T*>(g.b), g.ldb, j0, k0, min(BN, g.J - j0)),
  };
  Acc<TL> acc[1];
  gemm_loop<T, TL, 1, AKC, BKC>(acc, ops, kv, g.vec, reinterpret_cast<T*>(smem));
  const int warp = threadIdx.x / 32, wm = warp / TL::WN, wn = warp % TL::WN;
  float* out = g.out + blockIdx.z * g.zstride;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + acc_row<TL>(wm, mt, e), j = j0 + acc_col<TL>(wn, nt, e);
        if (i < g.I && j < g.J) out[(long long)i * g.ldo + j] = acc[0][mt][nt][e];
      }
}

// LayerNorm backward, one warp per row (from dln in f32, C wide): dx in T;
// block k of LNR rows writes the column sums of dln * xhat and dln
struct LnbArgs {
  const void* x;
  const float* dln;
  const float* mu;
  const float* rstd;
  const float* ln_s;
  void* dx;
  float* dls_part;
  float* dlb_part;
  long long n_rows;
  int C;
};

template <typename T>
__global__ void __launch_bounds__(NT) lnb_kernel(LnbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int W = NT / 32;
  float* acc_s = reinterpret_cast<float*>(smem);  // (8 warps, C): sum dln * xhat
  float* acc_b = acc_s + (size_t)W * C;           // (8 warps, C): sum dln
  float* ws = acc_s + (size_t)warp * C;
  float* wb = acc_b + (size_t)warp * C;
  for (int c = lane; c < C; c += 32) ws[c] = wb[c] = 0.f;
  const long long row0 = (long long)blockIdx.x * LNR;
  for (int i = warp; i < LNR; i += W) {
    const long long r = row0 + i;
    if (r >= a.n_rows) break;
    const T* xr = static_cast<const T*>(a.x) + r * C;
    const float* dr = a.dln + r * C;
    const float mu = a.mu[r], rstd = a.rstd[r];
    float sd = 0.f, sdx = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (Num<T>::load(xr[c]) - mu) * rstd;
      const float d = dr[c];
      const float dxhat = d * a.ln_s[c];
      sd += dxhat;
      sdx += dxhat * xhat;
      ws[c] += d * xhat;
      wb[c] += d;
    }
    const float mean_d = warp_sum(sd) / (float)C;
    const float mean_dx = warp_sum(sdx) / (float)C;
    T* dxr = static_cast<T*>(a.dx) + r * C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (Num<T>::load(xr[c]) - mu) * rstd;
      const float dxhat = dr[c] * a.ln_s[c];
      dxr[c] = Num<T>::store(rstd * (dxhat - mean_d - xhat * mean_dx));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < W; ++w) {
      s1 += acc_s[(size_t)w * C + c];
      s2 += acc_b[(size_t)w * C + c];
    }
    a.dls_part[(size_t)blockIdx.x * C + c] = s1;
    a.dlb_part[(size_t)blockIdx.x * C + c] = s2;
  }
}

template <typename K, typename A>
int launch_with(K kern, dim3 grid, size_t smem, void* stream, const A& args) {
  if (smem > (size_t)max_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the products hold large rings: ask for the largest shared-memory share
  // of the SM, so that two blocks fit
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
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

// the backward's tiling, for the caller's plan: rows of a front-product
// tile, rows and columns of a weight-gradient product's tile, the K step,
// rows per block of the row kernels
void fmg_bwd_geometry(int* geo) {
  geo[0] = bwd::Front::BM;
  geo[1] = bwd::Wide::BM;
  geo[2] = bwd::Wide::BK;
  geo[3] = bwd::LNR;
}

// prep: LayerNorm output and dz (B S, C) in the compute type, row mean and
// 1 / std (B S), column sums of dz per block of LNR rows (blocks, C)
int fmg_bwd_prep(int dtype, const void* x, const void* g, const float* mask, const float* ln_s,
                 const float* ln_b, void* ln, void* dz, float* mu, float* rstd, float* db2_part,
                 long long n_rows, int C, float eps_ln, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  bwd::PrepArgs a{x, g, mask, ln_s, ln_b, ln, dz, mu, rstd, db2_part, n_rows, C, eps_ln};
  const dim3 grid((unsigned)((n_rows + bwd::LNR - 1) / bwd::LNR));
  const size_t smem = (size_t)(NT / 32) * C * sizeof(float);
  return dtype == 0 ? bwd::launch_with(bwd::prep_kernel<float>, grid, smem, stream, a)
                    : bwd::launch_with(bwd::prep_kernel<bf16>, grid, smem, stream, a);
}

// front C (mode 0): y (B S, M) in the compute type, per-row-tile column sums
// of dy * v (part0) and dy (part1), (B ceil(S / 64), M) each. front D (mode
// 1): du (B S, M) and per-row-tile column sums of du in f32 (part0).
int fmg_bwd_front(int dtype, int mode, const void* ln, const void* dz, const void* w1,
                  const void* w2, const float* mask, const float* b1, const float* nx,
                  const float* gg, const float* gb, const float* coef1, const float* coef2,
                  void* hout, float* part0, float* part1, int B, int S, int C, int M,
                  void* stream) {
  if ((dtype != 0 && dtype != 1) || (mode != 0 && mode != 1) || B <= 0 || S <= 0 || C <= 0 ||
      M <= 0)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = C % V == 0 && M % V == 0 && bwd::aligned16({ln, dz, w1, w2});
  bwd::FrontArgs a{ln, dz, w1, w2, mask, b1, nx, gg, gb, coef1, coef2, hout, part0, part1,
                   S, C, M, vec};
  using namespace bwd;
  const long long tiles = (long long)B * ((S + Front::BM - 1) / Front::BM);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + Front::BN - 1) / Front::BN, (unsigned)tiles);
  if (dtype == 0) {
    const size_t smem = Ring<float, Front, 2, true, true, true, false>::bytes;
    return mode == 0 ? launch_with(front_kernel<float, kStats>, grid, smem, stream, a)
                     : launch_with(front_kernel<float, kMain>, grid, smem, stream, a);
  }
  const size_t smem = Ring<bf16, Front, 2, true, true, true, false>::bytes;
  return mode == 0 ? launch_with(front_kernel<bf16, kStats>, grid, smem, stream, a)
                   : launch_with(front_kernel<bf16, kMain>, grid, smem, stream, a);
}

// out (splits, I, J) in f32: split z holds A . B over K steps
// [z * kps, min(K, (z + 1) * kps)). kind 0 (weight gradients): A stored
// (K, I) and B stored (K, J), both row-major; kind 1 (dln): A stored (I, K),
// B stored (K, J). kps is a multiple of the K step.
int fmg_bwd_gemm(int dtype, int kind, const void* A, long long lda, const void* Bm,
                 long long ldb, float* out, int I, int J, int K, int kps, int splits,
                 void* stream) {
  if ((dtype != 0 && dtype != 1) || (kind != 0 && kind != 1) || I <= 0 || J <= 0 || K <= 0 ||
      kps <= 0 || kps % bwd::Wide::BK || splits <= 0 || splits > 65535 ||
      (long long)(splits - 1) * kps >= K)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = lda % V == 0 && ldb % V == 0 && bwd::aligned16({A, Bm});
  bwd::GemmArgs g{A, Bm, out, lda, ldb, (long long)J, (long long)I * J, I, J, K, kps, vec};
  using namespace bwd;
  const long long ti = (I + Wide::BM - 1) / Wide::BM;
  if (ti > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((J + Wide::BN - 1) / Wide::BN, (unsigned)ti, splits);
  if (dtype == 0) {
    return kind == 0 ? launch_with(gemm_kernel<float, false, false>, grid,
                                   Ring<float, Wide, 1, false, false, true, true>::bytes, stream, g)
                     : launch_with(gemm_kernel<float, true, false>, grid,
                                   Ring<float, Wide, 1, true, false, true, true>::bytes, stream, g);
  }
  return kind == 0 ? launch_with(gemm_kernel<bf16, false, false>, grid,
                                 Ring<bf16, Wide, 1, false, false, true, true>::bytes, stream, g)
                   : launch_with(gemm_kernel<bf16, true, false>, grid,
                                 Ring<bf16, Wide, 1, true, false, true, true>::bytes, stream, g);
}

// LayerNorm backward: dx (B S, C) in the compute type from dln (B S, C) in
// f32; column sums of dln * xhat and dln per block of LNR rows (blocks, C)
int fmg_bwd_lnb(int dtype, const void* x, const float* dln, const float* mu, const float* rstd,
                const float* ln_s, void* dx, float* dls_part, float* dlb_part, long long n_rows,
                int C, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  bwd::LnbArgs a{x, dln, mu, rstd, ln_s, dx, dls_part, dlb_part, n_rows, C};
  const dim3 grid((unsigned)((n_rows + bwd::LNR - 1) / bwd::LNR));
  const size_t smem = 2 * (size_t)(NT / 32) * C * sizeof(float);
  return dtype == 0 ? bwd::launch_with(bwd::lnb_kernel<float>, grid, smem, stream, a)
                    : bwd::launch_with(bwd::lnb_kernel<bf16>, grid, smem, stream, a);
}

}  // extern "C"
