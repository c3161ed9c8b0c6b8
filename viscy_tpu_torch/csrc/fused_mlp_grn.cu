// Fused ConvNeXt-v2 MLP + GRN forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU Pallas kernels viscy_tpu/ops/pallas/fused_block.py::
// _stats_kernel (pass A) and ::_apply_kernel (pass B). It computes
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

}  // extern "C"
