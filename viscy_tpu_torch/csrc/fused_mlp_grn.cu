// Fused ConvNeXt-v2 MLP + GRN for Hopper (sm_90a), plain C interface: the
// forward (passes A and B) and the backward (passes C and D), every product
// on one pipelined tensor-core main loop (namespace mm).
//
// The forward replaces the TPU Pallas kernels viscy_tpu/ops/pallas/
// fused_block.py::_stats_kernel (pass A) and ::_apply_kernel (pass B). It
// computes
//
//     out = shortcut + fc2(GRN(gelu(fc1(LN(x)))))        x, shortcut: (B, S, C)
//
// as a short chain of kernels (namespace fwd):
//
//   prep     one warp per row writes the LayerNorm output ln (B S, C) in T
//   pass A   u = ln . w1^T for one (row tile, hidden tile); epilogue:
//            v = GELU(T(u) + T(b1)) in T to an M-wide (B S, M) scratch, and
//            per-row-tile column sums of (v * mask)^2 in f32. Row tiles stop
//            at each sample's end, since the GRN statistics are per sample.
//   (torch, on (B, M): ss = the partials summed per sample in a fixed
//   order, nx = gx / (mean_m gx + eps))
//   pass B   z = y . w2^T with K = M. y = GRN(v) is formed on each v tile in
//            shared memory right after it lands (each thread rewrites the
//            elements it loaded, before the barrier the main loop takes
//            anyway); epilogue: out = shortcut + mask * T(T(z) + T(b2)),
//            written once. Row tiles run over B S flat (a tile may straddle
//            samples: each row finds its own nx row); C is split over blocks
//            in column tiles of 128 or 256, the wrapper's choice.
//
// No float atomics: every cross-block sum goes to a partial of its own, so
// two runs give bit-identical outputs.
//
// Value semantics follow the flax modules op for op: LN statistics in f32
// with the fast variance max(E[x^2] - mu^2, 0); every intermediate rounded
// to the compute type T where flax rounds it (fc1/fc2 outputs, the bias
// adds, each GELU step, v * nx); the GRN combine gamma * t + beta + v in
// f32 and rounded to T before fc2. The weights arrive in T (the caller casts
// them, as flax casts its f32 parameters to the compute dtype); biases, LN
// and GRN parameters arrive in f32 and are rounded to T where flax rounds.
//
// What bounds the forward on an H100: 4 B S C M operations (fc1 and fc2
// once each) against the activations (x, shortcut, out: 3 B S C elements)
// and the v scratch, 2 B S M bytes of bf16 written by pass A and read back
// by pass B. At (B, S, C, M) = (49, 6400, 480, 1920) that is 1.17 ms of
// operations against about 0.9 ms of HBM traffic: compute, by a little.
// The design spends the scratch (1.2 GB there, freed on return) to do fc1
// once, where the first port recomputed it in pass B (6 B S C M), and puts
// both products on the tensor cores through a cp.async ring with ldmatrix
// and mma.sync, with every elementwise step fused into a product's operand
// load or epilogue. f32 runs the same tiling on the CUDA cores.
//
// The backward (namespace bwd) is described at its section. mma.sync
// reaches only part of the tensor cores' rate; wgmma with TMA-fed stages is
// the next step for both directions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block (8 warps) in every kernel
constexpr int LNR = 64;  // rows per block of the row kernels
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

// fc1 output (f32 sum) and T(b1) -> v = GELU(T(T(u) + T(b1)))
template <typename T>
__device__ __forceinline__ float hidden_value(float acc, float b1r) {
  return gelu_exact<T>(Num<T>::rnd(__fadd_rn(Num<T>::rnd(acc), b1r)));
}

// GRN output y = T(gamma * T(v * T(nx)) + beta + v), nxr = T(nx)
template <typename T>
__device__ __forceinline__ float grn_value(float v, float nxr, float gg, float gb) {
  const float t = Num<T>::rnd(__fmul_rn(v, nxr));
  return Num<T>::rnd(__fadd_rn(__fadd_rn(__fmul_rn(gg, t), gb), v));
}

// block output from the fc2 sum: shortcut + T(T(T(z) + T(b2)) * mask), in f32
template <typename T>
__device__ __forceinline__ float store_out(float acc, float b2r, float mk, float sc) {
  float z = Num<T>::rnd(__fadd_rn(Num<T>::rnd(acc), b2r));
  z = Num<T>::rnd(__fmul_rn(z, mk));
  return __fadd_rn(sc, z);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row xr (C wide) into lr, by one warp; returns (mean,
// 1 / std). Used by both directions' prep kernels.
template <typename T>
__device__ __forceinline__ float2 ln_row(const T* __restrict__ xr, T* __restrict__ lr,
                                         const float* __restrict__ ln_s,
                                         const float* __restrict__ ln_b, int C, float eps_ln) {
  const int lane = threadIdx.x % 32;
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
  const float rstd = rsqrtf(var + eps_ln);
  for (int c = lane; c < C; c += 32)
    lr[c] = Num<T>::store((Num<T>::load(xr[c]) - mu) * (rstd * ln_s[c]) + ln_b[c]);
  return make_float2(mu, rstd);
}

// largest dynamic shared memory a block may take (H100: 227 KB)
int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// ---------------------------------------------------------------------------
// the main loop every product runs on
// ---------------------------------------------------------------------------
//
// A block tile of 8 warps (2 along its rows, 4 along its columns), operand
// tiles brought into a ring of shared-memory stages by cp.async (zero-filled
// past the valid rows, columns and K), so the next tiles load while the
// current one is multiplied. bf16 runs on the tensor cores (ldmatrix,
// transposing where an operand is stored with its M or N dimension
// contiguous, and mma.sync m16n8k16 with f32 accumulators in registers);
// float32 runs the same tiling on the CUDA cores, each thread owning exactly
// the accumulator elements of the mma layout, so the epilogues are shared.
namespace mm {

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
// of 16 bytes, every pointer aligned); else plain loads. Thread t moves the
// chunks (vec) or elements e = t, t + NT, ... of the tile, row e / (chunks
// or elements per row): a Fix of gemm_loop relies on this map.
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

// leaves the landed A tiles as they are
struct NoFix {
  template <typename T>
  __device__ __forceinline__ void operator()(T*, int) const {}
};

// acc[p] = sum over K of A_p . B_p for the block's tile, operands ops[2p]
// (A) and ops[2p + 1] (B); k_valid = the block's K extent. fix(A0 tile, k0)
// runs on each landed tile of the first A operand before the barrier that
// publishes it, so a thread may rewrite the elements it loaded itself (the
// map of load_tile). Ends with the ring free for reuse.
template <typename T, class TL, int NP, bool AK0, bool BK0, bool AK1 = true, bool BK1 = true,
          class Fix = NoFix>
__device__ __forceinline__ void gemm_loop(Acc<TL> (&acc)[NP], const Opnd* ops, int k_valid,
                                          bool vec, T* ring, const Fix& fix = Fix()) {
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
    cp_async_wait<S - 2>();  // this thread's part of tile kt landed
    T* st = ring + (kt % S) * R::STAGE;
    fix(st + R::A0, kt * BK);
    __syncthreads();  // tile kt complete; every warp is done with tile kt - 1
    if (kt + S - 1 < nk) load(kt + S - 1);
    cp_async_commit();
    tile_product<TL, AK0, BK0>(acc[0], st + R::A0, st + R::B0, wm, wn);
    if constexpr (NP > 1) tile_product<TL, AK1, BK1>(acc[1], st + R::A1, st + R::B1, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();
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

// column sums of a warp's rows (cs: this thread's rows, summed in row
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

}  // namespace mm

// ---------------------------------------------------------------------------
// forward: prep, pass A, pass B
// ---------------------------------------------------------------------------
namespace fwd {

using namespace mm;

// pass A: one product, so 128 x 128 tiles with a 3-stage ring still let two
// blocks share an SM and one block's GELU epilogue overlap the other's main
// loop (with 64-row tiles pass A took 22 % longer at (B, S, C, M) =
// (49, 6400, 480, 1920) on an H100)
using StatsTL = Tiling<128, 128, 64, 3>;
// pass B: 64 rows by 128 or 256 output columns (the wrapper picks the width
// that fills the card with the fewest padded columns); two blocks an SM
constexpr int APPLY_BM = 64;
template <int BN>
using ApplyTL = Tiling<APPLY_BM, BN, 64, BN == 256 ? 2 : 3>;

struct PrepArgs {
  const void* x;
  const float* ln_s;
  const float* ln_b;
  void* ln;
  long long n_rows;
  int C;
  float eps_ln;
};

// LayerNorm output (B S, C) in T, one warp per row, LNR rows a block
template <typename T>
__global__ void __launch_bounds__(NT) prep_kernel(PrepArgs a) {
  const long long row0 = (long long)blockIdx.x * LNR;
  for (int i = threadIdx.x / 32; i < LNR; i += NT / 32) {
    const long long r = row0 + i;
    if (r >= a.n_rows) break;
    ln_row<T>(static_cast<const T*>(a.x) + r * a.C, static_cast<T*>(a.ln) + r * a.C, a.ln_s,
              a.ln_b, a.C, a.eps_ln);
  }
}

struct StatsArgs {
  const void* ln;  // (B S, C)
  const void* w1;  // (M, C)
  const float* mask;
  const float* b1;
  void* v;      // (B S, M) in T
  float* part;  // (row tiles, M): column sums of (v * mask)^2
  int S, C, M, vec;
};

// block (hidden tile x, row tile y) of sample y / tiles_per_sample
template <typename T>
__global__ void __launch_bounds__(NT, 2) stats_kernel(StatsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using TL = StatsTL;
  constexpr int BM = TL::BM, BN = TL::BN, MT = TL::MT, NT8 = TL::NT8;
  const int S = a.S, C = a.C, M = a.M;
  const int tps = (S + BM - 1) / BM;
  const int b = blockIdx.y / tps, t = blockIdx.y % tps;
  const int rows = min(BM, S - t * BM);
  const long long r0 = (long long)b * S + (long long)t * BM;
  const int n0 = blockIdx.x * BN, nv = min(BN, M - n0);
  const Opnd ops[2] = {
      opnd<true>(static_cast<const T*>(a.ln), C, r0, 0, rows),
      opnd<true>(static_cast<const T*>(a.w1), C, n0, 0, nv),
  };
  Acc<TL> acc[1];  // u
  gemm_loop<T, TL, 1, true, true>(acc, ops, C, a.vec, reinterpret_cast<T*>(smem));

  const int warp = threadIdx.x / 32, wm = warp / TL::WN, wn = warp % TL::WN;
  const bool pairs = M % 2 == 0;  // two neighbouring columns share one aligned store
  float mk[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row<TL>(wm, mt, 2 * h);
      mk[mt][h] = a.mask && r < rows ? a.mask[r0 + r] : 1.f;
    }
  float cs[NT8][2];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    // this thread's two columns: their bias once, then its rows in order
    const int gm0 = n0 + acc_col<TL>(wn, nt, 0);
    float pb[2] = {};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cs[nt][e] = 0.f;
      if (gm0 + e < M) pb[e] = Num<T>::rnd(a.b1[gm0 + e]);
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
          o[e] = hidden_value<T>(acc[0][mt][nt][2 * h + e], pb[e]);
          const float vm = Num<T>::rnd(__fmul_rn(o[e], mk[mt][h]));
          cs[nt][e] += vm * vm;
        }
        store_pair<T>(static_cast<T*>(a.v) + (r0 + r) * M + gm0, o, pairs && gm0 + 1 < M,
                      gm0 + 1 < M);
      }
  }
  // the ring is free (gemm_loop ended on a barrier): per-warp column sums,
  // then the two row halves of the tile added in order
  float* red = reinterpret_cast<float*>(smem);
  warp_col_sums<TL>(cs, red, wm, wn);
  __syncthreads();
  const int j = threadIdx.x;
  if (j < nv) a.part[(size_t)blockIdx.y * M + n0 + j] = red[j] + red[BN + j];
}

// y = GRN(v) in place on each landed v tile of pass B (APPLY_BM rows of K =
// hidden columns, K-contiguous), each thread on the chunks or elements it
// loaded (load_tile's map)
template <class TL>
struct GrnFix {
  const float* nx;  // (B, M)
  const float* gg;
  const float* gb;
  const int* rowb;  // shared: offset sample * M of each tile row into nx
  int rows, M;
  bool vec;

  template <typename T>
  __device__ __forceinline__ void operator()(T* As, int k0) const {
    constexpr int BK = TL::BK, LD = BK + Cfg<T>::PAD;
    const int kv = M - k0;
    if (vec) {  // M % V == 0: a chunk lies wholly inside or outside K
      constexpr int V = 16 / sizeof(T), CPR = BK / V;
      for (int e = threadIdx.x; e < TL::BM * CPR; e += NT) {
        const int r = e / CPR, i = (e % CPR) * V;
        if (r >= rows || i >= kv) continue;
        uint4* p = reinterpret_cast<uint4*>(As + r * LD + i);
        uint4 raw = *p;
        T* vals = reinterpret_cast<T*>(&raw);
        const int k = k0 + i;
        float pn[V], pg[V], pbt[V];
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          *reinterpret_cast<float4*>(pn + q) = *reinterpret_cast<const float4*>(nx + rowb[r] + k + q);
          *reinterpret_cast<float4*>(pg + q) = *reinterpret_cast<const float4*>(gg + k + q);
          *reinterpret_cast<float4*>(pbt + q) = *reinterpret_cast<const float4*>(gb + k + q);
        }
#pragma unroll
        for (int q = 0; q < V; ++q)
          vals[q] = Num<T>::store(grn_value<T>(Num<T>::load(vals[q]), Num<T>::rnd(pn[q]), pg[q], pbt[q]));
        *p = raw;
      }
    } else {
      for (int e = threadIdx.x; e < TL::BM * BK; e += NT) {
        const int r = e / BK, i = e % BK, k = k0 + i;
        if (r >= rows || i >= kv) continue;
        T* p = As + r * LD + i;
        *p = Num<T>::store(grn_value<T>(Num<T>::load(*p), Num<T>::rnd(nx[rowb[r] + k]), gg[k], gb[k]));
      }
    }
  }
};

struct ApplyArgs {
  const void* v;   // (B S, M) pass A's GELU output
  const void* w2;  // (C, M)
  const void* sc;  // (B S, C)
  const float* mask;
  const float* nx;  // (B, M)
  const float* gg;
  const float* gb;
  const float* b2;
  void* out;  // (B S, C)
  long long n_rows;
  int S, C, M, vec;
};

// block (column tile x, row tile y) over the B S rows
template <typename T, int BN>
__global__ void __launch_bounds__(NT, 2) apply_kernel(ApplyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using TL = ApplyTL<BN>;
  using R = Ring<T, TL, 1, true, true, true, true>;
  constexpr int BM = TL::BM, MT = TL::MT, NT8 = TL::NT8;
  const int C = a.C, M = a.M;
  const long long r0 = (long long)blockIdx.y * BM;
  const int rows = (int)min((long long)BM, a.n_rows - r0);
  const int n0 = blockIdx.x * BN, nv = min(BN, C - n0);
  int* rowb = reinterpret_cast<int*>(smem + R::bytes);
  for (int r = threadIdx.x; r < BM; r += NT) rowb[r] = r < rows ? (int)((r0 + r) / a.S) * M : 0;
  __syncthreads();
  const Opnd ops[2] = {
      opnd<true>(static_cast<const T*>(a.v), M, r0, 0, rows),
      opnd<true>(static_cast<const T*>(a.w2), M, n0, 0, nv),
  };
  Acc<TL> acc[1];  // z
  const GrnFix<TL> fix{a.nx, a.gg, a.gb, rowb, rows, M, a.vec != 0};
  gemm_loop<T, TL, 1, true, true>(acc, ops, M, a.vec, reinterpret_cast<T*>(smem), fix);

  const int warp = threadIdx.x / 32, wm = warp / TL::WN, wn = warp % TL::WN;
  const bool pairs = C % 2 == 0;
  const T* sc = static_cast<const T*>(a.sc);
  T* out = static_cast<T*>(a.out);
  float pb[NT8][2];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + acc_col<TL>(wn, nt, e);
      pb[nt][e] = c < C ? Num<T>::rnd(a.b2[c]) : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row<TL>(wm, mt, 2 * h);
      if (r >= rows) continue;
      const long long gr = r0 + r;
      const float mk = a.mask ? a.mask[gr] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int c0 = n0 + acc_col<TL>(wn, nt, 0);
        if (c0 >= C) continue;
        float o[2] = {};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + e < C)
            o[e] = store_out<T>(acc[0][mt][nt][2 * h + e], pb[nt][e], mk,
                                Num<T>::load(sc[gr * C + c0 + e]));
        store_pair<T>(out + gr * C + c0, o, pairs && c0 + 1 < C, c0 + 1 < C);
      }
    }
}

}  // namespace fwd

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
// give bit-identical gradients. Every product runs on the main loop of
// namespace mm. The front products take 64 x 128 tiles (two products'
// accumulators in 64 registers a thread), so two blocks share an SM and one
// block's long elementwise epilogue overlaps the other's main loop; the
// others take 128 x 128. Both step K by 64.
//
// What bounds it on an H100: the function needs 8 B S C M operations (dy,
// d fc2, d fc1, dln); these kernels do 14 (front D recomputes u and dy
// rather than store dy in f32). The M-wide scratch moves 2 B S M elements
// of T out and 3 B S M back in (y read once, du twice), dln 4 B S C bytes
// each way: at (B, S, C, M) = (16, 9216, 480, 1920) about 3.4 GB, some 1 ms
// of HBM time against a 1.1 ms operation bound.
namespace bwd {

using namespace mm;

// the front products (two per block): 64 rows, so two blocks share an SM
// and one block's epilogue overlaps the other's main loop
using Front = Tiling<64, 128, 64, 2>;
// the weight-gradient and dln products
using Wide = Tiling<128, 128, 64, 3>;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu_grad_f32(float u) {
  const float phi = expf(-0.5f * u * u) * kInvSqrt2Pi;
  const float cdf = 0.5f * (erff(u / kSqrt2) + 1.0f);
  return cdf + u * phi;
}

// LayerNorm output, dz = T(g) * mask and the row statistics, one warp per
// row (ln_row); block k of LNR rows also writes the column sums of its dz
// (f32) to db2_part[k]
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
    const float2 st = ln_row<T>(static_cast<const T*>(a.x) + r * C, static_cast<T*>(a.ln) + r * C,
                                a.ln_s, a.ln_b, C, a.eps_ln);
    const T* gr = static_cast<const T*>(a.g) + r * C;
    T* dr = static_cast<T*>(a.dz) + r * C;
    const float mk = a.mask ? a.mask[r] : 1.f;
    for (int c = lane; c < C; c += 32) {
      const float d = Num<T>::rnd(__fmul_rn(Num<T>::load(gr[c]), mk));
      dr[c] = Num<T>::store(d);
      wacc[c] += d;
    }
    if (lane == 0) {
      a.mu[r] = st.x;
      a.rstd[r] = st.y;
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
            o[e] = grn_value<T>(v, p1[e], p2[e], p3[e]);
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

}  // namespace bwd

}  // namespace

extern "C" {

// the forward's tiling, for the caller's plan: rows and hidden columns of a
// pass-A tile, rows of a pass-B tile, rows per block of the row kernels
void fmg_fwd_geometry(int* geo) {
  geo[0] = fwd::StatsTL::BM;
  geo[1] = fwd::StatsTL::BN;
  geo[2] = fwd::APPLY_BM;
  geo[3] = LNR;
}

// dtype: 0 = float32, 1 = bfloat16 for every activation, scratch and weight
// (w1 (M, C), w2 (C, M)); every other parameter float32.
// forward prep: LayerNorm output ln (n_rows, C)
int fmg_fwd_prep(int dtype, const void* x, const float* ln_s, const float* ln_b, void* ln,
                 long long n_rows, int C, float eps_ln, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  fwd::PrepArgs a{x, ln_s, ln_b, ln, n_rows, C, eps_ln};
  const dim3 grid((unsigned)((n_rows + LNR - 1) / LNR));
  return dtype == 0 ? mm::launch_with(fwd::prep_kernel<float>, grid, 0, stream, a)
                    : mm::launch_with(fwd::prep_kernel<bf16>, grid, 0, stream, a);
}

// pass A: v = GELU(ln . w1^T + b1) (B S, M) and per-row-tile column sums of
// (v * mask)^2, (B ceil(S / 128), M) in f32; mask (B S) or NULL
int fmg_fwd_stats(int dtype, const void* ln, const void* w1, const float* mask, const float* b1,
                  void* v, float* part, int B, int S, int C, int M, void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || S <= 0 || C <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  using namespace fwd;
  const long long tiles = (long long)B * ((S + StatsTL::BM - 1) / StatsTL::BM);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = C % V == 0 && aligned16({ln, w1});
  StatsArgs a{ln, w1, mask, b1, v, part, S, C, M, vec};
  const dim3 grid((M + StatsTL::BN - 1) / StatsTL::BN, (unsigned)tiles);
  if (dtype == 0)
    return launch_with(stats_kernel<float>, grid, Ring<float, StatsTL, 1, true, true, true, true>::bytes,
                       stream, a);
  return launch_with(stats_kernel<bf16>, grid, Ring<bf16, StatsTL, 1, true, true, true, true>::bytes,
                     stream, a);
}

// pass B: out = shortcut + mask * fc2(GRN(v)) (B S, C) from pass A's v and
// nx (B, M); bn: output columns of a block tile, 128 or 256
int fmg_fwd_apply(int dtype, int bn, const void* v, const void* w2, const void* sc,
                  const float* mask, const float* nx, const float* gg, const float* gb,
                  const float* b2, void* out, int B, int S, int C, int M, void* stream) {
  if ((dtype != 0 && dtype != 1) || (bn != 128 && bn != 256) || B <= 0 || S <= 0 || C <= 0 ||
      M <= 0 || (long long)B * M > INT_MAX)
    return (int)cudaErrorInvalidValue;
  using namespace fwd;
  const long long n_rows = (long long)B * S;
  const long long tiles = (n_rows + APPLY_BM - 1) / APPLY_BM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = M % V == 0 && aligned16({v, w2, nx, gg, gb});
  ApplyArgs a{v, w2, sc, mask, nx, gg, gb, b2, out, n_rows, S, C, M, vec};
  const dim3 grid((C + bn - 1) / bn, (unsigned)tiles);
  const size_t rowb = APPLY_BM * sizeof(int);
  if (dtype == 0) {
    return bn == 128 ? launch_with(apply_kernel<float, 128>, grid,
                                   Ring<float, ApplyTL<128>, 1, true, true, true, true>::bytes + rowb,
                                   stream, a)
                     : launch_with(apply_kernel<float, 256>, grid,
                                   Ring<float, ApplyTL<256>, 1, true, true, true, true>::bytes + rowb,
                                   stream, a);
  }
  return bn == 128 ? launch_with(apply_kernel<bf16, 128>, grid,
                                 Ring<bf16, ApplyTL<128>, 1, true, true, true, true>::bytes + rowb,
                                 stream, a)
                   : launch_with(apply_kernel<bf16, 256>, grid,
                                 Ring<bf16, ApplyTL<256>, 1, true, true, true, true>::bytes + rowb,
                                 stream, a);
}

// the backward's tiling, for the caller's plan: rows of a front-product
// tile, rows and columns of a weight-gradient product's tile, the K step,
// rows per block of the row kernels
void fmg_bwd_geometry(int* geo) {
  geo[0] = bwd::Front::BM;
  geo[1] = bwd::Wide::BM;
  geo[2] = bwd::Wide::BK;
  geo[3] = LNR;
}

// prep: LayerNorm output and dz (B S, C) in the compute type, row mean and
// 1 / std (B S), column sums of dz per block of LNR rows (blocks, C)
int fmg_bwd_prep(int dtype, const void* x, const void* g, const float* mask, const float* ln_s,
                 const float* ln_b, void* ln, void* dz, float* mu, float* rstd, float* db2_part,
                 long long n_rows, int C, float eps_ln, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  bwd::PrepArgs a{x, g, mask, ln_s, ln_b, ln, dz, mu, rstd, db2_part, n_rows, C, eps_ln};
  const dim3 grid((unsigned)((n_rows + LNR - 1) / LNR));
  const size_t smem = (size_t)(NT / 32) * C * sizeof(float);
  return dtype == 0 ? mm::launch_with(bwd::prep_kernel<float>, grid, smem, stream, a)
                    : mm::launch_with(bwd::prep_kernel<bf16>, grid, smem, stream, a);
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
  using namespace bwd;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = C % V == 0 && M % V == 0 && aligned16({ln, dz, w1, w2});
  FrontArgs a{ln, dz, w1, w2, mask, b1, nx, gg, gb, coef1, coef2, hout, part0, part1,
              S, C, M, vec};
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
  using namespace bwd;
  const int V = dtype == 0 ? 4 : 8;
  const int vec = lda % V == 0 && ldb % V == 0 && aligned16({A, Bm});
  GemmArgs g{A, Bm, out, lda, ldb, (long long)J, (long long)I * J, I, J, K, kps, vec};
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
  const dim3 grid((unsigned)((n_rows + LNR - 1) / LNR));
  const size_t smem = 2 * (size_t)(NT / 32) * C * sizeof(float);
  return dtype == 0 ? mm::launch_with(bwd::lnb_kernel<float>, grid, smem, stream, a)
                    : mm::launch_with(bwd::lnb_kernel<bf16>, grid, smem, stream, a);
}

}  // extern "C"
