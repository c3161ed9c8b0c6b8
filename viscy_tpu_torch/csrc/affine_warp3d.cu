// Batched 3D affine warp with exact trilinear sampling for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU Pallas kernel viscy_tpu/ops/pallas/warp3d.py::
// _warp_kernel / ::_warp_kernel_resident (affine_warp_3d_pallas). It
// computes the function of viscy_tpu/ops/warp.py batched_trilinear_sample
// of affine_grid_3d, exactly, not the TPU kernel's two-pass separable
// approximation:
//
//   out[b, c, zo, yo, xo] = trilinear(vol[b, c], A_b @ q + t_b + center_in)
//   q_a = s_a * (i_a - (n_a - 1) / 2) + off_a          (centered output coord)
//
// with per-sample 3x4 output->input maps A_b | t_b, per-sample offsets off
// (a fused crop) and optional signs s (a fused flip). The base corner is
// clamped to [0, n-2] and the fraction clipped to [0, 1]; "zeros" padding
// zeroes a point with any coordinate outside [0, n-1], "border" clamps,
// "reflection" mirrors first. Every product and sum is rounded where the
// plain PyTorch version rounds it (no fused multiply-add), so the two agree
// to the last bit on the same inputs.
//
// One thread per output voxel: it forms the coordinates once and loops
// over the channels, 8 corner reads each (neighbouring threads read
// neighbouring input voxels, so the reads coalesce through L1/L2). None of
// the TPU kernel's limits apply: any plane shape, any offsets, any depth.
//
// What bounds it on an H100: ~30 operations per output voxel against at
// least one 4-byte read and one write per voxel: device-memory bytes. The
// least bytes are the input voxels the maps touch, read once, and the
// output written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Args {
  const float* vol;   // (B, C, Zi, Yi, Xi)
  const float* mats;  // (B, 3, 4)
  const float* off;   // (B, 3)
  const float* signs; // (B, 3) or null
  float* out;         // (B, C, Zo, Yo, Xo)
  int C, Zi, Yi, Xi, Zo, Yo, Xo;
  int mode;  // 0 zeros, 1 border, 2 reflection
};

__device__ __forceinline__ float reflect(float c, int n) {
  if (n == 1) return 0.f;
  const float period = (float)(2 * (n - 1));
  float r = fmodf(c, period);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, period);
  return r > (float)(n - 1) ? __fsub_rn(period, r) : r;
}

__device__ __forceinline__ void base_frac(float c, int n, int& b0, float& f) {
  const float fl = fminf(fmaxf(floorf(c), 0.f), (float)max(n - 2, 0));
  b0 = (int)fl;
  f = fminf(fmaxf(__fsub_rn(c, fl), 0.f), 1.f);
}

__global__ void __launch_bounds__(NT) warp_kernel(Args a) {
  const long long n_out = (long long)a.Zo * a.Yo * a.Xo;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= n_out) return;
  const int xo = (int)(idx % a.Xo);
  const int yo = (int)((idx / a.Xo) % a.Yo);
  const int zo = (int)(idx / ((long long)a.Xo * a.Yo));

  const float* m = a.mats + b * 12;
  const float* off = a.off + b * 3;
  const float sz = a.signs ? a.signs[b * 3 + 0] : 1.f;
  const float sy = a.signs ? a.signs[b * 3 + 1] : 1.f;
  const float sx = a.signs ? a.signs[b * 3 + 2] : 1.f;
  const float qz = __fadd_rn(__fmul_rn(sz, __fsub_rn((float)zo, 0.5f * (float)(a.Zo - 1))), off[0]);
  const float qy = __fadd_rn(__fmul_rn(sy, __fsub_rn((float)yo, 0.5f * (float)(a.Yo - 1))), off[1]);
  const float qx = __fadd_rn(__fmul_rn(sx, __fsub_rn((float)xo, 0.5f * (float)(a.Xo - 1))), off[2]);
  const float center[3] = {0.5f * (float)(a.Zi - 1), 0.5f * (float)(a.Yi - 1),
                           0.5f * (float)(a.Xi - 1)};
  float p[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* mr = m + 4 * r;
    float s = __fadd_rn(__fmul_rn(mr[0], qz), __fmul_rn(mr[1], qy));
    s = __fadd_rn(s, __fmul_rn(mr[2], qx));
    s = __fadd_rn(s, mr[3]);
    p[r] = __fadd_rn(s, center[r]);
  }
  float cz = p[0], cy = p[1], cx = p[2];
  if (a.mode == 2) {
    cz = reflect(cz, a.Zi);
    cy = reflect(cy, a.Yi);
    cx = reflect(cx, a.Xi);
  }
  const bool inside = cz >= 0.f && cz <= (float)(a.Zi - 1) && cy >= 0.f &&
                      cy <= (float)(a.Yi - 1) && cx >= 0.f && cx <= (float)(a.Xi - 1);
  const bool zero = a.mode == 0 && !inside;

  int z0, y0, x0;
  float fz, fy, fx;
  base_frac(cz, a.Zi, z0, fz);
  base_frac(cy, a.Yi, y0, fy);
  base_frac(cx, a.Xi, x0, fx);
  const long long xs = a.Xi > 1 ? 1 : 0;
  const long long ys = a.Yi > 1 ? a.Xi : 0;
  const long long zs = a.Zi > 1 ? (long long)a.Yi * a.Xi : 0;
  const long long n_in = (long long)a.Zi * a.Yi * a.Xi;
  const long long base = ((long long)z0 * a.Yi + y0) * a.Xi + x0;
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy), gz = __fsub_rn(1.f, fz);

  for (int c = 0; c < a.C; ++c) {
    const long long bc = (long long)b * a.C + c;
    float v = 0.f;
    if (!zero) {
      const float* src = a.vol + bc * n_in + base;
      float pl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* q = src + k * zs;
        const float w0 = __fadd_rn(__fmul_rn(__ldg(q), gx), __fmul_rn(__ldg(q + xs), fx));
        const float w1 = __fadd_rn(__fmul_rn(__ldg(q + ys), gx), __fmul_rn(__ldg(q + ys + xs), fx));
        pl[k] = __fadd_rn(__fmul_rn(w0, gy), __fmul_rn(w1, fy));
      }
      v = __fadd_rn(__fmul_rn(pl[0], gz), __fmul_rn(pl[1], fz));
    }
    a.out[bc * n_out + idx] = v;
  }
}

}  // namespace

extern "C" {

// vol (B, C, Zi, Yi, Xi), mats (B, 3, 4), off (B, 3), signs (B, 3) or null,
// out (B, C, Zo, Yo, Xo), all float32 and contiguous. mode: 0 zeros,
// 1 border, 2 reflection. Returns the launch's cudaError_t.
int aw3_warp(const float* vol, const float* mats, const float* off, const float* signs,
             float* out, int B, int C, int Zi, int Yi, int Xi, int Zo, int Yo, int Xo, int mode,
             void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Zi <= 0 || Yi <= 0 || Xi <= 0 || Zo <= 0 || Yo <= 0 ||
      Xo <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)Zo * Yo * Xo;
  const long long blocks = (n_out + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a{vol, mats, off, signs, out, C, Zi, Yi, Xi, Zo, Yo, Xo, mode};
  warp_kernel<<<dim3((unsigned)blocks, B), NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
