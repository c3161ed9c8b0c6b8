// Batched 3D affine warp with exact trilinear sampling for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU Pallas kernel viscy_tpu/ops/pallas/warp3d.py:226,352
// (_warp_kernel / _warp_kernel_resident of affine_warp_3d_pallas). It
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
// to the last bit on the same inputs. One launch warps up to four keys
// (source and target volumes of any channel counts, one set of maps), and a
// sample whose apply mask is 0 gets the exact integer crop
// x[..., s:s+r] of each key instead of a warp.
//
// What bounds it on an H100: about 30 operations per output voxel against
// a 4-byte write per voxel and channel and the input the maps touch:
// device-memory bytes. The least bytes are the input voxels the maps
// touch, read once, and the output written once (0.86 GB, 0.256 ms at
// 3.35 TB/s, for the flagship (16,3,20,600,600) -> (16,3,15,384,384)).
// The first version of this kernel, one thread per output voxel reading
// its 8 corners from device memory, made 24 scattered loads a voxel whose
// lanes walk a rotated diagonal of the source; it ran at 14 % of that
// bound.
//
// The design serves the bound by reading each input voxel from device
// memory about once, and from shared memory after that:
// - A block owns a 16 x 16 output tile in (y, x) and walks all output
//   z-slices; each of its 128 threads carries two voxels of the tile (rows
//   y and y + 8), whose coordinate chains interleave. The tile's input box
//   in (y, x) is the min and max over the maps of the 8 corners of its
//   (z, y, x) run, floored, plus the trilinear neighbour and a 1/16-voxel
//   margin against rounding (an interior voxel's rounded coordinate is not
//   exactly affine, but it is within a few ulps, < 1e-3 voxel at these
//   sizes, of the hull of the corners'), clamped to the volume (which is
//   what zeros and border read); in x it is widened to whole 16-byte
//   chunks.
// - Each output slice needs the input planes its 4 corners' z range
//   covers (tabulated once per block, 2 x Zo ints of shared memory after
//   the ring). The planes live in a ring in shared
//   memory (plane p in slot p % R), staged with cp.async (16-byte copies
//   when rows are 16-byte aligned, else 4-byte ones), one commit group per
//   plane, as far ahead of the current slice as the ring holds; a slice
//   waits only for its own planes. Each plane's box comes from device
//   memory (or L2) once per block.
// - The ring has RING_FLOATS floats, 55 KiB, so four blocks (16 warps) fit
//   on an SM: with two voxels a thread, two or three larger rings an SM
//   measured slower, the math's latency less hidden. R = RING_FLOATS /
//   (channels x box) per block.
//   At the production draws (scale 0.5-1.5 in y and x, any rotation about
//   z, shear yz 0.05) a tile's 15 output steps span at most 15 x 2 x
//   sqrt(2) = 42.4 input voxels, so a box is at most about 46 x 48 per
//   plane and channel with the neighbour, margins and 16-byte columns, and
//   a slice reads at most 3 planes (the z-shear is at most 0.05 x 20/600:
//   a tile's slice spans less than 0.25 input planes). A box too large for
//   3 planes of 3 channels (the corner of the range: scale 0.5 in y and x
//   near 45 degrees) is staged one channel per pass, R >= 6, so every
//   production draw is staged (tests/test_torch_port_warp_plan.py).
// - A thread forms its voxels' corner indices and fractions once per
//   slice in registers and, with the launch's channel count a template
//   argument (1-4), reads every channel's 8 corners from shared memory
//   before the math; each channel's rows are written coalesced.
// - Direct path, in the same kernel: blocks in reflection mode (mirrored
//   coordinates do not map a box to a box), slices whose planes exceed the
//   ring even one channel at a time, and any voxel whose corners fall
//   outside the staged box read device memory directly, as the first version
//   did; the result is the same. counters[0] counts blocks with a direct
//   slice, counters[1] voxels of staged slices read directly (expected 0),
//   counters[2] samples warped (so counters[2] x tiles blocks ran).
//
// ops/warp3d.py::warp_plan mirrors the box and plane arithmetic in Python
// (the same float32 roundings), so the CPU tests check what the kernel
// stages.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int VPT = 2;                 // output voxels per thread and slice
constexpr int NT = TILE * TILE / VPT;  // threads per block
constexpr int ROWS = TILE / VPT;       // a thread's voxels sit ROWS rows apart
constexpr int BLOCKS_PER_SM = 4;
constexpr int RING_FLOATS = 14080;  // 55 KiB: four blocks per SM with the slice table
constexpr float EPS = 0.0625f;  // box margin, in voxels
constexpr int MAX_KEYS = 4;

struct Args {
  const float* src[MAX_KEYS];  // (B, ch[k], Zi, Yi, Xi)
  float* dst[MAX_KEYS];        // (B, ch[k], Zo, Yo, Xo)
  int ch[MAX_KEYS];            // 0 for unused keys
  int C;                       // sum of ch
  const float* mats;           // (B, 3, 4)
  const float* off;            // (B, 3)
  const float* signs;          // (B, 3) or null
  const unsigned char* mask;   // (B,) or null: 0 = copy the crop
  unsigned long long* counters;  // [3], see the note above
  int Zi, Yi, Xi, Zo, Yo, Xo;
  int crop_z, crop_y, crop_x;  // the center crop's start, (n_in - n_out) / 2
  int mode;  // 0 zeros, 1 border, 2 reflection
  int vec;   // rows 16-byte aligned: Xi % 4 == 0 and every src 16-byte aligned
  int tiles_x;
};

__device__ __forceinline__ float qcoord(float s, int i, int n, float off) {
  return __fadd_rn(__fmul_rn(s, __fsub_rn((float)i, 0.5f * (float)(n - 1))), off);
}

__device__ __forceinline__ float map_row(const float* mr, float qz, float qy, float qx, float center) {
  float s = __fadd_rn(__fmul_rn(mr[0], qz), __fmul_rn(mr[1], qy));
  s = __fadd_rn(s, __fmul_rn(mr[2], qx));
  s = __fadd_rn(s, mr[3]);
  return __fadd_rn(s, center);
}

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

// first and last index a coordinate range [lo, hi] reads (base corner and
// its neighbour), with the margin, clamped as base_frac clamps
__device__ __forceinline__ int first_read(float lo, int n) {
  return (int)fminf(fmaxf(floorf(__fsub_rn(lo, EPS)), 0.f), (float)max(n - 2, 0));
}
__device__ __forceinline__ int last_read(float hi, int n) {
  return (int)fminf(fmaxf(floorf(__fadd_rn(hi, EPS)), 0.f), (float)max(n - 2, 0)) + (n > 1 ? 1 : 0);
}

// trilinear blend of the corners at q0 (plane z0) and q1 (plane z0 + 1),
// neighbour steps xs and ys, rounded as the plain version rounds
template <bool kGlobal>
__device__ __forceinline__ float blend(const float* q0, const float* q1, int xs, int ys, float fx,
                                       float gx, float fy, float gy, float fz, float gz) {
  auto ld = [](const float* p) {
    if constexpr (kGlobal)
      return __ldg(p);
    else
      return *p;
  };
  float pl[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* q = k ? q1 : q0;
    const float w0 = __fadd_rn(__fmul_rn(ld(q), gx), __fmul_rn(ld(q + xs), fx));
    const float w1 = __fadd_rn(__fmul_rn(ld(q + ys), gx), __fmul_rn(ld(q + ys + xs), fx));
    pl[k] = __fadd_rn(__fmul_rn(w0, gy), __fmul_rn(w1, fy));
  }
  return __fadd_rn(__fmul_rn(pl[0], gz), __fmul_rn(pl[1], fz));
}

// the source volume of channel c (over all keys) of sample b
__device__ __forceinline__ const float* channel_src(const Args& a, int b, int c, size_t n_in) {
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k) {
    if (c < a.ch[k]) return a.src[k] + (size_t)(b * a.ch[k] + c) * n_in;
    c -= a.ch[k];
  }
  return nullptr;
}

// the output volume of channel c (over all keys) of sample b
__device__ __forceinline__ float* channel_dst(const Args& a, int b, int c, size_t n_out) {
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k) {
    if (c < a.ch[k]) return a.dst[k] + (size_t)(b * a.ch[k] + c) * n_out;
    c -= a.ch[k];
  }
  return nullptr;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// wait until at most n (clamped to [0, 7]) of this thread's newest commit
// groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n < 0 ? 0 : n > 7 ? 7 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// a sample the apply mask leaves alone: the exact crop of every key
__device__ void copy_crop(const Args& a, int b, int yo, int xo) {
  const int n_in = a.Zi * a.Yi * a.Xi, n_out = a.Zo * a.Yo * a.Xo;
  const int in0 = ((a.crop_z * a.Yi) + yo + a.crop_y) * a.Xi + xo + a.crop_x;
  const int out0 = yo * a.Xo + xo;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k) {
    for (int c = 0; c < a.ch[k]; ++c) {
      const size_t bc = (size_t)b * a.ch[k] + c;
      const float* s = a.src[k] + bc * n_in + in0;
      float* d = a.dst[k] + bc * n_out + out0;
      for (int zo = 0; zo < a.Zo; ++zo) d[zo * a.Yo * a.Xo] = __ldg(s + zo * a.Yi * a.Xi);
    }
  }
}

// kC: the launch's total channel count when it is 1-4 (the channel loops
// unroll and each channel's output pointer is formed once per block), or 0
// for any count
template <int kC>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) warp_kernel(Args a) {
  extern __shared__ __align__(16) float ring[];  // RING_FLOATS, then the slice table
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / a.tiles_x) * TILE, tx0 = (blockIdx.x % a.tiles_x) * TILE;
  const int ty1 = min(ty0 + TILE, a.Yo) - 1, tx1 = min(tx0 + TILE, a.Xo) - 1;
  const int xo = tx0 + tid % TILE;
  int yo[VPT];
  bool active[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    yo[v] = ty0 + tid / TILE + v * ROWS;
    active[v] = yo[v] <= ty1 && xo <= tx1;
  }
  if (a.mask && !a.mask[b]) {
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      if (active[v]) copy_crop(a, b, yo[v], xo);
    return;
  }
  const int C = kC ? kC : a.C;
  const size_t n_out = (size_t)a.Zo * a.Yo * a.Xo;
  float* out[kC ? kC : 1];
#pragma unroll
  for (int c = 0; c < (kC ? kC : 1); ++c) out[c] = kC ? channel_dst(a, b, c, n_out) : nullptr;

  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = a.mats[b * 12 + i];
  const float oz = a.off[b * 3 + 0], oy = a.off[b * 3 + 1], ox = a.off[b * 3 + 2];
  const float sz = a.signs ? a.signs[b * 3 + 0] : 1.f;
  const float sy = a.signs ? a.signs[b * 3 + 1] : 1.f;
  const float sx = a.signs ? a.signs[b * 3 + 2] : 1.f;
  const float center_z = 0.5f * (float)(a.Zi - 1), center_y = 0.5f * (float)(a.Yi - 1),
              center_x = 0.5f * (float)(a.Xi - 1);
  const float qx = qcoord(sx, xo, a.Xo, ox);
  float qy[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) qy[v] = qcoord(sy, yo[v], a.Yo, oy);
  const float qy_c[2] = {qcoord(sy, ty0, a.Yo, oy), qcoord(sy, ty1, a.Yo, oy)};
  const float qx_c[2] = {qcoord(sx, tx0, a.Xo, ox), qcoord(sx, tx1, a.Xo, ox)};

  // the block's input box in (y, x): the 8 corners of its (z, y, x) run
  float ymin = INFINITY, ymax = -INFINITY, xmin = INFINITY, xmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float qz = qcoord(sz, (k & 4) ? a.Zo - 1 : 0, a.Zo, oz);
    const float py = map_row(m + 4, qz, qy_c[(k >> 1) & 1], qx_c[k & 1], center_y);
    const float px = map_row(m + 8, qz, qy_c[(k >> 1) & 1], qx_c[k & 1], center_x);
    ymin = fminf(ymin, py);
    ymax = fmaxf(ymax, py);
    xmin = fminf(xmin, px);
    xmax = fmaxf(xmax, px);
  }
  const int ylo = first_read(ymin, a.Yi), yhi = last_read(ymax, a.Yi);
  int xlo = first_read(xmin, a.Xi), xhi = last_read(xmax, a.Xi);
  if (a.vec) {
    xlo &= ~3;
    xhi = min(xhi | 3, a.Xi - 1);
  }
  const int by = yhi - ylo + 1, bx = xhi - xlo + 1;
  const int plane = by * bx;  // floats per plane and channel

  // every slice's input planes [za, zb] (its 4 corners' z range), formed
  // once per block
  int* const s_za = reinterpret_cast<int*>(ring + RING_FLOATS);
  int* const s_zb = s_za + a.Zo;
  for (int zo = tid; zo < a.Zo; zo += NT) {
    const float qz = qcoord(sz, zo, a.Zo, oz);
    float zmin = INFINITY, zmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pz = map_row(m, qz, qy_c[k >> 1], qx_c[k & 1], center_z);
      zmin = fminf(zmin, pz);
      zmax = fmaxf(zmax, pz);
    }
    s_za[zo] = first_read(zmin, a.Zi);
    s_zb[zo] = last_read(zmax, a.Zi);
  }
  __syncthreads();
  // The ring holds R planes of cpass channels each. A block whose box is
  // too large for one slice's planes of every channel stages and warps
  // one channel per pass instead (the same box; coordinates formed once
  // per pass).
  int need = 0;  // the most planes one slice reads
  for (int zo = 0; zo < a.Zo; ++zo) need = max(need, s_zb[zo] - s_za[zo] + 1);
  auto fits = [&](int channels) { return (long long)channels * plane * need <= RING_FLOATS; };
  const int cpass = a.mode != 2 && !fits(C) && fits(1) ? 1 : C;
  const long long slot_floats = (long long)cpass * plane;
  const int R = a.mode == 2 ? 0 : (int)(RING_FLOATS / slot_floats);
  const int per_slot = R ? (int)slot_floats : 0;  // a staged slot fits the ring

  const size_t n_in = (size_t)a.Zi * a.Yi * a.Xi;
  // each thread copies chunk column k0 (+ cols) of rows r0 (+ rstep) of
  // every staged (plane, channel) box: the divisions happen once here
  const int width = a.vec ? 4 : 1, chunks = bx / width;
  const int cols = min(chunks, NT), rstep = NT / cols;
  const int k0 = tid % cols, r0 = tid / cols;
  int c_lo = 0;  // the pass's first channel
  // stage plane p (the pass's channels) into slot p % R, as one commit group
  auto stage = [&](int p) {
    if (r0 < rstep) {
      for (int c = 0; c < cpass; ++c) {
        const float* s = channel_src(a, b, c_lo + c, n_in) + (p * a.Yi + ylo) * a.Xi + xlo;
        float* d = ring + (size_t)(p % R) * per_slot + c * plane;
        for (int r = r0; r < by; r += rstep) {
          for (int k = k0; k < chunks; k += cols) {
            if (a.vec)
              cp_async16(d + r * bx + 4 * k, s + r * a.Xi + 4 * k);
            else
              cp_async4(d + r * bx + k, s + r * a.Xi + k);
          }
        }
      }
    }
    cp_async_commit();
  };

  const int dz = a.Zi > 1, dy = a.Yi > 1, dx = a.Xi > 1;
  bool direct_slice = false;
  unsigned long long stray = 0;
  for (; c_lo < C; c_lo += cpass) {
    if (c_lo) {  // the last pass's copies have landed and its reads are done
      cp_async_wait_all();
      __syncthreads();
    }
    // The slices' plane ranges move monotonically with zo (up or down).
    // Planes ahead of the current slice are staged as far as the ring holds,
    // one commit group per plane in the order they are needed, so many
    // planes are in flight while slices compute; a slice waits only for its
    // own planes.
    int za = s_za[0], zb = s_zb[0];
    const int za_end = s_za[a.Zo - 1], zb_end = s_zb[a.Zo - 1];
    const bool up = za_end >= za;
    const int z_first = min(za, za_end), z_last = max(zb, zb_end);
    int lo = 0, hi = -1;  // planes issued in this run, plane p in slot p % R
    int ready = up ? -1 : a.Zi;  // planes up to (down from) here have landed for the whole block
    int slot_a = R ? za % R : 0;  // the slot of plane za
    for (int zo = 0; zo < a.Zo; ++zo) {
      if (zo) {
        const int prev = za;
        za = s_za[zo];
        zb = s_zb[zo];
        if (R) {
          slot_a += za - prev;
          while (slot_a >= R) slot_a -= R;
          while (slot_a < 0) slot_a += R;
        }
      }
      const bool staged = zb - za + 1 <= R;
      if (staged) {
        if (up ? (hi < lo || za < lo || za > hi + 1) : (hi < lo || zb > hi || zb < lo - 1)) {
          lo = up ? za : zb + 1;  // a new run: nothing of it issued yet
          hi = lo - 1;
          ready = up ? -1 : a.Zi;
        }
        const int target = up ? min(za + R - 1, z_last) : max(zb - R + 1, z_first);
        if (up ? hi < target : lo > target) {
          // the new planes take the slots of planes target -/+ R and beyond:
          // their copies land and every thread is done reading them first
          cp_async_wait_pending(up ? hi - max(target - R, lo - 1) : min(target + R, hi + 1) - lo);
          __syncthreads();
          if (up) {
            for (int p = hi + 1; p <= target; ++p) stage(p);
            hi = target;
          } else {
            for (int p = lo - 1; p >= target; --p) stage(p);
            lo = target;
          }
        }
        if (up ? zb > ready : za < ready) {
          const int n = min(up ? hi - zb : za - lo, 7);
          cp_async_wait_pending(n);
          __syncthreads();
          ready = up ? hi - n : lo + n;
        }
      } else {
        direct_slice = true;
      }

      // the thread's voxels: coordinates, corners and fractions in registers
      const float qz = qcoord(sz, zo, a.Zo, oz);
      int z0[VPT], y0[VPT], x0[VPT];
      float fz[VPT], fy[VPT], fx[VPT];
      bool skip[VPT], in_box[VPT];
      bool shared_only = true;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        float cz = map_row(m, qz, qy[v], qx, center_z);
        float cy = map_row(m + 4, qz, qy[v], qx, center_y);
        float cx = map_row(m + 8, qz, qy[v], qx, center_x);
        if (a.mode == 2) {
          cz = reflect(cz, a.Zi);
          cy = reflect(cy, a.Yi);
          cx = reflect(cx, a.Xi);
        }
        const bool inside = cz >= 0.f && cz <= (float)(a.Zi - 1) && cy >= 0.f &&
                            cy <= (float)(a.Yi - 1) && cx >= 0.f && cx <= (float)(a.Xi - 1);
        const bool zero = a.mode == 0 && !inside;
        base_frac(cz, a.Zi, z0[v], fz[v]);
        base_frac(cy, a.Yi, y0[v], fy[v]);
        base_frac(cx, a.Xi, x0[v], fx[v]);
        in_box[v] = staged && z0[v] >= za && z0[v] + dz <= zb && y0[v] >= ylo && y0[v] + dy <= yhi &&
                    x0[v] >= xlo && x0[v] + dx <= xhi;
        skip[v] = zero || !active[v];  // no reads: a zero or a voxel beyond the tile's edge
        if (!skip[v] && !in_box[v]) {
          shared_only = false;
          if (staged) ++stray;
        }
      }
      // every voxel's every channel read before the math, when all come from shared memory
      if (kC > 0 && cpass == C && shared_only) {
        constexpr int nc = kC ? kC : 1;
        float val[VPT][nc];
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          int s0 = slot_a + (z0[v] - za), s1 = s0 + dz;  // planes za..zb: consecutive slots mod R
          if (s0 >= R) s0 -= R;
          if (s1 >= R) s1 -= R;
          const int yx = (y0[v] - ylo) * bx + (x0[v] - xlo);
          const int i0 = s0 * per_slot + yx, i1 = s1 * per_slot + yx, ys = dy ? bx : 0;
          const float gx = __fsub_rn(1.f, fx[v]), gy = __fsub_rn(1.f, fy[v]),
                      gz = __fsub_rn(1.f, fz[v]);
#pragma unroll
          for (int c = 0; c < nc; ++c)
            val[v][c] = skip[v] ? 0.f
                                : blend<false>(ring + i0 + c * plane, ring + i1 + c * plane, dx, ys,
                                               fx[v], gx, fy[v], gy, fz[v], gz);
        }
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          if (!active[v]) continue;
          const int o = (zo * a.Yo + yo[v]) * a.Xo + xo;
#pragma unroll
          for (int c = 0; c < nc; ++c) out[c][o] = val[v][c];
        }
      } else {
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          if (!active[v]) continue;
          const int o = (zo * a.Yo + yo[v]) * a.Xo + xo;
          const float gx = __fsub_rn(1.f, fx[v]), gy = __fsub_rn(1.f, fy[v]),
                      gz = __fsub_rn(1.f, fz[v]);
          if (skip[v] || in_box[v]) {
            int s0 = slot_a + (z0[v] - za), s1 = s0 + dz;
            if (s0 >= R) s0 -= R;
            if (s1 >= R) s1 -= R;
            const int yx = (y0[v] - ylo) * bx + (x0[v] - xlo);
            const int i0 = s0 * per_slot + yx, i1 = s1 * per_slot + yx, ys = dy ? bx : 0;
            for (int c = 0; c < cpass; ++c)
              channel_dst(a, b, c_lo + c, n_out)[o] =
                  skip[v] ? 0.f
                          : blend<false>(ring + i0 + c * plane, ring + i1 + c * plane, dx, ys, fx[v],
                                         gx, fy[v], gy, fz[v], gz);
          } else {
            const int base = (z0[v] * a.Yi + y0[v]) * a.Xi + x0[v];
            const int zs = dz ? a.Yi * a.Xi : 0, ys = dy ? a.Xi : 0;
            for (int c = c_lo; c < c_lo + cpass; ++c) {
              const float* q = channel_src(a, b, c, n_in) + base;
              channel_dst(a, b, c, n_out)[o] =
                  blend<true>(q, q + zs, dx, ys, fx[v], gx, fy[v], gy, fz[v], gz);
            }
          }
        }
      }
    }
  }  // channel passes
  cp_async_wait_all();
  if (tid == 0 && direct_slice) atomicAdd(&a.counters[0], 1ULL);
  if (tid == 0 && blockIdx.x == 0) atomicAdd(&a.counters[2], 1ULL);
  if (stray) atomicAdd(&a.counters[1], stray);
}

}  // namespace

extern "C" {

// src[k] (B, ch[k], Zi, Yi, Xi) and dst[k] (B, ch[k], Zo, Yo, Xo) for
// k < nkeys <= 4, mats (B, 3, 4), off (B, 3), signs (B, 3) or null, all
// float32 and contiguous; mask (B,) uint8 or null: a sample it leaves at 0
// gets the center crop, start (n_in - n_out) / 2 per axis; counters three
// uint64 on the device. mode: 0 zeros, 1 border, 2 reflection; vec: every
// src 16-byte aligned and Xi % 4 == 0. Returns the launch's cudaError_t.
int aw3_warp(const float* const* src, float* const* dst, const int* ch, int nkeys, int B, int Zi,
             int Yi, int Xi, int Zo, int Yo, int Xo, const float* mats, const float* off,
             const float* signs, const unsigned char* mask, int mode, int vec,
             unsigned long long* counters, void* stream) {
  if (nkeys < 1 || nkeys > MAX_KEYS || B <= 0 || B > 65535 || Zi <= 0 || Yi <= 0 || Xi <= 0 ||
      Zo <= 0 || Yo <= 0 || Xo <= 0 || mode < 0 || mode > 2 || !counters)
    return (int)cudaErrorInvalidValue;
  if ((long long)Zi * Yi * Xi > 0x7fffffffLL || (long long)Zo * Yo * Xo > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec && Xi % 4) return (int)cudaErrorInvalidValue;
  if (mask && (Zo > Zi || Yo > Yi || Xo > Xi)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.C = 0;
  for (int k = 0; k < nkeys; ++k) {
    if (ch[k] <= 0 || !src[k] || !dst[k]) return (int)cudaErrorInvalidValue;
    a.src[k] = src[k];
    a.dst[k] = dst[k];
    a.ch[k] = ch[k];
    a.C += ch[k];
  }
  a.mats = mats;
  a.off = off;
  a.signs = signs;
  a.mask = mask;
  a.counters = counters;
  a.Zi = Zi, a.Yi = Yi, a.Xi = Xi, a.Zo = Zo, a.Yo = Yo, a.Xo = Xo;
  a.crop_z = (Zi - Zo) / 2, a.crop_y = (Yi - Yo) / 2, a.crop_x = (Xi - Xo) / 2;
  a.mode = mode;
  a.vec = vec;
  a.tiles_x = (Xo + TILE - 1) / TILE;
  const long long tiles = (long long)a.tiles_x * ((Yo + TILE - 1) / TILE);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = a.C == 1   ? warp_kernel<1>
                         : a.C == 2 ? warp_kernel<2>
                         : a.C == 3 ? warp_kernel<3>
                         : a.C == 4 ? warp_kernel<4>
                                    : warp_kernel<0>;
  const long long smem_ll = (long long)RING_FLOATS * sizeof(float) + 2LL * Zo * sizeof(int);
  if (smem_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
