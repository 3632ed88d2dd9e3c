// SGM cost aggregation for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface.
//
// Semantics are those of wass_tpu.stereo.sgm.sgm_aggregate (the plain JAX
// reference): for every path direction r the recurrence
//
//   L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d-1) + P1,
//                             L_r(p-r, d+1) + P1, min_k L_r(p-r, k) + P2)
//               - min_k L_r(p-r, k)
//
// runs along every scan line, and the int16 output is the sum over the
// directions.  All arithmetic is on small integers, so the kernel and the
// reference agree exactly.
//
// Windowed volumes (coarse-to-fine search): lane j of row y means disparity
// offsets[y] + j.  When a vertical or diagonal path crosses into a row whose
// offset differs by delta, the carry is realigned (new[j] = old[j + delta])
// and lanes that enter the window start from the no-predecessor value BIG.
// Full-range volumes pass all-equal offsets, so they never realign.
//
// Design: one warp walks one scan line from end to end in an in-kernel
// loop.  Disparities are spread over the lanes in chunks of 128: lane t holds
// d = 128*k + 4*t + e (e = 0..3) of chunk k, so each chunk's cost and sum
// are read with one coalesced 4-byte (cost) and 8-byte (sum) access per
// lane.  The +-1 disparity neighbours across lanes come from two warp
// shuffles per chunk, the min over d from a butterfly reduction.  The next
// pixel's cost and partial sum are loaded before the current pixel is
// computed, so memory latency overlaps the recurrence.  Each direction is
// one launch on the stream; the first writes the sum, the others add to it,
// so no two threads ever update one pixel at the same time.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBig = 32000;  // no-predecessor value, as in the reference
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Line {
  int y, x, len;
};

__device__ __forceinline__ Line line_start(int l, int H, int W, int dy, int dx) {
  Line s;
  if (dy == 0) {
    s.y = l;
    s.x = dx > 0 ? 0 : W - 1;
    s.len = W;
  } else if (dx == 0) {
    s.x = l;
    s.y = dy > 0 ? 0 : H - 1;
    s.len = H;
  } else {
    const int ys = dy > 0 ? 0 : H - 1;
    const int xs = dx > 0 ? 0 : W - 1;
    if (l < W) {
      s.y = ys;
      s.x = l;
    } else {
      s.y = ys + dy * (l - W + 1);
      s.x = xs;
    }
    const int rows = dy > 0 ? H - s.y : s.y + 1;
    const int cols = dx > 0 ? W - s.x : s.x + 1;
    s.len = rows < cols ? rows : cols;
  }
  return s;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// NC = number of 128-disparity chunks held by each warp (Dp <= 128 * NC).
template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_path_kernel(const uint8_t* __restrict__ cost, const int32_t* __restrict__ offsets,
                int16_t* __restrict__ agg, int H, int W, int D, int Dp, int dy, int dx,
                int P1, int P2, int accumulate, int windowed) {
  extern __shared__ int realign_buf[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const int line = blockIdx.x * kWarpsPerBlock + warp;
  if (line >= n_lines) return;  // warp-uniform
  int* buf = realign_buf + warp * 128 * NC;

  const Line s = line_start(line, H, W, dy, dx);
  const long long step = (long long)dy * W + dx;  // pixel stride along the line
  long long pix = (long long)s.y * W + s.x;

  int L[NC][4];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) L[k][e] = kBig;

  // Prefetched operands of the pixel about to be computed.
  uint32_t cq[NC] = {};
  uint2 aq[NC] = {};
  auto load = [&](long long p) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int d0 = 128 * k + 4 * lane;
      if (d0 < Dp) {
        cq[k] = *reinterpret_cast<const uint32_t*>(cost + p * Dp + d0);
        if (accumulate) aq[k] = *reinterpret_cast<const uint2*>(agg + p * Dp + d0);
      }
    }
  };
  load(pix);

  int y = s.y;
  int prev_off = windowed ? offsets[y] : 0;
  for (int i = 0; i < s.len; ++i) {
    uint32_t c_cur[NC];
    uint2 a_cur[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      c_cur[k] = cq[k];
      a_cur[k] = aq[k];
    }
    const long long cur = pix;
    if (i + 1 < s.len) {
      pix += step;
      load(pix);
    }

    if (windowed && dy != 0) {
      const int off = offsets[y];
      const int delta = off - prev_off;  // warp-uniform
      prev_off = off;
      if (delta != 0) {
#pragma unroll
        for (int k = 0; k < NC; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) buf[128 * k + 4 * lane + e] = L[k][e];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < NC; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 128 * k + 4 * lane + e;
            const int src = d + delta;
            L[k][e] = (d < D && src >= 0 && src < D) ? buf[src] : kBig;
          }
        __syncwarp();
      }
    }

    int m = kBig;
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) m = min(m, L[k][e]);
    const int minprev = warp_min(m);

    // Neighbours across lanes: lane t-1's last element and lane t+1's
    // first element of each chunk; lane 0 / lane 31 take them from the
    // previous / next chunk (lane 31 / lane 0 of it).
    int from_left[NC], from_right[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      from_left[k] = __shfl_sync(kFull, L[k][3], (lane + 31) & 31);
      from_right[k] = __shfl_sync(kFull, L[k][0], (lane + 1) & 31);
    }

    int16_t* out = agg + cur * Dp;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int d0 = 128 * k + 4 * lane;
      int left = from_left[k];
      if (lane == 0) left = k > 0 ? from_left[k > 0 ? k - 1 : 0] : kBig;
      int right = from_right[k];
      if (lane == 31) right = k + 1 < NC ? from_right[k + 1 < NC ? k + 1 : k] : kBig;
      int nv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int prev = L[k][e];
        const int lo = e > 0 ? L[k][e - 1] : left;
        const int hi = e < 3 ? L[k][e + 1] : right;
        const int best = min(min(prev, minprev + P2), min(lo, hi) + P1);
        const int c = (c_cur[k] >> (8 * e)) & 0xff;
        nv[e] = (d0 + e < D) ? c + best - minprev : kBig;
      }
      if (d0 < Dp) {
        int s0 = nv[0] < kBig ? nv[0] : 0, s1 = nv[1] < kBig ? nv[1] : 0;
        int s2 = nv[2] < kBig ? nv[2] : 0, s3 = nv[3] < kBig ? nv[3] : 0;
        if (accumulate) {
          s0 += (int16_t)(a_cur[k].x & 0xffff);
          s1 += (int16_t)(a_cur[k].x >> 16);
          s2 += (int16_t)(a_cur[k].y & 0xffff);
          s3 += (int16_t)(a_cur[k].y >> 16);
        }
        uint2 w;
        w.x = (uint32_t)(s0 & 0xffff) | ((uint32_t)(s1 & 0xffff) << 16);
        w.y = (uint32_t)(s2 & 0xffff) | ((uint32_t)(s3 & 0xffff) << 16);
        *reinterpret_cast<uint2*>(out + d0) = w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) L[k][e] = nv[e];
    }
    y += dy;
  }
}

// Path directions (dy, dx) for each supported path count, in the order of
// the reference: horizontal pair, vertical pair, then the diagonals.
struct Dir {
  int dy, dx;
};
constexpr Dir kDirs2[] = {{0, 1}, {0, -1}};
constexpr Dir kDirs4[] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}};
constexpr Dir kDirs5[] = {{0, 1}, {0, -1}, {1, 0}, {1, 1}, {1, -1}};
constexpr Dir kDirs8[] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {-1, -1}, {1, -1}, {-1, 1}};

template <int NC>
cudaError_t launch_all(cudaStream_t stream, const uint8_t* cost, const int32_t* offsets,
                       int16_t* agg, int H, int W, int D, int Dp, const Dir* dirs, int n_dirs,
                       int P1, int P2, int windowed) {
  const size_t smem = (size_t)kWarpsPerBlock * 128 * NC * sizeof(int);
  for (int i = 0; i < n_dirs; ++i) {
    const int dy = dirs[i].dy, dx = dirs[i].dx;
    const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
    const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sgm_path_kernel<NC><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
        cost, offsets, agg, H, W, D, Dp, dy, dx, P1, P2, i > 0 ? 1 : 0, windowed);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

ffi::Error SgmAggregateImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> cost,
                            ffi::Buffer<ffi::S32> offsets, ffi::ResultBuffer<ffi::S16> agg,
                            int64_t num_disp, int64_t p1, int64_t p2, int64_t directions,
                            int64_t windowed) {
  const auto dims = cost.dimensions();
  if (dims.size() != 3) return ffi::Error::InvalidArgument("cost must be (H, W, Dp)");
  const int H = (int)dims[0], W = (int)dims[1], Dp = (int)dims[2];
  const int D = (int)num_disp;
  if (Dp % 4 != 0 || D > Dp || D < 1)
    return ffi::Error::InvalidArgument("padded disparity axis must be a multiple of 4 and >= D");
  if (offsets.dimensions().size() != 1 || (int)offsets.dimensions()[0] != H)
    return ffi::Error::InvalidArgument("offsets must be (H,)");
  const Dir* dirs;
  int n_dirs;
  switch (directions) {
    case 2: dirs = kDirs2; n_dirs = 2; break;
    case 4: dirs = kDirs4; n_dirs = 4; break;
    case 5: dirs = kDirs5; n_dirs = 5; break;
    case 8: dirs = kDirs8; n_dirs = 8; break;
    default: return ffi::Error::InvalidArgument("directions must be 2, 4, 5 or 8");
  }
  const uint8_t* c = cost.typed_data();
  const int32_t* o = offsets.typed_data();
  int16_t* a = agg->typed_data();
  const int P1 = (int)p1, P2 = (int)p2, win = (int)windowed;
  const int nc = (Dp + 127) / 128;
  cudaError_t err;
  switch (nc) {
    case 1: err = launch_all<1>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 2: err = launch_all<2>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 3: err = launch_all<3>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 4: err = launch_all<4>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 5: err = launch_all<5>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 6: err = launch_all<6>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 7: err = launch_all<7>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    case 8: err = launch_all<8>(stream, c, o, a, H, W, D, Dp, dirs, n_dirs, P1, P2, win); break;
    default: return ffi::Error::InvalidArgument("disparity range above 1024 is not supported");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sgm_path_kernel launch: ") + cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(WassSgmAggregate, SgmAggregateImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S16>>()
                                  .Attr<int64_t>("num_disp")
                                  .Attr<int64_t>("p1")
                                  .Attr<int64_t>("p2")
                                  .Attr<int64_t>("directions")
                                  .Attr<int64_t>("windowed"));
