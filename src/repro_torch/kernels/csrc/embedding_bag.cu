// K6 — EmbeddingBag: weighted row gather and bag sum over padded bags.
//
// Replaces: src/repro/kernels/embedding_bag.py::_embag_kernel (the pallas_call in
// embedding_bag, embedding_bag.py:63).
//
// Computes, for bag b of B and column d of D:
//     out[b, d] = Σ_l  w[b, l] · f32(table[idx[b, l], d])      (idx < 0: padding)
// from acc = +0.0f, slot by slot in l order, acc = acc + row * w with the
// product and the sum each rounded once (__fmul_rn / __fadd_rn, built with
// --fmad=false). A pad slot is skipped, which leaves acc's bits as they were;
// ref.embedding_bag_ref takes the same steps, so the two agree bit for bit.
// Ids >= V are outside the contract, as in the reference: nothing checks them.
//
// Bound on an H100: bytes. Each slot reads 4 B of idx and 4 B of w and one
// table row; each bag writes 4·D B; 2·D flops a slot are nothing beside
// that. The least time is (idx + w + the distinct rows gathered + out) over
// 3.35 TB/s. A gather moves whole 32-byte sectors, so a row narrower than 8
// floats (FM's linear table, D = 1) costs 32 B for 4 useful ones and cannot
// come near that bound.
//
// Design (simple first): one thread per (bag, column) pair, so that D = 1
// still fills a warp — a 256-thread block owns 256 / min(D, 256) bags and
// min(D, 256) columns (wider rows take more blocks along grid.y). The block
// stages its bags' idx and w in shared memory one tile of slots at a time
// (rows padded to an odd pitch, so the 32 bags a warp reads sit on distinct
// banks) and each thread walks the tile's slots in order, keeping its sum in
// a register across tiles. The TPU kernel walked one bag's slots with a
// scalar loop and a dynamic row DMA each; here a warp issues 32 gathers at
// once and the table stays in HBM behind L2. Vector loads for D >= 4 and a
// warp per bag for wide D are a later change.
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int SMEM_SLOTS = 4096;   // (idx, w) pairs staged per tile: 32 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out, long long B,
                     int L, int D, int cols, int bags, int tile, int pitch) {
  __shared__ int s_idx[SMEM_SLOTS];
  __shared__ float s_w[SMEM_SLOTS];
  const long long b0 = (long long)blockIdx.x * bags;
  const int c0 = blockIdx.y * cols;
  const int lb = threadIdx.x / cols;             // this thread's bag in the block
  const int c = threadIdx.x % cols;              // and its column in the block's span
  const long long b = b0 + lb;
  const bool active = lb < bags && b < B && c0 + c < D;
  const int nb = (int)min((long long)bags, B - b0);
  float acc = 0.0f;
  for (int l0 = 0; l0 < L; l0 += tile) {
    const int nl = min(tile, L - l0);
    __syncthreads();                             // the previous tile is consumed
    for (int i = threadIdx.x; i < nb * nl; i += THREADS) {
      const int bb = i / nl, l = i % nl;
      const long long src = (b0 + bb) * L + l0 + l;
      s_idx[bb * pitch + l] = idx[src];
      s_w[bb * pitch + l] = w[src];
    }
    __syncthreads();
    if (active) {
      const int* si = s_idx + lb * pitch;
      const float* sw = s_w + lb * pitch;
      for (int l = 0; l < nl; ++l) {
        const int r = si[l];
        if (r >= 0) {
          const float x = to_f32(table[(long long)r * D + c0 + c]);
          acc = __fadd_rn(acc, __fmul_rn(x, sw[l]));
        }
      }
    }
  }
  if (active) out[b * D + c0 + c] = acc;
}

// table (V, D) f32 or bf16, idx (B, L) i32, w (B, L) f32, out (B, D) f32; all
// contiguous. L = 0 writes zeros.
REPRO_EXPORT int embedding_bag_launch(const void* table, const void* idx, const void* w,
                                      void* out, long long B, int L, int D, int bf16,
                                      void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const int cols = D < THREADS ? D : THREADS;
  const int bags = THREADS / cols;
  int tile = SMEM_SLOTS / bags - 1;              // pitch = tile | 1 <= SMEM_SLOTS / bags
  if (tile > L) tile = L;
  if (tile < 1) tile = 1;
  const int pitch = tile | 1;
  const dim3 grid((unsigned)((B + bags - 1) / bags), (unsigned)((D + cols - 1) / cols));
  if (bf16) {
    embedding_bag_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)table, (const int*)idx, (const float*)w, (float*)out, B, L, D,
        cols, bags, tile, pitch);
  } else {
    embedding_bag_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)idx, (const float*)w, (float*)out, B, L, D, cols,
        bags, tile, pitch);
  }
  return (int)cudaGetLastError();
}
