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
// A gather waits on L2 or HBM, and the sum's order forbids splitting one
// column's slots between threads, so the design keeps several gathers in
// flight per thread and moves each row in as few loads as it can:
//  - a group of G = D / V threads a bag, each owning V neighbouring columns
//    (V = 4 floats — 16 bytes — where D % 4 == 0 and the table's base is
//    16-byte aligned, 2 where D % 2 == 0 (FM's D 10), else 1; bf16 rows take
//    8, 4, 2 or 1 elements a load), several bags a warp and NT / G bags a
//    block of NT threads (rows wider than NT loads take more blocks along
//    grid.y);
//  - the block's bags are contiguous in idx and w, so it stages that range in
//    shared memory with 16-byte loads, a tile of up to EB_TILE slots at a
//    time (one tile for the recsys shapes), with no division per element;
//  - each thread loads the rows of U slots into registers first (each load
//    predicated on its id >= 0), then adds them in slot order: U gathers in
//    flight.
// More gathers in flight stopped paying at U = 4 to 8 on an H100 (U = 16 was
// slower), so the rest is the gathers' own traffic through L1 and L2: one
// or two 32-byte sectors a row fetched, ~13 rows fetched for each distinct
// row at FM's zipf ids.
#include <cuda_bf16.h>

#include "common.cuh"

#define EB_TILE 12288     // (idx, w) slots staged per tile: 96 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Row {
  T e[V];
};

// dst[0..len) = src[start..start + len) for 4-byte elements, with 16-byte
// loads where src is 16-byte aligned; no load reaches past src[total - 1].
template <typename E>
__device__ __forceinline__ void stage(const E* __restrict__ src, long long start, int len,
                                      long long total, E* dst) {
  static_assert(sizeof(E) == 4, "4-byte elements");
  if (((uintptr_t)src & 15) == 0) {
    const long long a0 = start & ~3LL;
    const int chunks = (int)((start + len - a0 + 3) >> 2);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const long long e0 = a0 + 4LL * c;
      Row<E, 4> v;
      if (e0 + 4 <= total) {
        v = *reinterpret_cast<const Row<E, 4>*>(src + e0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v.e[i] = e0 + i < total ? src[e0 + i] : E(0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long e = e0 + i;
        if (e >= start && e < start + len) dst[e - start] = v.e[i];
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[start + i];
  }
}

// Block (x, y) of NT threads: bags [x·nb, x·nb + nb), columns [y·G·V,
// (y + 1)·G·V); thread t serves bag t / G and columns V·(t % G) of that
// span, loading the rows of U slots before it adds them. tile: slots staged
// at a time.
template <typename T, int V, int NT, int U>
__global__ void __launch_bounds__(NT, 1024 / NT)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out, long long B,
                     int L, int D, int G, int nb, int tile) {
  extern __shared__ __align__(16) int eb_smem[];
  int* s_idx = eb_smem;
  float* s_w = reinterpret_cast<float*>(eb_smem + tile);
  const long long b0 = (long long)blockIdx.x * nb;
  const int lb = threadIdx.x / G;
  const int col = blockIdx.y * G * V + (threadIdx.x - lb * G) * V;
  const long long b = b0 + lb;
  const bool active = lb < nb && b < B && col < D;
  const int nbags = (int)min((long long)nb, B - b0);
  const long long first = b0 * L, total = B * L;
  const int region = nbags * L;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int s0 = 0; s0 < region; s0 += tile) {
    const int len = min(tile, region - s0);
    __syncthreads();                             // the previous tile is consumed
    stage(idx, first + s0, len, total, s_idx);
    stage(w, first + s0, len, total, s_w);
    __syncthreads();
    if (!active) continue;
    const int l0 = max(lb * L, s0) - s0;         // this bag's slots in the tile
    const int l1 = min(lb * L + L, s0 + len) - s0;
    for (int i = l0; i < l1; i += U) {
      int r[U];
      Row<T, V> x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) r[u] = i + u < l1 ? s_idx[i + u] : -1;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r[u] >= 0) x[u] = *reinterpret_cast<const Row<T, V>*>(table + (long long)r[u] * D + col);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r[u] >= 0) {
          const float wt = s_w[i + u];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(to_f32(x[u].e[e]), wt));
        }
      }
    }
  }
  if (!active) return;
  float* o = out + b * D + col;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(o + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

template <typename T, int V, int NT, int U>
static int launch_nt(const void* table, const void* idx, const void* w, void* out, long long B,
                     int L, int D, cudaStream_t stream) {
  int G = D / V;
  if (G > NT) G = NT;                            // wider rows: more blocks along grid.y
  const int nb = NT / G;
  long long region = (long long)nb * L;
  const int tile = (int)(region < 1 ? 1 : region < EB_TILE ? region : EB_TILE);
  const size_t smem = (size_t)tile * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        embedding_bag_kernel<T, V, NT, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((B + nb - 1) / nb), (unsigned)((D + G * V - 1) / (G * V)));
  embedding_bag_kernel<T, V, NT, U><<<grid, NT, smem, stream>>>(
      (const T*)table, (const int*)idx, (const float*)w, (float*)out, B, L, D, G, nb, tile);
  return (int)cudaGetLastError();
}

// One thread a bag (D = V): 256 threads, 8 gathers ahead. Groups of threads
// a bag: 128 threads, 4 ahead (the faster pair at FM's D 10 and DCN-v2's
// D 16 on an H100).
template <typename T, int V>
static int launch(const void* table, const void* idx, const void* w, void* out, long long B,
                  int L, int D, cudaStream_t stream) {
  if (D == V) return launch_nt<T, V, 256, 8>(table, idx, w, out, B, L, D, stream);
  return launch_nt<T, V, 128, 4>(table, idx, w, out, B, L, D, stream);
}

// The widest load, in elements, that every row of the table allows.
static int vector_width(const void* table, int D, int elem, int widest) {
  for (int v = widest; v > 1; v >>= 1)
    if (D % v == 0 && (uintptr_t)table % (size_t)(v * elem) == 0) return v;
  return 1;
}

// table (V, D) f32 or bf16, idx (B, L) i32, w (B, L) f32, out (B, D) f32; all
// contiguous. L = 0 writes zeros.
REPRO_EXPORT int embedding_bag_launch(const void* table, const void* idx, const void* w,
                                      void* out, long long B, int L, int D, int bf16,
                                      void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    switch (vector_width(table, D, 2, 8)) {
      case 8: return launch<T, 8>(table, idx, w, out, B, L, D, s);
      case 4: return launch<T, 4>(table, idx, w, out, B, L, D, s);
      case 2: return launch<T, 2>(table, idx, w, out, B, L, D, s);
      default: return launch<T, 1>(table, idx, w, out, B, L, D, s);
    }
  }
  switch (vector_width(table, D, 4, 4)) {
    case 4: return launch<float, 4>(table, idx, w, out, B, L, D, s);
    case 2: return launch<float, 2>(table, idx, w, out, B, L, D, s);
    default: return launch<float, 1>(table, idx, w, out, B, L, D, s);
  }
}
