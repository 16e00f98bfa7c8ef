// Thread-block clusters (Hopper): the helpers K16 (controller_kernels.cu)
// and K5's variance section (tick_kernel.cu) share; K4
// (single_tick_kernels.cu) takes the transaction barrier and the bulk copy
// from device memory.
//
// A cluster is a few blocks that the hardware runs at once on neighbouring
// SMs. Each block can read and write the others' shared memory
// (distributed shared memory, DSMEM) through a generic pointer that
// peer_shared maps, and the blocks meet at the cluster barrier. The
// barrier is split: arrive (release) publishes every memory access the
// thread made before it, shared or global, to the cluster; wait (acquire)
// returns once every thread of the cluster has arrived, and makes those
// accesses visible. A block must not write a peer's shared memory before
// the peer has started (a first barrier), nor exit while a peer may still
// touch its own (a last barrier after the last remote access).
//
// Host side: launch_cluster launches through cudaLaunchKernelEx with the
// cluster dimension as a launch attribute (such launches can be captured
// in a CUDA graph) and returns the launch's error, or else
// cudaGetLastError(). Cluster sizes up to 8 are portable.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace uav {

// The block's rank in its cluster, and the cluster's number of blocks.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// The address in block `rank`'s shared memory that corresponds to `local`
// in this block's (the same offset): plain loads and stores through it
// reach the peer.
template <class T>
__device__ __forceinline__ T* peer_shared(T* local, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(local, rank);
}

// The 32-bit shared::cluster address of `local`'s counterpart in block
// `rank`; an offset added to it moves as it would in `local`'s block.
__device__ __forceinline__ unsigned peer_address(const void* local, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// ---- one block's data into the others' shared memory, asynchronously ----
// A transaction barrier (mbarrier) in the receiving block counts the bytes
// that bulk copies (cp.async.bulk, the copy engine of the SM) deliver into
// it: the receiver's arrive declares how many bytes the phase waits for,
// the copies complete them, and its threads wait on the phase's parity.

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread; then fence_barrier_init and a cluster barrier before a peer's
// copy may complete bytes on it.
__device__ __forceinline__ void barrier_init(void* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on this block's `bar`, its phase then waiting for `bytes` more.
__device__ __forceinline__ void barrier_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void barrier_wait(void* bar, unsigned parity) {
  const unsigned a = shared_address(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Make this thread's writes to shared memory visible to bulk copies issued
// after a following __syncthreads().
__device__ __forceinline__ void fence_for_copies() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from this
// block's `src` to `dst` in block `rank`, completing them on that block's
// `bar` (dst and bar given as this block's counterparts).
__device__ __forceinline__ void copy_to_peer(void* dst, const void* src, unsigned bytes,
                                             void* bar, unsigned rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(peer_address(dst, rank)),
      "r"(shared_address(src)), "r"(bytes), "r"(peer_address(bar, rank))
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into this block's shared memory with one bulk copy (the
// SM's copy engine: no thread waits on it), completing them on this block's
// `bar`.
__device__ __forceinline__ void copy_from_global(void* dst, const void* src, unsigned bytes,
                                                 void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most `kPending` committed groups of this thread's copies
// still read their sources.
template <int kPending>
__device__ __forceinline__ void copies_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}

// Every thread of every block of the cluster executes these, in the same
// order (the .aligned forms: whole warps at a time).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Launch `kernel` on `blocks` blocks of `threads` in clusters of `cluster`
// blocks (`blocks` a multiple of it).
template <class... Params, class... Args>
inline int launch_cluster(void (*kernel)(Params...), int blocks, int threads, int cluster,
                          int smem_bytes, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many clusters of `cluster` blocks with `smem_bytes` of dynamic
// shared memory each the card runs at once (cudaOccupancyMaxActiveClusters).
template <class... Params>
inline int max_active_clusters(void (*kernel)(Params...), int threads, int cluster,
                               int smem_bytes, int* count) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, kernel, &cfg));
}

}  // namespace uav
