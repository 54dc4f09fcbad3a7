// Hopper (sm_90a) building blocks of the kernels on warpgroup MMA: the int8
// 3x3 (int8_conv.cuh, int8_taps_kernel_wgmma) and K6's bf16 block
// (convblock128_wgmma.cu, block128_tc_kernel_wgmma).
//
// - shared-memory matrix descriptors without swizzle and the wgmma fences;
// - mbarriers, bulk copies (the TMA without a tensor map, plain or multicast
//   to every CTA of a cluster), tensor-map copies (the TMA with a tensor map:
//   elements outside the tensor read as zero), completing on mbarriers;
// - cluster barriers, the proxy fence that hands generic writes to the async
//   proxy, and hardware named barriers.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor without swizzle: 8-row x 16-byte core
// matrices (128 contiguous bytes), `lbo` bytes apart along K, `sbo` bytes
// apart along M or N.  Any 16-byte aligned start is valid, so a shift of one
// 16-byte row moves an operand by one row.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the same, with the data and its completion multicast to the same shared
// memory offsets of every CTA of the cluster in cta_mask
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(cta_mask)
      : "memory");
}
// the box of the tensor map `map` (a __grid_constant__ kernel parameter) at
// element coordinates (c0, c1, c2, c3), innermost first, into shared memory
// at dst (128-byte aligned); elements outside the tensor read as zero
__device__ __forceinline__ void tensor_copy_4d(uint32_t dst, const void* map, int c0, int c1,
                                               int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// arrive on the mbarrier at local offset `bar` of CTA `cta` of the cluster
// (the default .release.cta: a cluster-scope release on every stage costs
// more than the whole stage)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// generic-proxy writes to shared memory, made visible to the async proxy
// (bulk copies, wgmma) before the barrier that hands them over
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// hardware named barriers: a waiting warp takes no instruction slots
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
