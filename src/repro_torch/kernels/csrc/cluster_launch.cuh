// Launches of the thread-block cluster kernels (fabric_step.cu's cluster
// variant, rv_sweeps.cu): `grid` blocks of `threads` threads in clusters of
// `cluster` blocks, `smem` bytes of dynamic shared memory a block. Past 8
// blocks a cluster is non-portable, which an H100 schedules where a GPC has
// 16 free SMs; kernels/cluster_plan.py takes such a size only where
// max_active_clusters says the card holds one.
#pragma once

#include <cuda_runtime.h>

template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), int grid, int threads,
                           int cluster, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)grid);
    cfg->blockDim = dim3((unsigned)threads);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return err;
}

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int grid, int threads,
                   int cluster, size_t smem, cudaStream_t stream,
                   Args... args) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(kernel, grid, threads, cluster, smem,
                                     stream, &cfg, &attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks the card holds at once (0: none).
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int threads, int cluster,
                        size_t smem, int* active) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(kernel, cluster, threads, cluster, smem,
                                     0, &cfg, &attr);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(active, (const void*)kernel,
                                             &cfg);
    return (int)err;
}
