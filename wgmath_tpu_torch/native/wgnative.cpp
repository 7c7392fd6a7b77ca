// Native scene-build kernels (≙ the reference's CPU-side Rust host code):
//  - greedy constraint-graph coloring (≙ wgrapier joint.rs:228-290, which
//    colors the joint graph on the CPU at build time with u128 color masks)
//  - a flattened median-split BVH over primitive AABBs (≙ wgparry
//    shape.rs:307-480, which builds a per-mesh BVH with the CPU `bvh` crate
//    and flattens it into GPU buffers)
// Both run at scene-construction time, where a Python loop's cost would
// dominate for large worlds; the device-side pipeline consumes their output.
//
// Build: g++ -O3 -shared -fPIC -o wgnative.so wgnative.cpp
// (wgmath_tpu_torch/core/native_build.py builds it at first use).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Greedy graph coloring. Two joints sharing a *dynamic* body get distinct
// colors (1-based). Returns the number of colors used, or -1 on overflow
// (more than 64 colors needed).
int wg_greedy_color(const int32_t* body_a, const int32_t* body_b,
                    const uint8_t* dynamic, const uint8_t* valid,
                    int32_t n_joints, int32_t n_bodies, int32_t* colors_out) {
    std::vector<uint64_t> body_masks(static_cast<size_t>(n_bodies), 0);
    int max_color = 0;
    for (int32_t j = 0; j < n_joints; ++j) {
        if (!valid[j]) {
            colors_out[j] = 0;
            continue;
        }
        uint64_t used = 0;
        const int32_t a = body_a[j];
        const int32_t b = body_b[j];
        if (a >= 0 && a < n_bodies && dynamic[a]) used |= body_masks[a];
        if (b >= 0 && b < n_bodies && dynamic[b]) used |= body_masks[b];
        int c = 1;
        while (c <= 64 && (used & (1ull << (c - 1)))) ++c;
        if (c > 64) return -1;
        colors_out[j] = c;
        max_color = std::max(max_color, c);
        const uint64_t bit = 1ull << (c - 1);
        if (a >= 0 && a < n_bodies && dynamic[a]) body_masks[a] |= bit;
        if (b >= 0 && b < n_bodies && dynamic[b]) body_masks[b] |= bit;
    }
    return max_color;
}

namespace {

struct BvhBuilder {
    const float* mins;   // [n, dim]
    const float* maxs;   // [n, dim]
    int dim;
    int n;
    int32_t* left;       // [n-1]
    int32_t* right;      // [n-1]
    float* node_min;     // [2n-1, dim] (internal nodes then leaves)
    float* node_max;
    int32_t* order;      // [n] leaf k -> primitive index
    std::vector<int32_t> prims;  // working permutation
    int next_internal = 0;
    int next_leaf = 0;

    // Builds the subtree over prims[lo, hi); returns the node id
    // (internal < n-1, leaf encoded as leaf_rank + n-1).
    int build(int lo, int hi) {
        if (hi - lo == 1) {
            const int leaf = next_leaf++;
            order[leaf] = prims[lo];
            const int node = leaf + (n - 1);
            std::memcpy(node_min + static_cast<size_t>(node) * dim,
                        mins + static_cast<size_t>(prims[lo]) * dim,
                        sizeof(float) * dim);
            std::memcpy(node_max + static_cast<size_t>(node) * dim,
                        maxs + static_cast<size_t>(prims[lo]) * dim,
                        sizeof(float) * dim);
            return node;
        }
        // split along the widest centroid axis at the median
        float cmin[3] = {1e30f, 1e30f, 1e30f};
        float cmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = lo; i < hi; ++i) {
            const int p = prims[i];
            for (int d = 0; d < dim; ++d) {
                const float c = 0.5f * (mins[p * dim + d] + maxs[p * dim + d]);
                cmin[d] = std::min(cmin[d], c);
                cmax[d] = std::max(cmax[d], c);
            }
        }
        int axis = 0;
        float widest = -1.0f;
        for (int d = 0; d < dim; ++d) {
            const float w = cmax[d] - cmin[d];
            if (w > widest) { widest = w; axis = d; }
        }
        const int mid = (lo + hi) / 2;
        std::nth_element(prims.begin() + lo, prims.begin() + mid,
                         prims.begin() + hi, [&](int32_t x, int32_t y) {
            return mins[x * dim + axis] + maxs[x * dim + axis]
                 < mins[y * dim + axis] + maxs[y * dim + axis];
        });
        const int node = next_internal++;
        const int l = build(lo, mid);
        const int r = build(mid, hi);
        left[node] = l;
        right[node] = r;
        for (int d = 0; d < dim; ++d) {
            node_min[static_cast<size_t>(node) * dim + d] =
                std::min(node_min[static_cast<size_t>(l) * dim + d],
                         node_min[static_cast<size_t>(r) * dim + d]);
            node_max[static_cast<size_t>(node) * dim + d] =
                std::max(node_max[static_cast<size_t>(l) * dim + d],
                         node_max[static_cast<size_t>(r) * dim + d]);
        }
        return node;
    }
};

}  // namespace

// Median-split BVH over n primitive AABBs. Layout matches the device LBVH:
// internal nodes 0..n-2 (root 0), leaf k stored at node k+(n-1) with
// order[k] giving the source primitive. Returns 0 on success.
int wg_build_bvh(const float* mins, const float* maxs, int32_t n, int32_t dim,
                 int32_t* left, int32_t* right, float* node_min,
                 float* node_max, int32_t* order) {
    if (n <= 0 || (dim != 2 && dim != 3)) return 1;
    BvhBuilder b;
    b.mins = mins;
    b.maxs = maxs;
    b.dim = dim;
    b.n = n;
    b.left = left;
    b.right = right;
    b.node_min = node_min;
    b.node_max = node_max;
    b.order = order;
    b.prims.resize(n);
    for (int i = 0; i < n; ++i) b.prims[i] = i;
    if (n == 1) {
        order[0] = 0;
        std::memcpy(node_min, mins, sizeof(float) * dim);
        std::memcpy(node_max, maxs, sizeof(float) * dim);
        return 0;
    }
    b.build(0, n);
    return 0;
}

}  // extern "C"
