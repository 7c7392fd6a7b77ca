// Native scene-build kernel (≙ the reference's CPU-side Rust host code):
// greedy constraint-graph coloring (≙ wgrapier joint.rs:228-290, which
// colors the joint graph on the CPU at build time with u128 color masks).
// It runs at scene-construction time, where a Python loop's cost would
// dominate for large worlds; the device-side pipeline consumes its output.
//
// Build: g++ -O3 -shared -fPIC -o wgnative.so wgnative.cpp
// (wgmath_tpu_torch/core/native_build.py builds it at first use).

#include <cstdint>
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

}  // extern "C"
