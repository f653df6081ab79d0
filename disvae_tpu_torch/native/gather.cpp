// Native host-side batch gather for the input pipeline.
//
// The hot host op feeding the chip is "take N rows of a uint8 (possibly
// memory-mapped) image stack at given indices and emit float32 in [0,1]".
// numpy does this as two passes (fancy-index copy, then astype+multiply) on
// one thread; this fuses gather + convert + scale in a single multithreaded
// pass so batch assembly keeps up with the device's step times. (The
// reference's equivalent surface is torch DataLoader collation,
// utils/datasets.py:49-71.)
//
// Copied from disvae_tpu/native/gather.cpp (the JAX package's host gather).
// Built by disvae_tpu_torch/native/__init__.py with g++ -O3 at first use
// into build/disvae_tpu_torch/; bound via ctypes.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// out[r, :] = base[idcs[r], :] * scale   (row_elems elements per row)
void gather_u8_f32(const uint8_t* base, int64_t row_elems,
                   const int64_t* idcs, int64_t n_rows,
                   float scale, float* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_rows) n_threads = static_cast<int>(n_rows);

    auto work = [=](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t* src = base + idcs[r] * row_elems;
            float* dst = out + r * row_elems;
            for (int64_t i = 0; i < row_elems; ++i) {
                dst[i] = static_cast<float>(src[i]) * scale;
            }
        }
    };

    if (n_threads == 1) {
        work(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t r0 = t * chunk;
        const int64_t r1 = std::min(n_rows, r0 + chunk);
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

// uint8 gather with per-element multiply: out[r, :] = base[idcs[r], :] * mul.
// mul renormalizes storage conventions onto the wire format value/255
// (dsprites stores {0,1} -> mul 255; byte images -> mul 1). No overflow:
// callers guarantee src * mul <= 255.
void gather_u8_mul(const uint8_t* base, int64_t row_bytes,
                   const int64_t* idcs, int64_t n_rows,
                   int mul, uint8_t* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_rows) n_threads = static_cast<int>(n_rows);

    auto work = [=](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t* src = base + idcs[r] * row_bytes;
            uint8_t* dst = out + r * row_bytes;
            if (mul == 1) {
                __builtin_memcpy(dst, src, static_cast<size_t>(row_bytes));
            } else {
                for (int64_t i = 0; i < row_bytes; ++i) {
                    dst[i] = static_cast<uint8_t>(src[i] * mul);
                }
            }
        }
    };

    if (n_threads == 1) {
        work(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t r0 = t * chunk;
        const int64_t r1 = std::min(n_rows, r0 + chunk);
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

// Plain uint8 gather (no conversion) — used for raw byte staging.
void gather_u8(const uint8_t* base, int64_t row_bytes,
               const int64_t* idcs, int64_t n_rows,
               uint8_t* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_rows) n_threads = static_cast<int>(n_rows);

    auto work = [=](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t* src = base + idcs[r] * row_bytes;
            uint8_t* dst = out + r * row_bytes;
            __builtin_memcpy(dst, src, static_cast<size_t>(row_bytes));
        }
    };

    if (n_threads == 1) {
        work(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t r0 = t * chunk;
        const int64_t r1 = std::min(n_rows, r0 + chunk);
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
