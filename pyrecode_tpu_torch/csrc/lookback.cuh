// Decoupled look-back over per-tile status words: the offset of a tile's
// first element in a stream compacted by blocks that run in no order.
//
// Blocks take tiles in the order of a ticket counter, so a tile only waits
// on tiles whose blocks already run.  A tile's status word is flag << 32 |
// count: 0 (not yet published), TILE_AGG (the tile's own count) or
// TILE_INCL (the count of the tile and every tile before it).  The caller
// zeroes the words (and the ticket) before the pass.  Used by the compact
// deflate tokenizer (tokenize.cu) and the bitmap -> positions kernel
// (bitmap_positions.cu).
#pragma once

#include "common.cuh"

namespace {

constexpr int LOOK = 4;                                // status words a lane reads a round
constexpr unsigned long long TILE_AGG = 1ull << 32;    // the tile's own count
constexpr unsigned long long TILE_INCL = 2ull << 32;   // the count of the tile and all before it

// Warp 0 of a block, all lanes: publishes tile t's count in its status word
// (words: the stream's), looks back over the earlier tiles' words, 32 *
// LOOK a round, for the elements before the tile, publishes the inclusive
// count and returns the elements before the tile to every lane.
__device__ long long look_back(unsigned long long* status, int t, int tile_tok) {
    volatile unsigned long long* words = status;
    const int lane = threadIdx.x & 31;
    const unsigned long long own = static_cast<unsigned>(tile_tok);
    if (lane == 0) words[t] = own | (t == 0 ? +TILE_INCL : +TILE_AGG);
    long long excl = 0;
    for (int j = t - 1; j >= 0; j -= 32 * LOOK) {
        unsigned long long w[LOOK];
        bool pending;
        do {   // earlier tiles' blocks took earlier tickets: they all publish
            pending = false;
#pragma unroll
            for (int q = 0; q < LOOK; ++q) {
                const int idx = j - 32 * q - lane;
                w[q] = TILE_INCL;   // before the row: nothing
                if (idx >= 0) w[q] = words[idx];
                pending |= (w[q] >> 32) == 0ull;
            }
        } while (__any_sync(kFullMask, pending));
        int stop = 32 * LOOK;   // the nearest inclusive word, q-major
#pragma unroll
        for (int q = LOOK - 1; q >= 0; --q) {
            const unsigned m = __ballot_sync(kFullMask, (w[q] >> 32) == 2ull);
            if (m) stop = 32 * q + __ffs(m) - 1;
        }
        long long part = 0;
#pragma unroll
        for (int q = 0; q < LOOK; ++q) {
            if (32 * q + lane <= stop) part += static_cast<long long>(w[q] & 0xFFFFFFFFull);
        }
        excl += warp_sum(part);
        if (stop < 32 * LOOK) break;
    }
    if (lane == 0 && t > 0) words[t] = TILE_INCL | static_cast<unsigned long long>(excl + tile_tok);
    return excl;
}

}  // namespace
