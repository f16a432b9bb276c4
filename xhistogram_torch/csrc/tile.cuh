// Tiles of an (m, c) layout, shared by the kept-row histogram kernels
// (one_input.cuh, slot.cuh).
//
// Work is cut into tiles of R rows by C columns. A block walks its tiles in
// a grid-stride loop and enumerates each tile's elements in memory order,
// along whichever dimension has the smaller stride (row_fast), so a warp
// reads neighbouring addresses in both the contiguous (m, c) layout and the
// (1, m)-strided view that canonicalize_2d gives for axis=0 of (time, lat,
// lon) data. A kernel keeps one histogram per row of its tile in shared
// memory, so the caller bounds R (max_rows).

#pragma once

namespace xh {

constexpr long long kMaxTile = 64 * 1024;        // elements of a tile
constexpr long long kMaxWholeRowTile = 1 << 20;  // elements, whole rows

struct Tiling {
  long long rows;       // R
  long long cols;       // C
  long long row_tiles;  // ceil(m / R)
  long long col_tiles;  // ceil(c / C)
  int copies;           // histogram replicas in shared memory (the caller's)
  int row_fast;         // enumerate a tile rows first (rows have stride sm)
};

inline long long ceil_div(long long x, long long y) { return (x + y - 1) / y; }

// C columns cut into equal column tiles of at most `most` columns.
inline long long balanced(long long c, long long most) {
  return ceil_div(c, ceil_div(c, most));
}

// Tiles of at most max_rows rows that give each of the `resident` blocks a
// share of the elements within [min_tile, kMaxTile]; whole rows where that
// leaves enough tiles. tl.copies is left at 1 for the caller to set.
inline Tiling make_tiling(long long m, long long c, bool row_fast,
                          long long max_rows, long long min_tile,
                          long long resident) {
  Tiling tl;
  tl.row_fast = row_fast;
  tl.copies = 1;
  long long target = ceil_div(m * c, resident);
  target = target < min_tile ? min_tile : target > kMaxTile ? kMaxTile : target;
  if (row_fast) {
    tl.rows = m < max_rows ? m : max_rows;
    if (tl.rows > target) tl.rows = target;
    const long long row_tiles = ceil_div(m, tl.rows);
    if ((row_tiles * 2 >= resident || tl.rows * c <= target) &&
        tl.rows * c <= kMaxWholeRowTile)
      tl.cols = c;  // enough tiles of whole rows: no split row
    else
      tl.cols = balanced(c, target / tl.rows > 1 ? target / tl.rows : 1);
  } else if (c >= target) {
    tl.rows = 1;
    tl.cols = balanced(c, target);
  } else {
    tl.rows = target / c;
    if (tl.rows > m) tl.rows = m;
    if (tl.rows > max_rows) tl.rows = max_rows;
    tl.cols = c;
  }
  tl.row_tiles = ceil_div(m, tl.rows);
  tl.col_tiles = ceil_div(c, tl.cols);
  return tl;
}

}  // namespace xh
