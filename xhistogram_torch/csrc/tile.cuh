// Tiles of an (m1, m0, c1, c0) view, shared by the kept-row histogram
// kernels (one_input.cuh, slot.cuh).
//
// Rows r = i1 * m0 + i0 and columns j = j1 * c0 + j0 each come as two
// levels, each level at its own stride (xhistogram_torch.utils.axes
// strided_layout: the README call's (time, depth, cell) view with axis=(0,
// 2) has one row level of depth and column levels of time and cell). A tile
// is R rows of one run of m0 rows by C columns of one run of c0 columns, so
// its elements lie at base + i * s_m + j * s_c from a corner that each
// input maps once a tile; no tile reads across a run. A block walks its
// tiles in a grid-stride loop, or in a contiguous chunk where a row's tiles
// span several runs of columns (so that one block adds a row's runs into
// one histogram before it flushes it); tiles of one row may instead be
// pieces of whole runs (run_tiling), each block a contiguous range of
// (row, run) pairs, the runs a piece's slow dimension. It enumerates each
// piece's elements
// in memory order, along whichever dimension has the smaller stride
// (row_fast), so a warp reads neighbouring addresses in both the
// contiguous layout and the (1, m)-strided view of axis=0 of (time, lat,
// lon) data. A kernel keeps one histogram per row of its tile in shared
// memory, so the caller bounds R (max_rows).

#pragma once

namespace xh {

constexpr long long kMaxTile = 64 * 1024;        // elements of a tile
constexpr long long kMaxWholeRowTile = 1 << 20;  // elements, whole rows

// The levels of a view: rows r = i1 * m0 + i0, columns j = j1 * c0 + j0.
struct Dims {
  long long m1;
  long long m0;
  long long c1;
  long long c0;
};

struct Tiling {
  long long rows;       // R, within a run of m0 rows
  long long cols;       // C, within a run of c0 columns
  long long row_run;    // tiles along a run of rows: ceil(m0 / R)
  long long col_run;    // tiles along a run of columns: ceil(c0 / C)
  long long row_tiles;  // m1 * row_run
  long long col_tiles;  // c1 * col_run
  long long chunk;      // tiles a block walks in a row (0: a grid-stride loop)
  // > 0: one row a piece, whole runs of columns (run_tiling): a block walks
  // `runs` (row, column run) pairs in a row, one piece a row they touch
  long long runs;
  int copies;           // histogram replicas in shared memory (the caller's)
  int row_fast;         // enumerate a tile rows first (rows have stride sm)
};

// The corner of a piece: its run of rows i1 and first row i0 in it, its run
// of columns j1 and first column j0 in it, and its first row r0 = i1 * m0 +
// i0 of the layout; rr rows by cc columns, in cj runs of columns (cj > 1
// only for whole runs, cc = c0, of one row: run_tiling).
struct Corner {
  long long i1;
  long long i0;
  long long j1;
  long long j0;
  long long r0;
  unsigned rr;
  unsigned cc;
  unsigned cj;
};

inline long long ceil_div(long long x, long long y) { return (x + y - 1) / y; }

__host__ __device__ inline Corner corner_of(long long tile, const Tiling& tl,
                                            const Dims& d) {
  Corner k;
  const long long rt = tile / tl.col_tiles;
  const long long ct = tile - rt * tl.col_tiles;
  k.i1 = rt / tl.row_run;
  k.i0 = (rt - k.i1 * tl.row_run) * tl.rows;
  k.j1 = ct / tl.col_run;
  k.j0 = (ct - k.j1 * tl.col_run) * tl.cols;
  k.r0 = k.i1 * d.m0 + k.i0;
  k.rr = (unsigned)(tl.rows < d.m0 - k.i0 ? tl.rows : d.m0 - k.i0);
  k.cc = (unsigned)(tl.cols < d.c0 - k.j0 ? tl.cols : d.c0 - k.j0);
  k.cj = 1;
  return k;
}

// The offset of a tile's corner in a view of strides (sm1, sm, sc1, sc).
__host__ __device__ inline long long corner_offset(const Corner& k, long long sm1,
                                                   long long sm, long long sc1,
                                                   long long sc) {
  return k.i1 * sm1 + k.i0 * sm + k.j1 * sc1 + k.j0 * sc;
}

// The pieces a block (or a cluster) walks: tiles cur, cur + step, ...
// below last; or, for run_tiling (step 0), its range [cur, last) of (row,
// column run) pairs in row-major order.
struct PieceLoop {
  long long cur;
  long long last;
  long long step;
};

__host__ __device__ inline PieceLoop piece_loop(const Tiling& tl, const Dims& d,
                                                long long who, long long how_many) {
  if (tl.runs) {
    const long long pairs = d.m1 * d.m0 * d.c1;
    const long long first = who * tl.runs;
    return {first, first + tl.runs < pairs ? first + tl.runs : pairs, 0};
  }
  const long long n = tl.row_tiles * tl.col_tiles;
  if (tl.chunk == 0) return {who, n, how_many};
  const long long first = who * tl.chunk;
  return {first, first + tl.chunk < n ? first + tl.chunk : n, 1};
}

// The loop's next piece into k, or false past its last. `flush`: whether
// the block has added the piece's rows for the last time (a chunk's next
// tile of the same rows adds into their histograms first; a run piece
// holds all of its row's runs the block walks).
__host__ __device__ inline bool next_piece(PieceLoop& pl, const Tiling& tl, const Dims& d,
                                           Corner& k, bool& flush) {
  if (pl.cur >= pl.last) return false;
  flush = true;
  if (tl.runs) {
    const long long r = pl.cur / d.c1;
    k.j1 = pl.cur - r * d.c1;
    const long long cj = d.c1 - k.j1 < pl.last - pl.cur ? d.c1 - k.j1 : pl.last - pl.cur;
    k.i1 = r / d.m0;
    k.i0 = r - k.i1 * d.m0;
    k.j0 = 0;
    k.r0 = r;
    k.rr = 1;
    k.cc = (unsigned)d.c0;
    k.cj = (unsigned)cj;
    pl.cur += cj;
    return true;
  }
  k = corner_of(pl.cur, tl, d);
  const long long next = pl.cur + pl.step;
  if (tl.chunk && next < pl.last && next / tl.col_tiles == pl.cur / tl.col_tiles)
    flush = false;
  pl.cur = next;
  return true;
}

// C columns cut into equal column tiles of at most `most` columns.
inline long long balanced(long long c, long long most) {
  return ceil_div(c, ceil_div(c, most));
}

// The tile counts of tl.rows by tl.cols tiles of d.
inline void count_tiles(Tiling& tl, const Dims& d) {
  tl.row_run = ceil_div(d.m0, tl.rows);
  tl.col_run = ceil_div(d.c0, tl.cols);
  tl.row_tiles = d.m1 * tl.row_run;
  tl.col_tiles = d.c1 * tl.col_run;
}

// Tiles of at most max_rows rows that give each of the `resident` blocks a
// share of the elements within [min_tile, kMaxTile]; whole rows where that
// leaves enough tiles. tl.copies is left at 1 and tl.chunk at 0 for the
// caller to set.
inline Tiling make_tiling(const Dims& d, bool row_fast, long long max_rows,
                          long long min_tile, long long resident) {
  Tiling tl = {};
  tl.row_fast = row_fast;
  tl.copies = 1;
  const long long m0 = d.m0;
  const long long c0 = d.c0;
  long long target = ceil_div(d.m1 * m0 * d.c1 * c0, resident);
  target = target < min_tile ? min_tile : target > kMaxTile ? kMaxTile : target;
  if (row_fast) {
    tl.rows = m0 < max_rows ? m0 : max_rows;
    if (tl.rows > target) tl.rows = target;
    const long long row_tiles = d.m1 * ceil_div(m0, tl.rows);
    if ((row_tiles * 2 >= resident || tl.rows * c0 <= target) &&
        tl.rows * c0 <= kMaxWholeRowTile)
      tl.cols = c0;  // enough tiles of whole runs: no split run
    else
      tl.cols = balanced(c0, target / tl.rows > 1 ? target / tl.rows : 1);
  } else if (c0 >= target) {
    tl.rows = 1;
    tl.cols = balanced(c0, target);
  } else {
    tl.rows = target / c0;
    if (tl.rows > m0) tl.rows = m0;
    if (tl.rows > max_rows) tl.rows = max_rows;
    tl.cols = c0;
  }
  count_tiles(tl, d);
  return tl;
}

// Contiguous chunks of tiles, one a block, where a row's tiles span several
// runs of columns (d.c1 > 1), so a block flushes a row once a chunk rather
// than once a run; `blocks` of them, or more where a chunk would hold more
// elements than a block's 32-bit shared counters take before a flush
// (2^32 - 1; a tile holds at most 2^20). Returns the blocks to launch.
inline long long chunk_tiles(Tiling& tl, const Dims& d, long long blocks) {
  const long long n = tl.row_tiles * tl.col_tiles;
  if (d.c1 <= 1) return n < blocks ? n : blocks;
  const long long most = 0xffffffffLL / (tl.rows * tl.cols);
  tl.chunk = ceil_div(n, blocks);
  if (tl.chunk > most) tl.chunk = most;
  return ceil_div(n, tl.chunk);
}

// One row a piece, walked as whole runs of its c0 columns (the slow
// dimension the c1 runs, the fast one the columns): each of at most
// `blocks` blocks takes a contiguous range of the m c1 (row, run) pairs and
// flushes each row it touches once, so a row of many short runs costs no
// tile a run (the README call: 3650 runs of 64800 cells over 50 depth
// levels). Returns the tiling; the blocks to launch are
// ceil(m c1 / tl.runs).
inline Tiling run_tiling(const Dims& d, long long blocks) {
  Tiling tl = {};
  tl.rows = 1;
  tl.cols = d.c0;
  tl.copies = 1;
  count_tiles(tl, d);
  long long runs = ceil_div(d.m1 * d.m0 * d.c1, blocks);
  const long long most = ((1LL << 31) - 1) / d.c0;  // a piece's elements, unsigned
  tl.runs = runs < most ? runs : most > 0 ? most : 1;
  return tl;
}

}  // namespace xh
