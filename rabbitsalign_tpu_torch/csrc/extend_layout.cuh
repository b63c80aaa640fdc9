// The extend's packed transfer rows, shared by sw_traceback.cu (which
// writes them) and extend_q2.cu (which copies them back): a pair's first
// kRleM completed cigar runs, two rows a run, then 14 rows of its ends,
// edits and run count. = tb_cuda.RLE_M and OUT_ROWS, engine.cpp
// chunk_set_device_results M.
#pragma once

constexpr int kRleM = 32;                 // run slots per pair
constexpr int kOutRows = 2 * kRleM + 14;  // rows of the packed transfer buffer
