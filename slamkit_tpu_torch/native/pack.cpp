// Greedy sequence-packing row assignment.
//
// Assigns each sequence (given its length) a (row, col) slot in an infinite
// stream of fixed-width rows: place at the current column if it fits, else
// start a new row. This is the sequential recurrence behind the TPU packed
// batches (the reference packs via HF DataCollatorWithFlattening + FA2
// varlen, reference slamkit/data/hf_dataset.py:61-64); the recurrence cannot
// be vectorized in numpy, so it lives here — everything around it (token
// gather/scatter into the [B, T] batch) is vectorized numpy.
//
// Built by _build.py into <repo>/build/native/ at first use; a copy of
// slamkit_tpu/native/pack.cpp.
#include <algorithm>
#include <cstdint>
#include <map>
#include <vector>

extern "C" {

// lens: sequence lengths (already clamped to <= T by the caller).
// row0/col0: carry state from the previous slab (global row index, column).
// rows/cols: per-sequence assignment output.
// state_out[0] = next row candidate, state_out[1] = column after last place.
void sk_greedy_pack(const int64_t* lens, int64_t n, int64_t T,
                    int64_t row0, int64_t col0,
                    int64_t* rows, int64_t* cols, int64_t* state_out) {
  int64_t row = row0, col = col0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = lens[i];
    if (col + len > T) {
      ++row;
      col = 0;
    }
    rows[i] = row;
    cols[i] = col;
    col += len;
  }
  state_out[0] = row;
  state_out[1] = col;
}

// Best-fit-decreasing bin packing (the high-occupancy planner).
//
// Greedy in-order packing of ~500-token utterances into 1024-token rows
// leaves ~27% of every batch as padding (measured on the Slam rehearsal
// corpus); BFD reaches ~97.5% occupancy — a 1.33x real-token throughput
// gain at identical compute. Sequences are sorted by length descending
// (ties by original index, deterministic) and each is placed into the open
// row with the SMALLEST remaining capacity that still fits (multimap
// lower_bound), else a new row opens. Outputs are per ORIGINAL index.
// Returns the number of rows.
int64_t sk_bestfit_pack(const int64_t* lens, int64_t n, int64_t T,
                        int64_t* rows, int64_t* cols) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  std::stable_sort(idx.begin(), idx.end(),
                   [&](int64_t a, int64_t b) { return lens[a] > lens[b]; });
  std::multimap<int64_t, int64_t> caps;  // remaining capacity -> row id
  int64_t n_rows = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = idx[k];
    int64_t len = lens[i];
    auto it = caps.lower_bound(len);
    if (it != caps.end()) {
      int64_t row = it->second, rem = it->first;
      caps.erase(it);
      rows[i] = row;
      cols[i] = T - rem;
      caps.emplace(rem - len, row);
    } else {
      rows[i] = n_rows;
      cols[i] = 0;
      caps.emplace(T - len, n_rows);
      ++n_rows;
    }
  }
  return n_rows;
}

// Row count only (for steps-per-epoch accounting without assembling batches).
int64_t sk_greedy_pack_count(const int64_t* lens, int64_t n, int64_t T) {
  int64_t row = 0, col = 0;
  bool any = false;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = lens[i];
    if (len <= 0) continue;
    any = true;
    if (col + len > T) {
      ++row;
      col = 0;
    }
    col += len;
  }
  return any ? row + 1 : 0;
}

}  // extern "C"
