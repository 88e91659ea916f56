"""Token dataset: jsonl -> flat id buffer -> packed [B, T] batches (numpy only).

A copy of `slamkit_tpu/data/dataset.py` (`TokenDataset` :74 with `repeat`
:172 and `concatenate` :153, `load_token_dataset` :297, multi-corpus
`_materialize_picks` :326 and `interleave` :381, `parse_single_dataset`
:477, `init_dataset` :502, `_bestfit_slabs` :582, `_pack_bestfit` :617,
`pack_into_rows` :675, `pad_into_rows` :772, `Batcher` :804), copied because
the JAX package's data module cannot be imported without jax.
`tests/test_torch_data.py` and `tests/test_torch_sims.py` hold its datasets
and batches equal to the original's bit for bit.

  * storage is one flat int32 buffer plus per-sequence (starts, lengths)
    views; filter and chunk never copy the token buffer;
  * batches have static shapes [B, context_len];
  * packing fills rows with whole sequences and emits segment_ids (-1 on
    pads) and per-segment positions for the segment-aware flash kernels;
    labels mask each segment's first token and all padding with -100;
  * the stream is a deterministic function of (seed, epoch), so a resume can
    fast-forward by batch index.

  * several corpora mix as HF `interleave_datasets(probabilities,
    stopping_strategy, seed=0)` does, each repeated `repetitions` times
    first.

Not ported yet (ROADMAP queue 1 item 18): the disk spill of `TokenWriter`
and of the mixed corpus (the buffers stay in RAM) and the `saved_ds_path`
cache; `init_dataset` raises on a saved_ds_path.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .pack import bestfit_pack, greedy_pack, greedy_pack_count

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100

# sequences processed per vectorized slab in the batchers
_SLAB = 1 << 18
# rows per prepare_batch call during jsonl loading
TOKENISE_CHUNK_ROWS = 2048


def _ranges(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out_starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(out_starts, lens)


def _gather_ragged(tokens: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """tokens[starts[i]:starts[i] + lens[i]] for all i, concatenated."""
    if len(starts) == 0:
        return np.empty(0, np.int32)
    idx = np.repeat(np.asarray(starts, np.int64), lens) + _ranges(lens)
    return np.asarray(tokens[idx], dtype=np.int32)


@dataclasses.dataclass
class TokenDataset:
    """Ragged token-id sequences as (starts, lengths) views over one flat
    buffer; view-producing ops only touch the O(rows) view arrays."""

    tokens: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray

    def __post_init__(self):
        self.tokens = np.ascontiguousarray(self.tokens, dtype=np.int32)
        self.starts = np.ascontiguousarray(self.starts, dtype=np.int64)
        self.lengths = np.ascontiguousarray(self.lengths, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.starts)

    def __getitem__(self, i: int) -> np.ndarray:
        s = self.starts[i]
        return np.asarray(self.tokens[s:s + self.lengths[i]], dtype=np.int32)

    @property
    def num_tokens(self) -> int:
        return int(self.lengths.sum())

    @classmethod
    def from_lists(cls, seqs: Sequence[Sequence[int]]) -> "TokenDataset":
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs))
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        tokens = np.empty(int(offsets[-1]), dtype=np.int32)
        for i, s in enumerate(seqs):
            tokens[offsets[i]:offsets[i + 1]] = s
        return cls(tokens, offsets[:-1], lens)

    def filter_by_length(self, min_len: Optional[int] = None,
                         max_len: Optional[int] = None) -> "TokenDataset":
        keep = np.ones(len(self), dtype=bool)
        if min_len is not None:
            keep &= self.lengths >= min_len
        if max_len is not None:
            keep &= self.lengths <= max_len
        return TokenDataset(self.tokens, self.starts[keep], self.lengths[keep])

    def chunk(self, chunk_size: int) -> "TokenDataset":
        """Split every sequence into chunk_size pieces, keeping the remainder."""
        c = int(chunk_size)
        n_chunks = (self.lengths + c - 1) // c  # len-0 rows produce 0 chunks
        rep_starts = np.repeat(self.starts, n_chunks)
        rep_lens = np.repeat(self.lengths, n_chunks)
        k = _ranges(n_chunks)
        return TokenDataset(self.tokens, rep_starts + k * c,
                            np.minimum(c, rep_lens - k * c))

    @staticmethod
    def concatenate(parts: Sequence["TokenDataset"]) -> "TokenDataset":
        """The rows of every part in order (views of one shared buffer stay
        views; otherwise the tokens are gathered into a new buffer)."""
        parts = list(parts)
        if not parts:
            return TokenDataset(np.empty(0, np.int32), np.empty(0, np.int64),
                                np.empty(0, np.int64))
        first = parts[0].tokens
        if all(p.tokens is first for p in parts):
            return TokenDataset(first, np.concatenate([p.starts for p in parts]),
                                np.concatenate([p.lengths for p in parts]))
        tokens = np.concatenate([_gather_ragged(p.tokens, p.starts, p.lengths) for p in parts])
        lens = np.concatenate([p.lengths for p in parts])
        return TokenDataset(tokens, np.cumsum(lens) - lens, lens)

    def repeat(self, n: int) -> "TokenDataset":
        """n copies of the rows in order (a corpus's `repetitions`): a tiled
        view, the buffer is shared."""
        if n <= 1:
            return self
        return TokenDataset(self.tokens, np.tile(self.starts, n), np.tile(self.lengths, n))

    def token_stats(self) -> dict:
        lens = self.lengths
        return {"sum": int(lens.sum()), "len_ds": len(self),
                "mean": float(lens.mean()) if len(self) else 0.0,
                "var": float(lens.var()) if len(self) else 0.0}


# --------------------------------------------------------------------------- #
# jsonl loading
# --------------------------------------------------------------------------- #
def load_jsonl_rows(path_glob: str) -> Iterator[dict]:
    files = sorted(glob(path_glob))
    if not files:
        raise FileNotFoundError(f"No files match {path_glob!r}")
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def load_token_dataset(path_glob: str, tokeniser) -> TokenDataset:
    """jsonl rows -> tokeniser.prepare_batch (in chunks) -> TokenDataset."""
    seqs: List[List[int]] = []
    chunk: List[dict] = []
    for row in load_jsonl_rows(path_glob):
        chunk.append(row)
        if len(chunk) >= TOKENISE_CHUNK_ROWS:
            seqs.extend(tokeniser.prepare_batch(chunk))
            chunk.clear()
    if chunk:
        seqs.extend(tokeniser.prepare_batch(chunk))
    return TokenDataset.from_lists(seqs)


# --------------------------------------------------------------------------- #
# multi-corpus mixing
# --------------------------------------------------------------------------- #
def _materialize_picks(datasets: Sequence[TokenDataset], src: np.ndarray,
                       idx: np.ndarray) -> TokenDataset:
    """One contiguous dataset of the (source, row) picks, gathered per source
    and scattered to the picks' places in a new buffer (in RAM)."""
    n = len(src)
    lens = np.empty(n, dtype=np.int64)
    for s, d in enumerate(datasets):
        m = src == s
        if m.any():
            lens[m] = d.lengths[idx[m]]
    out_starts = np.cumsum(lens) - lens
    tokens = np.empty(int(lens.sum()), dtype=np.int32)
    for s, d in enumerate(datasets):
        m = src == s
        if not m.any():
            continue
        r = _ranges(lens[m])
        src_idx = np.repeat(d.starts[idx[m]], lens[m]) + r
        tokens[np.repeat(out_starts[m], lens[m]) + r] = d.tokens[src_idx]
    return TokenDataset(tokens, out_starts, lens)


def _occurrences(draws: np.ndarray, n_src: int) -> np.ndarray:
    """Each draw's 0-based occurrence number within its source."""
    order = np.argsort(draws, kind="stable")
    counts = np.bincount(draws[order], minlength=n_src)
    occ = np.empty(len(draws), dtype=np.int64)
    occ[order] = _ranges(counts[counts > 0])
    return occ


def interleave(datasets: Sequence[TokenDataset], probabilities: Sequence[float],
               stopping_strategy: str = "first_exhausted", seed: int = 0) -> TokenDataset:
    """Mix corpora as HF `interleave_datasets(probabilities, seed=seed)`: draw a
    source per output row (numpy's Generator, blocks of max(4096, rows)
    draws) and take its next row, until the first source runs out
    (`first_exhausted`) or, with sources restarting from their first row,
    until the last one has been through all of its rows (`all_exhausted`);
    the draw that finds a source exhausted is not taken."""
    if len(datasets) != len(probabilities):
        raise ValueError("Number of train paths should match number of train ratios")
    rng = np.random.default_rng(seed)
    p = np.asarray(probabilities, dtype=np.float64)
    p = p / p.sum()
    n_src = len(datasets)
    sizes = np.array([len(d) for d in datasets], dtype=np.int64)
    block = int(max(4096, sizes.sum()))

    if stopping_strategy == "first_exhausted":
        base = np.zeros(n_src, dtype=np.int64)
        src_parts, idx_parts = [], []
        while True:
            draws = rng.choice(n_src, size=block, p=p)
            idx = base[draws] + _occurrences(draws, n_src)
            over = idx >= sizes[draws]
            if over.any():
                stop = int(np.argmax(over))
                src_parts.append(draws[:stop])
                idx_parts.append(idx[:stop])
                break
            src_parts.append(draws)
            idx_parts.append(idx)
            base += np.bincount(draws, minlength=n_src)
        return _materialize_picks(datasets, np.concatenate(src_parts),
                                  np.concatenate(idx_parts))
    if stopping_strategy != "all_exhausted":
        raise ValueError(f"unknown stopping_strategy: {stopping_strategy!r}")
    # a source's pick is (its occurrence number) % size; it is exhausted at
    # its (size + 1)-th draw, and the stream stops at the latest such draw
    # over the sources that can be drawn
    active = (p > 0) & (sizes > 0)
    if not active.any():
        return _materialize_picks(datasets, np.empty(0, np.int64), np.empty(0, np.int64))
    counts = np.zeros(n_src, dtype=np.int64)
    pos_exhaust = np.full(n_src, -1, dtype=np.int64)
    pos_base = 0
    draw_parts, occ_parts = [], []
    while ((pos_exhaust < 0) & active).any():
        draws = rng.choice(n_src, size=block, p=p)
        occ = counts[draws] + _occurrences(draws, n_src)
        for s in np.nonzero(active & (pos_exhaust < 0))[0]:
            hit = np.nonzero((draws == s) & (occ == sizes[s]))[0]
            if hit.size:
                pos_exhaust[s] = pos_base + int(hit[0])
        draw_parts.append(draws)
        occ_parts.append(occ)
        counts += np.bincount(draws, minlength=n_src)
        pos_base += block
    stop = int(pos_exhaust[active].max())
    draws = np.concatenate(draw_parts)[:stop]
    occs = np.concatenate(occ_parts)[:stop]
    keep = sizes[draws] > 0
    src = draws[keep]
    return _materialize_picks(datasets, src, occs[keep] % sizes[src])


def parse_single_dataset(cfg, tokeniser, train_path: str,
                         val_path: Optional[str] = None) -> Dict[str, TokenDataset]:
    """{'train', 'validation'?} from one corpus, with the composed config's
    length filter and chunking (`cfg['data']`, `cfg['model']['context_len']`;
    a dict or the config node)."""
    data = cfg["data"]
    ds = {"train": load_token_dataset(train_path, tokeniser)}
    if val_path is not None:
        ds["validation"] = load_token_dataset(val_path, tokeniser)
    if data.get("sample_units_max_length", None):
        ds["train"] = ds["train"].filter_by_length(max_len=data["sample_units_max_length"])
    context_len = cfg["model"].get("context_len", None)
    if context_len is not None:
        ds = {k: v.chunk(context_len) for k, v in ds.items()}
    if data.get("chunk_units_min_length", None):
        ds["train"] = ds["train"].filter_by_length(min_len=data["chunk_units_min_length"])
    logger.info("Statistics over tokens: %s", ds["train"].token_stats())
    return ds


def init_dataset(cfg, tokeniser) -> Dict[str, TokenDataset]:
    """{'train', 'validation'?} from the composed config, as the JAX package's
    `init_dataset` builds them: one corpus (`data.train_path` a path or
    glob), or several (a list, with `data.train_ratios`, optional
    `data.repetitions`, `data.stopping_strategy` and a `data.val_path` list
    whose corpora are concatenated) mixed by `interleave` with seed 0. A
    `data.saved_ds_path` cache raises rather than being ignored."""
    data = cfg["data"]
    if data.get("saved_ds_path", None):
        raise NotImplementedError(
            f"data.saved_ds_path={data.get('saved_ds_path')!r}: the dataset cache is not "
            f"ported yet (ROADMAP queue 1 item 18)")
    train_path = data["train_path"]
    if isinstance(train_path, str):
        return parse_single_dataset(cfg, tokeniser, train_path, data.get("val_path", None))
    train_paths = list(train_path)
    ratios = list(data["train_ratios"])
    if len(train_paths) != len(ratios):
        raise ValueError("Number of train paths should match number of train ratios")
    val_paths = data.get("val_path", None)
    if isinstance(val_paths, str):
        val_paths = [val_paths]
    val_paths = list(val_paths or []) + [None] * (len(train_paths) - len(val_paths or []))
    reps = data.get("repetitions", None)
    if reps and len(reps) != len(train_paths):
        raise ValueError(f"Number of repetitions ({len(reps)}) should match number of "
                         f"train paths ({len(train_paths)})")
    trains, vals = [], []
    for i, (tp, vp) in enumerate(zip(train_paths, val_paths)):
        logger.info("Parsing datasets %s and %s", tp, vp)
        ds = parse_single_dataset(cfg, tokeniser, tp, vp)
        trains.append(ds["train"].repeat(reps[i]) if reps else ds["train"])
        if "validation" in ds:
            vals.append(ds["validation"])
    return {"train": interleave(trains, ratios,
                                stopping_strategy=data.get("stopping_strategy",
                                                           "first_exhausted"), seed=0),
            "validation": TokenDataset.concatenate(vals)}


# --------------------------------------------------------------------------- #
# batching
# --------------------------------------------------------------------------- #
def _fresh(B: int, T: int, pad_id: int) -> Dict[str, np.ndarray]:
    return {"input_ids": np.full((B, T), pad_id, np.int32),
            "labels": np.full((B, T), IGNORE_INDEX, np.int32),
            "segment_ids": np.full((B, T), -1, np.int32),
            "positions": np.zeros((B, T), np.int32)}


def _finalize(buffers: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    buffers["num_items_in_batch"] = np.int32((buffers["labels"] != IGNORE_INDEX).sum())
    return buffers


def _assemble_packed(ds: TokenDataset, sel: np.ndarray, rows: np.ndarray,
                     cols: np.ndarray, segs: np.ndarray, lens: np.ndarray,
                     buffers: Dict[str, np.ndarray]) -> None:
    """Scatter sequences into a [B, T] batch (rows batch-local), in place."""
    T = buffers["input_ids"].shape[1]
    r = _ranges(lens)
    src_idx = np.repeat(ds.starts[sel], lens) + r
    dst_idx = np.repeat(rows * T + cols, lens) + r
    toks = np.asarray(ds.tokens[src_idx], dtype=np.int32)
    buffers["input_ids"].reshape(-1)[dst_idx] = toks
    labels = buffers["labels"].reshape(-1)
    labels[dst_idx] = toks
    labels[rows * T + cols] = IGNORE_INDEX  # segment boundary: no cross-doc label
    buffers["segment_ids"].reshape(-1)[dst_idx] = np.repeat(segs.astype(np.int32), lens)
    buffers["positions"].reshape(-1)[dst_idx] = r.astype(np.int32)


def _segment_numbers(rows: np.ndarray) -> np.ndarray:
    """0, 1, ... within each run of equal row ids."""
    first_of_row = np.r_[True, rows[1:] != rows[:-1]]
    row_group_start = np.maximum.accumulate(np.where(first_of_row, np.arange(len(rows)), 0))
    return np.arange(len(rows)) - row_group_start


def _bestfit_slabs(ds: TokenDataset, order: np.ndarray, context_len: int,
                   row_perm_seed: Optional[int]):
    """Slab-wise best-fit-decreasing row assignment: (sel, lens, rows, cols,
    segs) per slab, with globally monotone row ids."""
    T = context_len
    order = np.asarray(order, dtype=np.int64)
    row_base = 0
    for slab_i, lo in enumerate(range(0, len(order), _SLAB)):
        sel = order[lo:lo + _SLAB]
        lens = np.minimum(ds.lengths[sel], T)
        nonzero = lens > 0
        sel, lens = sel[nonzero], lens[nonzero]
        if len(sel) == 0:
            continue
        rows, cols, n_rows = bestfit_pack(lens, T)
        if row_perm_seed is not None:
            # undo the length ordering BFD imposes on the rows' creation order
            perm = np.random.default_rng((int(row_perm_seed), slab_i)).permutation(n_rows)
            rows = perm[rows]
        ord2 = np.lexsort((cols, rows))
        sel, lens, rows, cols = sel[ord2], lens[ord2], rows[ord2], cols[ord2]
        yield sel, lens, rows + row_base, cols, _segment_numbers(rows)
        row_base += n_rows


def _emit_batches(ds, slabs, B: int, T: int, pad_id: int, skip_batches: int):
    """Group slab placements by batch (rows // B) into [B, T] batches;
    batches below skip_batches are counted but not assembled."""
    buffers = _fresh(B, T, pad_id)
    cur_batch, dirty = 0, False
    for sel, lens, rows, cols, segs in slabs:
        batch_ids = rows // B
        b_lo = 0
        while b_lo < len(rows):
            b = int(batch_ids[b_lo])
            b_hi = int(np.searchsorted(batch_ids, b + 1))
            if b != cur_batch:
                if dirty and cur_batch >= skip_batches:
                    yield _finalize(buffers)
                    buffers = _fresh(B, T, pad_id)
                cur_batch, dirty = b, False
            if b >= skip_batches:
                _assemble_packed(ds, sel[b_lo:b_hi], rows[b_lo:b_hi] - b * B,
                                 cols[b_lo:b_hi], segs[b_lo:b_hi], lens[b_lo:b_hi], buffers)
            dirty = True
            b_lo = b_hi
    if dirty and cur_batch >= skip_batches:
        yield _finalize(buffers)


def bestfit_pack_rows_per_epoch(ds: TokenDataset, order: np.ndarray,
                                context_len: int) -> int:
    total = 0
    for _, _, rows, _, _ in _bestfit_slabs(ds, order, context_len, None):
        total = int(rows[-1]) + 1
    return total


def _greedy_slabs(ds: TokenDataset, order: np.ndarray, context_len: int):
    """Slab-wise in-order row assignment; a row continues across slabs."""
    T = context_len
    order = np.asarray(order, dtype=np.int64)
    row_carry, col_carry = 0, -1   # -1: the first sequence opens row 0
    seg_carry, last_row = 0, -1    # segments already in the continued row
    for lo in range(0, len(order), _SLAB):
        sel = order[lo:lo + _SLAB]
        lens = np.minimum(ds.lengths[sel], T)
        nonzero = lens > 0
        sel, lens = sel[nonzero], lens[nonzero]
        if len(sel) == 0:
            continue
        if col_carry < 0:
            col_carry, row_carry = T, -1
        rows, cols, row_carry, col_carry = greedy_pack(lens, T, row_carry, col_carry)
        segs = _segment_numbers(rows)
        if rows[0] == last_row:
            segs[rows == last_row] += seg_carry
        last_row = int(rows[-1])
        seg_carry = int(segs[rows == last_row][-1]) + 1
        yield sel, lens, rows, cols, segs


def pack_into_rows(ds: TokenDataset, order: np.ndarray, context_len: int,
                   batch_size: int, pad_id: int, skip_batches: int = 0,
                   strategy: str = "greedy", row_perm_seed: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Whole sequences packed into [B, context_len] rows with segment ids
    (-1 = pad) and per-segment positions. 'greedy' is the in-order
    recurrence; 'bestfit' packs each slab best-fit-decreasing, then permutes
    its rows deterministically (row_perm_seed). skip_batches skips the
    assembly, not the assignment, of the first k batches."""
    if strategy == "bestfit":
        slabs = _bestfit_slabs(ds, order, context_len, row_perm_seed)
    elif strategy == "greedy":
        slabs = _greedy_slabs(ds, order, context_len)
    else:
        raise ValueError(f"unknown packing strategy: {strategy!r}")
    yield from _emit_batches(ds, slabs, batch_size, context_len, pad_id, skip_batches)


def pad_into_rows(ds: TokenDataset, order: np.ndarray, context_len: int,
                  batch_size: int, pad_id: int, drop_last: bool = False,
                  skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """One sequence per row, padded to context_len (pads get label -100)."""
    B, T = batch_size, context_len
    order = np.asarray(order, dtype=np.int64)
    for b, start in enumerate(range(0, len(order), B)):
        idx = order[start:start + B]
        if len(idx) < B and drop_last:
            return
        if b < skip_batches:
            continue
        out = _fresh(B, T, pad_id)
        lens = np.minimum(ds.lengths[idx], T)
        r = _ranges(lens)
        src_idx = np.repeat(ds.starts[idx], lens) + r
        dst_idx = np.repeat(np.arange(len(idx), dtype=np.int64) * T, lens) + r
        toks = np.asarray(ds.tokens[src_idx], dtype=np.int32)
        out["input_ids"].reshape(-1)[dst_idx] = toks
        out["labels"].reshape(-1)[dst_idx] = toks
        out["segment_ids"].reshape(-1)[dst_idx] = 0
        out["positions"].reshape(-1)[dst_idx] = r.astype(np.int32)
        yield _finalize(out)


class Batcher:
    """Epoch-shuffled batch stream, deterministic in (seed, epoch) so a
    resume can fast-forward by batch index."""

    def __init__(self, ds: TokenDataset, batch_size: int, context_len: int,
                 pad_id: int, packing: bool = False, shuffle: bool = True,
                 seed: int = 0, packing_strategy: str = "bestfit"):
        self.ds = ds
        self.batch_size = batch_size
        self.context_len = context_len
        self.pad_id = pad_id
        self.packing = packing
        self.packing_strategy = packing_strategy
        self.shuffle = shuffle
        self.seed = seed

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def epoch(self, epoch: int = 0, skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if self.packing:
            yield from pack_into_rows(
                self.ds, self._order(epoch), self.context_len, self.batch_size,
                self.pad_id, skip_batches=skip_batches, strategy=self.packing_strategy,
                row_perm_seed=self.seed * 1_000_003 + epoch)
        else:
            yield from pad_into_rows(self.ds, self._order(epoch), self.context_len,
                                     self.batch_size, self.pad_id,
                                     skip_batches=skip_batches)

    def batches_per_epoch(self) -> int:
        """Batch count of epoch 0's order (an estimate for later epochs under
        packing, whose row count depends on the order)."""
        if self.packing:
            if self.packing_strategy == "bestfit":
                n_rows = bestfit_pack_rows_per_epoch(self.ds, self._order(0),
                                                     self.context_len)
            else:
                lens = np.minimum(self.ds.lengths[self._order(0)], self.context_len)
                n_rows = greedy_pack_count(lens, self.context_len)
            return (n_rows + self.batch_size - 1) // self.batch_size
        return (len(self.ds) + self.batch_size - 1) // self.batch_size
