"""Data pipeline of the port (counterpart of :mod:`repro.data.pipeline`):
the column-batch stream adapters, the synthetic corpus, corpus dedup,
length packing and the resumable loader.

``iter_column_batches`` cuts a table into batch mappings and
``rebatch_columns`` re-chunks a producer's batches; pass either generator
as ``columns`` to :func:`repro_torch.aggregate`, which then absorbs the
input batch by batch, so the device holds at most a batch of input at a
time.

``dedup_examples`` is the paper's web-log duplicate removal applied to an
LM corpus: SELECT DISTINCT on document fingerprints through the in-sort
operator (:func:`repro_torch.core.operators.distinct`), whose sorted output
keeps later grouping passes in-stream.  The fingerprints of a corpus come
from one vectorised pass in int64 arithmetic (:func:`fingerprints`), equal
to :func:`fingerprint` document by document.  ``pack_by_length`` is the
reference's greedy first-fit-decreasing packing, with a max-tree over the
rows' free space in place of its row-by-row scan.  ``SyntheticCorpus`` and
``DataLoader`` give the reference's NumPy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.operators import distinct
from repro_torch.core.types import ExecConfig, empty_key, keys_to_numpy, resolve_device


def iter_column_batches(columns, rows: int):
    """Split a column mapping into ``rows``-row batch mappings."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    cols = {k: np.asarray(v) for k, v in columns.items()}
    if not cols:
        return
    n = len(next(iter(cols.values())))
    for k, v in cols.items():
        if len(v) != n:
            raise ValueError(f"column {k!r} has {len(v)} rows, expected {n}")
    for s in range(0, n, rows):
        yield {k: v[s:s + rows] for k, v in cols.items()}


def rebatch_columns(batches, rows: int):
    """Re-chunk an iterable of column-batch mappings to ``rows``-row
    batches; producers emit whatever granularity is natural (log shards,
    row groups), the engine wants batches big enough to amortize its
    launches.  The final partial batch comes as it is."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    buf: dict[str, list[np.ndarray]] = {}
    have = 0
    for batch in batches:
        batch = {k: np.asarray(v) for k, v in batch.items()}
        if not batch:
            continue
        n = len(next(iter(batch.values())))
        if n == 0:
            continue
        if buf and set(batch) != set(buf):
            raise ValueError(f"batch columns {sorted(batch)} != stream columns {sorted(buf)}")
        for k, v in batch.items():
            buf.setdefault(k, []).append(v)
        have += n
        while have >= rows:
            cat = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in buf.items()}
            yield {k: v[:rows] for k, v in cat.items()}
            buf = {k: [v[rows:]] for k, v in cat.items()}
            have -= rows
    if have:
        yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in buf.items()}


@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic synthetic corpus: duplicated zipf-ish documents."""

    vocab: int
    seed: int = 0
    dup_rate: float = 0.3
    n_docs: int = 4096
    max_len: int = 512

    def documents(self) -> list[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        base: list[np.ndarray] = []
        docs: list[np.ndarray] = []
        for _ in range(self.n_docs):
            if base and rng.random() < self.dup_rate:
                docs.append(base[rng.integers(len(base))])  # duplicate
            else:
                ln = int(rng.integers(16, self.max_len))
                d = rng.integers(0, self.vocab, ln).astype(np.int32)
                base.append(d)
                docs.append(d)
        return docs


_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_LO32 = 0xFFFFFFFF
_NOT_EMPTY = 0xFFFFFFFE  # fingerprints stay below the uint32 EMPTY
_CHUNK = 64  # a document hashes in max(1, len // 64) chunks
FINGERPRINT_BLOCK_TOKENS = 1 << 25  # tokens of one vectorised block


def fingerprint(doc: np.ndarray) -> np.uint32:
    """Order-sensitive 32-bit content hash (FNV-ish), one document: the
    reference's loop over ``np.array_split`` chunks in uint64 arithmetic."""
    h = np.uint64(_FNV_OFFSET)
    mul = np.uint64(_FNV_PRIME)
    for chunk in np.array_split(doc.astype(np.uint64), max(1, len(doc) // _CHUNK)):
        h = (h * mul + np.uint64(chunk.sum() % (1 << 32))) % (1 << 32)
        h = (h * mul + np.uint64((chunk * np.arange(1, len(chunk) + 1,
             dtype=np.uint64)).sum() % (1 << 32))) % (1 << 32)
    return np.uint32(h % np.uint64(_NOT_EMPTY))


def _fingerprint_block(lens: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """:func:`fingerprint` of each of a block's documents, in int64 on the
    tensors' device: ``lens`` their lengths, ``tokens`` their tokens end to
    end.

    A document of ``n`` tokens has ``k = max(1, n // 64)`` chunks, the
    first ``n % k`` of ``n // k + 1`` tokens and the rest of ``n // k``
    (``np.array_split``).  Each chunk's sum and position-weighted sum are
    segment sums (``index_add_``); reduced mod 2^32 they equal the
    reference's uint64 sums mod 2^32.  The hash then takes its 2k steps
    for all documents at once, a step a chunk index; ``h * 16777619 +
    s`` stays below 2^57."""
    dev, n_docs = tokens.device, lens.shape[0]
    k = torch.clamp_min(lens // _CHUNK, 1)
    q, r = lens // k, lens % k
    doc = torch.repeat_interleave(torch.arange(n_docs, device=dev), k)
    first = torch.cumsum(k, 0) - k  # each document's first chunk
    j = torch.arange(doc.shape[0], device=dev) - first[doc]  # chunk index in its document
    size = q[doc] + (j < r[doc]).to(torch.int64)
    start = (torch.cumsum(lens, 0) - lens)[doc] + j * q[doc] + torch.minimum(j, r[doc])
    chunk = torch.repeat_interleave(torch.arange(doc.shape[0], device=dev), size)
    weight = torch.arange(tokens.shape[0], device=dev) - start[chunk] + 1
    plain = torch.zeros(doc.shape[0], dtype=torch.int64, device=dev).index_add_(0, chunk, tokens)
    weighted = torch.zeros_like(plain).index_add_(0, chunk, tokens * weight)
    plain, weighted = plain & _LO32, weighted & _LO32
    h = torch.full((n_docs,), _FNV_OFFSET, dtype=torch.int64, device=dev)
    for step in range(int(k.max()) if n_docs else 0):
        live = k > step
        at = torch.clamp(first + step, max=doc.shape[0] - 1)
        nh = (h * _FNV_PRIME + plain[at]) & _LO32
        nh = (nh * _FNV_PRIME + weighted[at]) & _LO32
        h = torch.where(live, nh, h)
    return h % _NOT_EMPTY


def fingerprints(docs: list[np.ndarray], *, device="cuda") -> np.ndarray:
    """Every document's :func:`fingerprint` (uint32), computed on
    ``device`` in blocks of about ``FINGERPRINT_BLOCK_TOKENS`` tokens (a
    longer document is a block of its own).  A block's tokens are copied
    end to end into one reused int64 host buffer (pinned for a card), so
    the host faults in its pages once, then go to the device in one
    copy."""
    dev = resolve_device(device)
    lens = np.fromiter((len(d) for d in docs), np.int64, len(docs))
    if not len(docs):
        return np.zeros(0, np.uint32)
    ends = np.cumsum(lens)
    buf = torch.empty(max(FINGERPRINT_BLOCK_TOKENS, int(lens.max())), dtype=torch.int64,
                      pin_memory=dev.type == "cuda")
    out, s = [], 0
    while s < len(docs):
        e = max(s + 1, int(np.searchsorted(ends, ends[s] - lens[s] + FINGERPRINT_BLOCK_TOKENS,
                                           side="right")))
        n = int(ends[e - 1] - ends[s] + lens[s])
        if n:  # int64 as the reference's uint64: negative and wide tokens wrap mod 2^64
            np.concatenate(docs[s:e], out=buf.numpy()[:n], casting="unsafe")
        block = _fingerprint_block(torch.from_numpy(lens[s:e]).to(dev), buf[:n].to(dev))
        out.append(block.cpu().numpy())
        s = e
    return np.concatenate(out).astype(np.uint32)


def dedup_examples(docs: list[np.ndarray], cfg: ExecConfig | None = None, *, device="cuda"):
    """DISTINCT on document fingerprints via the paper's operator.

    Returns (unique docs, spill stats).  Output order is fingerprint-sorted
    (the operator's interesting ordering), keeping downstream grouping
    passes in-stream; each kept document is the first with its
    fingerprint."""
    cfg = cfg or ExecConfig()
    prints = fingerprints(docs, device=device)
    state, stats = distinct(prints, cfg, output_estimate=len(docs), device=device)
    keys = keys_to_numpy(state.keys, state.key_dtype)
    keys = keys[keys != empty_key(np.uint32)]
    seen, first = np.unique(prints, return_index=True)  # first occurrences
    at = np.searchsorted(seen, keys)
    if not np.array_equal(seen[np.minimum(at, max(0, seen.size - 1))], keys):
        raise RuntimeError("the operator's distinct fingerprints are not the input's")
    return [docs[i] for i in first[at]], stats


class _FreeSpace:
    """A max-tree over the packed rows' free space: the lowest-index row
    with room for ``need`` tokens in O(log R) (R the rows, at most one a
    document)."""

    def __init__(self, capacity: int):
        self.size = 1 << max(0, capacity - 1).bit_length()
        self.tree = [-1] * (2 * self.size)  # -1: no row there
        self.rows = 0

    def first_at_least(self, need: int) -> int:
        t = self.tree
        if t[1] < need:
            return -1
        i = 1
        while i < self.size:
            i = 2 * i if t[2 * i] >= need else 2 * i + 1
        return i - self.size

    def free(self, row: int) -> int:
        return self.tree[row + self.size]

    def set(self, row: int, free: int) -> None:
        t = self.tree
        i = row + self.size
        t[i] = free
        i //= 2
        while i:
            top = max(t[2 * i], t[2 * i + 1])
            if t[i] == top:  # the maxima above hold as they are
                break
            t[i] = top
            i //= 2

    def append(self, free: int) -> int:
        self.rows += 1
        self.set(self.rows - 1, free)
        return self.rows - 1


def pack_by_length(docs: list[np.ndarray], seq_len: int) -> np.ndarray:
    """Greedy first-fit packing of docs into (N, seq_len) rows (-1 pad),
    longest first: the reference's array exactly.

    Each document (cut to ``seq_len``) goes into the lowest-index row with
    room, a new row if none has.  A run of documents of one length fills
    the lowest row with room as far as it takes them, then the next, so
    the max-tree is asked once a row and run, not once a document."""
    order = np.argsort([len(d) for d in docs])[::-1]
    lens = np.minimum(np.fromiter((len(docs[i]) for i in order), np.int64, len(order)), seq_len)
    rows = _FreeSpace(len(order))
    row_of = np.empty(len(order), np.int64)
    at_of = np.empty(len(order), np.int64)
    cuts = np.flatnonzero(np.diff(lens)) + 1
    for s, e in zip(np.r_[0, cuts], np.r_[cuts, len(order)]) if len(order) else ():
        need, i = int(lens[s]), int(s)
        while i < e:
            r = rows.first_at_least(need)
            if r < 0:
                r = rows.append(seq_len)
            free = rows.free(r)
            take = int(e - i) if need == 0 else min(int(e - i), free // need)
            row_of[i:i + take] = r
            at_of[i:i + take] = seq_len - free + need * np.arange(take)
            rows.set(r, free - need * take)
            i += take
    # a row's documents lie end to end from its first position, so in row
    # order (then position) the tokens fill each row's used prefix
    out = np.full((rows.rows, seq_len), -1, np.int32)
    if len(order) and lens.sum():
        placed = np.argsort(row_of * seq_len + at_of)
        used = np.bincount(row_of, weights=lens, minlength=rows.rows).astype(np.int64)
        out[np.arange(seq_len)[None, :] < used[:, None]] = np.concatenate(
            [docs[order[i]][:seq_len] for i in placed])
    return out


@dataclasses.dataclass
class DataLoader:
    """Deterministic resumable batches of (tokens, labels)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, vocab, batch, seq, state):
        return cls(vocab, batch, seq, seed=state["seed"], step=state["step"])

    def next(self):
        rng = np.random.default_rng((self.seed, self.step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1)).astype(np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
