"""The port's data pipeline held against the JAX package's
(``repro.data.pipeline``), on the CPU.

* ``fingerprint`` equals the reference's bit for bit on random documents
  of 0-1,000 tokens (under 64, and lengths no multiple of 64 among them),
  and so does the vectorised pass ``fingerprints`` over a whole corpus;
* ``dedup_examples`` keeps the reference's documents in the reference's
  order with equal ``SpillStats``, on ``tests/test_substrate.py``'s case
  and on one that spills through its merge levels (M = 2^8, 4,096
  documents);
* ``pack_by_length`` gives the reference's array exactly, ties in length
  and documents longer than ``seq_len`` included;
* ``SyntheticCorpus`` and ``DataLoader`` give the reference's arrays, and
  the loader resumes from its state.

The reference's dedup compiles its operator for seconds a case, so its
results for ``CASES`` are computed by ``scripts/make_torch_data_reference.py``
from this module's case table and read from
``tests/data/torch_data_reference.npz``; the rest runs both packages live
(host NumPy in the reference).
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_shim import given, settings, st

from repro.core import ExecConfig as JExecConfig
from repro.data import pipeline as ref
from repro_torch.core.types import ExecConfig
from repro_torch.data import DataLoader, SyntheticCorpus, dedup_examples, pack_by_length
from repro_torch.data import pipeline
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_data_reference.npz"

CASES = {  # name -> (SyntheticCorpus arguments, ExecConfig arguments)
    "substrate": (dict(vocab=500, n_docs=600, dup_rate=0.5, seed=3),  # test_substrate.py:132
                  dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=128)),
    "spill": (dict(vocab=500, n_docs=4096, dup_rate=0.3, seed=5, max_len=128),
              dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)),
}
STORED_CASES = tuple(CASES)


def _flat(docs) -> dict[str, np.ndarray]:
    return {"lens": np.asarray([len(d) for d in docs], np.int64),
            "tokens": np.concatenate(docs).astype(np.int32)}


def compute(name: str) -> dict[str, np.ndarray]:
    """The reference's dedup of case ``name``: the kept documents (lengths
    and tokens, in order) and its ``SpillStats`` as JSON."""
    corpus, cfg = CASES[name]
    uniq, stats = ref.dedup_examples(ref.SyntheticCorpus(**corpus).documents(),
                                     JExecConfig(**cfg))
    return {**_flat(uniq), "stats": np.asarray(json.dumps(stats.as_dict(), sort_keys=True))}


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    got = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.startswith(f"{name}|")}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_data_reference.py")
    return got


def _docs(rng, lens, vocab=1 << 17):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def test_fingerprint_matches_reference():
    rng = np.random.default_rng(0)
    lens = list(range(0, 200)) + [255, 256, 257, 511, 640, 999, 1000] + list(
        rng.integers(1, 1001, 200))
    docs = _docs(rng, lens)
    want = np.asarray([ref.fingerprint(d) for d in docs], np.uint32)
    got = np.asarray([pipeline.fingerprint(d) for d in docs], np.uint32)
    np.testing.assert_array_equal(got, want)
    assert int(want.max()) < 0xFFFFFFFF  # never the uint32 EMPTY


@pytest.mark.parametrize("block_tokens", [64, 1 << 25])
def test_vectorised_fingerprints_match_reference(monkeypatch, block_tokens):
    """The whole corpus in one pass (or in blocks of 64 tokens, each
    document a block of its own where it is longer), tokens of the full
    int32 range and lengths 0-1,000 included."""
    monkeypatch.setattr(pipeline, "FINGERPRINT_BLOCK_TOKENS", block_tokens)
    rng = np.random.default_rng(1)
    docs = _docs(rng, list(rng.integers(0, 1001, 300)) + [0, 1, 63, 64, 65, 127, 128, 129])
    docs.append(rng.integers(-(1 << 31), (1 << 31) - 1, 777).astype(np.int32))
    want = np.asarray([ref.fingerprint(d) for d in docs], np.uint32)
    got = pipeline.fingerprints(docs, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert pipeline.fingerprints([], device="cpu").shape == (0,)


# ---------------------------------------------------------------------------
# corpus dedup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STORED_CASES)
def test_dedup_examples_matches_reference(name):
    corpus, cfg = CASES[name]
    docs = SyntheticCorpus(**corpus).documents()
    uniq, stats = dedup_examples(docs, ExecConfig(**cfg), device="cpu")
    want = stored(name)
    got = _flat(uniq)
    np.testing.assert_array_equal(got["lens"], want["lens"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert stats.as_dict() == json.loads(str(want["stats"]))
    if name == "spill":  # runs spilled and merged in levels
        assert stats.runs_generated > 4 and stats.merge_levels >= 2


def test_dedup_examples_keeps_first_occurrences_in_fingerprint_order():
    docs = SyntheticCorpus(vocab=300, n_docs=500, dup_rate=0.6, seed=9).documents()
    uniq, _ = dedup_examples(docs, device="cpu")
    prints = pipeline.fingerprints(docs, device="cpu")
    keys, first = np.unique(prints, return_index=True)
    assert len(uniq) == keys.size
    assert all(u is docs[i] for u, i in zip(uniq, first))


def test_stored_reference_is_the_reference_output():
    """The small case recomputed live through the JAX package equals the
    stored file (the script's ``--check`` recomputes both)."""
    got, want = compute("substrate"), stored("substrate")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(seq_len=st.integers(1, 96), n=st.integers(0, 300),
       lens=st.sampled_from(["ties", "wide", "long"]), seed=st.integers(0, 2**31 - 1))
def test_pack_by_length_matches_reference(seq_len, n, lens, seed):
    """Ties in length (a few distinct lengths), a wide spread, and documents
    longer than ``seq_len`` (cut to it); empty documents among them."""
    rng = np.random.default_rng(seed)
    if lens == "ties":
        sizes = rng.choice(rng.integers(0, seq_len + 1, 3), n)
    elif lens == "wide":
        sizes = rng.integers(0, seq_len + 1, n)
    else:
        sizes = rng.integers(0, 3 * seq_len, n)
    docs = _docs(rng, sizes, vocab=100)
    want = ref.pack_by_length(docs, seq_len)
    got = pack_by_length(docs, seq_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pack_by_length_matches_reference_on_a_corpus():
    """The dedup's output of a synthetic corpus packed as a trainer packs
    it: many ties in length, every token kept."""
    docs = SyntheticCorpus(vocab=1000, n_docs=3000, dup_rate=0.0, seed=4, max_len=300).documents()
    got = pack_by_length(docs, 512)
    np.testing.assert_array_equal(got, ref.pack_by_length(docs, 512))
    assert int((got >= 0).sum()) == sum(len(d) for d in docs)


# ---------------------------------------------------------------------------
# the corpus and the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab=500), dict(vocab=128256, seed=7, dup_rate=0.6,
                                                      n_docs=700, max_len=64)])
def test_synthetic_corpus_matches_reference(kw):
    got, want = SyntheticCorpus(**kw).documents(), ref.SyntheticCorpus(**kw).documents()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _same_batch(got, want):
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_loader_matches_reference_and_resumes():
    a, b = DataLoader(1000, 4, 16, seed=7), ref.DataLoader(1000, 4, 16, seed=7)
    for _ in range(3):
        _same_batch(a.next(), b.next())
    state = a.state()
    assert state == b.state() == {"seed": 7, "step": 3}
    resumed = DataLoader.from_state(1000, 4, 16, state)
    _same_batch(resumed.next(), b.next())  # both at step 3
    _same_batch(resumed.next(),
                ref.DataLoader.from_state(1000, 4, 16, {"seed": 7, "step": 4}).next())
