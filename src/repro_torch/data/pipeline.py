"""Deterministic synthetic token pipeline.

The port of ``repro/data/pipeline.py``: an iterator of fixed-size
{tokens, labels} batches, built from a seeded document stream, greedily
packed into sequences.  The stream is the reference's NumPy code with its
seeding, so it gives the reference's batches bit for bit.  Determinism is
per (seed, step), so a restart from a checkpoint replays the identical
stream — the data-side half of fault tolerance (see runtime/fault.py).
:func:`shard_batch` copies a host batch to the device (or to a mesh's).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def _doc_stream(seed: int, vocab: int, mean_len: int = 512):
    """Endless seeded stream of variable-length 'documents'."""
    rng = np.random.default_rng(seed)
    while True:
        n = max(8, int(rng.exponential(mean_len)))
        yield rng.integers(1, vocab, size=n, dtype=np.int32)


def pack_documents(docs, seq_len: int, eos: int = 0):
    """Greedy packing of documents into (seq_len+1,) rows (with EOS joints)."""
    buf: list = []
    for d in docs:
        buf.extend(d.tolist())
        buf.append(eos)
        while len(buf) >= seq_len + 1:
            row = np.asarray(buf[:seq_len + 1], dtype=np.int32)
            buf = buf[seq_len + 1:]
            yield row


class TokenDataset:
    """Seeded, restartable batch iterator.

    ``state()``/``restore()`` expose the stream position for checkpointing;
    restoring replays from the exact batch index.
    """

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 n_codebooks: int = 1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.n_codebooks = n_codebooks
        self._step = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self._step}

    def restore(self, state: dict) -> None:
        self.seed = state["seed"]
        self._step = state["step"]

    def next_batch(self) -> dict:
        # per-batch independent seeding → O(1) restart (no stream replay)
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        shape = (self.batch, self.seq_len + 1)
        if self.n_codebooks > 1:
            shape = shape + (self.n_codebooks,)
        # learnable structure (not uniform noise): a random-walk bigram
        # process t_{i+1} = t_i + d_i, d ∈ {1, 2} — ~1 bit/token entropy,
        # so the training loss has log(V) − 1 bit of headroom to descend.
        start = rng.integers(1, self.vocab, size=(shape[0],) + shape[2:],
                             dtype=np.int64)
        deltas = rng.integers(1, 3, size=shape, dtype=np.int64)
        deltas[:, 0] = 0
        rows = ((start[:, None] + np.cumsum(deltas, axis=1) - 1)
                % (self.vocab - 1) + 1).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def shard_batch(batch: dict, sharding_or_device="cuda") -> dict:
    """A host batch as int64 tensors (the models index their embeddings
    with them) on a device: the card unless the caller asks for the CPU,
    or, given the reference's spelling, a sharding of ``("batch", "seq")``
    (``rules.sharding(...)``), the home device of that sharding's mesh,
    where the train step takes each replica's rows from the whole batch."""
    mesh = getattr(sharding_or_device, "mesh", None)
    dev = resolve_device(mesh.home if mesh is not None
                         else sharding_or_device)
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(dev)
            for k, v in batch.items()}
