"""Data pipeline: deterministic synthetic corpus -> packed token batches.

The port's own copy of ``repro.data.pipeline`` (numpy only): the same seed
gives the same batches, snapshots and restores, bit for bit, as the
original (tests/test_torch_ckpt_data.py holds it).

Production-shaped: documents are tokenized (byte-level stub tokenizer),
packed into fixed-length sequences with EOS separators, sharded per data-
parallel host, and streamed with a resumable cursor (checkpointable state:
one integer per host).  On a real cluster each host feeds its local devices
via a per-host placement of its local slice; here the
host count is 1 but the sharding math is the same.  The batches are numpy
arrays; the train driver moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


EOS = 1
PAD = 0


class ByteTokenizer:
    """Byte-level tokenizer stub (vocab 256 + specials), deterministic."""
    vocab_size = 258

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode(), np.uint8).astype(np.int32) + 2

    def decode(self, ids: np.ndarray) -> str:
        b = bytes(int(i) - 2 for i in ids if i >= 2)
        return b.decode(errors="replace")


def synthetic_documents(seed: int, vocab_size: int,
                        mean_len: int = 512) -> Iterator[np.ndarray]:
    """Infinite stream of Zipf-distributed synthetic documents (stable
    across restarts for a given seed)."""
    rng = np.random.default_rng(seed)
    while True:
        n = max(8, int(rng.exponential(mean_len)))
        # Zipf-ish unigram model over the model's vocab
        toks = (rng.zipf(1.3, size=n) + 1) % (vocab_size - 2) + 2
        yield toks.astype(np.int32)


@dataclasses.dataclass
class PackerState:
    doc_index: int = 0
    carry: Optional[np.ndarray] = None


class PackedStream:
    """Packs documents into (seq_len+1)-token rows; resumable."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed + 1000003 * host_id
        self.n_hosts = n_hosts
        self.state = PackerState()
        self._docs = synthetic_documents(self.seed, vocab_size)

    def _next_doc(self) -> np.ndarray:
        self.state.doc_index += 1
        return next(self._docs)

    def next_row(self) -> np.ndarray:
        need = self.seq_len + 1
        parts = []
        if self.state.carry is not None:
            parts.append(self.state.carry)
            self.state.carry = None
        total = sum(p.size for p in parts)
        while total < need:
            d = self._next_doc()
            parts.append(np.concatenate([d, [EOS]]).astype(np.int32))
            total += d.size + 1
        row = np.concatenate(parts)
        self.state.carry = row[need:].copy() if row.size > need else None
        return row[:need]

    def next_batch(self, local_batch: int) -> Dict[str, np.ndarray]:
        rows = np.stack([self.next_row() for _ in range(local_batch)])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
            "mask": (rows[:, 1:] != PAD).astype(np.float32),
        }

    # -- checkpointable cursor -------------------------------------------
    def snapshot(self) -> Dict:
        return {"doc_index": self.state.doc_index,
                "carry": None if self.state.carry is None
                else self.state.carry.tolist()}

    def restore(self, snap: Dict):
        # deterministic regeneration: re-wind the doc stream
        self._docs = synthetic_documents(self.seed, self.vocab_size)
        for _ in range(snap["doc_index"]):
            next(self._docs)
        self.state = PackerState(
            doc_index=snap["doc_index"],
            carry=None if snap["carry"] is None
            else np.asarray(snap["carry"], np.int32))


def make_train_batches(cfg, shape_seq: int, global_batch: int, *,
                       seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    stream = PackedStream(cfg.vocab_size, shape_seq, seed=seed)
    while True:
        yield stream.next_batch(global_batch)
