"""Deterministic byte-level data pipeline (the port's own copy of the
reference's ``data/pipeline.py``; numpy only).

No external datasets are available offline, so the corpus is built from
local text files (default: the Python standard library sources — real,
richly structured text).  Byte-level tokenization with a few specials.
Everything is seeded and order-deterministic so experiments reproduce;
the batches are byte for byte the reference's.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

PAD, BOS, EOS = 256, 257, 258
N_SPECIALS = 3
VOCAB_BYTES = 256 + N_SPECIALS  # 259; model vocabs round up (e.g. 512)

_DEFAULT_DIRS = [
    os.path.dirname(os.__file__),  # python stdlib
]


def build_corpus(dirs: Optional[List[str]] = None, max_bytes: int = 8_000_000,
                 ext: str = ".py") -> np.ndarray:
    """Concatenated byte corpus with EOS between documents (deterministic
    file order by path hash)."""
    dirs = dirs or _DEFAULT_DIRS
    files: List[Path] = []
    for d in dirs:
        files.extend(p for p in sorted(Path(d).rglob(f"*{ext}"))
                     if p.is_file())
    files.sort(key=lambda p: hashlib.md5(str(p).encode()).hexdigest())
    chunks = []
    total = 0
    for p in files:
        try:
            raw = p.read_bytes()
        except OSError:
            continue
        arr = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
        chunks.append(np.concatenate([arr, [EOS]]))
        total += arr.size + 1
        if total >= max_bytes:
            break
    corpus = np.concatenate(chunks)[:max_bytes]
    return corpus


@dataclass
class DataConfig:
    seq_len: int = 256
    batch_size: int = 8
    max_bytes: int = 8_000_000
    seed: int = 0
    split_holdout: float = 0.05


class PackedDataset:
    """Packs the corpus into fixed-length sequences; iterates shuffled
    batches of (tokens, labels) with next-byte labels."""

    def __init__(self, cfg: DataConfig, corpus: Optional[np.ndarray] = None):
        self.cfg = cfg
        corpus = corpus if corpus is not None else build_corpus(
            max_bytes=cfg.max_bytes)
        n_hold = int(len(corpus) * cfg.split_holdout)
        self.train_bytes = corpus[:-n_hold] if n_hold else corpus
        self.eval_bytes = corpus[-n_hold:] if n_hold else corpus[-1024:]

    def _sequences(self, data: np.ndarray) -> np.ndarray:
        L = self.cfg.seq_len + 1
        n = len(data) // L
        return data[: n * L].reshape(n, L)

    def batches(self, split: str = "train", epochs: int = 1000
                ) -> Iterator[dict]:
        data = self.train_bytes if split == "train" else self.eval_bytes
        seqs = self._sequences(data)
        rng = np.random.default_rng(self.cfg.seed)
        B = self.cfg.batch_size
        for _ in range(epochs):
            order = rng.permutation(len(seqs))
            for i in range(0, len(order) - B + 1, B):
                chunk = seqs[order[i: i + B]]
                yield {"tokens": chunk[:, :-1].astype(np.int32),
                       "labels": chunk[:, 1:].astype(np.int32)}

    def eval_batches(self, max_batches: int = 8) -> Iterator[dict]:
        seqs = self._sequences(self.eval_bytes)
        B = self.cfg.batch_size
        for i in range(0, min(len(seqs), max_batches * B) - B + 1, B):
            chunk = seqs[i: i + B]
            yield {"tokens": chunk[:, :-1].astype(np.int32),
                   "labels": chunk[:, 1:].astype(np.int32)}


def decode_bytes(tokens: np.ndarray) -> str:
    return bytes(int(t) for t in tokens if t < 256).decode("utf-8", "replace")


def encode_text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int32)
