"""Byte-level tokenizer (vocab 256 + specials), built in-repo.

Deterministic, versionable: the tokenizer spec itself is committed to the
catalog so runs pin the exact vocabulary (the paper's reproducibility
story applies to *all* artifacts, not just tables).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    vocab_size: int = 259
    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return np.array(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")

    def spec(self) -> dict:
        return dataclasses.asdict(self)
