"""Byte-level tokenizer (port of ``repro.data.tokenizer``; no vocab files).

IDs 0..255 are raw bytes; 256 = BOS, 257 = EOS, 258 = PAD. Vocab sizes in
model configs exceed 259, which is fine — unused ids just never occur.
"""

from __future__ import annotations

from typing import Iterable, List


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        bs = bytes(i for i in ids if i < 256)
        return bs.decode("utf-8", errors="replace")
