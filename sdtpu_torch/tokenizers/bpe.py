"""Byte-level BPE engine (this package's copy of ``sdtpu/tokenizers/bpe.py``):
GPT-2's byte↔unicode mapping and greedy lowest-rank pair merging.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def get_pairs(word: Sequence[str]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPE:
    """Greedy pair merging against a rank table."""

    def __init__(self, merge_ranks: Dict[Tuple[str, str], int]):
        self.ranks = merge_ranks
        self._cache: Dict[Tuple[str, ...], List[str]] = {}

    def apply(self, word: Tuple[str, ...]) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        w = list(word)
        while len(w) > 1:
            pairs = get_pairs(w)
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(w):
                if i < len(w) - 1 and w[i] == first and w[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            w = out
        self._cache[word] = w
        return w
