"""T5 SentencePiece-unigram tokenizer (this package's copy of
``sdtpu/tokenizers/t5.py``: ``T5UnigramTokenizer``, standard library only).

Standard unigram Viterbi over a piece→score table loaded from a HF
``tokenizer.json`` (Unigram model), a ``spiece.model`` or a GGUF's embedded
vocab (``sdtpu_torch.tokenizers.gguf_vocab``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

WHITESPACE_PIECE = "▁"  # ▁


class T5UnigramTokenizer:
    def __init__(
        self,
        vocab: List[Tuple[str, float]],
        unk_id: int = 2,
        eos_id: int = 1,
        pad_id: int = 0,
    ):
        self.pieces = vocab
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _) in enumerate(vocab)}
        self.scores = [s for _, s in vocab]
        self.unk_id = unk_id
        self.eos_token_id = eos_id
        self.pad_token_id = pad_id
        self.max_piece_len = max((len(p) for p, _ in vocab), default=1)
        # sentencepiece gives unknown chars a low penalty score
        self.unk_score = min(self.scores, default=0.0) - 10.0

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "T5UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: expected a Unigram tokenizer model")
        vocab = [(p, float(s)) for p, s in model["vocab"]]
        unk_id = int(model.get("unk_id", 2))
        return cls(vocab, unk_id=unk_id)

    def _normalize(self, text: str) -> str:
        # sentencepiece: collapse spaces to ▁, add dummy prefix
        text = " ".join(text.split())
        if not text:
            return ""
        return WHITESPACE_PIECE + text.replace(" ", WHITESPACE_PIECE)

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return [self.eos_token_id] if add_eos else []
        # Viterbi over the piece lattice
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None:
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
            # unknown fallback: single char
            sc = best[i] + self.unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        # merge consecutive unk ids (sentencepiece semantics)
        merged: List[int] = []
        for t in ids:
            if t == self.unk_id and merged and merged[-1] == self.unk_id:
                continue
            merged.append(t)
        if add_eos:
            merged.append(self.eos_token_id)
        return merged

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if i in (self.eos_token_id, self.pad_token_id):
                continue
            parts.append(self.pieces[i][0])
        return "".join(parts).replace(WHITESPACE_PIECE, " ").strip()

    def pad(self, ids: List[int], length: int) -> Tuple[List[int], List[int]]:
        """→ (padded ids, attention mask) with trailing pads."""
        ids = ids[:length]
        mask = [1] * len(ids) + [0] * (length - len(ids))
        return ids + [self.pad_token_id] * (length - len(ids)), mask
