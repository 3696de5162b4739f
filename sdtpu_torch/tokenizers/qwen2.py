"""Qwen2 / Qwen3 byte-level BPE tokenizer (this package's copy of
``sdtpu/tokenizers/qwen2.py``: ``Qwen2Tokenizer`` with ``byte_fallback``,
``from_tokenizer_json``, ``encode`` and ``pad``, standard library only).

The vocabulary comes from an HF ``tokenizer.json``, from a GGUF's embedded
``"gpt2"`` vocab (``sdtpu_torch.tokenizers.gguf_vocab``), or, with no file
at all, from ``byte_fallback``: the 256 byte units at ids 0..255 and the
family's special tokens at their fixed ids, without merges.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

from sdtpu_torch.tokenizers.bpe import BPE, bytes_to_unicode

# GPT-2 style pre-tokenization regex used by Qwen2 (contractions, words,
# numbers in 1-3 digit groups, punctuation, whitespace runs)
_PRETOK = re.compile(
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|[^\r\n\w]?[a-zA-Z]+|\d{1,3}"
    r"| ?[^\s\w]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


class Qwen2Tokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 special_tokens: Dict[str, int]):
        self.vocab = vocab
        self.special = special_tokens
        self.bpe = BPE({tuple(m): i for i, m in enumerate(merges)})
        self.byte_map = bytes_to_unicode()
        self.eos_token_id = special_tokens.get("<|im_end|>", special_tokens.get("<|endoftext|>", 151643))
        self.pad_token_id = special_tokens.get("<|endoftext|>", 151643)
        # longest-first special token splitting
        self._special_re = (
            re.compile("(" + "|".join(re.escape(t) for t in
                                      sorted(special_tokens, key=len, reverse=True)) + ")")
            if special_tokens
            else None
        )

    # canonical Qwen2 / Qwen2.5 / Qwen3 special-token ids (fixed across the family)
    CANONICAL_SPECIAL = {
        "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
        "<|object_ref_start|>": 151646, "<|object_ref_end|>": 151647,
        "<|box_start|>": 151648, "<|box_end|>": 151649,
        "<|quad_start|>": 151650, "<|quad_end|>": 151651,
        "<|vision_start|>": 151652, "<|vision_end|>": 151653,
        "<|vision_pad|>": 151654, "<|image_pad|>": 151655,
        "<|video_pad|>": 151656,
    }

    @classmethod
    def byte_fallback(cls) -> "Qwen2Tokenizer":
        """The tokenizer of a bare checkpoint with no vocab file: byte-level
        BPE vocabs of the GPT-2 lineage (Qwen2's among them) give the 256
        byte units ids 0..255 in ``bytes_to_unicode`` order and pin the
        special tokens at fixed ids, so raw byte tokens plus the exact
        chat-template specials are valid Qwen ids, without the multi-byte
        merges (every word becomes its bytes)."""
        byte_vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
        return cls(byte_vocab, [], dict(cls.CANONICAL_SPECIAL))

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "Qwen2Tokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        vocab = model["vocab"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        special = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
        return cls(vocab, merges, special)

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _PRETOK.findall(text):
            word = tuple(self.byte_map[b] for b in piece.encode("utf-8"))
            for tok in self.bpe.apply(word):
                if tok in self.vocab:
                    ids.append(self.vocab[tok])
        return ids

    def encode(self, text: str) -> List[int]:
        if self._special_re is None:
            return self._encode_plain(text)
        ids: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids.extend(self._encode_plain(part))
        return ids
