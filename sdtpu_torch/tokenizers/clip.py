"""CLIP tokenizer — 49408-token vocab with ``</w>`` end-of-word markers
(this package's copy of ``sdtpu/tokenizers/clip.py``).

Behavioral parity with the reference CLIPTokenizer
(src/tokenizers/clip_tokenizer.h:10) which follows OpenAI CLIP's
simple_tokenizer: lowercase, whitespace-collapse, the CLIP word regex, then
byte-level BPE where the final character of each word carries ``</w>``.

The vocabulary is reconstructed from the public merges table
(data/clip_merges.txt.gz): 256 byte symbols, 256 byte+``</w>`` symbols,
48894 merge products, then <|startoftext|> and <|endoftext|>.
"""
from __future__ import annotations

import gzip
import importlib.resources
from typing import Dict, List, Tuple

import regex

from .bpe import BPE, bytes_to_unicode

_WORD_PATTERN = regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    regex.IGNORECASE,
)
_WHITESPACE = regex.compile(r"\s+")

BOS_TOKEN_ID = 49406  # <|startoftext|>
EOS_TOKEN_ID = 49407  # <|endoftext|>
PAD_TOKEN_ID_SD1 = 49407  # SD1.x pads with EOS
PAD_TOKEN_ID_SDXL = 0  # OpenCLIP pads with 0
VOCAB_SIZE = 49408


def _load_merges() -> List[Tuple[str, str]]:
    ref = importlib.resources.files("sdtpu_torch.tokenizers").joinpath("data/clip_merges.txt.gz")
    with ref.open("rb") as f:
        text = gzip.decompress(f.read()).decode("utf-8")
    lines = text.split("\n")
    # line 0 is "#version: 0.2"; CLIP uses exactly 48894 merges
    merges = [tuple(line.split()) for line in lines[1 : 48894 + 1]]
    return merges  # type: ignore[return-value]


class CLIPTokenizer:
    def __init__(self):
        merges = _load_merges()
        byte_list = list(bytes_to_unicode().values())
        vocab = byte_list + [v + "</w>" for v in byte_list]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        assert len(vocab) == VOCAB_SIZE, len(vocab)
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe = BPE({m: i for i, m in enumerate(merges)})
        self.byte_encoder = bytes_to_unicode()
        self.bos_token_id = BOS_TOKEN_ID
        self.eos_token_id = EOS_TOKEN_ID

    def _clean(self, text: str) -> str:
        return _WHITESPACE.sub(" ", text).strip().lower()

    def tokenize_word(self, token: str) -> List[int]:
        mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
        if not mapped:
            return []
        word = tuple(mapped[:-1]) + (mapped[-1] + "</w>",)
        return [self.encoder[t] for t in self.bpe.apply(word)]

    def encode(self, text: str) -> List[int]:
        """Token ids without BOS/EOS/padding."""
        ids: List[int] = []
        for token in _WORD_PATTERN.findall(self._clean(text)):
            if token == "<|startoftext|>":
                ids.append(BOS_TOKEN_ID)
            elif token == "<|endoftext|>":
                ids.append(EOS_TOKEN_ID)
            else:
                ids.extend(self.tokenize_word(token))
        return ids

    def decode(self, ids) -> str:
        from .bpe import unicode_to_bytes

        u2b = unicode_to_bytes()
        parts: List[str] = []
        for i in ids:
            tok = self.decoder[int(i)]
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                continue
            end_of_word = tok.endswith("</w>")
            if end_of_word:
                tok = tok[: -len("</w>")]
            raw = bytes(u2b[c] for c in tok if c in u2b)
            parts.append(raw.decode("utf-8", errors="replace"))
            if end_of_word:
                parts.append(" ")
        return "".join(parts).strip()
