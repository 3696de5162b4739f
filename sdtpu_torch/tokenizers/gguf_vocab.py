"""Tokenizers from embedded checkpoint vocabularies (this package's copy of
``sdtpu/tokenizers/gguf_vocab.py``).

- llama.cpp-style GGUF text encoders carry ``tokenizer.ggml.*`` metadata;
  ``tokenizer_from_gguf_metadata`` turns a SentencePiece-unigram vocab
  ("t5" / "llama") into a ``T5UnigramTokenizer`` and a byte-level BPE one
  ("gpt2", the Qwen LLMs') into a ``Qwen2Tokenizer``.
- SentencePiece ``spiece.model`` protobufs: ``load_spiece_model`` parses the
  ModelProto wire format directly (no protobuf dependency).
"""
from __future__ import annotations

import struct
from typing import List, Tuple

from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer

# llama.cpp token_type values (llama.h llama_token_type)
_TT_UNKNOWN = 2
_TT_CONTROL = 3
_TT_USER_DEFINED = 4


def tokenizer_from_gguf_metadata(md: dict):
    """``tokenizer.ggml.*`` GGUF KV metadata → tokenizer, or None when the
    file carries no vocab (or one of another model).

    - model "t5" / "llama" (SentencePiece unigram with scores) →
      T5UnigramTokenizer
    - model "gpt2" (byte-level BPE with merges) → Qwen2Tokenizer
    """
    model = md.get("tokenizer.ggml.model")
    tokens = md.get("tokenizer.ggml.tokens")
    if not model or not tokens:
        return None
    ttypes = md.get("tokenizer.ggml.token_type") or []

    def _id(key, default):
        v = md.get(f"tokenizer.ggml.{key}")
        return int(v) if v is not None else default

    if model in ("t5", "llama"):
        scores = md.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        unk = next((i for i, t in enumerate(ttypes) if t == _TT_UNKNOWN), 2)
        return T5UnigramTokenizer(
            list(zip(tokens, [float(s) for s in scores])),
            unk_id=_id("unknown_token_id", unk),
            eos_id=_id("eos_token_id", 1),
            pad_id=_id("padding_token_id", 0),
        )
    if model == "gpt2":
        merges = [tuple(m.split(" ", 1)) for m in md.get("tokenizer.ggml.merges") or []]
        vocab = {t: i for i, t in enumerate(tokens)}
        special = {tokens[i]: i for i, tt in enumerate(ttypes)
                   if tt in (_TT_CONTROL, _TT_USER_DEFINED)}
        tok = Qwen2Tokenizer(vocab, merges, special)
        tok.eos_token_id = _id("eos_token_id", tok.eos_token_id)
        tok.pad_token_id = _id("padding_token_id", tok.pad_token_id)
        return tok
    return None


def tokenizer_from_gguf_file(path: str):
    """Open a GGUF and build a tokenizer from its embedded vocab (None when
    absent)."""
    from sdtpu_torch.io.gguf import GGUFFile

    f = GGUFFile(path)
    try:
        return tokenizer_from_gguf_metadata(f.metadata)
    finally:
        f.close()


# ----------------------------------------------------------- spiece.model
def _read_varint(b: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        v = b[pos]
        pos += 1
        out |= (v & 0x7F) << shift
        if not v & 0x80:
            return out, pos
        shift += 7


def _skip_field(b: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(b, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(b, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire}")
    return pos


def _parse_sentence_piece(b: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, 1
    pos = 0
    while pos < len(b):
        tag, pos = _read_varint(b, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # piece
            n, pos = _read_varint(b, pos)
            piece = b[pos:pos + n].decode("utf-8", "replace")
            pos += n
        elif field == 2 and wire == 5:  # score
            (score,) = struct.unpack("<f", b[pos:pos + 4])
            pos += 4
        elif field == 3 and wire == 0:  # type
            ptype, pos = _read_varint(b, pos)
        else:
            pos = _skip_field(b, pos, wire)
    return piece, score, ptype


def parse_spiece_model(data: bytes) -> List[Tuple[str, float, int]]:
    """SentencePiece ModelProto bytes → [(piece, score, type)] in id order
    (field 1 = repeated SentencePiece{piece, score, type})."""
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return pieces


def load_spiece_model(path: str) -> T5UnigramTokenizer:
    """``spiece.model`` → T5UnigramTokenizer (the sidecar T5 checkpoints
    ship)."""
    with open(path, "rb") as f:
        pieces = parse_spiece_model(f.read())
    if not pieces:
        raise ValueError(f"{path}: no sentencepiece vocab found")
    vocab = [(p, s) for p, s, _ in pieces]
    ids = {p: i for i, (p, _, _) in enumerate(pieces)}
    unk = next((i for i, (_, _, t) in enumerate(pieces) if t == 2), 2)
    return T5UnigramTokenizer(
        vocab,
        unk_id=unk,
        eos_id=ids.get("</s>", 1),
        pad_id=ids.get("<pad>", 0),
    )
