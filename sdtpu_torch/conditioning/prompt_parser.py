"""webui-style prompt attention parsing (this package's copy of
``sdtpu/conditioning/prompt_parser.py``).

Behavioral parity with the reference's ``parse_prompt_attention``
(src/core/util.cpp:776-869), which implements the AUTOMATIC1111 webui grammar:

  (text)        weight * 1.1
  [text]        weight / 1.1
  (text:1.5)    explicit weight
  \\( \\) \\[ \\]   escaped literal brackets
  BREAK         chunk separator (emitted as ("BREAK", -1.0))
"""
from __future__ import annotations

import re
from typing import List, Tuple

_RE_ATTENTION = re.compile(
    r"""
    \\\(|\\\)|\\\[|\\\]|\\\\|\\|
    \(|\[|
    :\s*([+-]?[.\d]+)\s*\)|
    \)|\]|
    [^\\()\[\]:]+|
    :
    """,
    re.VERBOSE,
)
_RE_BREAK = re.compile(r"\s*\bBREAK\b\s*")

ROUND_MULT = 1.1
SQUARE_MULT = 1 / 1.1


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    res: List[Tuple[str, float]] = []
    round_brackets: List[int] = []
    square_brackets: List[int] = []

    def multiply_range(start: int, mult: float) -> None:
        for p in range(start, len(res)):
            res[p] = (res[p][0], res[p][1] * mult)

    for m in _RE_ATTENTION.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append((tok[1:], 1.0))
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), ROUND_MULT)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), SQUARE_MULT)
        else:
            parts = _RE_BREAK.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(("BREAK", -1.0))
                if part:
                    res.append((part, 1.0))

    for pos in round_brackets:
        multiply_range(pos, ROUND_MULT)
    for pos in square_brackets:
        multiply_range(pos, SQUARE_MULT)

    if not res:
        res = [("", 1.0)]

    # merge runs with identical weights
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i] = (res[i][0] + res[i + 1][0], res[i][1])
            del res[i + 1]
        else:
            i += 1
    return res
