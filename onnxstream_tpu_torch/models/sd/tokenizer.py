"""CLIP tokenizer with A1111-style prompt weighting.

Reproduces the reference's prompt pipeline (src/sd.cpp:1782-2290):

  * parse_prompt_attention — `(boost)` multiplies enclosed tokens by 1.1,
    `[deboost]` by 1/1.1, nesting multiplies (sd.cpp:1782-1900);
  * BPE with merge ranks over the CLIP regex (sd.cpp:1915-2032), `</w>`
    end-of-word marker;
  * 75-token chunking with comma backtracking: when a chunk fills within 20
    tokens of the last comma, the tail after the comma moves to the next chunk
    (sd.cpp:2062-2113);
  * per-token embedding multipliers with whole-chunk mean renormalization
    (sd.cpp:2196-2216) — applied by the pipeline after the text encoder runs.

Special ids (CLIP ViT-L/14 vocab): BOS 49406, EOS/pad 49407, comma 267.

Counterpart of ``onnxstream_tpu/models/sd/tokenizer.py``: the same code, carried
here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

BOS = 49406
EOS = 49407
COMMA = 267
CHUNK = 75

_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|\d|[^ \t\nA-Za-z\d]"
)


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """A1111 bracket weighting (reference src/sd.cpp:1782-1900)."""
    res: List[List] = []
    round_stack: List[int] = []
    square_stack: List[int] = []
    # split into bracket tokens and literal runs, exactly like the reference
    ms: List[str] = []
    for c in text:
        if c in "([)]":
            ms.append(c)
        else:
            if not ms or ms[-1] in "([)]":
                ms.append("")
            ms[-1] += c
    for tok in ms:
        if tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif tok == ")" and round_stack:
            for p in range(round_stack.pop(), len(res)):
                res[p][1] *= 1.1
        elif tok == "]" and square_stack:
            for p in range(square_stack.pop(), len(res)):
                res[p][1] *= 1 / 1.1
        else:
            res.append([tok, 1.0])
    for start in round_stack:
        for p in range(start, len(res)):
            res[p][1] *= 1.1
    for start in square_stack:
        for p in range(start, len(res)):
            res[p][1] *= 1 / 1.1
    # merge adjacent equal-weight runs
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i][0] += res[i + 1][0]
            del res[i + 1]
        else:
            i += 1
    return [(t, w) for t, w in res]


class ClipTokenizer:
    """BPE tokenizer over a CLIP vocab.

    Accepts the HF layout (vocab.json + merges.txt) or a plain vocab.txt whose
    line number is the id. Without merges, falls back to whole-word `</w>`
    splitting like the reference does when rankings are absent
    (src/sd.cpp:2018-2027).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Optional[List[Tuple[str, str]]] = None,
        lowercase: bool = True,
    ):
        self.token2idx = vocab
        self.ranks: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges or [])
        }
        self.lowercase = lowercase
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------- loading
    @classmethod
    def from_dir(cls, path: str, **kw) -> "ClipTokenizer":
        vj = os.path.join(path, "vocab.json")
        vt = os.path.join(path, "vocab.txt")
        if os.path.exists(vj):
            vocab = {k: int(v) for k, v in json.load(open(vj)).items()}
        elif os.path.exists(vt):
            vocab = {line.rstrip("\n"): i for i, line in enumerate(open(vt))}
        else:
            raise FileNotFoundError(f"no vocab.json/vocab.txt under {path}")
        merges = None
        mt = os.path.join(path, "merges.txt")
        if os.path.exists(mt):
            merges = []
            for line in open(mt):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        return cls(vocab, merges, **kw)

    # ----------------------------------------------------------------- BPE
    def bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = [c for c in token[:-1]] + [token[-1] + "</w>"]
        if len(word) == 1:
            return [token + "</w>"]
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
            if len(word) == 1:
                break
        self._cache[token] = word
        return word

    def split(self, text: str) -> List[str]:
        out: List[str] = []
        for m in _CLIP_PAT.finditer(text):
            s = m.group(0)
            if self.ranks:
                out.extend(self.bpe(s))
            else:
                if s:
                    out.append(s + "</w>")
        return out

    def encode_word_ids(self, text: str) -> List[int]:
        if self.lowercase:
            text = text.lower()
        ids = []
        for tok in self.split(text):
            idx = self.token2idx.get(tok)
            if idx is not None:
                ids.append(idx)
        return ids

    # ------------------------------------------------- prompt -> 77-chunks
    def encode_with_weights(self, prompt: str) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Returns a list of (tokens[77] int64, multipliers[77] float32) chunks,
        implementing the comma-backtracking repacking (src/sd.cpp:2062-2113)."""
        parsed = parse_prompt_attention(prompt)
        remade: List[int] = []
        mults: List[float] = []
        last_comma = -1
        for text, weight in parsed:
            for token in self.encode_word_ids(text):
                if token == COMMA:
                    last_comma = len(remade)
                elif (
                    max(len(remade), 1) % CHUNK == 0
                    and last_comma != -1
                    and len(remade) - last_comma <= 20
                ):
                    last_comma += 1
                    reloc_t = remade[last_comma:]
                    reloc_m = mults[last_comma:]
                    remade = remade[:last_comma]
                    mults = mults[:last_comma]
                    rem = math.ceil(len(remade) / CHUNK) * CHUNK - len(remade)
                    remade += [EOS] * rem + reloc_t
                    mults += [1.0] * rem + reloc_m
                remade.append(token)
                mults.append(weight)
        target = math.ceil(max(len(remade), 1) / CHUNK) * CHUNK
        remade += [EOS] * (target - len(remade))
        mults += [1.0] * (target - len(mults))

        chunks = []
        for off in range(0, len(remade), CHUNK):
            toks = np.full(77, BOS, np.int64)
            ws = np.ones(77, np.float32)
            toks[1:76] = remade[off : off + CHUNK]
            ws[1:76] = mults[off : off + CHUNK]
            toks[76] = EOS
            chunks.append((toks, ws))
        return chunks


def apply_multipliers(hidden: np.ndarray, multipliers: np.ndarray) -> np.ndarray:
    """Scale per-token embeddings and renormalize to preserve the chunk mean
    (reference src/sd.cpp:2196-2216). hidden: (77, d), multipliers: (77,)."""
    hidden = np.asarray(hidden, np.float32)
    mean = hidden.mean(dtype=np.float64)
    out = hidden * multipliers[:, None].astype(np.float32)
    mean2 = out.mean(dtype=np.float64)
    if mean2 != 0:
        out = out * np.float32(mean / mean2)
    return out
